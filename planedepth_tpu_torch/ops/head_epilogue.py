"""The plane heads' epilogue (``planedepth_tpu/ops/pallas_relayout.py``'s arithmetic).

The decoder's ``dispconv`` and ``sigmaconv`` write plane-first ``(B, N, H, W)``
maps with their bias; the epilogue masks the logits with the plane volume's
``padding_mask`` and turns the sigma head into the mixture scales,
``clip(sigmoid(x), 0.01, 1)``.  Under ``render_probability`` the logits head
has ``N - 1`` planes beside the N of the mask and sigma, and takes the mask's
first ``N - 1`` planes (the decoder appends the last density plane after
the epilogue).  On the TPU the same epilogue rides inside the
relayout kernels that move the merged head to and from the sweep's padded
NCHW layout; NCHW PyTorch has no layout left to change, so the port's
kernel is the epilogue alone.

``head_epilogue`` launches the CUDA forward and backward kernels of
``csrc/head_epilogue.cu`` on CUDA tensors (``head_epilogue.fwd_launches`` and
``head_epilogue.bwd_launches`` count the launches) and takes
``head_epilogue_plain``, differentiated by autograd, on CPU tensors.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from planedepth_tpu_torch.ops._build import launch


def head_epilogue_plain(raw_logits: torch.Tensor, raw_sigma: Optional[torch.Tensor],
                        padding_mask: torch.Tensor
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version: the CPU path and the kernels' oracle.

    raw_logits ``(B, N_l, H, W)`` with ``N_l`` N or N - 1, raw_sigma ``(B,
    N, H, W)`` (None without a sigma head); padding_mask ``(B, N, H, 1)`` or
    ``(B, N, H, W)``, whose first ``N_l`` planes mask the logits.  Returns
    ``(logits, sigma)``.
    """
    logits = raw_logits * padding_mask[:, :raw_logits.shape[1]]
    if raw_sigma is None:
        return logits, None
    return logits, torch.clamp(torch.sigmoid(raw_sigma), 0.01, 1.0)


def _check(raw_logits, raw_sigma, padding_mask):
    if raw_logits.dim() != 4 or padding_mask.dim() != 4:
        raise ValueError(f"raw_logits and padding_mask must be 4-D, got "
                         f"{tuple(raw_logits.shape)} and {tuple(padding_mask.shape)}")
    B, N_l, H, W = raw_logits.shape
    N = padding_mask.shape[1]
    if N_l not in (N, N - 1) or N_l < 1:
        raise ValueError(f"raw_logits: {N_l} planes beside the mask's {N} (want N or N - 1)")
    if raw_sigma is not None and tuple(raw_sigma.shape) != (B, N, H, W):
        raise ValueError(f"raw_sigma: shape {tuple(raw_sigma.shape)}, want {(B, N, H, W)}")
    if tuple(padding_mask.shape) not in ((B, N, H, 1), (B, N, H, W)):
        raise ValueError(f"padding_mask: shape {tuple(padding_mask.shape)}, want "
                         f"{(B, N, H, 1)} or {(B, N, H, W)}")
    if B * N * H >= 2 ** 31:
        raise ValueError(f"(B, N, H) = {(B, N, H)}: more rows than the kernels' 32-bit "
                         f"row index takes")
    if padding_mask.requires_grad:
        raise NotImplementedError("head_epilogue: the kernel takes no gradient "
                                  "through the padding mask")
    for name, t in (("raw_logits", raw_logits), ("raw_sigma", raw_sigma),
                    ("padding_mask", padding_mask)):
        if t is None:
            continue
        if t.device != raw_logits.device:
            raise ValueError(f"{name} on {t.device}, raw_logits on {raw_logits.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {t.dtype}, the kernels take float32")


class _HeadEpilogue(torch.autograd.Function):
    """The two CUDA kernels joined as forward and backward."""

    @staticmethod
    def forward(ctx, raw_logits, raw_sigma, padding_mask):
        B, N_l, H, W = raw_logits.shape
        N = padding_mask.shape[1]
        raw_logits = raw_logits.contiguous()
        raw_sigma = None if raw_sigma is None else raw_sigma.contiguous()
        mask = padding_mask.contiguous()
        full = int(mask.shape[-1] == W and W != 1)
        logits = torch.empty_like(raw_logits)
        sigma = None if raw_sigma is None else torch.empty_like(raw_sigma)
        launch("pdt_head_epilogue_fwd", raw_logits, raw_sigma, mask, logits, sigma,
               B, N, N_l, H, W, full)
        head_epilogue.fwd_launches += 1
        ctx.save_for_backward(sigma, mask)
        ctx.full = full
        return (logits,) if sigma is None else (logits, sigma)

    @staticmethod
    def backward(ctx, g_logits, g_sigma=None):
        sigma, mask = ctx.saved_tensors
        B, N_l, H, W = g_logits.shape
        N = mask.shape[1]
        g_logits = g_logits.contiguous()
        g_sigma = None if sigma is None else g_sigma.contiguous()
        d_logits = torch.empty_like(g_logits)
        d_sigma = None if sigma is None else torch.empty_like(sigma)
        launch("pdt_head_epilogue_bwd", g_logits, g_sigma, sigma, mask, d_logits, d_sigma,
               B, N, N_l, H, W, ctx.full)
        head_epilogue.bwd_launches += 1
        return d_logits, d_sigma, None


def head_epilogue(raw_logits: torch.Tensor, raw_sigma: Optional[torch.Tensor],
                  padding_mask: torch.Tensor
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(logits, sigma)`` as :func:`head_epilogue_plain`.

    CPU tensors take :func:`head_epilogue_plain`.  CUDA tensors run the
    forward kernel, and the backward kernel when autograd reaches it; any
    other device raises.
    """
    if raw_logits.device.type == "cpu":
        return head_epilogue_plain(raw_logits, raw_sigma, padding_mask)
    if raw_logits.device.type != "cuda":
        raise NotImplementedError(f"head_epilogue: no kernel for {raw_logits.device}")
    _check(raw_logits, raw_sigma, padding_mask)
    with torch.cuda.device(raw_logits.device):
        out = _HeadEpilogue.apply(raw_logits, raw_sigma, padding_mask)
    return (out[0], None) if raw_sigma is None else out


head_epilogue.fwd_launches = 0
head_epilogue.bwd_launches = 0
