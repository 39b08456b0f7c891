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

The forward and its backward are ``torch.library`` custom ops,
``planedepth_tpu_torch::head_epilogue`` and ``::head_epilogue_bwd``,
registered when this module is imported (``import planedepth_tpu_torch.ops``
imports it), so an eager call and a ``torch.export``-ed program reach the
same code: on CUDA tensors the kernels of ``csrc/head_epilogue.cu``
(``head_epilogue.fwd_launches`` and ``head_epilogue.bwd_launches`` count
their runs), on CPU tensors ``head_epilogue_plain`` and its adjoint
``head_epilogue_bwd_plain``.  Without a sigma head the ops carry an empty
tensor in its place.
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
    for name, t in (("raw_logits", raw_logits), ("raw_sigma", raw_sigma),
                    ("padding_mask", padding_mask)):
        if t is None:
            continue
        if t.device != raw_logits.device:
            raise ValueError(f"{name} on {t.device}, raw_logits on {raw_logits.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {t.dtype}, the kernels take float32")


def head_epilogue_bwd_plain(g_logits: torch.Tensor, g_sigma: Optional[torch.Tensor],
                            sigma: Optional[torch.Tensor], padding_mask: torch.Tensor
                            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The adjoint of :func:`head_epilogue_plain` in plain PyTorch: the CPU
    path of the backward and the backward kernel's oracle.  ``sigma`` is
    the epilogue's output, whose clip gates the gradient as in the kernel
    (``csrc/head_epilogue.cu:sigma_grad``).  Returns ``(d_raw_logits,
    d_raw_sigma)``."""
    d_logits = g_logits * padding_mask[:, :g_logits.shape[1]]
    if sigma is None:
        return d_logits, None
    inside = (sigma > 0.01) & (sigma < 1.0)
    return d_logits, torch.where(inside, g_sigma * (1.0 - sigma) * sigma,
                                 torch.zeros_like(sigma))


def _no_sigma(like: torch.Tensor) -> torch.Tensor:
    """The empty tensor that stands for an absent sigma in the ops."""
    return like.new_empty(0)


@torch.library.custom_op("planedepth_tpu_torch::head_epilogue", mutates_args=(),
                         device_types="cpu")
def _head_epilogue_op(raw_logits: torch.Tensor, raw_sigma: Optional[torch.Tensor],
                      padding_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    logits, sigma = head_epilogue_plain(raw_logits, raw_sigma, padding_mask)
    return logits, _no_sigma(logits) if sigma is None else sigma


def _full(mask: torch.Tensor, W: int) -> int:
    """1 where the mask has a column for every pixel, 0 where it is one a row."""
    return int(mask.shape[-1] == W and W != 1)


@_head_epilogue_op.register_kernel("cuda")
def _head_epilogue_cuda(raw_logits, raw_sigma, padding_mask):
    _check(raw_logits, raw_sigma, padding_mask)
    B, N_l, H, W = raw_logits.shape
    N = padding_mask.shape[1]
    with torch.cuda.device(raw_logits.device):
        raw_logits = raw_logits.contiguous()
        raw_sigma = None if raw_sigma is None else raw_sigma.contiguous()
        mask = padding_mask.contiguous()
        logits = torch.empty_like(raw_logits)
        sigma = None if raw_sigma is None else torch.empty_like(raw_sigma)
        launch("pdt_head_epilogue_fwd", raw_logits, raw_sigma, mask, logits, sigma,
               B, N, N_l, H, W, _full(mask, W))
    head_epilogue.fwd_launches += 1
    return logits, _no_sigma(logits) if sigma is None else sigma


@_head_epilogue_op.register_fake
def _(raw_logits, raw_sigma, padding_mask):
    return (torch.empty_like(raw_logits),
            _no_sigma(raw_logits) if raw_sigma is None else torch.empty_like(raw_sigma))


@torch.library.custom_op("planedepth_tpu_torch::head_epilogue_bwd", mutates_args=(),
                         device_types="cpu")
def _head_epilogue_bwd_op(g_logits: torch.Tensor, g_sigma: Optional[torch.Tensor],
                          sigma: Optional[torch.Tensor], padding_mask: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    d_logits, d_sigma = head_epilogue_bwd_plain(g_logits, g_sigma, sigma, padding_mask)
    return d_logits, _no_sigma(d_logits) if d_sigma is None else d_sigma


@_head_epilogue_bwd_op.register_kernel("cuda")
def _head_epilogue_bwd_cuda(g_logits, g_sigma, sigma, padding_mask):
    B, N_l, H, W = g_logits.shape
    N = padding_mask.shape[1]
    with torch.cuda.device(g_logits.device):
        g_logits = g_logits.contiguous()
        g_sigma = None if sigma is None else g_sigma.contiguous()
        mask = padding_mask.contiguous()
        d_logits = torch.empty_like(g_logits)
        d_sigma = None if sigma is None else torch.empty_like(sigma)
        launch("pdt_head_epilogue_bwd", g_logits, g_sigma, sigma, mask, d_logits, d_sigma,
               B, N, N_l, H, W, _full(mask, W))
    head_epilogue.bwd_launches += 1
    return d_logits, _no_sigma(d_logits) if d_sigma is None else d_sigma


@_head_epilogue_bwd_op.register_fake
def _(g_logits, g_sigma, sigma, padding_mask):
    return (torch.empty_like(g_logits),
            _no_sigma(g_logits) if sigma is None else torch.empty_like(sigma))


def _setup_context(ctx, inputs, output):
    _, raw_sigma, padding_mask = inputs
    ctx.with_sigma = raw_sigma is not None
    ctx.save_for_backward(output[1] if ctx.with_sigma else None, padding_mask)


def _backward(ctx, g_logits, g_sigma):
    sigma, mask = ctx.saved_tensors
    if sigma is None:
        g_sigma = None
    elif g_sigma is None:
        g_sigma = torch.zeros_like(sigma)
    d_logits, d_sigma = _head_epilogue_bwd_op(g_logits, g_sigma, sigma, mask)
    return d_logits, d_sigma if ctx.with_sigma else None, None


_head_epilogue_op.register_autograd(_backward, setup_context=_setup_context)


def head_epilogue(raw_logits: torch.Tensor, raw_sigma: Optional[torch.Tensor],
                  padding_mask: torch.Tensor
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(logits, sigma)`` as :func:`head_epilogue_plain`, through the
    ``planedepth_tpu_torch::head_epilogue`` op.

    CPU tensors take :func:`head_epilogue_plain` (and
    :func:`head_epilogue_bwd_plain` under autograd).  CUDA tensors run the
    forward kernel, and the backward kernel when autograd reaches it; any
    other device raises.
    """
    if raw_logits.device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"head_epilogue: no kernel for {raw_logits.device}")
    if raw_logits.device.type == "cuda" and padding_mask.requires_grad:
        raise NotImplementedError("head_epilogue: the kernel takes no gradient "
                                  "through the padding mask")
    logits, sigma = _head_epilogue_op(raw_logits, raw_sigma, padding_mask)
    return logits, None if raw_sigma is None else sigma


head_epilogue.fwd_launches = 0
head_epilogue.bwd_launches = 0
