"""Expected-disparity head (``planedepth_tpu/ops/pallas_disp.py:disp_head``).

Per pixel over the N planes: ``p = softmax(l)``, ``u = p * m / s``,
``U = sum u``, ``disp = sum(u * d) / U``, and 0 where ``U <= 1e-7`` (the
guarded reciprocal of ``mixture_reweight``).  ``disp_head`` launches the
forward kernel of ``csrc/disp_head.cu`` on CUDA tensors, and its backward
kernel when autograd reaches it (``disp_head.launches`` and
``disp_head.bwd_launches`` count the launches); on CPU tensors it takes
``disp_head_plain``, differentiated by autograd.  The gradient reaches the
logits, sigma and the row disparities; the mask is a constant.
"""
from __future__ import annotations

import torch

from planedepth_tpu_torch.ops._build import launch, load_library

EPS = 1e-7


def disp_head_plain(logits: torch.Tensor, sigma: torch.Tensor,
                    disp_rows: torch.Tensor, mask_rows: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the CPU path and the kernel's oracle.

    logits, sigma: ``(B, N, H, W)``, logits already masked; disp_rows,
    mask_rows: ``(B, H, N)`` row-constant plane disparities and 0/1 mask.
    Returns disp ``(B, 1, H, W)``.
    """
    p = torch.softmax(logits, dim=1)
    m = mask_rows.transpose(1, 2)[..., None]                  # (B, N, H, 1)
    d = disp_rows.transpose(1, 2)[..., None]
    u = p * m / sigma
    U = u.sum(dim=1, keepdim=True)
    D = (u * d).sum(dim=1, keepdim=True)
    inv = torch.where(U > EPS, 1.0 / torch.clamp_min(U, EPS), torch.zeros_like(U))
    return D * inv


def _check(logits, sigma, disp_rows, mask_rows):
    if logits.dim() != 4:
        raise ValueError(f"logits must be (B, N, H, W), got {tuple(logits.shape)}")
    B, N, H, W = logits.shape
    want = {"logits": (B, N, H, W), "sigma": (B, N, H, W),
            "disp_rows": (B, H, N), "mask_rows": (B, H, N)}
    for name, t in zip(want, (logits, sigma, disp_rows, mask_rows)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, want {want[name]}")
        if t.device != logits.device:
            raise ValueError(f"{name} on {t.device}, logits on {logits.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if 2 * N * 4 > 48 * 1024:
        raise ValueError(f"N={N} planes exceed the kernel's shared-memory rows")
    if mask_rows.requires_grad:
        raise NotImplementedError("disp_head: the kernels take no gradient through "
                                  "the mask")


class _DispHead(torch.autograd.Function):
    """The forward and backward kernels joined by autograd."""

    @staticmethod
    def forward(ctx, logits, sigma, disp_rows, mask_rows):
        B, N, H, W = logits.shape
        out = torch.empty((B, 1, H, W), dtype=torch.float32, device=logits.device)
        launch("pdt_disp_head_fwd", logits, sigma, disp_rows, mask_rows, out, B, N, H, W)
        disp_head.launches += 1
        ctx.save_for_backward(logits, sigma, disp_rows, mask_rows)
        return out

    @staticmethod
    def backward(ctx, g):
        logits, sigma, disp_rows, mask_rows = ctx.saved_tensors
        B, N, H, W = logits.shape
        g = g.contiguous()
        d_logits, d_sigma = torch.empty_like(logits), torch.empty_like(sigma)
        d_rows = torch.empty_like(disp_rows)
        # the per-tile partial sums of d_rows, reduced in a fixed order
        scratch = torch.empty(load_library().pdt_disp_head_bwd_scratch_floats(B, N, H, W),
                              dtype=torch.float32, device=logits.device)
        launch("pdt_disp_head_bwd", logits, sigma, disp_rows, mask_rows, g, d_logits,
               d_sigma, d_rows, scratch if scratch.numel() else None, B, N, H, W)
        disp_head.bwd_launches += 1
        return d_logits, d_sigma, d_rows, None


def disp_head(logits: torch.Tensor, sigma: torch.Tensor,
              disp_rows: torch.Tensor, mask_rows: torch.Tensor) -> torch.Tensor:
    """Expected disparity ``(B, 1, H, W)`` from the plane heads.

    CPU tensors take :func:`disp_head_plain`.  CUDA tensors launch the
    forward kernel, and the backward kernel when autograd reaches it, or
    raise.
    """
    if logits.device.type == "cpu":
        return disp_head_plain(logits, sigma, disp_rows, mask_rows)
    if logits.device.type != "cuda":
        raise NotImplementedError(f"disp_head: no kernel for {logits.device}")
    _check(logits, sigma, disp_rows, mask_rows)
    with torch.cuda.device(logits.device):
        return _DispHead.apply(logits, sigma, disp_rows, mask_rows)


disp_head.launches = 0
disp_head.bwd_launches = 0
