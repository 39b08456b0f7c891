"""Expected-disparity head (``planedepth_tpu/ops/pallas_disp.py:disp_head``).

Per pixel over the N planes: ``p = softmax(l)``, ``u = p * m / s``,
``U = sum u``, ``disp = sum(u * d) / U``, and 0 where ``U <= 1e-7`` (the
guarded reciprocal of ``mixture_reweight``).  The gradient reaches the
logits, sigma and the row disparities; the mask is a constant.

The forward and its backward are ``torch.library`` custom ops,
``planedepth_tpu_torch::disp_head`` and ``::disp_head_bwd``, registered when
this module is imported (``import planedepth_tpu_torch.ops`` imports it),
so an eager call and a ``torch.export``-ed program reach the same code: on
CUDA tensors the kernels of ``csrc/disp_head.cu`` (``disp_head.launches``
and ``disp_head.bwd_launches`` count their runs), on CPU tensors
``disp_head_plain`` and its adjoint ``disp_head_bwd_plain``.  The library
is built at the first launch, not at import.
"""
from __future__ import annotations

from typing import Tuple

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


def disp_head_bwd_plain(logits: torch.Tensor, sigma: torch.Tensor,
                        disp_rows: torch.Tensor, mask_rows: torch.Tensor,
                        g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The adjoint of :func:`disp_head_plain` in plain PyTorch: the CPU path
    of the backward and the backward kernel's oracle.  ``g`` is the
    cotangent of disp ``(B, 1, H, W)``; returns ``(d_logits, d_sigma,
    d_disp_rows)``, the mask a constant.  Written out, as autograd through
    :func:`disp_head_plain` composes it: inside a custom op autograd does
    not record."""
    p = torch.softmax(logits, dim=1)
    m = mask_rows.transpose(1, 2)[..., None]                  # (B, N, H, 1)
    d = disp_rows.transpose(1, 2)[..., None]
    pm = p * m
    u = pm / sigma
    U = u.sum(dim=1, keepdim=True)
    D = (u * d).sum(dim=1, keepdim=True)
    inv = torch.where(U > EPS, 1.0 / torch.clamp_min(U, EPS), torch.zeros_like(U))
    g_D = g * inv
    g_U = -(g * D) * inv * inv                      # 0 where the reciprocal is guarded
    g_u = g_D * d + g_U
    d_rows = (g_D * u).sum(dim=3).transpose(1, 2)             # (B, H, N)
    d_sigma = -g_u * pm / (sigma * sigma)
    g_p = g_u / sigma * m
    d_logits = p * (g_p - (g_p * p).sum(dim=1, keepdim=True))
    return d_logits, d_sigma, d_rows.contiguous()


@torch.library.custom_op("planedepth_tpu_torch::disp_head", mutates_args=(),
                         device_types="cpu")
def _disp_head_op(logits: torch.Tensor, sigma: torch.Tensor, disp_rows: torch.Tensor,
                  mask_rows: torch.Tensor) -> torch.Tensor:
    return disp_head_plain(logits, sigma, disp_rows, mask_rows)


@_disp_head_op.register_kernel("cuda")
def _disp_head_cuda(logits, sigma, disp_rows, mask_rows):
    _check(logits, sigma, disp_rows, mask_rows)
    B, N, H, W = logits.shape
    with torch.cuda.device(logits.device):
        out = torch.empty((B, 1, H, W), dtype=torch.float32, device=logits.device)
        launch("pdt_disp_head_fwd", logits, sigma, disp_rows, mask_rows, out, B, N, H, W)
    disp_head.launches += 1
    return out


@_disp_head_op.register_fake
def _(logits, sigma, disp_rows, mask_rows):
    B, _, H, W = logits.shape
    return logits.new_empty((B, 1, H, W))


@torch.library.custom_op("planedepth_tpu_torch::disp_head_bwd", mutates_args=(),
                         device_types="cpu")
def _disp_head_bwd_op(logits: torch.Tensor, sigma: torch.Tensor, disp_rows: torch.Tensor,
                      mask_rows: torch.Tensor, g: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return disp_head_bwd_plain(logits, sigma, disp_rows, mask_rows, g)


@_disp_head_bwd_op.register_kernel("cuda")
def _disp_head_bwd_cuda(logits, sigma, disp_rows, mask_rows, g):
    B, N, H, W = logits.shape
    with torch.cuda.device(logits.device):
        g = g.contiguous()
        d_logits, d_sigma = torch.empty_like(logits), torch.empty_like(sigma)
        d_rows = torch.empty_like(disp_rows)
        # the per-tile partial sums of d_rows, reduced in a fixed order
        scratch = torch.empty(load_library().pdt_disp_head_bwd_scratch_floats(B, N, H, W),
                              dtype=torch.float32, device=logits.device)
        launch("pdt_disp_head_bwd", logits, sigma, disp_rows, mask_rows, g, d_logits,
               d_sigma, d_rows, scratch if scratch.numel() else None, B, N, H, W)
    disp_head.bwd_launches += 1
    return d_logits, d_sigma, d_rows


@_disp_head_bwd_op.register_fake
def _(logits, sigma, disp_rows, mask_rows, g):
    return torch.empty_like(logits), torch.empty_like(sigma), torch.empty_like(disp_rows)


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _backward(ctx, g):
    d_logits, d_sigma, d_rows = _disp_head_bwd_op(*ctx.saved_tensors, g)
    return d_logits, d_sigma, d_rows, None


_disp_head_op.register_autograd(_backward, setup_context=_setup_context)


def disp_head(logits: torch.Tensor, sigma: torch.Tensor,
              disp_rows: torch.Tensor, mask_rows: torch.Tensor) -> torch.Tensor:
    """Expected disparity ``(B, 1, H, W)`` from the plane heads, through the
    ``planedepth_tpu_torch::disp_head`` op.

    CPU tensors take :func:`disp_head_plain` (and :func:`disp_head_bwd_plain`
    under autograd).  CUDA tensors launch the forward kernel, and the
    backward kernel when autograd reaches it, or raise.
    """
    if logits.device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"disp_head: no kernel for {logits.device}")
    if logits.device.type == "cuda" and mask_rows.requires_grad:
        raise NotImplementedError("disp_head: the kernels take no gradient through "
                                  "the mask")
    return _disp_head_op(logits, sigma, disp_rows, mask_rows)


disp_head.launches = 0
disp_head.bwd_launches = 0
