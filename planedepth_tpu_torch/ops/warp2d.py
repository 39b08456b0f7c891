"""Per-plane 2-D warp of the 2-D warp recipes (``planedepth_tpu/ops/pallas_warp2d.py:warp2d_sample``).

For each plane n and pixel (x, y) the source image, the plane's logit and
its sigma are sampled bilinearly at ``(x + dx, y + dy)`` with zero padding
(``F.grid_sample(align_corners=True, padding_mode="zeros")`` in pixel
units), and multiplied by ``mask`` and by the fold of fully-outside samples
(``prepare_coords``: ``x + dx`` in (-1, W) and ``y + dy`` in (-1, H), as
positive comparisons, so a NaN coordinate is masked).  Every sample is
exact; the TPU kernel's tap windows and spread clamp have no counterpart.

``warp2d`` launches the CUDA forward and backward kernels of
``csrc/warp2d.cu`` on CUDA tensors (``warp2d.fwd_launches`` and
``warp2d.bwd_launches`` count the launches) and takes ``warp2d_plain``,
differentiated by autograd, on CPU tensors.  The gradient reaches the
logits, sigma, dx and dy; ``src`` and ``mask`` get none, as in the JAX
package's VJP (``_w2d_bwd``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from planedepth_tpu_torch.ops._build import launch


def _fold(dx: torch.Tensor, dy: torch.Tensor, mask: torch.Tensor):
    """Pixel coordinates and the folded mask: ``(xs, ys, m)``, with
    ``xs, ys`` set to 0 where the sample is fully outside (where no
    gradient flows back to a degenerate coordinate)."""
    H, W = dx.shape[-2:]
    xs = dx + torch.arange(W, dtype=dx.dtype, device=dx.device)
    ys = dy + torch.arange(H, dtype=dy.dtype, device=dy.device)[:, None]
    valid = (xs > -1.0) & (xs < W) & (ys > -1.0) & (ys < H)
    zero = torch.zeros_like(xs)
    return (torch.where(valid, xs, zero), torch.where(valid, ys, zero),
            mask.detach() * valid.to(mask.dtype))


def warp2d_plain(src: torch.Tensor, logits: torch.Tensor, sigma: torch.Tensor,
                 dx: torch.Tensor, dy: torch.Tensor, mask: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the CPU path and the kernels' oracle, with
    explicit 4-tap gathers in pixel space (no normalised coordinates).

    src ``(B, 3, H, W)``; logits, sigma, dx, dy, mask ``(B, N, H, W)``.
    Returns ``(rgb (B, N, 3, H, W), logit (B, N, H, W), sigma (B, N, H, W))``.
    """
    B, N, H, W = dx.shape
    xs, ys, m = _fold(dx, dy, mask)
    x0, y0 = torch.floor(xs.detach()), torch.floor(ys.detach())
    fx, fy = xs - x0, ys - y0
    x0, y0 = x0.long(), y0.long()
    maps = torch.cat([src.detach()[:, None].expand(B, N, 3, H, W),
                      logits[:, :, None], sigma[:, :, None]], dim=2)      # (B,N,5,H,W)
    flat = maps.reshape(B, N, 5, H * W)
    out = 0.0
    for iy, wy in ((y0, 1.0 - fy), (y0 + 1, fy)):
        for ix, wx in ((x0, 1.0 - fx), (x0 + 1, fx)):
            inside = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
            idx = (iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)).reshape(B, N, 1, H * W)
            v = torch.gather(flat, 3, idx.expand(B, N, 5, H * W)).reshape(B, N, 5, H, W)
            out = out + (wy * wx * inside.to(wy.dtype))[:, :, None] * v
    out = out * m[:, :, None]
    return out[:, :, :3], out[:, :, 3], out[:, :, 4]


def _check(src, logits, sigma, dx, dy, mask):
    if dx.dim() != 4:
        raise ValueError(f"dx must be (B, N, H, W), got {tuple(dx.shape)}")
    B, N, H, W = dx.shape
    want = {"src": (B, 3, H, W), "logits": (B, N, H, W), "sigma": (B, N, H, W),
            "dx": (B, N, H, W), "dy": (B, N, H, W), "mask": (B, N, H, W)}
    for name, t in zip(want, (src, logits, sigma, dx, dy, mask)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, want {want[name]}")
        if t.device != dx.device:
            raise ValueError(f"{name} on {t.device}, dx on {dx.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {t.dtype}, the kernels take float32")
    if B * N > 65535 or H > 65535:
        raise ValueError(f"(B * N, H) = ({B * N}, {H}) exceed the kernels' grid")
    if src.requires_grad or mask.requires_grad:
        raise NotImplementedError("warp2d: the kernels take no gradient through "
                                  "src or mask")


class _Warp2d(torch.autograd.Function):
    """The two CUDA kernels joined as forward and backward."""

    @staticmethod
    def forward(ctx, src, logits, sigma, dx, dy, mask):
        B, N, H, W = dx.shape
        src, logits, sigma, dx, dy, mask = (
            t.contiguous() for t in (src, logits, sigma, dx, dy, mask))
        rgb = torch.empty((B, N, 3, H, W), dtype=torch.float32, device=dx.device)
        logit, sig = torch.empty_like(logits), torch.empty_like(sigma)
        launch("pdt_warp2d_fwd", *(t.data_ptr() for t in (
            src, logits, sigma, dx, dy, mask, rgb, logit, sig)), B, N, H, W)
        warp2d.fwd_launches += 1
        ctx.save_for_backward(src, logits, sigma, dx, dy, mask)
        return rgb, logit, sig

    @staticmethod
    def backward(ctx, g_rgb, g_logit, g_sigma):
        src, logits, sigma, dx, dy, mask = ctx.saved_tensors
        B, N, H, W = dx.shape
        d_logits, d_sigma = torch.zeros_like(logits), torch.zeros_like(sigma)
        d_dx, d_dy = torch.empty_like(dx), torch.empty_like(dy)
        launch("pdt_warp2d_bwd", *(t.data_ptr() for t in (
            src, logits, sigma, dx, dy, mask, g_rgb.contiguous(), g_logit.contiguous(),
            g_sigma.contiguous(), d_logits, d_sigma, d_dx, d_dy)), B, N, H, W)
        warp2d.bwd_launches += 1
        return None, d_logits, d_sigma, d_dx, d_dy, None


def warp2d(src: torch.Tensor, logits: torch.Tensor, sigma: torch.Tensor,
           dx: torch.Tensor, dy: torch.Tensor, mask: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(rgb, logit, sigma)`` as :func:`warp2d_plain`.

    CPU tensors take :func:`warp2d_plain`.  CUDA tensors run the forward
    kernel, and the backward kernel when autograd reaches it; any other
    device raises.
    """
    if dx.device.type == "cpu":
        return warp2d_plain(src, logits, sigma, dx, dy, mask)
    if dx.device.type != "cuda":
        raise NotImplementedError(f"warp2d: no kernel for {dx.device}")
    _check(src, logits, sigma, dx, dy, mask)
    with torch.cuda.device(dx.device):
        return _Warp2d.apply(src, logits, sigma, dx, dy, mask)


warp2d.fwd_launches = 0
warp2d.bwd_launches = 0
