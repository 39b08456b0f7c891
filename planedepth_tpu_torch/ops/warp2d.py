"""Per-plane 2-D warp of the 2-D warp recipes (``planedepth_tpu/ops/pallas_warp2d.py:warp2d_sample``).

For each plane n and pixel (x, y) the source image, the plane's logit and
its sigma are sampled bilinearly at ``(x + dx, y + dy)`` with zero padding
(``F.grid_sample(align_corners=True, padding_mode="zeros")`` in pixel
units), and multiplied by ``mask`` and by the fold of fully-outside samples
(``prepare_coords``: ``x + dx`` in (-1, W) and ``y + dy`` in (-1, H), as
positive comparisons, so a NaN coordinate is masked).  Every sample is
exact; the TPU kernel's tap windows and spread clamp have no counterpart.

``sigma=None`` is the mode without the mixture (``warp2d_sample(...,
with_sigma=False)``): only ``[rgb | logit]`` are warped, and the result is
``(rgb, logit)``.

``warp2d`` launches the CUDA forward and backward kernels of
``csrc/warp2d.cu`` on CUDA tensors (``warp2d.fwd_launches`` and
``warp2d.bwd_launches`` count the launches with sigma,
``nosigma_fwd_launches`` and ``nosigma_bwd_launches`` those without) and
takes ``warp2d_plain``, differentiated by autograd, on CPU tensors.  The
gradient reaches the logits, sigma, dx and dy; ``src`` and ``mask`` get
none, as in the JAX package's VJP (``_w2d_bwd``).
"""
from __future__ import annotations

from typing import Optional, Tuple

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


def warp2d_plain(src: torch.Tensor, logits: torch.Tensor, sigma: Optional[torch.Tensor],
                 dx: torch.Tensor, dy: torch.Tensor, mask: torch.Tensor
                 ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version: the CPU path and the kernels' oracle, with
    explicit 4-tap gathers in pixel space (no normalised coordinates).

    src ``(B, 3, H, W)``; logits, sigma, dx, dy, mask ``(B, N, H, W)``.
    Returns ``(rgb (B, N, 3, H, W), logit (B, N, H, W), sigma (B, N, H, W))``,
    without the last when ``sigma`` is None.
    """
    B, N, H, W = dx.shape
    xs, ys, m = _fold(dx, dy, mask)
    x0, y0 = torch.floor(xs.detach()), torch.floor(ys.detach())
    fx, fy = xs - x0, ys - y0
    x0, y0 = x0.long(), y0.long()
    heads = [logits[:, :, None]] + ([] if sigma is None else [sigma[:, :, None]])
    maps = torch.cat([src.detach()[:, None].expand(B, N, 3, H, W), *heads], dim=2)
    C = maps.shape[2]                                                  # 5, or 4
    flat = maps.reshape(B, N, C, H * W)
    out = 0.0
    for iy, wy in ((y0, 1.0 - fy), (y0 + 1, fy)):
        for ix, wx in ((x0, 1.0 - fx), (x0 + 1, fx)):
            inside = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
            idx = (iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)).reshape(B, N, 1, H * W)
            v = torch.gather(flat, 3, idx.expand(B, N, C, H * W)).reshape(B, N, C, H, W)
            out = out + (wy * wx * inside.to(wy.dtype))[:, :, None] * v
    out = out * m[:, :, None]
    return (out[:, :, :3],) + tuple(out[:, :, c] for c in range(3, C))


def _check(src, logits, sigma, dx, dy, mask):
    if dx.dim() != 4:
        raise ValueError(f"dx must be (B, N, H, W), got {tuple(dx.shape)}")
    B, N, H, W = dx.shape
    want = {"src": (B, 3, H, W), "logits": (B, N, H, W), "sigma": (B, N, H, W),
            "dx": (B, N, H, W), "dy": (B, N, H, W), "mask": (B, N, H, W)}
    for name, t in zip(want, (src, logits, sigma, dx, dy, mask)):
        if t is None and name == "sigma":
            continue
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, want {want[name]}")
        if t.device != dx.device:
            raise ValueError(f"{name} on {t.device}, dx on {dx.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {t.dtype}, the kernels take float32")
    if N > 65535 or H > 65535:
        raise ValueError(f"(N, H) = ({N}, {H}) exceed the kernels' grid (65535)")
    if (H + 1) * (W + 2) >= 2 ** 31:
        raise ValueError(f"an ({H}, {W}) plane exceeds the backward's 32-bit offsets")
    if src.requires_grad or mask.requires_grad:
        raise NotImplementedError("warp2d: the kernels take no gradient through "
                                  "src or mask")


class _Warp2d(torch.autograd.Function):
    """The two CUDA kernels joined as forward and backward; ``sigma=None``
    launches their instances without sigma."""

    @staticmethod
    def forward(ctx, src, logits, sigma, dx, dy, mask):
        B, N, H, W = dx.shape
        with_sigma = sigma is not None
        src, logits, sigma, dx, dy, mask = (
            None if t is None else t.contiguous()
            for t in (src, logits, sigma, dx, dy, mask))
        rgb = torch.empty((B, N, 3, H, W), dtype=torch.float32, device=dx.device)
        logit = torch.empty_like(logits)
        sig = torch.empty_like(sigma) if with_sigma else None
        launch("pdt_warp2d_fwd", src, logits, sigma, dx, dy, mask, rgb, logit, sig,
               B, N, H, W, int(with_sigma))
        if with_sigma:
            warp2d.fwd_launches += 1
        else:
            warp2d.nosigma_fwd_launches += 1
        ctx.save_for_backward(src, logits, sigma, dx, dy, mask)
        ctx.with_sigma = with_sigma
        return (rgb, logit, sig) if with_sigma else (rgb, logit)

    @staticmethod
    def backward(ctx, g_rgb, g_logit, g_sigma=None):
        src, logits, sigma, dx, dy, mask = ctx.saved_tensors
        B, N, H, W = dx.shape
        with_sigma = ctx.with_sigma
        d_logits = torch.zeros_like(logits)
        d_sigma = torch.zeros_like(sigma) if with_sigma else None
        d_dx, d_dy = torch.empty_like(dx), torch.empty_like(dy)
        launch("pdt_warp2d_bwd", src, logits, sigma, dx, dy, mask, g_rgb.contiguous(),
               g_logit.contiguous(), g_sigma.contiguous() if with_sigma else None,
               d_logits, d_sigma, d_dx, d_dy, B, N, H, W, int(with_sigma))
        if with_sigma:
            warp2d.bwd_launches += 1
        else:
            warp2d.nosigma_bwd_launches += 1
        return None, d_logits, d_sigma, d_dx, d_dy, None


def warp2d(src: torch.Tensor, logits: torch.Tensor, sigma: Optional[torch.Tensor],
           dx: torch.Tensor, dy: torch.Tensor, mask: torch.Tensor
           ) -> Tuple[torch.Tensor, ...]:
    """``(rgb, logit, sigma)``, or ``(rgb, logit)`` when ``sigma`` is None,
    as :func:`warp2d_plain`.

    CPU tensors take :func:`warp2d_plain`.  CUDA tensors run the forward
    kernel, and the backward kernel when autograd reaches it, of the mode
    ``sigma`` selects; any other device raises.
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
warp2d.nosigma_fwd_launches = 0
warp2d.nosigma_bwd_launches = 0
