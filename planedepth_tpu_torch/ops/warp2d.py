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
``nosigma_fwd_launches`` and ``nosigma_bwd_launches`` those without, and
``bf16_*`` the same of the bf16 instances) and takes ``warp2d_plain``,
differentiated by autograd, on CPU tensors.  The gradient reaches the
logits, sigma, dx and dy; ``src`` and ``mask`` get none, as in the JAX
package's VJP (``_w2d_bwd``).  src, logits and sigma are float32 or all
bf16 (the JAX package's default: its stacks and head gradients are then
bf16, every sum float32); dx, dy, mask and their gradients are float32.
The float32 backward adds into d_logits and d_sigma, which the wrapper
zeroes; the bf16 one sums the taps in float32 in a scratch of
:func:`scratch_bytes` (logit and sigma side by side), which its entry point
clears, and rounds them once into the bf16 gradients.  The bf16 forward
packs src into a scratch of :func:`fwd_scratch_bytes` (pixel-interleaved,
8 bytes a pixel, with a zero border), allocated for the call.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from planedepth_tpu_torch.ops._build import launch, load_library


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
    without the last when ``sigma`` is None.  bf16 operands are upcast,
    which is exact, computed in float32, and the stacks rounded to bf16
    (the heads' gradients come back in bf16).
    """
    if logits.dtype == torch.bfloat16:
        up = lambda t: None if t is None else t.float()   # noqa: E731
        out = warp2d_plain(up(src), up(logits), up(sigma), dx, dy, mask)
        return tuple(t.to(logits.dtype) for t in out)
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
    if logits.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"logits: dtype {logits.dtype}, the kernels take float32 or bfloat16")
    want = {"src": (B, 3, H, W), "logits": (B, N, H, W), "sigma": (B, N, H, W),
            "dx": (B, N, H, W), "dy": (B, N, H, W), "mask": (B, N, H, W)}
    for name, t in zip(want, (src, logits, sigma, dx, dy, mask)):
        if t is None and name == "sigma":
            continue
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, want {want[name]}")
        if t.device != dx.device:
            raise ValueError(f"{name} on {t.device}, dx on {dx.device}")
        dtype = torch.float32 if name in ("dx", "dy", "mask") else logits.dtype
        if t.dtype != dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, the kernels take {dtype} here")
    if N > 65535 or H > 65535:
        raise ValueError(f"(N, H) = ({N}, {H}) exceed the kernels' grid (65535)")
    if (H + 2) * (W + 2) >= 2 ** 31:
        raise ValueError(f"an ({H}, {W}) plane exceeds the kernels' 32-bit offsets")
    if src.requires_grad or mask.requires_grad:
        raise NotImplementedError("warp2d: the kernels take no gradient through "
                                  "src or mask")


def _count(direction: str, with_sigma: bool, bf16: bool) -> None:
    name = ("bf16_" if bf16 else "") + ("" if with_sigma else "nosigma_") + direction
    setattr(warp2d, name, getattr(warp2d, name) + 1)


class _Warp2d(torch.autograd.Function):
    """The two CUDA kernels joined as forward and backward; ``sigma=None``
    launches their instances without sigma, bf16 operands their bf16
    instances."""

    @staticmethod
    def forward(ctx, src, logits, sigma, dx, dy, mask):
        B, N, H, W = dx.shape
        with_sigma, bf16 = sigma is not None, logits.dtype == torch.bfloat16
        src, logits, sigma, dx, dy, mask = (
            None if t is None else t.contiguous()
            for t in (src, logits, sigma, dx, dy, mask))
        rgb = torch.empty((B, N, 3, H, W), dtype=logits.dtype, device=dx.device)
        logit = torch.empty_like(logits)
        sig = torch.empty_like(sigma) if with_sigma else None
        if bf16:
            # the entry packs src here, pixel-interleaved
            scratch = torch.empty(fwd_scratch_bytes(B, H, W), dtype=torch.uint8,
                                  device=dx.device)
            launch("pdt_warp2d_fwd_bf16", src, logits, sigma, dx, dy, mask, rgb, logit, sig,
                   scratch, B, N, H, W, int(with_sigma))
        else:
            launch("pdt_warp2d_fwd", src, logits, sigma, dx, dy, mask, rgb, logit, sig,
                   B, N, H, W, int(with_sigma))
        _count("fwd_launches", with_sigma, bf16)
        ctx.save_for_backward(src, logits, sigma, dx, dy, mask)
        ctx.with_sigma = with_sigma
        return (rgb, logit, sig) if with_sigma else (rgb, logit)

    @staticmethod
    def backward(ctx, g_rgb, g_logit, g_sigma=None):
        src, logits, sigma, dx, dy, mask = ctx.saved_tensors
        B, N, H, W = dx.shape
        with_sigma, bf16 = ctx.with_sigma, logits.dtype == torch.bfloat16
        d_dx, d_dy = torch.empty_like(dx), torch.empty_like(dy)
        cts = (g_rgb.contiguous(), g_logit.contiguous(),
               g_sigma.contiguous() if with_sigma else None)
        if bf16:
            # every element written once; the float32 tap sums go to the
            # scratch, which the entry point clears
            d_logits = torch.empty_like(logits)
            d_sigma = torch.empty_like(sigma) if with_sigma else None
            scratch = torch.empty(scratch_bytes(B, N, H, W, with_sigma), dtype=torch.uint8,
                                  device=dx.device)
            launch("pdt_warp2d_bwd_bf16", src, logits, sigma, dx, dy, mask, *cts, d_logits,
                   d_sigma, d_dx, d_dy, scratch, B, N, H, W, int(with_sigma))
        else:
            d_logits = torch.zeros_like(logits)
            d_sigma = torch.zeros_like(sigma) if with_sigma else None
            launch("pdt_warp2d_bwd", src, logits, sigma, dx, dy, mask, *cts, d_logits,
                   d_sigma, d_dx, d_dy, B, N, H, W, int(with_sigma))
        _count("bwd_launches", with_sigma, bf16)
        return None, d_logits, d_sigma, d_dx, d_dy, None


def scratch_bytes(B: int, N: int, H: int, W: int, with_sigma: bool) -> int:
    """Bytes of device scratch the bf16 backward takes: its float32 tap
    sums, logit and sigma side by side (``csrc/warp2d.cu``)."""
    return int(load_library().pdt_warp2d_bwd_bf16_scratch_bytes(B, N, H, W, int(with_sigma)))


def fwd_scratch_bytes(B: int, H: int, W: int) -> int:
    """Bytes of device scratch the bf16 forward takes: src pixel-interleaved,
    8 bytes an entry of a (B, H + 2, W + 2) grid (``csrc/warp2d.cu``)."""
    return int(load_library().pdt_warp2d_fwd_bf16_scratch_bytes(B, H, W))


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
warp2d.bf16_fwd_launches = 0
warp2d.bf16_bwd_launches = 0
warp2d.bf16_nosigma_fwd_launches = 0
warp2d.bf16_nosigma_bwd_launches = 0
