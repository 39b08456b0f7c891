"""Per-plane row shift of the distillation warps (``planedepth_tpu/ops/pallas_shift.py``).

For each row of plane-first maps ``(B, N, H, W)`` and its shift
``s = clip(shift[b, h, n], -lim, lim)``, ``k = floor(s)``, ``f = s - k``:
``out[b, n, h, x] = (1 - f) * maps[b, n, h, x + k] + f * maps[b, n, h, x + k + 1]``,
zero outside [0, W).  ``lim = round128(pad) - 2`` is the TPU kernel's clip,
on both signs: the self-distillation teacher warps by +disparity and by
-disparity.  Forward only; its callers take no gradient through it.

``row_shift`` launches the CUDA kernel of ``csrc/row_shift.cu`` on CUDA
tensors (``row_shift.launches`` counts the launches) and takes
``row_shift_plain`` on CPU tensors.
"""
from __future__ import annotations

import torch

from planedepth_tpu_torch.ops._build import launch


def shift_limit(pad: int) -> float:
    """The shift clip: the TPU kernel's lane-rounded pad less 2."""
    return float(((pad + 127) // 128) * 128 - 2)


def row_shift_plain(maps: torch.Tensor, shift: torch.Tensor, pad: int) -> torch.Tensor:
    """Plain PyTorch version: the CPU path and the kernel's oracle.

    maps ``(B, N, H, W)``, shift ``(B, H, N)`` in pixels.  Returns
    ``(B, N, H, W)``.
    """
    lim = shift_limit(pad)
    s = shift.transpose(1, 2).clamp(-lim, lim)                        # (B,N,H)
    k = torch.floor(s)
    f = (s - k)[..., None]
    W = maps.shape[-1]
    i0 = torch.arange(W, device=maps.device) + k.long()[..., None]     # (B,N,H,W)
    out = 0.0
    for idx, w in ((i0, 1.0 - f), (i0 + 1, f)):
        valid = (idx >= 0) & (idx < W)
        g = torch.gather(maps, -1, idx.clamp(0, W - 1))
        out = out + torch.where(valid, w * g, torch.zeros_like(g))
    return out


def _check(maps, shift):
    if maps.dim() != 4:
        raise ValueError(f"maps must be (B, N, H, W), got {tuple(maps.shape)}")
    B, N, H, W = maps.shape
    if tuple(shift.shape) != (B, H, N):
        raise ValueError(f"shift: shape {tuple(shift.shape)}, want {(B, H, N)}")
    if shift.device != maps.device:
        raise ValueError(f"shift on {shift.device}, maps on {maps.device}")
    for name, t in (("maps", maps), ("shift", shift)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes float32")
    if W * 4 > 48 * 1024:
        raise ValueError(f"W={W} exceeds the kernel's shared-memory row")
    if B * N * H >= 2 ** 31:
        raise ValueError(f"{B * N * H} rows exceed the kernel's grid")


def row_shift(maps: torch.Tensor, shift: torch.Tensor, pad: int) -> torch.Tensor:
    """Per-plane row shift ``(B, N, H, W)``, as :func:`row_shift_plain`.

    CPU tensors take :func:`row_shift_plain`.  CUDA tensors launch the
    kernel or raise; it has no backward, so inputs that require a gradient
    are refused.  Any other device raises.
    """
    if maps.device.type == "cpu":
        return row_shift_plain(maps, shift, pad)
    if maps.device.type != "cuda":
        raise NotImplementedError(f"row_shift: no kernel for {maps.device}")
    if torch.is_grad_enabled() and (maps.requires_grad or shift.requires_grad):
        raise NotImplementedError("row_shift: the kernel is forward only")
    _check(maps, shift)
    B, N, H, W = maps.shape
    maps, shift = maps.contiguous(), shift.contiguous()
    out = torch.empty_like(maps)
    with torch.cuda.device(maps.device):
        launch("pdt_row_shift_fwd", maps, shift, out, B, N, H, W, shift_limit(pad))
    row_shift.launches += 1
    return out


row_shift.launches = 0
