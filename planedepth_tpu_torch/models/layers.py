"""Network building blocks, NCHW (``planedepth_tpu/models/layers.py`` and ``ops/resize.py``).

The ResNet decoder's blocks name their modules after the reference torch
code, so a reference ``state_dict`` loads as it is: ``Conv3x3.conv``,
``ConvBlock.conv.conv``.  The PladeNet/FalNet blocks (``ConvELU``,
``ResidualBlock``, ``Deconv``, ``EpConv``) name theirs after the JAX modules
(``conv``, ``norm``, ``conv1``, ``conv2``, ``conv0``), the names
``utils/weights.py`` maps.

Every block takes a ``dtype``, as the JAX package's flax modules do: None
computes in the input's dtype (float32), ``torch.bfloat16`` in bf16 (the
JAX package's default, ``TrainConfig.bf16``).  The parameters stay float32
and are cast where they are used (:class:`Conv2d`), so Adam updates float32
weights.  BatchNorm (:class:`BatchNorm2d`) keeps its statistics and
normalises in float32 on a bf16 input, and rounds its output to bf16, as
flax's ``BatchNorm(dtype=bf16)``; on running statistics it normalises in
flax's order.  Elementwise work runs op by op in the tensor's dtype, with its
constants in that dtype (:func:`scalar`), which is where XLA rounds the JAX
package's bf16 arithmetic.  ``torch.autocast`` is not used: its op lists
differ between the CPU and CUDA and from flax's rounding points.

On row shards (a spatial mesh axis, ``parallel/halo.py``) the ops that
read rows beyond their shard (:class:`Conv2d`, :class:`Conv3x3`,
:func:`max_pool_3x3_s2`, :func:`resize_bilinear_align_corners`,
:class:`GlobalAvgPool2d`) take them from the other ranks; the rest are
row-local (``upsample2x_nearest`` once the shards align).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from planedepth_tpu_torch.parallel.halo import (
    global_height,
    image_mean,
    row_halo,
    sharded,
    spatial,
)
from planedepth_tpu_torch.parallel.mesh import global_moments, world


_recompute = threading.local()


@contextlib.contextmanager
def _recomputing():
    depth = getattr(_recompute, "depth", 0)
    _recompute.depth = depth + 1
    try:
        yield
    finally:
        _recompute.depth = depth


def recomputing() -> bool:
    """True inside a :func:`remat` segment's recompute in the backward pass."""
    return getattr(_recompute, "depth", 0) > 0


def remat(fn, *args):
    """``fn(*args)`` with its activations recomputed in the backward pass
    instead of kept (flax ``nn.remat`` / ``jax.checkpoint``): the
    non-reentrant ``torch.utils.checkpoint``, which DDP's unused-parameter
    search and a nested checkpoint take, the RNG state replayed.  The
    recompute is marked (:func:`recomputing`), so that :class:`BatchNorm2d`
    normalises as the forward did and updates its statistics only once, as
    flax keeps the forward's update."""
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(), _recomputing()))


def upcast(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A bf16 (or fp16) tensor in float32, any other as it is: the JAX
    package's ``astype(jnp.float32)`` where a float64 run stays float64."""
    if x is not None and x.dtype in (torch.bfloat16, torch.float16):
        return x.float()
    return x


def to_dtype(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``x`` cast to ``dtype``; None leaves it as it is (flax ``dtype=None``)."""
    return x if dtype is None else x.to(dtype)


def scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-d tensor of ``like``'s dtype: a Python float beside a
    bf16 tensor would enter PyTorch's float32 arithmetic unrounded, where
    JAX rounds it to bf16 first."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour x2 upsample, ``(B, C, H, W) -> (B, C, 2H, 2W)``."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def resize_bilinear_align_corners(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Bilinear resize to ``size=(Ho, Wo)`` with ``align_corners=True``.  On
    row shards ``Ho`` is the shard's: output row ``i`` samples the global
    source row ``i (H_in - 1) / (H_out - 1)`` of the whole image, so the
    shard takes the source rows it reaches from its neighbours, resizes the
    columns, then blends the two source rows of each output row with
    ``F.interpolate``'s weights (in its arithmetic: float32, float64 for
    a float64 input)."""
    if not sharded():
        return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=True)
    rank, n_ranks = spatial()
    rows, out_rows = x.shape[-2], size[0]
    h_in, h_out = global_height(rows), global_height(out_rows)
    wide = torch.float64 if x.dtype == torch.float64 else torch.float32
    scale = torch.tensor(h_in - 1, dtype=wide) / (h_out - 1)
    pos = scale * torch.arange(h_out, dtype=wide)
    i0 = pos.long()
    i1 = torch.clamp_max(i0 + 1, h_in - 1)
    # the halo is a collective: the widest any shard needs, on every rank
    top = max(max(0, t * rows - int(i0[t * out_rows])) for t in range(n_ranks))
    bottom = max(max(0, int(i1[(t + 1) * out_rows - 1]) + 1 - (t + 1) * rows)
                 for t in range(n_ranks))
    mine = slice(rank * out_rows, (rank + 1) * out_rows)
    pos, i0, i1 = pos[mine], i0[mine], i1[mine]
    lam = (pos - i0)[:, None].to(x.device)
    ext = upcast(row_halo(x, top, bottom))
    ext = F.interpolate(ext, size=(ext.shape[-2], size[1]), mode="bilinear", align_corners=True)
    start = rank * rows - top
    a, b = (ext[..., (i - start).to(x.device), :] for i in (i0, i1))
    return ((1.0 - lam) * a + lam * b).to(x.dtype)


def resize_nearest(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Nearest resize to ``size=(Ho, Wo)``: source index ``floor(dst * in /
    out)`` on each axis, torch's ``mode="nearest"`` rule, at any ratio (a
    stride-2 stage maps 5 columns to 3, its deconv 3 back to 5)."""
    if tuple(size) == tuple(x.shape[-2:]):
        return x
    return F.interpolate(x, size=tuple(size), mode="nearest")


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``dtype`` (flax ``nn.Conv(dtype=...)``): the
    input, the weight and the bias are cast at use, the parameters stay
    float32.  In a set dtype the bias is added after the convolution, in
    that dtype, where flax adds it; None is ``nn.Conv2d`` as it is.

    On row shards a conv that reads beyond its rows takes them from the
    neighbouring shards (``parallel/halo.py:row_halo``), its zero pad at the
    image's top and bottom only: ``pad`` rows above, ``d (k - 1) - pad -
    stride + 1`` below (a stride-2 conv's shard starts on an even row, so
    it reads one row fewer below than above)."""

    def __init__(self, *args, dtype: Optional[torch.dtype] = None, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = dtype

    def forward(self, x):
        if not sharded():
            return self._plain_forward(x, self.padding)
        (k, _), (stride, _), (dil, _) = self.kernel_size, self.stride, self.dilation
        pad, pad_w = self.padding
        x = row_halo(to_dtype(x, self.compute_dtype), pad,
                     max(0, dil * (k - 1) - pad - stride + 1))
        return self._plain_forward(x, (0, pad_w))

    def _plain_forward(self, x, padding):
        """The convolution of ``x`` as it stands, zero-padded by ``padding``
        (rows, columns)."""
        dt = self.compute_dtype
        if dt is None:
            return F.conv2d(x, self.weight, self.bias, self.stride, padding, self.dilation,
                            self.groups)
        y = F.conv2d(x.to(dt), self.weight.to(dt), None, self.stride, padding, self.dilation,
                     self.groups)
        return y if self.bias is None else y + self.bias.to(dt)[:, None, None]


class GlobalAvgPool2d(nn.AdaptiveAvgPool2d):
    """``nn.AdaptiveAvgPool2d(1)``; on row shards the mean over the whole
    image: the shards' sums added over the spatial group (in float32),
    over the global count."""

    def __init__(self):
        super().__init__(1)

    def forward(self, x):
        if not sharded():
            return super().forward(x)
        return image_mean(upcast(x))[..., None, None].to(x.dtype)


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """``F.max_pool2d(x, 3, 2, padding=1)`` (the ResNet stem's pool, -inf
    pad); on row shards the row above from the shard above, -inf above the
    image's top (a shard starts on an even row: none below)."""
    if not sharded():
        return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
    return F.max_pool2d(row_halo(x, 1, 0, "-inf"), kernel_size=3, stride=2, padding=(0, 1))


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` that, on running statistics and a bf16 (or fp16)
    input, normalises in flax's order: ``(x - mean) * (scale * rsqrt(var +
    eps)) + bias`` in float32, rounded once to the input's dtype, on every
    device.  torch's CPU kernel folds the mean into the bias, ``x * a +
    (bias - mean * a)``, which cancels where the mean is large beside the
    spread and so rounds elsewhere.  Training in a process group of more
    than one rank normalises by the global batch's moments
    (``parallel/mesh.py:global_moments``) in the same order, and updates the
    running variance with the global count's n / (n - 1).  Other training
    and float32 inputs take ``nn.BatchNorm2d``.

    In a :func:`remat` segment's recompute, training normalises by the
    batch's moments as the forward did, bit for bit (the same call, on
    copies of the running statistics), and updates neither the statistics
    nor ``num_batches_tracked``: the forward pass updated them once."""

    def forward(self, x):
        if self.training and world()[1] > 1:
            return self._global_batch_forward(x)
        if self.training and recomputing():
            return F.batch_norm(x, self.running_mean.clone(), self.running_var.clone(),
                                self.weight, self.bias, True,
                                self.momentum or 0.0, self.eps)
        if self.training or x.dtype not in (torch.bfloat16, torch.float16):
            return super().forward(x)
        view = lambda t: t[:, None, None]      # noqa: E731
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        # x - mean promotes to float32 in one pass, as flax upcasts x
        return torch.addcmul(view(self.bias), x - view(self.running_mean),
                             view(mul)).to(x.dtype)

    def _global_batch_forward(self, x):
        view = lambda t: t[:, None, None]      # noqa: E731
        wide = upcast(x)
        mean, var, n = global_moments(wide)
        if not recomputing():
            self._update_statistics(mean, var, n)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return torch.addcmul(view(self.bias), wide - view(mean), view(mul)).to(x.dtype)

    @torch.no_grad()
    def _update_statistics(self, mean, var, n):
        m = self.momentum
        self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
        self.running_var.mul_(1.0 - m).add_(var * (n / (n - 1)), alpha=m)
        self.num_batches_tracked.add_(1)


class Conv3x3(nn.Module):
    """Reflection pad, then a VALID 3x3 conv (reference layers.py:110-125);
    on row shards the rows from the neighbouring shards, reflected at the
    image's top and bottom only."""

    def __init__(self, in_ch: int, out_ch: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, 3, dtype=dtype)

    def forward(self, x):
        x = to_dtype(x, self.conv.compute_dtype)
        if not sharded():
            return self.conv(F.pad(x, (1, 1, 1, 1), mode="reflect"))
        x = F.pad(row_halo(x, 1, 1, "reflect"), (1, 1, 0, 0), mode="reflect")
        return self.conv._plain_forward(x, self.conv.padding)


class ConvBlock(nn.Module):
    """Conv3x3 + ELU (reference layers.py:95-107)."""

    def __init__(self, in_ch: int, out_ch: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = Conv3x3(in_ch, out_ch, dtype)

    def forward(self, x):
        return F.elu(self.conv(x))


def ep_conv(num_ep: int, dtype: Optional[torch.dtype] = None) -> nn.Sequential:
    """Neural positional encoding: 1x1 2->16 ELU -> 1x1 16->num_ep ELU
    (reference depth_decoder.py:66-71; parameters at ``0.*`` and ``2.*``)."""
    return nn.Sequential(Conv2d(2, 16, 1, dtype=dtype), nn.ELU(),
                         Conv2d(16, num_ep, 1, dtype=dtype), nn.ELU())


def frequency_embed(grid: torch.Tensor, num_ep: int) -> torch.Tensor:
    """NeRF-style frequency embedding of the 2-channel ``(B, 2, H, W)`` grid:
    ``[grid, sin/cos(grid * 2^k) for k < (num_ep//2 - 1)//2]`` on channels."""
    multires = (num_ep // 2 - 1) // 2
    outs = [grid]
    for k in range(multires):
        freq = 2.0 ** k
        outs.append(torch.sin(grid * freq))
        outs.append(torch.cos(grid * freq))
    return torch.cat(outs, dim=1)


def inject_grid(x: torch.Tensor, grid_ep: Optional[torch.Tensor]) -> torch.Tensor:
    """Resize the positional-encoding feature to x's size and concatenate it
    on channels (reference depth_decoder.py:128-139)."""
    if grid_ep is None:
        return x
    g = resize_bilinear_align_corners(grid_ep, x.shape[-2:])
    return torch.cat([x, g.to(x.dtype)], dim=1)


class ConvELU(nn.Module):
    """Conv, then ELU: the PladeNet/FalNet stage conv (reference
    plade_net.py:33-46, JAX ``layers.py:ConvELU``).  With ``batch_norm`` the
    conv is bias-free and a :class:`BatchNorm2d` named ``norm`` (torch
    momentum 0.1, eps 1e-5) sits between the conv and the ELU, as in the
    JAX module (``norm/bn``); only ``PladePoseNet`` builds it."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, stride: int = 1,
                 pad: int = 1, batch_norm: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, kernel_size, stride=stride, padding=pad,
                           bias=not batch_norm, dtype=dtype)
        self.norm = BatchNorm2d(out_ch, eps=1e-5, momentum=0.1) if batch_norm else None

    def forward(self, x):
        x = self.conv(x)
        return F.elu(x if self.norm is None else self.norm(x))


class EpConv(nn.Module):
    """Neural positional encoding in the JAX module's names (``conv0``,
    ``conv1``; JAX ``layers.py:EpConv``): 1x1 2->16 ELU -> 1x1 16->num_ep
    ELU, the layers of :func:`ep_conv`."""

    def __init__(self, num_ep: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv0 = Conv2d(2, 16, 1, dtype=dtype)
        self.conv1 = Conv2d(16, num_ep, 1, dtype=dtype)

    def forward(self, grid):
        return F.elu(self.conv1(F.elu(self.conv0(grid))))


class ResidualBlock(nn.Module):
    """Two bias-free 3x3 convs, ``elu(conv2(elu(conv1(x))) + x)`` (reference
    plade_net.py:61-72)."""

    def __init__(self, ch: int, kernel_size: int = 3, dtype: Optional[torch.dtype] = None):
        super().__init__()
        p = (kernel_size - 1) // 2
        self.conv1 = Conv2d(ch, ch, kernel_size, padding=p, bias=False, dtype=dtype)
        self.conv2 = Conv2d(ch, ch, kernel_size, padding=p, bias=False, dtype=dtype)

    def forward(self, x):
        x = to_dtype(x, self.conv1.compute_dtype)
        return F.elu(self.conv2(F.elu(self.conv1(x))) + x)


class Deconv(nn.Module):
    """Nearest resize to a reference size, a bias-free 3x3 conv, ELU
    (reference plade_net.py:49-58)."""

    def __init__(self, in_ch: int, out_ch: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = Conv2d(in_ch, out_ch, 3, padding=1, bias=False, dtype=dtype)

    def forward(self, x, size: Sequence[int]):
        return F.elu(self.conv1(resize_nearest(x, size)))
