"""Image rows over ranks: the row exchange of the ``spatial`` mesh axis.

The JAX package shards image rows over the mesh's ``spatial`` axis
(``planedepth_tpu/parallel/mesh.py``) and lets GSPMD insert the halo
exchange that every row-coupled op needs; its Pallas kernels are
row-parallel and run on the row shards (``parallel/shard.py``).  Here each
op that reads rows beyond its shard asks for them: :func:`row_halo` gives a
shard the ``top`` rows above it and the ``bottom`` rows below it from the
ranks that own them, however many ranks away (a dilation-24 conv at 1/16
scale reads past its neighbour's rows), and fills the rows beyond the
image's global top and bottom as the op itself pads there (zeros for a
zero-padded conv, the reflection for a reflect pad, ``-inf`` for a
max-pool).  Its backward sends each halo row's cotangent to the rank that
owns the row and adds it there.

The exchange is one all-reduce over the spatial group of a buffer that
holds the halo rows of every rank of the group, each filled by its owner
and zero elsewhere: exact, and on both backends (gloo reduces CUDA tensors
but has no all-gather or point-to-point for them).  16-bit tensors travel
as float32.

:func:`shard_mean` is a rank's share of a mean over the global rows: the
ranks' shares, averaged over the ranks as DDP averages their gradients and
``mean_over_ranks`` their losses, give the mean over the whole image;
:func:`image_mean` is the mean itself, the same on every rank.

The ops that read an image anywhere (the 2-D warp, the 2-D samples of the
oracle view synthesis and of the self-reconstruction) run on the whole
image, as the JAX package's ``shard_kernel`` gathers the 2-D warp's operands
over the ``spatial`` axis (``planedepth_tpu/train/mono.py:302-307``):
:func:`gather_rows` gives every rank of the group the whole image, and
:func:`own_rows` keeps this rank's rows of a whole-image result.
Without a spatial axis every function here is the op on the whole image.
"""
from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from planedepth_tpu_torch.parallel.mesh import (
    current_mesh,
    gather_batch,
    mesh_group,
    sum_over_ranks,
)

EDGES = {"zero": 0.0, "-inf": float("-inf"), "reflect": None}


def spatial() -> Tuple[int, int]:
    """``(spatial rank, S)`` of this process; ``(0, 1)`` without the axis."""
    mesh = current_mesh()
    return mesh.spatial_rank, mesh.spatial_size


def sharded() -> bool:
    """True where this process holds a row shard of every image."""
    return current_mesh().spatial_size > 1


def global_height(rows: int) -> int:
    """The image's rows, from a shard's ``rows``."""
    return rows * current_mesh().spatial_size


def shard_rows(rows: int) -> slice:
    """The image's rows that this rank holds in a shard of ``rows`` rows."""
    rank = current_mesh().spatial_rank
    return slice(rank * rows, (rank + 1) * rows)


class _Plan(NamedTuple):
    """A row exchange seen from one rank: the buffer rows it fills from
    its own rows (``buf_rows`` <- local ``own_rows``, in layers whose local
    rows are distinct, so the backward's adds are deterministic on the
    card), and where its halo rows come from (``seg_rows`` of the buffer ->
    halo positions ``dest``)."""
    total: int
    buf_rows: Tuple[Tuple[int, ...], ...]
    own_rows: Tuple[Tuple[int, ...], ...]
    seg_rows: Tuple[int, ...]
    dest: Tuple[int, ...]


def _source(p: int, height: int, edge: str) -> Optional[int]:
    """The global row that halo position ``p`` holds: ``p`` inside the
    image, its reflection under ``reflect``, None (a fill) otherwise."""
    if 0 <= p < height:
        return p
    if edge != "reflect":
        return None
    return -p if p < 0 else 2 * (height - 1) - p


@functools.lru_cache(maxsize=None)
def _plan(wants: Tuple[Tuple[Optional[int], ...], ...], rows: int, rank: int) -> _Plan:
    """``wants[t]``: the global rows (None: a fill) of rank t's halo, in
    order; each rank holds ``rows`` rows."""
    total, pairs, seg_rows, dest = 0, [], [], []
    for t, want in enumerate(wants):
        for j, q in enumerate(want):
            if q is None:
                continue
            if q // rows == rank:
                pairs.append((total, q - rank * rows))
            if t == rank:
                seg_rows.append(total)
                dest.append(j)
            total += 1
    layers: List[List[Tuple[int, int]]] = []
    for pair in pairs:
        layer = next((la for la in layers if all(pair[1] != o for _, o in la)), None)
        if layer is None:
            layer = []
            layers.append(layer)
        layer.append(pair)
    return _Plan(total, tuple(tuple(b for b, _ in la) for la in layers),
                 tuple(tuple(o for _, o in la) for la in layers), tuple(seg_rows), tuple(dest))


def _wire(t: torch.Tensor) -> torch.dtype:
    return torch.float32 if t.dtype in (torch.bfloat16, torch.float16) else t.dtype


@functools.lru_cache(maxsize=None)
def _index(values: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    # made once per plan and device (a copy from pageable host memory would
    # wait for the card's queue at every exchange), as a normal tensor even
    # when first asked for under inference mode
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=torch.long, device=device)


def _exchange(x: torch.Tensor, plan: _Plan, n_rows: int, fill: float) -> torch.Tensor:
    """This rank's ``n_rows`` halo rows of ``x`` (rows on dim -2)."""
    dim = x.dim() - 2
    shape = x.shape[:-2] + (plan.total, x.shape[-1])
    buf = torch.zeros(shape, dtype=_wire(x), device=x.device)
    for b, o in zip(plan.buf_rows, plan.own_rows):
        buf.index_copy_(dim, _index(b, x.device),
                        x.index_select(dim, _index(o, x.device)).to(buf.dtype))
    if plan.total:                      # the same on every rank of the group
        dist.all_reduce(buf, group=mesh_group("spatial"))
    out = x.new_full(x.shape[:-2] + (n_rows, x.shape[-1]), fill)
    if plan.dest:
        out.index_copy_(dim, _index(plan.dest, x.device),
                        buf.index_select(dim, _index(plan.seg_rows, x.device)).to(x.dtype))
    return out


def _send_back(g: torch.Tensor, gx: torch.Tensor, plan: _Plan) -> torch.Tensor:
    """Adds the cotangents ``g`` of this rank's halo rows, and those the
    other ranks send, into ``gx`` at the rows this rank owns."""
    dim = gx.dim() - 2
    buf = torch.zeros(gx.shape[:-2] + (plan.total, gx.shape[-1]), dtype=_wire(gx),
                      device=gx.device)
    if plan.dest:
        buf.index_copy_(dim, _index(plan.seg_rows, gx.device),
                        g.index_select(dim, _index(plan.dest, gx.device)).to(buf.dtype))
    if plan.total:
        dist.all_reduce(buf, group=mesh_group("spatial"))
    for b, o in zip(plan.buf_rows, plan.own_rows):
        gx.index_add_(dim, _index(o, gx.device),
                      buf.index_select(dim, _index(b, gx.device)).to(gx.dtype))
    return gx


def _halo_wants(rows: int, size: int, top: int, bottom: int, edge: str):
    height = rows * size
    if edge == "reflect" and max(top, bottom) >= height:
        raise ValueError(f"a reflect pad of {max(top, bottom)} rows needs more than "
                         f"{height} rows")
    return tuple(tuple(_source(p, height, edge)
                       for p in [*range(t * rows - top, t * rows),
                                 *range((t + 1) * rows, (t + 1) * rows + bottom)])
                 for t in range(size))


class _RowHalo(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, top, bottom, edge):
        rank, size = spatial()
        rows = x.shape[-2]
        plan = _plan(_halo_wants(rows, size, top, bottom, edge), rows, rank)
        halo = _exchange(x, plan, top + bottom, EDGES[edge] or 0.0)
        ctx.plan, ctx.top, ctx.rows = plan, top, rows
        return torch.cat([halo.narrow(-2, 0, top), x, halo.narrow(-2, top, bottom)], -2)

    @staticmethod
    def backward(ctx, g):
        top, rows = ctx.top, ctx.rows
        halo = torch.cat([g.narrow(-2, 0, top), g.narrow(-2, top + rows, g.shape[-2] - top - rows)],
                         -2)
        gx = _send_back(halo, g.narrow(-2, top, rows).clone(memory_format=torch.contiguous_format),
                        ctx.plan)
        return gx, None, None, None


def row_halo(x: torch.Tensor, top: int, bottom: int, edge: str = "zero") -> torch.Tensor:
    """``x`` (rows on dim -2) with ``top`` rows above it and ``bottom``
    below: the neighbouring shards' rows, and beyond the image's top and
    bottom the op's own pad, ``edge``: ``"zero"``, ``"reflect"`` (as
    ``F.pad(mode="reflect")``) or ``"-inf"``.  Differentiable; a collective
    over the spatial group, which every rank of it calls alike.  Without a
    spatial axis it is that pad."""
    if edge not in EDGES:
        raise ValueError(f"unknown edge {edge!r}")
    if top == 0 and bottom == 0:
        return x
    if not sharded():
        if edge == "reflect":
            return F.pad(x, (0, 0, top, bottom), mode="reflect")
        return F.pad(x, (0, 0, top, bottom), value=EDGES[edge])
    return _RowHalo.apply(x.contiguous(), top, bottom, edge)


def global_rows(x: torch.Tensor, rows: Sequence[int]) -> torch.Tensor:
    """The image's global ``rows`` of ``x`` (rows on dim -2; negative
    indices from the bottom) on every rank of the spatial group; on row
    shards without a gradient."""
    if not sharded():
        return torch.stack([x[..., r, :] for r in rows], -2)
    rank, size = spatial()
    height = global_height(x.shape[-2])
    want = tuple(r % height for r in rows)
    with torch.no_grad():
        return _exchange(x, _plan((want,) * size, x.shape[-2], rank), len(want), 0.0)


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The whole image of the row shards ``x`` (rows on dim -2) on every
    rank of the spatial group (``parallel/mesh.py:gather_batch``, 16-bit
    tensors as float32), differentiably: the backward sums the group's
    cotangents of the whole image and gives each rank those of its rows.  A
    collective over the group.  Without a spatial axis ``x`` itself."""
    if not sharded():
        return x
    return gather_batch(x.to(_wire(x)), mesh_group("spatial"), dim=-2).to(x.dtype)


def own_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of the whole-image ``x`` (rows on dim -2), in a
    tensor of their own (a view would keep the whole image alive);
    without a spatial axis ``x`` itself."""
    if not sharded():
        return x
    return x[..., shard_rows(x.shape[-2] // current_mesh().spatial_size), :].contiguous()


def image_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over its rows and columns (the last two dims):
    on row shards the image's, the same on every rank of the spatial
    group (the shards' sums added over it, over the global count), not a
    rank's share."""
    if not sharded():
        return t.mean(dim=(-2, -1))
    return spatial_sum(t.sum(dim=(-2, -1))) / (global_height(t.shape[-2]) * t.shape[-1])


def spatial_sum(t: torch.Tensor) -> torch.Tensor:
    """The differentiable sum of ``t`` over the spatial group."""
    return sum_over_ranks(t, mesh_group("spatial")) if sharded() else t


def shard_mean(t: torch.Tensor, rows: Optional[int] = None) -> torch.Tensor:
    """This rank's share of the mean of ``t`` (rows on dim -2) over the
    image's ``rows`` global rows (default: the image's, ``S`` times the
    shard's): ``S sum(t) / count``, whose average over the spatial group is
    the mean.  A shard's own mean where the rows split evenly; a term
    whose global row count is not the sum of the shards' (the row
    differences of the smoothness, ``H - 1`` rows) needs ``rows``."""
    _, size = spatial()
    if rows is None:
        return t.mean()
    return t.sum() * (size * t.shape[-2] / (t.numel() * rows))
