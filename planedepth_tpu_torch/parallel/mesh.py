"""Data parallelism over ranks (``planedepth_tpu/parallel/mesh.py``; reference trainer.py:50-99).

The JAX package lays the batch over a 1-D ``data`` mesh and lets XLA insert
the gradient, BatchNorm and metric all-reduces.  Here each rank is one
process, as the reference's ``torchrun --nproc_per_node=N`` runs it:

  * :func:`init_distributed` joins the launcher's process group (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``; NCCL when every local rank has a card
    of its own, gloo where local ranks share one or tensors stay on the
    CPU) and :func:`world` is ``(rank, size)``, ``(0, 1)`` without a group;
  * :func:`shard_batch` sends this rank's slice of the global batch (the
    sampler's host sharding, ``data/loader.py``) to its device from pinned
    memory, and :func:`prefetch_to_device` overlaps the next batch's copy
    with the current step on a side stream (JAX ``trainer.py:_device_prefetch``);
  * :func:`ddp_wrap` is ``jit_train_step``'s counterpart: DDP averages the
    gradients; ``models/layers.py:BatchNorm2d`` normalises by the global
    batch's moments (:func:`global_moments`), as flax does under a mesh and
    SyncBatchNorm in the reference; :func:`mean_over_ranks` and
    :func:`gather_batch` give every rank the global losses and the global
    validation batch.

Every rank holds an equal share of the global batch: the moments and the
means over ranks count on it, as the JAX mesh's even sharding does.

:func:`make_mesh` lays the ranks out as the JAX mesh lays its devices, a
``(data, spatial)`` grid with rank ``r = d S + s``: the ``S`` ranks of a
data rank ``d`` share its samples, rank ``s`` holding rows ``[s H / S, (s +
1) H / S)`` of every image (:func:`shard_batch`), and the row-coupled ops
exchange their halos over the spatial group (``parallel/halo.py``).  Unlike
GSPMD, which pads an uneven split, the port refuses one: ``H`` must be a
multiple of ``s S``, ``s`` the network's total stride (32 for the ResNet
encoders, 64 for FalNet and PladeNet), so that every scale of the network
splits into equal shards.
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, Iterator, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn


def distributed() -> bool:
    """True inside an initialised process group."""
    return dist.is_available() and dist.is_initialized()


def world() -> Tuple[int, int]:
    """``(rank, size)`` of the data-parallel group; a single process is ``(0, 1)``."""
    if distributed():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh(NamedTuple):
    """This rank's place in the ``(data, spatial)`` grid of ranks."""
    data_rank: int
    data_size: int
    spatial_rank: int
    spatial_size: int


# the mesh of this process's group (make_mesh), with its subgroups: the
# process group is process state, and so is its layout
_MESH: Dict[str, object] = {}


def make_mesh(spatial: int = 1, data: Optional[int] = None,
              height: Optional[int] = None, stride: int = 32) -> Mesh:
    """This rank's ``(data_rank, D, spatial_rank, S)`` on a ``D x S`` grid
    of the group's ranks (JAX ``make_mesh``: ``devices.reshape(len //
    spatial, spatial)``, so rank ``r = d S + s``), and the subgroups that the
    row exchange and the validation gathers take: the ``S`` ranks of each
    data rank (the spatial group) and the ``D`` ranks of each spatial rank
    (the data group).  ``data`` defaults to ``world size / S``.  Every rank
    of the group calls it (building a subgroup is a collective).

    Raises ``ValueError`` where ``D S`` is not the launcher's world size, or
    where ``height`` (the images' rows) is not a multiple of ``stride S``:
    each of the network's stride-2 stages (five in the ResNet encoders, for
    a ``stride`` of 32; six in FalNet and PladeNet, 64) halves the rows,
    and every scale must split into equal shards.  GSPMD pads an uneven
    split; the port refuses it."""
    if spatial > 1 and height is not None:
        _check_rows(height, spatial, stride)
    rank, size = world()
    if data is None:
        data = size // spatial
    if data * spatial != size:
        raise ValueError(f"mesh_shape ({data}, {spatial}) needs D x S = {data * spatial} "
                         f"ranks: D x S must equal the launcher's world size, {size}")
    mesh = Mesh(rank // spatial, data, rank % spatial, spatial)
    if _MESH.get("mesh") != mesh or _MESH.get("group") is not _default_group():
        groups = {"mesh": mesh, "group": _default_group(), "spatial": None, "data": None}
        if spatial > 1:
            for d in range(data):             # every rank builds every subgroup
                g = dist.new_group(list(range(d * spatial, (d + 1) * spatial)))
                if d == mesh.data_rank:
                    groups["spatial"] = g
            for s in range(spatial):
                g = dist.new_group(list(range(s, size, spatial)))
                if s == mesh.spatial_rank:
                    groups["data"] = g
        _MESH.clear()
        _MESH.update(groups)
    return mesh


def _default_group():
    return dist.group.WORLD if distributed() else None


def current_mesh() -> Mesh:
    """The mesh :func:`make_mesh` built for this process's group, else the
    group's ranks on the data axis alone."""
    if _MESH and _MESH["group"] is _default_group():
        return _MESH["mesh"]
    rank, size = world()
    return Mesh(rank, size, 0, 1)


def mesh_group(axis: str):
    """The process group of this rank's ``"spatial"`` or ``"data"`` axis
    (None: the whole group, where the other axis has one rank)."""
    return _MESH.get(axis) if current_mesh().spatial_size > 1 else None


def launcher_env() -> Optional[Dict[str, int]]:
    """``rank``, ``size``, ``local_rank`` and ``local_size`` from the
    launcher's environment (``torch.distributed.run`` sets them), or None
    where it names no world."""
    if "WORLD_SIZE" not in os.environ:
        return None
    size = int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    return {"rank": int(os.environ.get("RANK", "0")), "size": size,
            "local_rank": local_rank,
            "local_size": int(os.environ.get("LOCAL_WORLD_SIZE", str(size)))}


def default_device() -> torch.device:
    """The card of this rank: ``cuda:LOCAL_RANK`` under a launcher, else
    the current card."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device=torch.device('cpu') "
                           "to run on the CPU")
    env = launcher_env()
    return torch.device("cuda", env["local_rank"]) if env else torch.device("cuda")


def choose_backend(device: torch.device, local_size: int) -> str:
    """NCCL where each local rank has a card of its own; gloo where local
    ranks share a card (NCCL refuses two ranks on one device) and for CPU
    tensors.  The tensors stay on ``device`` either way."""
    if device.type == "cuda" and local_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_distributed(device: Optional[torch.device] = None,
                     init_method: str = "env://") -> bool:
    """Join the process group the launcher's environment names (the
    reference's ``init_process_group``, trainer.py:50-53) and print the
    backend.  Returns False, and does nothing, where the environment names
    no world or a group exists already."""
    env = launcher_env()
    if env is None or distributed():
        return False
    device = torch.device(device) if device is not None else default_device()
    backend = choose_backend(device, env["local_size"])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    print(f"[parallel] rank {env['rank']} of {env['size']} (local {env['local_rank']} of "
          f"{env['local_size']}) on {device}: backend {backend}", flush=True)
    dist.init_process_group(backend, init_method=init_method, rank=env["rank"],
                            world_size=env["size"])
    return True


def shard_batch(batch: Mapping[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """This rank's NHWC numpy batch as NCHW tensors on ``device``, on the
    current stream (``train/step.py:batch_to_tensors``).  On a spatial mesh
    axis each image array (4-D) keeps this rank's rows ``[s H / S, (s + 1) H
    / S)`` and the rest (``K``, ``Rt``, indices) stays whole, as JAX's
    ``shard_batch`` places them.  On the card each array goes through
    pinned memory and a ``non_blocking`` copy; the transpose runs on the
    device."""
    out = {}
    device = torch.device(device)
    pin = device.type == "cuda"
    mesh = current_mesh()
    for k, v in batch.items():
        if mesh.spatial_size > 1 and v.ndim == 4:
            v = v[:, row_block(v.shape[1], mesh)]
        t = torch.from_numpy(np.ascontiguousarray(v))
        t = t.pin_memory().to(device, non_blocking=True) if pin else t.to(device)
        out[k] = t.permute(0, 3, 1, 2).contiguous() if t.dim() == 4 else t
    return out


def row_block(height: int, mesh: Mesh) -> slice:
    """This rank's rows of an image of ``height`` rows on ``mesh``; raises
    ``ValueError`` unless ``height`` is a multiple of ``32 S``."""
    _check_rows(height, mesh.spatial_size)
    h = height // mesh.spatial_size
    return slice(mesh.spatial_rank * h, (mesh.spatial_rank + 1) * h)


def _check_rows(height: int, spatial: int, stride: int = 32) -> None:
    if height % (stride * spatial):
        raise ValueError(f"image rows over {spatial} ranks: the height {height} must be a "
                         f"multiple of {stride} x S = {stride * spatial} "
                         f"(H % {stride}S == 0)")


def prefetch_to_device(batches: Iterable[Mapping[str, np.ndarray]], device: torch.device
                       ) -> Iterator[Tuple[Mapping[str, np.ndarray], Dict[str, torch.Tensor]]]:
    """``(host batch, device batch)`` in the order of ``batches``, one batch
    ahead (JAX ``trainer.py:_device_prefetch``): on the card the next
    batch's copy is issued on a side stream before the current batch is
    handed over; the current stream waits for that batch's copy alone and
    the batch's tensors are recorded on it, so the allocator does not reuse
    their memory while a step reads it.  On the CPU a plain generator."""
    device = torch.device(device)
    if device.type != "cuda":
        for host in batches:
            yield host, shard_batch(host, device)
        return
    side = torch.cuda.Stream(device)
    pending = None

    def handed_over(item):
        host, tensors, copied = item
        current = torch.cuda.current_stream(device)
        current.wait_event(copied)
        for t in tensors.values():
            t.record_stream(current)
        return host, tensors

    for host in batches:
        with torch.cuda.stream(side):
            tensors = shard_batch(host, device)
            copied = torch.cuda.Event()
            copied.record(side)
        if pending is not None:
            yield handed_over(pending)
        pending = (host, tensors, copied)
    if pending is not None:
        yield handed_over(pending)


def replicate_state(modules: Sequence[nn.Module]) -> None:
    """Rank 0's parameters and buffers on every rank (JAX ``replicate_state``)."""
    if world()[1] == 1:
        return
    with torch.no_grad():
        for module in modules:
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, 0)


def ddp_wrap(net: nn.Module) -> nn.Module:
    """``net`` under DDP, the counterpart of JAX ``jit_train_step``: the
    gradients averaged over ranks.  ``find_unused_parameters`` as the
    reference sets it (trainer.py:99): a parameter no rank reaches keeps no
    gradient, as in the single-process step.  ``broadcast_buffers=False``:
    the buffers are equal on every rank by construction (global BatchNorm
    moments), and a buffer broadcast is a collective on every forward of the
    wrapper, which a chief-only forward would hang on."""
    from torch.nn.parallel import DistributedDataParallel

    device = next(net.parameters()).device
    ids = None
    if device.type == "cuda":
        ids = [torch.cuda.current_device() if device.index is None else device.index]
    return DistributedDataParallel(net, device_ids=ids, broadcast_buffers=False,
                                   find_unused_parameters=True)


class _SumOverRanks(torch.autograd.Function):
    """The sum of a tensor over the ranks of ``group`` (None: all); its
    backward sums the cotangents over them too (each rank's output feeds
    every rank's loss)."""

    @staticmethod
    def forward(ctx, t, group=None):
        ctx.group = group
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def sum_over_ranks(t: torch.Tensor, group=None) -> torch.Tensor:
    """The differentiable sum of ``t`` over the ranks of ``group``."""
    return _SumOverRanks.apply(t, group)


def gather_batch(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """The blocks of ``t`` of every rank of ``group`` (None: all) joined
    along ``dim`` in rank order, on every rank, differentiably: each rank's
    block in a zero tensor, summed over the ranks (exact; gloo has no
    all-gather of CUDA tensors)."""
    rank, size = ((dist.get_rank(group), dist.get_world_size(group)) if group is not None
                  else world())
    if size == 1:
        return t
    zeros = torch.zeros_like(t)
    return sum_over_ranks(torch.cat([t if r == rank else zeros for r in range(size)], dim),
                          group)


def gather_global(t: torch.Tensor) -> torch.Tensor:
    """The global batch of the NCHW ``t`` on every rank: the rows of the
    spatial group joined, then the data ranks' samples (validation and the
    eval step's metrics)."""
    if current_mesh().spatial_size == 1:
        return gather_batch(t)
    return gather_batch(gather_batch(t, mesh_group("spatial"), dim=-2), mesh_group("data"))


def global_moments(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Per-channel mean and biased variance of the global batch of the NCHW
    ``x`` (float32 or wider), and the global count.  Each rank's own mean
    and variance (``torch.var_mean``, as one process's BatchNorm computes
    them, without the cancellation of ``E[x^2] - E[x]^2`` where the mean is
    large beside the spread) are gathered in one differentiable all-reduce
    and combined over the equal shares: the mean of the means, and the mean
    of the variances plus the variance of the means."""
    size = world()[1]
    var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
    stats = gather_batch(torch.stack([mean, var])[None])          # (size, 2, C)
    means, variances = stats[:, 0], stats[:, 1]
    mean = means.mean(0)
    return mean, variances.mean(0) + (means - mean).square().mean(0), x.numel() // x.shape[1] * size


def mean_over_ranks(values: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The mean of each scalar over the ranks, in one all-reduce: the
    global batch's value of a mean over equal shares."""
    size = world()[1]
    if size == 1:
        return dict(values)
    keys = list(values)
    stacked = torch.stack([values[k] for k in keys])
    dist.all_reduce(stacked)
    return dict(zip(keys, (stacked / size).unbind()))


def all_ranks(flag: bool, device: torch.device) -> bool:
    """True where ``flag`` holds on every rank (a branch that must be taken
    alike around a collective)."""
    if world()[1] == 1:
        return flag
    t = torch.tensor([int(flag)], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t.item())
