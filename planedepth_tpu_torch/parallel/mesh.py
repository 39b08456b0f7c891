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
means over ranks count on it, as the JAX mesh's even sharding does.  Image
rows over cards (a ``spatial`` mesh axis) are not ported (:func:`make_mesh`).
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, Iterator, Mapping, Optional, Sequence, Tuple

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


def make_mesh(spatial: int = 1) -> Tuple[int, int]:
    """The data axis, ``(rank, size)`` (JAX ``make_mesh``).  A spatial axis
    (image rows over cards, with the convolutions' halo exchange) is not
    ported: the stage-3 volume fits one 80 GB card."""
    if spatial > 1:
        raise NotImplementedError(
            "a spatial mesh axis (image rows over cards) is not ported: ROADMAP A6b")
    return world()


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
    current stream (``train/step.py:batch_to_tensors``).  On the card each
    array goes through pinned memory and a ``non_blocking`` copy; the
    transpose runs on the device."""
    out = {}
    device = torch.device(device)
    pin = device.type == "cuda"
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        t = t.pin_memory().to(device, non_blocking=True) if pin else t.to(device)
        out[k] = t.permute(0, 3, 1, 2).contiguous() if t.dim() == 4 else t
    return out


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
    """The sum of a tensor over the ranks; its backward sums the cotangents
    over the ranks too (each rank's output feeds every rank's loss)."""

    @staticmethod
    def forward(ctx, t):
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t)
        return t

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad)
        return grad


def gather_batch(t: torch.Tensor) -> torch.Tensor:
    """The global batch of ``t`` on every rank, the ranks' rows in rank
    order, differentiably: each rank's rows in a zero block, summed over the
    ranks (exact; gloo has no all-gather of CUDA tensors)."""
    rank, size = world()
    if size == 1:
        return t
    zeros = torch.zeros_like(t)
    return _SumOverRanks.apply(torch.cat([t if r == rank else zeros for r in range(size)]))


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
