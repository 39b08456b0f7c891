"""Rank processes of the port's data-parallel tests (``tests/test_torch_parallel*.py``).

Each rank is a process of its own started by ``torch.multiprocessing.spawn``;
it imports the port and torch only (no JAX), joins a gloo group through
``parallel/mesh.py:init_distributed`` with the launcher's environment set
as ``torch.distributed.run`` sets it and a ``file://`` rendezvous under the
test's temporary directory (no port to race for between test workers), does
its part on the CPU, and writes what it computed to ``rank<r>.pkl`` there.
A case whose ``cfg.mesh_shape`` names a spatial axis holds its rows of the
images as well (``tests/test_torch_spatial.py``).
"""
import os
import pickle
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from planedepth_tpu_torch.parallel.mesh import current_mesh, init_distributed
from planedepth_tpu_torch.train.state import make_optimizer
from planedepth_tpu_torch.train.step import ModelBundle, batch_to_tensors, make_train_step

CPU = torch.device("cpu")


def start_ranks(target, size, tmp):
    """``target(rank, size, tmp)`` in ``size`` spawned processes, running
    while the caller works on; :func:`collect` waits for them."""
    return mp.spawn(target, args=(size, str(tmp)), nprocs=size, join=False)


def collect(ranks, tmp, timeout=240.0):
    """Each rank's pickled result once every rank has ended, its file
    removed once read.  A rank that raised fails the caller with its
    traceback; ranks still running after ``timeout`` seconds are killed."""
    deadline = time.monotonic() + timeout
    try:
        while not ranks.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks still running after {timeout} s")
    finally:
        for p in ranks.processes:
            if p.is_alive():
                p.kill()
                p.join(10)
    results = []
    for rank in range(len(ranks.processes)):
        path = os.path.join(str(tmp), f"rank{rank}.pkl")
        with open(path, "rb") as f:
            results.append(pickle.load(f))
        os.remove(path)
    return results


def join_group(rank, size, tmp, name="pg"):
    """The rank's environment as the launcher sets it, then the group (its
    rendezvous file ``name`` under ``tmp``)."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(size), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(size))
    torch.set_num_threads(1)
    assert init_distributed(CPU, init_method=f"file://{tmp}/{name}")


def finish(rank, tmp, result):
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def one_step(case, rank, size):
    """One training step of ``case`` (``cfg``, the depth model's ``state``
    and, where given, the pose nets' ``pose_states``, the global numpy
    ``batch``, ``float64`` to step in float64) on this
    rank's share of the batch (its data rank's samples; on a spatial mesh
    axis, ``cfg.mesh_shape``, their rows): its losses as floats, the
    stepped state, the depth model's gradients (None where the step gives
    none) and the pose nets' (``pose_grads``), and each BatchNorm's global
    count n."""
    cfg = case["cfg"]
    bundle = ModelBundle(cfg, CPU)
    bundle.model.load_state_dict(case["state"])
    for name, state in case.get("pose_states", {}).items():
        getattr(bundle, name).load_state_dict(state)
    batch = case["batch"]
    if case.get("float64"):
        for net in bundle.nets().values():
            net.double()
        batch = {k: v.astype(np.float64) if v.dtype == np.float32 else v
                 for k, v in batch.items()}
    if cfg.loss.self_distillation > 0:
        bundle.freeze_teacher()
    if case.get("unused"):
        # a parameter no forward reaches: no gradient, so Adam leaves it
        bundle.model.unused = torch.nn.Parameter(torch.ones(3))
    counts = {}
    for name, mod in bundle.model.named_modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            mod.register_forward_pre_hook(lambda m, a, name=name: counts.__setitem__(
                name, a[0].numel() // a[0].shape[1] * size))
    optimizer, scheduler = make_optimizer(cfg, bundle.parameters(), 10)
    step = make_train_step(bundle, optimizer, scheduler)
    mesh = current_mesh()
    b = len(batch["color_l"]) // mesh.data_size
    batch = {k: v[mesh.data_rank * b:(mesh.data_rank + 1) * b] for k, v in batch.items()}
    losses = step(batch_to_tensors(batch, CPU))
    assert all(isinstance(v, torch.Tensor) and v.dim() == 0 for v in losses.values())
    return {"losses": {k: float(v) for k, v in losses.items()},
            "state": {k: v.clone() for k, v in bundle.model.state_dict().items()},
            "grads": {k: None if p.grad is None else p.grad.clone()
                      for k, p in bundle.model.named_parameters()},
            "pose_grads": {k: p.grad.clone() for k, p in bundle.named_parameters()
                           if not k.startswith("model.") and p.grad is not None},
            "sizes": counts}


def step_rank(rank, size, tmp):
    """Every case of ``cases.pkl``, one step each, in one group."""
    join_group(rank, size, tmp)
    try:
        with open(os.path.join(tmp, "cases.pkl"), "rb") as f:
            cases = pickle.load(f)
        finish(rank, tmp, {name: one_step(case, rank, size) for name, case in cases.items()})
    finally:
        dist.destroy_process_group()
