"""Rank processes of the port's data-parallel tests (``tests/test_torch_parallel*.py``).

Each rank is a process of its own started by ``torch.multiprocessing.spawn``;
it imports the port and torch only (no JAX), joins a gloo group through
``parallel/mesh.py:init_distributed`` with the launcher's environment set
as ``torch.distributed.run`` sets it and a ``file://`` rendezvous under the
test's temporary directory (no port to race for between test workers), does
its part on the CPU, and writes what it computed to ``rank<r>.pkl`` there.
"""
import os
import pickle
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from planedepth_tpu_torch.parallel.mesh import init_distributed
from planedepth_tpu_torch.train.state import make_optimizer
from planedepth_tpu_torch.train.step import ModelBundle, batch_to_tensors, make_train_step

CPU = torch.device("cpu")


def start_ranks(target, size, tmp):
    """``target(rank, size, tmp)`` in ``size`` spawned processes, running
    while the caller works on; :func:`collect` waits for them."""
    return mp.spawn(target, args=(size, str(tmp)), nprocs=size, join=False)


def collect(ranks, tmp, timeout=240.0):
    """Each rank's pickled result once every rank has ended.  A rank that
    raised fails the caller with its traceback; ranks still running after
    ``timeout`` seconds are killed."""
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
        with open(os.path.join(str(tmp), f"rank{rank}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def join_group(rank, size, tmp):
    """The rank's environment as the launcher sets it, then the group."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(size), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(size))
    torch.set_num_threads(1)
    assert init_distributed(CPU, init_method=f"file://{tmp}/pg")


def finish(rank, tmp, result):
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def one_step(case, rank, size):
    """One training step of ``case`` (``cfg``, the depth model's ``state``,
    the global numpy ``batch``) on this rank's rows of the batch: its
    losses as floats, the stepped state, the parameters' gradients (None
    where the step gives none) and each BatchNorm's global count n."""
    cfg = case["cfg"]
    bundle = ModelBundle(cfg, CPU)
    bundle.model.load_state_dict(case["state"])
    if case.get("unused"):
        # a parameter no forward reaches: no gradient, so Adam leaves it
        bundle.model.unused = torch.nn.Parameter(torch.ones(3))
    counts = {}
    for name, mod in bundle.model.named_modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            mod.register_forward_pre_hook(lambda m, a, name=name: counts.__setitem__(
                name, a[0].numel() // a[0].shape[1] * size))
    optimizer, scheduler = make_optimizer(cfg, bundle.parameters(), 10)
    b = len(case["batch"]["color_l"]) // size
    batch = {k: v[rank * b:(rank + 1) * b] for k, v in case["batch"].items()}
    losses = make_train_step(bundle, optimizer, scheduler)(batch_to_tensors(batch, CPU))
    assert all(isinstance(v, torch.Tensor) and v.dim() == 0 for v in losses.values())
    return {"losses": {k: float(v) for k, v in losses.items()},
            "state": {k: v.clone() for k, v in bundle.model.state_dict().items()},
            "grads": {k: None if p.grad is None else p.grad.clone()
                      for k, p in bundle.model.named_parameters()},
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
