"""Gradients of one stage-1 step over two ranks, over one process, and in float64, on the CPU.

    PYTHONPATH=. python scripts/ddp_grad_ref_cpu.py [--height 64 --width 192]

``stage1_config()`` in float32 (ResNet-50, DenseASPP, 49+14 planes, VGG19 at
alpha_pc 0.1, seeded weights, batch 4 flipped to 8) at a small size: one
step as two gloo ranks (spawned, ``file://`` rendezvous, the launcher's
environment as ``torch.distributed.run`` sets it), as one process on the
global batch, and as one process in float64 (the plain kernels run in any
dtype on the CPU).  Prints the depth model's leaves whose gradients part
most, relative L2: the ranks' from the one process's, and each float32
run's from float64's; the last line is one JSON object.  A CPU run times
nothing.
"""
import argparse
import json
import os
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, ".")
from planedepth_tpu_torch import config  # noqa: E402
from planedepth_tpu_torch.data.synthetic import make_stereo_batch  # noqa: E402
from planedepth_tpu_torch.parallel.mesh import init_distributed  # noqa: E402
from planedepth_tpu_torch.train.state import make_optimizer  # noqa: E402
from planedepth_tpu_torch.train.step import (  # noqa: E402
    ModelBundle,
    batch_to_tensors,
    make_train_step,
    process_batch,
)

CPU = torch.device("cpu")


def cfg(height, width):
    return config.stage1_config(bf16=False, allow_random_pc=True,
                                data=config.DataConfig(height=height, width=width))


def step_grads(c, rank=0, size=1):
    """One float32 step on this rank's rows of the global batch."""
    bundle = ModelBundle(c, CPU)
    optimizer, scheduler = make_optimizer(c, bundle.parameters(), 1000)
    full = make_stereo_batch(c.per_step_batch, c.data.height, c.data.width, seed=0)
    b = c.per_step_batch // size
    make_train_step(bundle, optimizer, scheduler)(batch_to_tensors(
        {k: v[rank * b:(rank + 1) * b] for k, v in full.items()}, CPU))
    return {k: p.grad.clone() for k, p in bundle.model.named_parameters() if p.grad is not None}


def float64_grads(c):
    bundle = ModelBundle(c, CPU)
    for net in list(bundle.nets().values()) + [bundle.pc]:
        net.double()
    full = make_stereo_batch(c.per_step_batch, c.data.height, c.data.width, seed=0)
    losses = process_batch(bundle.train(), {k: v.double() for k, v in
                                            batch_to_tensors(full, CPU).items()},
                           torch.Generator().manual_seed(c.seed << 32))
    losses["loss/total_loss"].backward()
    return {k: p.grad.clone() for k, p in bundle.model.named_parameters() if p.grad is not None}


def rank_main(rank, size, tmp, height, width):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(size), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(size))
    init_distributed(CPU, init_method=f"file://{tmp}/pg")
    try:
        grads = step_grads(cfg(height, width), rank, size)
        if rank == 0:
            torch.save(grads, os.path.join(tmp, "ranks.pt"))
    finally:
        dist.destroy_process_group()


def worst(a, b, n=5):
    rel = {k: ((a[k].double() - g.double()).norm() / g.double().norm()).item()
           for k, g in b.items() if g.abs().max().item() > 1e-6}
    return dict(sorted(rel.items(), key=lambda kv: -kv[1])[:n])


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--height", type=int, default=64)
    parser.add_argument("--width", type=int, default=192)
    args = parser.parse_args()
    c = cfg(args.height, args.width)
    with tempfile.TemporaryDirectory() as tmp:
        ranks = mp.spawn(rank_main, args=(2, tmp, args.height, args.width), nprocs=2,
                         join=False)
        one = step_grads(c)
        ref = float64_grads(c)
        while not ranks.join():
            pass
        two = torch.load(os.path.join(tmp, "ranks.pt"))
    out = {"ranks_vs_one": worst(two, one), "one_vs_float64": worst(one, ref),
           "ranks_vs_float64": worst(two, ref)}
    for k, v in out.items():
        print(f"[ddp_grad_ref_cpu] {k}: {json.dumps(v)}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
