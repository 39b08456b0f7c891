"""The port's ``Trainer`` over two gloo ranks against one process, on the CPU.

Two spawned ranks (``tests/_torch_ranks.py``: the port alone) each build a
``Trainer`` of a small stage-1 configuration (ResNet-18, 5 planes, 64x96,
global batch 2 flipped to 4) on tiny synthetic datasets and run validation
with the stereo scale and with the ``no_stereo`` median ratio, one epoch of
two steps, and its closing validation; one process does the same here.
Held: only rank 0 writes the run's logs and checkpoints; both ranks'
validation metrics are equal to each other and to the one process's over
the same split (the median over the global batch included); each rank
trains on its sampler's share, whose shares make up the one process's
batches; the device batches come in the loader's order; and the losses are
read to the host on log steps only, by rank 0 alone.
"""
import dataclasses
import os
import pickle
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from planedepth_tpu_torch import config as tcfg
from planedepth_tpu_torch.data.loader import EpochSampler
from planedepth_tpu_torch.data.synthetic import make_stereo_batch
from planedepth_tpu_torch.train.step import batch_to_tensors, make_eval_step
from planedepth_tpu_torch.train.trainer import Trainer
from tests._torch_ranks import collect, finish, join_group, start_ranks

torch.set_num_threads(1)
CPU = torch.device("cpu")
H, W = 64, 96
N_TRAIN, N_VAL = 4, 3


class IndexedStereo:
    """Synthetic stereo samples carrying their ``index``."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def getitem(self, index, epoch=0):
        sample = {k: v[0] for k, v in make_stereo_batch(1, H, W, seed=index).items()}
        return dict(sample, index=np.int64(index))


def _cfg(log_dir):
    model = tcfg.ModelConfig(num_layers=18, num_ep=0, use_denseaspp=False, planes=tcfg.PlaneConfig(
        disp_levels=5, disp_max=24, xz_levels=0))
    base = tcfg.stage1_config()
    return tcfg.stage1_config(
        log_dir=log_dir, model=model, batch_size=4, bf16=False,
        loss=dataclasses.replace(base.loss, alpha_pc=0.0),
        data=tcfg.DataConfig(height=H, width=W, num_workers=2),
        optim=dataclasses.replace(base.optim, num_epochs=1), log_frequency=2)


def drive(trainer):
    """Validation both ways, then the training epoch; what the tests hold."""
    out = {"val": trainer.val(0)}
    stereo_step = trainer.eval_step
    mono = types.SimpleNamespace(cfg=trainer.cfg.replace(no_stereo=True),
                                 model=trainer.bundle.model)
    trainer.eval_step = make_eval_step(mono)
    out["val_no_stereo"] = trainer.val(0)
    trainer.eval_step = stereo_step
    indices, reads, step = [], [], trainer.train_step
    read = trainer.read_metrics

    def recorded_step(batch):
        indices.append(batch["index"].tolist())
        metrics = step(batch)
        assert all(isinstance(v, torch.Tensor) for v in metrics.values())
        return metrics

    def recorded_read(metrics):
        reads.append(trainer.step_count)
        return read(metrics)

    trainer.train_step, trainer.read_metrics = recorded_step, recorded_read
    trainer.val = lambda epoch, val=trainer.val: out.setdefault("val_after", val(epoch))
    trainer.train()
    trainer.close()
    return dict(out, indices=indices, reads=reads, steps=trainer.step_count)


def trainer_rank(rank, size, tmp):
    join_group(rank, size, tmp)
    try:
        trainer = Trainer(_cfg(os.path.join(tmp, f"rank{rank}")),
                          datasets=(IndexedStereo(N_TRAIN), IndexedStereo(N_VAL)), device=CPU)
        finish(rank, tmp, drive(trainer))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trainer_ranks")
    ranks = start_ranks(trainer_rank, 2, tmp)        # they run while this process works
    one = Trainer(_cfg(str(tmp / "one")), datasets=(IndexedStereo(N_TRAIN), IndexedStereo(N_VAL)),
                  device=CPU)
    batches = [(b, d) for b, d in one.device_batches(0)]
    return {"tmp": tmp, "one": drive(one), "ranks": collect(ranks, tmp), "batches": batches,
            "loader": list(one.train_loader.epoch(0))}


def test_only_rank_zero_writes(runs):
    run = runs["tmp"] / "rank0" / "stage1"
    for name in ("opt.json", "provenance.json", "logs.log", "last_models", "best_models"):
        assert (run / name).exists(), name
    assert not (runs["tmp"] / "rank1").exists()


@pytest.mark.parametrize("mode", ["val", "val_no_stereo", "val_after"])
def test_validation_is_the_global_batch_s(runs, mode):
    """Both ranks' metrics are equal; before training they equal the one
    process's over the same split (after it, the weights differ by the
    steps' rounding)."""
    r0, r1 = (r[mode] for r in runs["ranks"])
    assert r0 == r1 and len(r0) == 7
    if mode != "val_after":
        for k, v in runs["one"][mode].items():
            np.testing.assert_allclose(r0[k], v, rtol=1e-5, err_msg=k)


def test_ranks_train_on_their_shares(runs):
    """Rank r's batches are its sampler's host batches, and the ranks'
    batches side by side are the one process's."""
    cfg = _cfg("")
    for rank, r in enumerate(runs["ranks"]):
        want = EpochSampler(N_TRAIN, 1, 2, rank, shuffle=True, seed=cfg.seed).host_batches(0)
        assert r["indices"] == want.tolist() and r["steps"] == 2
    joined = [a + b for a, b in zip(*(r["indices"] for r in runs["ranks"]))]
    assert joined == runs["one"]["indices"]


def test_device_batches_are_the_loader_s_in_order(runs):
    assert len(runs["batches"]) == len(runs["loader"]) == N_TRAIN // 2
    for (host, device), want in zip(runs["batches"], runs["loader"]):
        assert sorted(host) == sorted(want)
        for k, v in batch_to_tensors(want, CPU).items():
            assert torch.equal(device[k], v), k


def test_losses_are_read_on_log_steps_only(runs):
    """log_frequency 2 over steps 0 and 1: step 0 alone is read, on rank 0."""
    assert runs["one"]["reads"] == [0]
    assert [r["reads"] for r in runs["ranks"]] == [[0], []]
