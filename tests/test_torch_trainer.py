"""The port's trainer, checkpoints, loader, logging and stage presets.

Presets, defaults, the sampler's index order, the loader's batches (with its
deterministic fallback) and the resumed LR are held to the JAX package; the
checkpoint round trip and the ``models_to_load`` restore to what they must
load; and a two-step stage-2 run hands its ``last_models`` to a stage-3
``Trainer``, whose frozen teacher must equal the restored student, stay
unchanged while the student moves.  Everything runs on the CPU.
"""
import dataclasses
import json
import os
import time

import numpy as np
import pytest
import torch

from planedepth_tpu import config as jcfg
from planedepth_tpu.data import loader as jloader
from planedepth_tpu.train.state import multistep_lr
from planedepth_tpu.utils import logging as jlogging
from planedepth_tpu_torch import config as tcfg
from planedepth_tpu_torch.data import loader as tloader
from planedepth_tpu_torch.data.synthetic import make_stereo_batch
from planedepth_tpu_torch.models.factory import DepthModel, init_weights_
from planedepth_tpu_torch.train.state import fast_forward_schedule, make_optimizer
from planedepth_tpu_torch.train.trainer import Trainer
from planedepth_tpu_torch.utils import logging as tlogging
from planedepth_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    load_checkpoint_meta,
    restore_submodules,
    save_checkpoint,
)
from planedepth_tpu_torch.utils.weights import load_reference_state_dicts

torch.set_num_threads(1)
CPU = torch.device("cpu")
H, W = 64, 96


def _same_fields(port, ref, path="cfg"):
    """Every field of the port's dataclass equals the JAX one's."""
    for f in dataclasses.fields(port):
        got, want = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(got):
            _same_fields(got, want, f"{path}.{f.name}")
        else:
            assert got == want, f"{path}.{f.name}: {got!r} vs {want!r}"


@pytest.mark.parametrize("name", ["stage1", "hr_finetune", "self_distillation"])
def test_presets_equal_jax(name):
    assert set(tcfg.STAGE_PRESETS) == set(jcfg.STAGE_PRESETS)
    _same_fields(tcfg.STAGE_PRESETS[name](), jcfg.STAGE_PRESETS[name]())


def test_defaults_equal_jax():
    _same_fields(tcfg.TrainConfig(), jcfg.TrainConfig())


@pytest.mark.parametrize("name", ["stage1", "self_distillation"])
def test_config_json_round_trip(name):
    cfg = tcfg.STAGE_PRESETS[name](log_dir="/x", load_weights_folder="/w")
    assert tcfg.TrainConfig.from_dict(json.loads(cfg.to_json())) == cfg
    # the JAX package's opt.json reads as the same port config
    ref = jcfg.STAGE_PRESETS[name](log_dir="/x", load_weights_folder="/w")
    assert tcfg.TrainConfig.from_dict(json.loads(ref.to_json())) == cfg


@pytest.mark.parametrize("n,batch,shuffle,drop_last", [
    (10, 3, True, True), (10, 3, False, False), (7, 2, True, False),
    (2, 4, False, False), (25, 4, True, True)])
def test_epoch_sampler_order_equals_jax(n, batch, shuffle, drop_last):
    """The port's sampler at its default of one host is the JAX sampler at
    one host."""
    kw = dict(shuffle=shuffle, seed=3, drop_last=drop_last)
    got = tloader.EpochSampler(n, batch, **kw)
    want = jloader.EpochSampler(n, batch, num_hosts=1, host_id=0, **kw)
    assert got.steps_per_epoch() == want.steps_per_epoch()
    for epoch in range(3):
        np.testing.assert_array_equal(got.epoch_indices(epoch), want.epoch_indices(epoch))
        np.testing.assert_array_equal(got.host_batches(epoch), want.host_batches(epoch))


def test_mono_config_json_round_trip():
    """The pose-net and COLMAP fields survive the round trip, and a JAX
    ``opt.json`` with them reads as the same port config."""
    cfg = tcfg.mono_config(model=tcfg.ModelConfig(pose_num_layers=34, pose_num_ep=0),
                           data=tcfg.DataConfig(use_colmap=True), log_dir="/x")
    assert tcfg.TrainConfig.from_dict(json.loads(cfg.to_json())) == cfg
    ref = jcfg.TrainConfig(model=jcfg.ModelConfig(pose_num_layers=34, pose_num_ep=0),
                           data=jcfg.DataConfig(use_colmap=True), log_dir="/x",
                           model_name="mono", fused_sweep=True, batch_size=8,
                           warp_type="homography_warp", novel_frame_ids=(-1, 1),
                           loss=jcfg.LossConfig(automask=True))
    assert tcfg.TrainConfig.from_dict(json.loads(ref.to_json())) == cfg


class FlakyDataset:
    """Samples ``{"x": [index, epoch]}``; indices 1 and 4 fail to load."""

    def __len__(self):
        return 9

    def getitem(self, index, epoch=0):
        if index in (1, 4):
            raise OSError(f"sample {index} is missing")
        return {"x": np.array([index, epoch], np.int64)}


@pytest.mark.parametrize("workers", [1, 3])
def test_batch_loader_equals_jax(workers):
    """Batches and the fallback of failed samples equal the JAX loader's at
    its default prefetch depth, the port's."""
    batches = []
    for mod in (tloader, jloader):
        sampler = mod.EpochSampler(9, 3, shuffle=True, seed=5, drop_last=True)
        loader = mod.BatchLoader(FlakyDataset(), sampler, num_workers=workers)
        batches.append([b["x"] for e in range(2) for b in loader.epoch(e)])
    assert jloader.BatchLoader(None, None).prefetch == tloader.PREFETCH
    assert len(batches[0]) == 6
    for got, want in zip(*batches):
        np.testing.assert_array_equal(got, want)
    assert not any(np.isin(b[:, 0], (1, 4)).any() for b in batches[0])


class FlakyEvalSet(FlakyDataset):
    is_train = False


class BrokenTrainSet(FlakyDataset):
    is_train = True

    def getitem(self, index, epoch=0):
        raise OSError(f"sample {index} is missing")


@pytest.mark.parametrize("dataset,message", [
    (FlakyEvalSet(), "sample 1 is missing"),
    (BrokenTrainSet(), "all fallback samples failed to load; the last: OSError"),
], ids=["eval_set_raises", "train_set_all_fallbacks_fail"])
def test_batch_loader_failure_reaches_the_caller(dataset, message):
    """An evaluation set's failed sample is not swapped for another: the
    epoch stops with its error; a training set with no loadable sample
    stops with the last error chained."""
    loader = tloader.BatchLoader(dataset, tloader.EpochSampler(9, 3, shuffle=False))
    with pytest.raises(RuntimeError, match=message) as failure:
        list(loader.epoch(0))
    assert isinstance(failure.value.__cause__, Exception)
    cause = failure.value.__cause__
    while cause.__cause__ is not None:
        cause = cause.__cause__
    assert isinstance(cause, OSError)


@pytest.mark.parametrize("step", [0, 7, 8, 15, 40])
def test_fast_forward_gives_the_resumed_lr(step):
    """The LR after fast-forwarding to ``step`` is the schedule's at that
    count, which is what the JAX package's ``fast_forward_schedule`` sets."""
    cfg = tcfg.TrainConfig(optim=tcfg.OptimConfig(milestones=(2, 4), lr_gamma=0.5))
    param = torch.nn.Parameter(torch.zeros(1))
    optimizer, scheduler = make_optimizer(cfg, [param], steps_per_epoch=4)
    fast_forward_schedule(optimizer, scheduler, step)
    sched = multistep_lr(1e-4, (2, 4), 0.5, 4)
    for t in range(step, step + 4):
        assert optimizer.param_groups[0]["lr"] == pytest.approx(float(sched(t)), rel=1e-6)
        optimizer.step()
        scheduler.step()


def test_logging_helpers_equal_jax(monkeypatch, tmp_path):
    for t in (0, 59, 3600, 10239, 360000):
        assert tlogging.sec_to_hm_str(t) == jlogging.sec_to_hm_str(t)
    monkeypatch.setattr(time, "time", lambda: 1000.0)
    lines = [mod.ThroughputMeter(100, 4) for mod in (tlogging, jlogging)]
    for meter in lines:
        meter.start = 900.0
    assert lines[0].log_line(1, 7, 20, 0.25, 0.125) == lines[1].log_line(1, 7, 20, 0.25, 0.125)
    logger = tlogging.Logger(str(tmp_path / "run"))
    logger.text("hello")
    logger.metric_row({k: 0.5 for k in tlogging.METRIC_NAMES})
    logger.close()
    assert "hello" in (tmp_path / "run" / "logs.log").read_text()


# --- checkpoints --------------------------------------------------------------

def _model_cfg(disp_levels=5):
    return tcfg.ModelConfig(num_layers=18, use_denseaspp=False, num_ep=0,
                            planes=tcfg.PlaneConfig(disp_levels=disp_levels, disp_max=24,
                                                    xz_levels=0))


def _model(seed, disp_levels=5):
    return init_weights_(DepthModel(_model_cfg(disp_levels)), torch.Generator().manual_seed(seed))


def _stepped_adam(model):
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-3)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    optimizer.step()
    return optimizer


def _states_equal(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


@pytest.fixture
def saved(tmp_path):
    model = _model(0)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-1, 1)
    optimizer = _stepped_adam(model)
    cfg = tcfg.TrainConfig(model=_model_cfg())
    path = save_checkpoint(str(tmp_path), "last_models", model, optimizer, cfg.to_json(),
                           height=H, width=W, step=3)
    return model, optimizer, path, cfg


def test_checkpoint_round_trip(saved, tmp_path):
    model, optimizer, path, cfg = saved
    assert sorted(os.listdir(path)) == ["adam.pth", "depth.pth", "encoder.pth"]
    encoder = torch.load(os.path.join(path, "encoder.pth"), weights_only=True)
    assert (encoder["height"], encoder["width"]) == (H, W)
    meta = load_checkpoint_meta(path)
    assert (meta["height"], meta["width"], meta["step"]) == (H, W, 3)
    assert tcfg.TrainConfig.from_dict(meta["config"]) == cfg
    assert json.loads((tmp_path / "opt.json").read_text()) == meta["config"]

    fresh = _model(1)
    fresh_opt = torch.optim.Adam(fresh.parameters(), lr=2e-5)
    loaded = restore_submodules(fresh, load_checkpoint(path), ("encoder", "depth"),
                                fresh_opt, restore_optimizer=True)
    assert loaded == ("encoder", "depth")
    assert _states_equal(fresh.state_dict(), model.state_dict())
    got, want = fresh_opt.state_dict(), optimizer.state_dict()
    assert fresh_opt.param_groups[0]["lr"] == 2e-5            # this run's LR
    for i, s in want["state"].items():
        assert all(torch.equal(got["state"][i][k], v) for k, v in s.items())
    # the reference's loader reads the same files
    other = _model(2)
    load_reference_state_dicts(other, encoder,
                               torch.load(os.path.join(path, "depth.pth"), weights_only=True))
    assert _states_equal(other.state_dict(), model.state_dict())


def test_restore_loads_only_the_named_submodules(saved):
    model, _, path, _ = saved
    fresh = _model(1)
    depth_before = {k: v.clone() for k, v in fresh.depth.state_dict().items()}
    restore_submodules(fresh, load_checkpoint(path), ("encoder",))
    assert _states_equal(fresh.encoder.state_dict(), model.encoder.state_dict())
    assert _states_equal(fresh.depth.state_dict(), depth_before)
    assert not _states_equal(depth_before, model.depth.state_dict())


def test_a_restore_that_loads_nothing_fails(saved):
    _, _, path, _ = saved
    payload = load_checkpoint(path)
    fresh = _model(1)
    with pytest.raises(ValueError, match="empty"):
        restore_submodules(fresh, payload, ())
    with pytest.raises(ValueError, match="pose"):
        restore_submodules(fresh, payload, ("pose",))
    renamed = dict(payload, depth={f"module.{k}": v for k, v in payload["depth"].items()})
    with pytest.raises(KeyError, match="lacks"):
        restore_submodules(fresh, renamed, ("encoder", "depth"))
    with pytest.raises(KeyError, match="no depth.pth"):
        restore_submodules(fresh, {"encoder": payload["encoder"]}, ("encoder", "depth"))
    with pytest.raises(ValueError, match="checkpoint"):
        restore_submodules(_model(1, disp_levels=6), payload, ("depth",))


def test_adam_is_restored_only_when_shapes_match(saved, capsys):
    _, _, path, _ = saved
    other = _model(1, disp_levels=6)
    optimizer = torch.optim.Adam(other.parameters())
    restore_submodules(other, load_checkpoint(path), ("encoder",), optimizer,
                       restore_optimizer=True)
    assert optimizer.state_dict()["state"] == {}
    assert "re-initialized" in capsys.readouterr().out


# --- the trainer ----------------------------------------------------------------

class SyntheticDataset:
    """Unbatched synthetic stereo samples (``__len__``, ``getitem(index, epoch)``)
    with the temporal frames ``novel_frame_ids``."""

    def __init__(self, n, novel_frame_ids=()):
        self.n, self.novel_frame_ids = n, novel_frame_ids

    def __len__(self):
        return self.n

    def getitem(self, index, epoch=0):
        batch = make_stereo_batch(1, H, W, seed=index, novel_frame_ids=self.novel_frame_ids)
        return {k: v[0] for k, v in batch.items()}


def _stage(preset, tmp_path, **kw):
    model = tcfg.ModelConfig(num_layers=18, num_ep=8, planes=tcfg.PlaneConfig(
        disp_levels=7, disp_max=24, xz_levels=3))
    base = preset()
    return preset(log_dir=str(tmp_path), model=model,
                  loss=dataclasses.replace(base.loss, alpha_pc=0.0),
                  data=tcfg.DataConfig(height=H, width=W, num_workers=2),
                  optim=dataclasses.replace(base.optim, num_epochs=1), log_frequency=1, **kw)


def test_trainer_needs_datasets_and_a_device(monkeypatch, tmp_path):
    """Without datasets the Trainer reads the split's file lists, which must
    exist; without a device it needs the card."""
    cfg = _stage(tcfg.stage1_config, tmp_path)
    missing = cfg.replace(data=dataclasses.replace(cfg.data, split=str(tmp_path / "none")))
    with pytest.raises(FileNotFoundError, match="train_files.txt"):
        Trainer(missing, device=CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(_stage(tcfg.stage1_config, tmp_path),
                datasets=(SyntheticDataset(2), SyntheticDataset(2)))


def test_stage2_to_stage3_hand_off(tmp_path):
    """Stage 2 takes two steps and saves; stage 3 restores encoder and
    depth, freezes the teacher as the restored student, takes two steps."""
    s2 = Trainer(_stage(tcfg.hr_finetune_config, tmp_path, batch_size=4),
                 datasets=(SyntheticDataset(4), SyntheticDataset(2)), device=CPU)
    s2.train()
    s2.close()
    ckpt = os.path.join(str(tmp_path), "hr_finetune", "last_models")
    assert s2.step_count == 2 and os.path.isdir(ckpt)
    payload = load_checkpoint(ckpt)

    cfg3 = _stage(tcfg.self_distillation_config, tmp_path, batch_size=2,
                  load_weights_folder=ckpt)
    s3 = Trainer(cfg3, datasets=(SyntheticDataset(4), SyntheticDataset(2)), device=CPU)
    teacher, student = s3.bundle.teacher, s3.bundle.model
    saved_sd = {f"{name}.{k}": v for name in ("encoder", "depth")
                for k, v in payload[name].items() if k not in ("height", "width", "use_stereo")}
    assert _states_equal(teacher.state_dict(), saved_sd)
    assert _states_equal(student.state_dict(), saved_sd)
    assert teacher is not student and not teacher.training
    assert s3.optimizer.state_dict()["state"][0]["step"] == 2      # stage 2's Adam
    assert s3.optimizer.param_groups[0]["lr"] == cfg3.optim.learning_rate

    losses = []
    step = s3.train_step

    def recorded(batch):
        out = step(batch)
        losses.append(s3.read_metrics(out))        # the step returns device tensors
        return out

    s3.train_step = recorded
    s3.train()
    s3.close()
    assert s3.step_count == 2 and len(losses) == 2
    for ls in losses:
        assert ls["loss/disp_loss"] > 0 and all(np.isfinite(v) for v in ls.values())
        assert ls["loss/total_loss"] == pytest.approx(
            ls["loss/ph_loss"] + 0.04 * ls["loss/smooth_loss"] + ls["loss/disp_loss"],
            rel=1e-5)
    assert _states_equal(teacher.state_dict(), saved_sd)
    moved = [k for k, v in student.state_dict().items() if not torch.equal(v, saved_sd[k])]
    assert len(moved) > len(saved_sd) // 2
    run = os.path.join(str(tmp_path), "self_distillation")
    for name in ("last_models", "opt.json", "provenance.json", "logs.log"):
        assert os.path.exists(os.path.join(run, name)), name
    assert load_checkpoint_meta(os.path.join(run, "last_models"))["step"] == 2
    assert json.load(open(os.path.join(run, "opt.json")))["loss"]["self_distillation"] == 1.0


def test_mono_trainer_saves_and_restores_the_pose_nets(tmp_path):
    """The homography recipe through the Trainer: two steps move the depth
    and pose networks, ``last_models`` holds ``pose_encoder.pth`` and
    ``pose.pth`` beside the depth pair, and a second Trainer restores only
    the networks ``models_to_load`` names."""
    def cfg(**kw):
        return _stage(tcfg.mono_config, tmp_path, batch_size=2, **kw)

    data = (SyntheticDataset(4, (-1, 1)), SyntheticDataset(2, (-1, 1)))
    first = Trainer(cfg(), datasets=data, device=CPU)
    nets = first.bundle.nets()
    assert set(nets) == {"model", "pose_encoder", "pose"}
    start = {name: {k: v.clone() for k, v in net.state_dict().items()}
             for name, net in nets.items()}
    n_params = sum(1 for _ in first.bundle.parameters())
    assert len(first.optimizer.param_groups[0]["params"]) == n_params
    first.train()
    first.close()
    assert first.step_count == 2
    for name, net in nets.items():
        moved = [k for k, v in net.state_dict().items() if not torch.equal(v, start[name][k])]
        assert len(moved) > len(start[name]) // 2, name
    ckpt = os.path.join(str(tmp_path), "mono", "last_models")
    assert sorted(os.listdir(ckpt)) == ["adam.pth", "depth.pth", "encoder.pth",
                                        "pose.pth", "pose_encoder.pth"]
    provenance = json.load(open(os.path.join(str(tmp_path), "mono", "provenance.json")))
    assert set(provenance["networks"]) == {"model", "pose_encoder", "pose"}

    second = Trainer(cfg(load_weights_folder=ckpt, models_to_load=("pose_encoder", "pose"),
                         model_name="mono_restored"), datasets=data, device=CPU)
    for name in ("pose_encoder", "pose"):
        assert _states_equal(second.bundle.nets()[name].state_dict(),
                             nets[name].state_dict()), name
    assert _states_equal(second.bundle.model.state_dict(), start["model"])
    # the Adam moments of all three networks come back with the pose nets
    assert second.optimizer.state_dict()["state"][0]["step"] == 2
    second.close()


def test_falnet_trainer_saves_and_restores_fal(tmp_path):
    """A FalNet stereo run saves its one network as ``fal.pth`` (with the
    train resolution); a second Trainer restores it by
    ``models_to_load=("fal",)``; a name FalNet lacks is refused."""
    def cfg(**kw):
        return _stage(tcfg.stage1_config, tmp_path, batch_size=4, **kw).replace(
            model=tcfg.ModelConfig(net_type="FalNet", use_mixture_loss=False,
                                   plane_residual=False, planes=tcfg.PlaneConfig(
                                       disp_levels=7, disp_max=24, xz_levels=0)))

    data = (SyntheticDataset(4), SyntheticDataset(2))
    first = Trainer(cfg(), datasets=data, device=CPU)
    start = {k: v.clone() for k, v in first.bundle.model.state_dict().items()}
    first.train()
    first.close()
    assert first.step_count == 2
    ckpt = os.path.join(str(tmp_path), "stage1", "last_models")
    assert sorted(os.listdir(ckpt)) == ["adam.pth", "fal.pth"]
    payload = load_checkpoint(ckpt)
    assert (payload["fal"]["height"], payload["fal"]["width"]) == (H, W)
    trained = first.bundle.model.fal.state_dict()
    assert not _states_equal(trained, {k[len("fal."):]: v for k, v in start.items()})

    second = Trainer(cfg(load_weights_folder=ckpt, models_to_load=("fal",),
                         model_name="fal_restored"), datasets=data, device=CPU)
    assert _states_equal(second.bundle.model.fal.state_dict(), trained)
    second.close()
    with pytest.raises(ValueError, match="no network 'encoder'"):
        Trainer(cfg(load_weights_folder=ckpt, models_to_load=("encoder",),
                    model_name="fal_refused"), datasets=data, device=CPU)
