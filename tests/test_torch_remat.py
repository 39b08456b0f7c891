"""The rematerialisation switches in the port: ``ModelConfig.remat`` (the depth
encoder's residual blocks recomputed in the backward pass) and
``TrainConfig.remat_warp`` (the oracle route's view synthesis and losses
recomputed), the JAX package's ``nn.remat`` and ``jax.checkpoint``.

- (a) One oracle step in float32 with both switches on, against the JAX
  step with both on, from the same perturbed weights: losses at rtol 1e-4,
  every gradient leaf by ``tests/_torch_parity.py:assert_grads_match``.
  It is ``tests/test_torch_oracle_step.py::
  test_oracle_step_with_both_remat_switches_matches_jax``, beside the step
  without them, whose JAX init it shares.
- (b) The port alone: ``remat`` on against off for the fused stage-1 step
  in float32 and in bf16 and for a mono (homography) step.  Losses and
  every gradient leaf are bit-equal; so are every BatchNorm's running
  statistics and ``num_batches_tracked`` after the step (the recompute
  updates nothing), while the encoder's residual blocks ran twice.
- (c) The port alone: ``remat_warp`` on against off on the oracle step
  with ``use_mom`` and the automask, bit-equal in the same terms.
- (d) The port alone: the eval forward and ``cli/export.py:export_forward``
  of a ``remat`` model equal the ``remat=False`` model's, the exported
  graphs node for node: ``tests/test_torch_export.py::
  test_remat_model_exports_the_same_program``, beside the plain model's
  program.
- ``cli.train.main`` with ``--stage hr_finetune --remat`` trains through
  the ``Trainer`` with the encoder's blocks recomputed, and the reference's
  own flags (no ``--stage``, no ``--fused_sweep``) with ``--remat_warp``
  through the oracle segment recomputed (synthetic samples in place of the
  split's reader).

ResNet-18, 7+3 planes, 64x96, one image and its flip.
"""
import dataclasses
import functools

import pytest
import torch

from planedepth_tpu_torch import config as tcfg
from planedepth_tpu_torch.cli import train as cli_train
from planedepth_tpu_torch.data.synthetic import make_stereo_batch as port_stereo_batch
from planedepth_tpu_torch.models import resnet
from planedepth_tpu_torch.models.layers import BatchNorm2d
from planedepth_tpu_torch.train import step as port_step
from planedepth_tpu_torch.train.mono import fused_warp2d_ok
from planedepth_tpu_torch.train.step import (
    ModelBundle,
    batch_to_tensors,
    fused_sweep_ok,
    process_batch,
)

torch.set_num_threads(1)
H, W = 64, 96
CPU = torch.device("cpu")
PLANES = dict(disp_levels=7, disp_min=2, disp_max=24, xz_levels=3, yz_levels=0)
MODEL = dict(num_layers=18, use_denseaspp=False, use_mixture_loss=True, plane_residual=True,
             num_ep=0)
ORACLE_LOSS = dict(alpha_pc=0.0, automask=True, use_mom=True)


def _oracle():
    """The oracle step of ``tests/test_torch_oracle_step.py``, one image and
    its flip."""
    common = dict(batch_size=2, flip_right=True, warp_type="disp_warp", fused_sweep=False,
                  bf16=False)
    return tcfg.TrainConfig(model=tcfg.ModelConfig(planes=tcfg.PlaneConfig(**PLANES), **MODEL),
                            loss=tcfg.LossConfig(**ORACLE_LOSS),
                            data=tcfg.DataConfig(height=H, width=W), **common)


def _stage1(bf16):
    planes = tcfg.PlaneConfig(**PLANES)
    return tcfg.TrainConfig(model=tcfg.ModelConfig(planes=planes, **dict(MODEL, num_ep=8)),
                            loss=tcfg.LossConfig(alpha_pc=0.0),
                            data=tcfg.DataConfig(height=H, width=W), bf16=bf16, batch_size=2,
                            flip_right=True, fused_sweep=True)


def _mono():
    return _stage1(False).replace(warp_type="homography_warp", novel_frame_ids=(-1, 1),
                                  flip_right=False, loss=tcfg.LossConfig(alpha_pc=0.0,
                                                                         automask=True))


def _step(cfg, state):
    """One training forward and backward of ``cfg`` from the bundle state
    ``state``: (losses, gradients, every buffer after the step, calls of
    each encoder BatchNorm)."""
    bundle = ModelBundle(cfg, CPU)
    for name, net in bundle.nets().items():
        net.load_state_dict(state[name])
    calls = {}
    for name, mod in bundle.model.named_modules():
        if isinstance(mod, BatchNorm2d) and name.startswith("encoder."):
            mod.register_forward_pre_hook(
                lambda m, a, name=name: calls.__setitem__(name, calls.get(name, 0) + 1))
    batch = port_stereo_batch(cfg.per_step_batch, H, W, seed=5,
                              novel_frame_ids=cfg.novel_frame_ids)
    losses = process_batch(bundle.train(), batch_to_tensors(batch, CPU),
                           torch.Generator().manual_seed(0))
    losses["loss/total_loss"].backward()
    grads = {k: p.grad for k, p in bundle.named_parameters()}
    buffers = {f"{n}.{k}": v for n, net in bundle.nets().items()
               for k, v in net.named_buffers()}
    return {k: v.item() for k, v in losses.items()}, grads, buffers, calls


def _assert_bit_equal(cfg, on):
    """``cfg`` against itself with ``on`` (config fields) set, from one
    state: the losses, the gradients and the buffers bit for bit."""
    state = {k: v.state_dict() for k, v in ModelBundle(cfg, CPU).nets().items()}
    (l0, g0, b0, c0), (l1, g1, b1, c1) = (_step(c, state) for c in (cfg, on(cfg)))
    assert l1 == l0
    assert g1.keys() == g0.keys() and [k for k, g in g0.items() if g is None] == []
    assert [k for k in g0 if not torch.equal(g1[k], g0[k])] == []
    assert [k for k in b0 if k.endswith("num_batches_tracked")]
    assert b1.keys() == b0.keys()
    assert [k for k in b0 if not torch.equal(b1[k], b0[k])] == []
    return c0, c1


def _remat(cfg):
    return cfg.replace(model=dataclasses.replace(cfg.model, remat=True))


@pytest.mark.parametrize("cfg", [_stage1(False), _stage1(True), _mono()],
                         ids=["stage1_f32", "stage1_bf16", "mono"])
def test_remat_step_is_bit_equal(cfg):
    """(b): the blocks' BatchNorms ran twice (forward and recompute), the
    stem's once, and the statistics moved once."""
    plain, recomputed = _assert_bit_equal(cfg, _remat)
    assert set(plain.values()) == {1}
    assert recomputed == {k: 1 if k == "encoder.encoder.bn1" else 2 for k in plain}
    if cfg.use_pose_net:
        assert fused_warp2d_ok(cfg)


def test_remat_warp_oracle_step_is_bit_equal():
    """(c): the oracle segment (view synthesis, the mirror occlusion mask,
    the losses) recomputed."""
    cfg = _oracle()
    assert not fused_sweep_ok(cfg) and cfg.loss.use_mom
    _assert_bit_equal(cfg, lambda c: c.replace(remat_warp=True))


class Samples:
    """Unbatched synthetic stereo samples in the trainer's dataset protocol."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def getitem(self, index, epoch=0):
        return {k: v[0] for k, v in port_stereo_batch(1, H, W, seed=index).items()}


SMALL = ["--height", str(H), "--width", str(W), "--num_layers", "18", "--disp_levels", "7",
         "--disp_max", "24", "--xz_levels", "3", "--num_ep", "0", "--alpha_pc", "0",
         "--batch_size", "2", "--num_epochs", "1", "--num_workers", "1"]


@pytest.mark.parametrize("argv,module", [
    (["--stage", "hr_finetune", "--remat"], resnet),
    (["--use_mixture_loss", "--plane_residual", "--flip_right", "--warp_type", "disp_warp",
      "--remat_warp"], port_step),
], ids=["hr_finetune_remat", "oracle_remat_warp"])
def test_train_cli_trains_with_the_switch(argv, module, tmp_path, monkeypatch):
    calls, real = [], module.remat
    monkeypatch.setattr(module, "remat", lambda fn, *a: (calls.append(fn), real(fn, *a))[1])
    monkeypatch.setattr(cli_train, "Trainer", functools.partial(
        cli_train.Trainer, datasets=(Samples(1), Samples(1))))
    trainer = cli_train.main(argv + SMALL + ["--log_dir", str(tmp_path)], device=CPU)
    cfg = trainer.cfg
    assert trainer.step_count == 1
    assert (cfg.model.remat, cfg.remat_warp) == ("--remat" in argv, "--remat_warp" in argv)
    assert fused_sweep_ok(cfg) == cfg.model.remat
    # one step: every residual block once, or the oracle segment once
    assert len(calls) == (8 if cfg.model.remat else 1)
