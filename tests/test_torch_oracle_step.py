"""The oracle training step in the port: against the JAX package's, against the
port's own fused step, and through the ``Trainer`` with its image panels.

- One stereo training forward and backward through the oracle view
  synthesis (``fused_sweep=False``, the JAX CLI's default) with flip_right,
  the mixture NLL, the automask and ``use_mom`` (the mirror occlusion mask
  over the synthesised right-view probability): the port's
  ``process_batch`` on the CPU against the JAX package's ``process_batch``
  from the same perturbed weights, losses at rtol 1e-4 and every gradient
  leaf by ``tests/_torch_parity.py:assert_grads_match`` (1e-3 of its scale;
  behind train-mode BatchNorm, where flax's float32 variance leaves JAX's
  gradients about a percent off, relative L2 1e-2 against the port's float64
  step, ROADMAP C4).
- The same step with both rematerialisation switches on (``model.remat``:
  the encoder's residual blocks; ``remat_warp``: the view synthesis and the
  losses, recomputed in the backward pass) in both packages, from the same
  weights (the JAX init shared), at the same bounds;
  ``tests/test_torch_remat.py`` holds each switch to the step without it,
  bit for bit.
- The port's fused step (the plane sweep, and the mirror occlusion mask
  rebuilt from the plane heads) against its own oracle step from the same
  weights and batch, losses at rtol 2e-4, as tests/test_fused_train.py
  holds the JAX fused step to its oracle.
- The reference's stage-1 flags without ``--fused_sweep`` through the port's
  CLI parser, trained by the ``Trainer`` for one step on synthetic samples,
  with its train and validation panels.

ResNet-18 without DenseASPP, 7+3 planes, 64x96, no perceptual loss.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from planedepth_tpu import config as jcfg
from planedepth_tpu.data.synthetic import make_stereo_batch
from planedepth_tpu.train import ModelBundle as JaxBundle
from planedepth_tpu_torch import config as tcfg
from planedepth_tpu_torch.cli import options as toptions
from planedepth_tpu_torch.data.synthetic import make_stereo_batch as port_stereo_batch
from planedepth_tpu_torch.train.mono import fused_warp2d_ok
from planedepth_tpu_torch.train.step import (
    ModelBundle,
    batch_to_tensors,
    fused_mixed_ok,
    fused_sweep_ok,
    process_batch,
)
from planedepth_tpu_torch.train.trainer import Trainer
from tests._torch_parity import (
    assert_grads_match,
    grads_as_port,
    jax_losses_and_grads,
    perturbed_init,
    port_losses_and_grads,
)

pytestmark = pytest.mark.heavy
torch.set_num_threads(1)

H, W = 64, 96
CPU = torch.device("cpu")
PLANES = dict(disp_levels=7, disp_min=2, disp_max=24, xz_levels=3, yz_levels=0)
MODEL = dict(num_layers=18, use_denseaspp=False, use_mixture_loss=True, plane_residual=True,
             num_ep=0)
LOSS = dict(alpha_pc=0.0, automask=True, use_mom=True)


def _configs(remat=False):
    """The JAX and port configurations; ``remat`` sets both switches."""
    common = dict(batch_size=1, flip_right=True, warp_type="disp_warp", fused_sweep=False,
                  remat_warp=remat)
    j = jcfg.TrainConfig(model=jcfg.ModelConfig(planes=jcfg.PlaneConfig(**PLANES), remat=remat,
                                                **MODEL),
                         loss=jcfg.LossConfig(**LOSS), data=jcfg.DataConfig(height=H, width=W),
                         bf16=False, **common)
    t = tcfg.TrainConfig(bf16=False,
                         model=tcfg.ModelConfig(planes=tcfg.PlaneConfig(**PLANES), remat=remat,
                                                **MODEL),
                         loss=tcfg.LossConfig(**LOSS), data=tcfg.DataConfig(height=H, width=W),
                         **common)
    return j, t


def _is_oracle(cfg):
    return not (fused_sweep_ok(cfg) or fused_warp2d_ok(cfg) or fused_mixed_ok(cfg))


def test_oracle_step_matches_jax():
    _assert_step_matches_jax(remat=False)


def test_oracle_step_with_both_remat_switches_matches_jax():
    _assert_step_matches_jax(remat=True)


def _assert_step_matches_jax(remat):
    jc, tc = _configs(remat)
    assert _is_oracle(tc)
    # the init of the configuration without the switches: the same variables
    params, stats, _ = perturbed_init(JaxBundle(_configs()[0]), 0, H, W)
    batch = make_stereo_batch(1, H, W, seed=4)
    losses_j, grads_j = jax_losses_and_grads(JaxBundle(jc), params, stats, None, batch)
    losses, grads, port = port_losses_and_grads(tc, params, stats, None, batch)
    assert port.model.encoder.encoder.remat == remat
    assert set(losses) == set(losses_j)
    for k, v in losses.items():
        np.testing.assert_allclose(v, float(losses_j[k]), rtol=1e-4, err_msg=k)
    _, grads64, _ = port_losses_and_grads(tc, params, stats, None, batch, torch.float64)
    assert_grads_match(grads, grads_as_port(port.model.cfg, grads_j, stats["model"]),
                       grads64, True)


def test_fused_step_matches_the_oracle_step():
    """The same weights (each bundle from the config's seed) and batch
    through the port's two routes."""
    _, oracle = _configs()
    fused = oracle.replace(fused_sweep=True)
    assert fused_sweep_ok(fused) and _is_oracle(oracle)
    batch = batch_to_tensors(port_stereo_batch(1, H, W, seed=6), CPU)
    losses = []
    for cfg in (fused, oracle):
        bundle = ModelBundle(cfg, CPU).train()
        losses.append({k: float(v) for k, v in process_batch(
            bundle, batch, torch.Generator().manual_seed(0)).items()})
    assert set(losses[0]) == set(losses[1])
    for k, v in losses[1].items():
        np.testing.assert_allclose(losses[0][k], v, rtol=2e-4, err_msg=k)


class Samples:
    """Unbatched synthetic stereo samples in the trainer's dataset protocol."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def getitem(self, index, epoch=0):
        return {k: v[0] for k, v in port_stereo_batch(1, H, W, seed=index).items()}


def test_reference_flags_train_through_the_oracle_with_panels(tmp_path):
    argv = ["--model_name", "stage1", "--height", str(H), "--width", str(W),
            "--net_type", "ResNet", "--num_layers", "18", "--use_mixture_loss",
            "--plane_residual", "--flip_right", "--disp_levels", "7", "--disp_min", "2",
            "--disp_max", "24", "--xz_levels", "3", "--num_ep", "0", "--warp_type",
            "disp_warp", "--batch_size", "2", "--num_epochs", "1", "--alpha_pc", "0",
            "--log_dir", str(tmp_path)]
    parser = toptions.build_parser()
    args, explicit = toptions.parse_with_explicit(parser, argv)
    cfg = toptions.args_to_config(args, explicit=explicit)
    assert not cfg.fused_sweep and _is_oracle(cfg)
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, num_workers=1))
    trainer = Trainer(cfg, datasets=(Samples(1), Samples(1)), device=CPU)
    logged, log = [], trainer.logger.images
    trainer.logger.images = lambda mode, images, step: (
        logged.append((mode, step, images)), log(mode, images, step))
    trainer.logger.has_writer = lambda mode: True       # with or without tensorboardX
    trainer.train()
    trainer.close()
    assert trainer.step_count == 1
    assert [(m, s) for m, s, _ in logged] == [("train", 0), ("val", 0)]
    for _, _, images in logged:
        assert sorted(images) == ["color_l/0", "color_pred_r/0", "color_r/0", "disp/0"]
        for name, im in images.items():
            assert im.shape == (H, W, 3) and np.isfinite(im).all(), name
            assert im.min() >= 0.0 and im.max() <= 1.0, name
    assert os.path.exists(os.path.join(str(tmp_path), "stage1", "last_models"))
