"""The port's no-mixture and PladeNet stereo training steps against the JAX package's, on the same weights.

One fused stereo step (flip_right, smoothness, Adam) of
``planedepth_tpu_torch.train.step`` on the CPU, where the sweep takes its
plain version, is held to the JAX package's ``make_train_step`` with the
Pallas kernels in interpret mode, in float32, at the configurations of
tests/test_fused_train.py (64x96, 7 planes, ResNet-18 without DenseASPP):

- FalNet (``use_mixture_loss=False``, 7 vertical planes, VGG19 perceptual
  loss at alpha_pc 0.1): the no-mixture sweep with the model's ``disp``
  (tests/test_fused_train.py:198-207);
- the ResNet-18 ``use_mixture_loss=False`` ablation with 3 ground planes:
  the no-mixture sweep computes ``disp`` from its centre samples, the head
  epilogue masks the logits without a sigma (:210-218);
- PladeNet with the mixture, an 8-channel PE and plane residuals (7+3
  planes): the mixture sweep (:164-195).

Losses agree at rtol 2e-4; the post-Adam weights by
``tests/_torch_parity.py:assert_step_matches`` (atol 5e-5 wherever the
step's direction is fixed, 2 * lr elsewhere, ROADMAP C4), the tolerances of
tests/test_torch_train_step.py; FalNet and PladeNet have no BatchNorm, whose
float32 rounding C4 is about, so every one of their weights is held at 5e-5.
"""
import numpy as np
import pytest
import torch

from planedepth_tpu import config as jcfg
from planedepth_tpu_torch import config as tcfg
from planedepth_tpu_torch.ops.plane_sweep import plane_sweep
from tests._torch_parity import assert_step_matches, stereo_step_pair

pytestmark = pytest.mark.heavy
torch.set_num_threads(1)

H, W = 64, 96
LOSS_KEYS = ("loss/ph_loss", "loss/pc_loss", "loss/smooth_loss", "loss/total_loss")

# name -> (ModelConfig fields, xz_levels, alpha_pc, automask)
RECIPES = {
    "falnet": (dict(net_type="FalNet", use_mixture_loss=False, num_ep=0), 0, 0.1, True),
    "resnet_nomix": (dict(net_type="ResNet", use_mixture_loss=False, num_ep=0), 3, 0.0, True),
    "pladenet": (dict(net_type="PladeNet", use_mixture_loss=True, num_ep=8), 3, 0.0, True),
}


def _configs(name):
    model, xz, alpha_pc, automask = RECIPES[name]
    planes = dict(disp_levels=7, disp_min=2, disp_max=24, xz_levels=xz, yz_levels=0)
    model = dict(model, num_layers=18, use_denseaspp=False, plane_residual=True)
    common = dict(batch_size=2, flip_right=True, fused_sweep=True)
    j = jcfg.TrainConfig(
        model=jcfg.ModelConfig(planes=jcfg.PlaneConfig(**planes), **model),
        loss=jcfg.LossConfig(alpha_pc=alpha_pc, automask=automask),
        data=jcfg.DataConfig(height=H, width=W),
        optim=jcfg.OptimConfig(learning_rate=1e-4), bf16=False,
        allow_random_pc=True, **common)
    t = tcfg.TrainConfig(
        model=tcfg.ModelConfig(planes=tcfg.PlaneConfig(**planes), **model),
        loss=tcfg.LossConfig(alpha_pc=alpha_pc, automask=automask),
        data=tcfg.DataConfig(height=H, width=W),
        optim=tcfg.OptimConfig(learning_rate=1e-4), **common)
    return j, t


@pytest.fixture(scope="module", params=list(RECIPES))
def steps(request):
    jc, tc = _configs(request.param)
    counts = lambda: (plane_sweep.fwd_launches, plane_sweep.bwd_launches,
                      plane_sweep.nomix_fwd_launches, plane_sweep.nomix_bwd_launches)
    before = counts()
    out = stereo_step_pair(jc, tc, H, W)
    assert counts() == before                    # CPU tensors: the plain path
    out["name"] = request.param
    return out


def test_step_losses_match_jax(steps):
    for k in LOSS_KEYS:
        np.testing.assert_allclose(steps["losses"][k], steps["metrics"][k],
                                   rtol=2e-4, err_msg=k)
    assert steps["losses"]["loss/ph_loss"] > 0
    if steps["name"] == "falnet":
        assert steps["losses"]["loss/pc_loss"] > 0


def test_step_parameters_match_jax(steps):
    """Post-Adam weights (and BatchNorm statistics, ResNet only) where the
    step's direction is fixed; FalNet and PladeNet have no BatchNorm, so
    every one of their weights is held at 5e-5; every family's weights
    move."""
    model = steps["port"].model
    no_bn = steps["name"] != "resnet_nomix"
    assert_step_matches(model, steps["want"], steps["before"], steps["sizes"],
                        steps["port"].cfg.optim.learning_rate,
                        min_share=0.0 if no_bn else 0.3)
    if no_bn:
        for k, v in model.state_dict().items():
            assert float((v - steps["want"][k]).abs().max()) <= 5e-5, k
    family = {"falnet": "fal", "pladenet": "plade", "resnet_nomix": "depth"}[steps["name"]]
    assert hasattr(model, family)
    moved = [k for k, v in model.state_dict().items()
             if k.startswith(family) and not torch.equal(v, steps["before"][k])]
    assert len(moved) > 0.9 * sum(k.startswith(family) for k in steps["before"])
