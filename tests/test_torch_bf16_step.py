"""The port's bf16 fused stage-1 step and eval forward against the JAX package's bf16 ones.

bf16 is the JAX package's default (``TrainConfig.bf16``): the networks
compute in bf16 with float32 parameters, the fused training heads stay
bf16, and the Pallas sweep takes bf16 images and heads.  One fused step
(flip_right, mixture NLL with the automask, VGG19 perceptual loss at
alpha_pc 0.1, smoothness) of the port in bf16 on the CPU, where the sweep
takes its plain version, and the eval forward of the same weights are held
to the JAX package's (Pallas sweep in interpret mode), computed with the
bf16 roundings its flax modules declare (``tests/_torch_bf16_ref.py``),
at the small configuration of tests/test_torch_train_step.py (ResNet-18
without DenseASPP, 7+3 planes, 64x96).  The port's float32 step and
forward from the same weights are the yardstick of bf16 rounding, since
they agree with the JAX float32 ones to 1e-4 (tests/test_torch_train_step.py):

- the rounding points: the port's bf16 forward in training mode (the same
  networks outside the fused sweep: float32 heads and a disp) stands at
  most half as far (mean |difference|) from the JAX bf16 forward as the
  port's float32 forward does, on logits, sigma and disp (0.41-0.46
  measured), and so do the fused step's bf16 logits; in eval mode at most
  0.75 of it (0.51-0.65 measured), where the float32 sums of the
  convolutions, taken in another order by the two frameworks, tip bf16
  roundings apart and each convolution spreads a tipped input over its
  window (the stem's output differs in 7e-5 of its elements, the encoder's
  last features in half).  The witness that this gap is summation order
  and not a rounding point: the port's own bf16 eval forward with every
  convolution summed in another order (the float32 convolution of the
  same bf16 values, rounded once where the bf16 one is) stands as far from
  the port's bf16 forward (0.50-0.64 of the float32 distance), and the JAX
  gap is held within 1.15 of it;
- the train-mode sigma, bf16 in both: the port rounds its float32 head
  epilogue once, where the JAX v1 route computes the sigmoid op by op in
  bf16 (a stated difference: exp, add and divide each rounded, up to ~2
  ulps from the exact value, a third of the elements apart), so it is
  held within three bf16 ulps of the value;
- the losses at rtol 2e-3 (bf16 rounding of the heads moves them by
  1.7e-4 to 6e-4 here);
- the gradients: every leaf within relative L2 max(1.5 x the port float32
  step's distance from the JAX bf16 step, 0.05), and the whole gradient
  nearer the JAX bf16 step than the float32 step is.  bf16 cotangents
  through train-mode BatchNorm leave the JAX bf16 step ~0.1 (relative L2,
  whole gradient; up to ~4 on a residual-head bias) from its own float32
  step, so two correct bf16 steps differ by as much.  Post-Adam weights
  are not compared: the first Adam step is ~lr sign(g) (ROADMAP C4).
"""
import numpy as np
import pytest
import torch

from planedepth_tpu_torch.models import layers
from planedepth_tpu_torch.train.step import ModelBundle
from planedepth_tpu_torch.utils.weights import load_jax_params
from tests._torch_bf16_ref import configs, reference
from tests._torch_parity import grads_as_port, nchw, port_losses_and_grads

torch.set_num_threads(1)
LOSS_KEYS = ("loss/ph_loss", "loss/pc_loss", "loss/smooth_loss", "loss/total_loss")


def bf16_ulp(x):
    a = np.maximum(np.abs(np.asarray(x, np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    ref = reference("stage1", tmp_path_factory.mktemp("bf16") / "stage1.npz")
    params, stats, pc, batch = ref["params"], ref["stats"], ref["pc"], ref["batch"]
    out = {"ref": ref}
    for name, bf16 in (("bf16", True), ("f32", False)):
        cfg = configs("stage1", bf16)[1]
        # the forwards on fresh models: the step updates the BN statistics
        fresh = ModelBundle(cfg, torch.device("cpu")).model
        load_jax_params(fresh, params["model"], stats["model"])
        plain = ModelBundle(cfg.replace(fused_sweep=False), torch.device("cpu")).model
        load_jax_params(plain, params["model"], stats["model"])
        with torch.no_grad():
            train = fresh.train()(nchw(batch["color_aug_l"]), nchw(batch["grid"]))
            load_jax_params(fresh, params["model"], stats["model"])
            ev = fresh.eval()(nchw(batch["color_l"]), nchw(batch["grid"]))
            full = plain.train()(nchw(batch["color_aug_l"]), nchw(batch["grid"]))
        losses, grads, port = port_losses_and_grads(cfg, params, stats, pc, batch)
        out[name] = {"losses": losses, "grads": grads, "train": train, "eval": ev,
                     "full": full}
    out["want"] = grads_as_port(port.model.cfg, ref["grads"]["model"], stats["model"])
    return out


def _jax(steps, name):
    return torch.from_numpy(np.moveaxis(steps["ref"]["out"][name], -1, 1))


@pytest.mark.parametrize("name,share", [
    ("train_logits", 0.5), ("full_logits", 0.5), ("full_sigma", 0.5), ("full_disp", 0.5),
    ("eval_logits", 0.75), ("eval_sigma", 0.75), ("eval_disp", 0.75)])
def test_bf16_forward_rounds_where_the_jax_one_does(steps, name, share):
    mode, key = name.split("_")
    got, f32 = steps["bf16"][mode][key], steps["f32"][mode][key]
    assert str(got.dtype).endswith(str(steps["ref"]["dtype"][name]))
    want = _jax(steps, name)
    d_bf16 = float((got.float() - want).abs().mean())
    d_f32 = float((f32 - want).abs().mean())
    assert d_bf16 <= share * d_f32, (name, d_bf16, d_f32)


def _conv_summed_in_float32(self, x):
    """``layers.Conv2d.forward`` with the convolution of the same bf16
    values summed by the float32 convolution, in its order, and rounded
    once where the bf16 one is: the same rounding points, another order."""
    dt = self.compute_dtype
    y = self._conv_forward(x.to(dt).float(), self.weight.to(dt).float(), None).to(dt)
    return y if self.bias is None else y + self.bias.to(dt)[:, None, None]


@pytest.fixture(scope="module")
def reordered_eval(steps):
    params, stats, batch = (steps["ref"][k] for k in ("params", "stats", "batch"))
    model = ModelBundle(configs("stage1", True)[1], torch.device("cpu")).model
    load_jax_params(model, params["model"], stats["model"])
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(layers.Conv2d, "forward", _conv_summed_in_float32)
        return model.eval()(nchw(batch["color_l"]), nchw(batch["grid"]))


@pytest.mark.parametrize("key", ["logits", "sigma", "disp"])
def test_bf16_eval_gap_is_the_spread_of_summation_order(steps, reordered_eval, key):
    """The port's bf16 eval forward stands from the JAX bf16 one within 1.15
    of its distance (mean |difference|) from itself with every convolution
    summed in another order (1.01-1.03 measured): what keeps the eval cases
    of the rounding-point test above 0.5 is summation order."""
    got, other = steps["bf16"]["eval"][key].float(), reordered_eval[key].float()
    want = _jax(steps, f"eval_{key}")
    d_jax = float((got - want).abs().mean())
    d_order = float((got - other).abs().mean())
    assert 0 < d_jax <= 1.15 * d_order, (key, d_jax, d_order)


def test_bf16_train_sigma_within_three_ulps_of_jax(steps):
    got = steps["bf16"]["train"]["sigma"]
    assert got.dtype == torch.bfloat16 and str(steps["ref"]["dtype"]["train_sigma"]) == "bfloat16"
    want = _jax(steps, "train_sigma").numpy()
    err = np.abs(got.float().numpy() - want)
    assert (err <= 3 * bf16_ulp(want)).all(), float((err / bf16_ulp(want)).max())


def test_bf16_step_losses_match_jax(steps):
    for k in LOSS_KEYS:
        np.testing.assert_allclose(steps["bf16"]["losses"][k], steps["ref"]["losses"][k],
                                   rtol=2e-3, err_msg=k)


def test_bf16_step_gradients_match_jax(steps):
    want = steps["want"]
    got, f32 = steps["bf16"]["grads"], steps["f32"]["grads"]
    assert set(got) == set(want)
    rel = lambda a, b: float((a.double() - b.double()).norm()     # noqa: E731
                             / max(float(b.double().norm()), 1e-30))
    for k, w in want.items():
        assert rel(got[k], w) <= max(1.5 * rel(f32[k], w), 0.05), (k, rel(got[k], w),
                                                                    rel(f32[k], w))
    flat = lambda d: torch.cat([d[k].double().flatten() for k in sorted(want)])   # noqa
    assert rel(flat(got), flat(want)) < rel(flat(f32), flat(want))
