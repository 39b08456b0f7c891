"""``alpha_self`` (with and without SSIM) in the port against the JAX package.

- ``ssim`` and ``reprojection_loss``: values and VJP;
- ``pred_self_images`` (one ``F.grid_sample`` with border padding, the JAX
  package's XLA gather): values and the VJP into the disparity;
- one training forward and backward with ``alpha_self=0.1`` of the port's
  ``process_batch`` on the CPU against the JAX package's, losses at rtol
  2e-4 (``loss/self_loss`` among them) and every gradient leaf by
  ``tests/_torch_parity.py:assert_grads_match``:
  - on the stereo sweep (flip_right, 1 -> 2 images), where the
    self-reconstruction reads the sweep's own disparity: held to the JAX
    fused step (its sweep kernels in interpret mode), so the self loss's
    cotangent must join the smoothness term's in the sweep's backward;
  - on the 2-D warp (a homography to side 'r'), where it reads the disp
    head's disparity: held to the JAX oracle step, with the stereo pose
    jittered off the pure x-translation as tests/test_torch_mono.py does;
- ``--use_ssim`` and ``--render_probability --yz_levels 4 --alpha_self 0.1``
  through the port's CLI give the JAX parser's config.

ResNet-18 without DenseASPP, 7+3 planes, 64x128, no perceptual loss.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planedepth_tpu import config as jcfg
from planedepth_tpu.cli import options as joptions
from planedepth_tpu.data.synthetic import make_stereo_batch
from planedepth_tpu.geometry.pose import transformation_from_parameters
from planedepth_tpu.ops.ssim import ssim as jax_ssim
from planedepth_tpu.train import ModelBundle as JaxBundle
from planedepth_tpu.train.losses import reprojection_loss as jax_reprojection_loss
from planedepth_tpu.train.view_synthesis import pred_self_images as jax_pred_self_images
from planedepth_tpu_torch import config as tcfg
from planedepth_tpu_torch.cli import options as toptions
from planedepth_tpu_torch.ops.ssim import ssim
from planedepth_tpu_torch.train.losses import reprojection_loss
from planedepth_tpu_torch.train.mono import fused_warp2d_ok
from planedepth_tpu_torch.train.step import fused_sweep_ok
from planedepth_tpu_torch.train.view_synthesis import pred_self_images
from tests._torch_parity import (
    assert_grads_match,
    grads_as_port,
    jax_losses_and_grads,
    nchw,
    perturbed_init,
    port_losses_and_grads,
)
from tests.test_torch_cli import _parse, _same_fields

pytestmark = pytest.mark.heavy
torch.set_num_threads(1)

H, W = 64, 128
LOSS_KEYS = ("loss/ph_loss", "loss/self_loss", "loss/smooth_loss", "loss/total_loss")


def _images(seed, shape=(2, 9, 11, 3)):
    rng = np.random.default_rng(seed)
    return rng.random(shape, dtype=np.float32), rng.random(shape, dtype=np.float32)


def _vjp_nchw(fn, *arrays, ct):
    """A JAX NHWC function's value and VJP at NCHW numpy arrays, NCHW, under
    ``jax.jit`` (one compiled program rather than one an operation)."""
    @jax.jit
    def value_and_vjp(args, ct):
        out, vjp = jax.vjp(fn, *args)
        return out, vjp(ct)
    out, grads = value_and_vjp(tuple(jnp.asarray(np.moveaxis(a, 1, -1)) for a in arrays),
                               jnp.asarray(np.moveaxis(ct, 1, -1)))
    return np.moveaxis(np.asarray(out), -1, 1), [np.moveaxis(np.asarray(g), -1, 1)
                                                 for g in grads]


def test_ssim_matches_jax():
    x, y = (np.moveaxis(a, -1, 1) for a in _images(0))
    ct = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)
    want, d_want = _vjp_nchw(jax_ssim, x, y, ct=ct)
    xt, yt = (torch.from_numpy(a).requires_grad_() for a in (x, y))
    got = ssim(xt, yt)
    d_got = torch.autograd.grad(got, (xt, yt), torch.from_numpy(ct))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-6)
    for name, a, b in zip(("d_x", "d_y"), d_got, d_want):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("use_ssim", [False, True], ids=["l1", "ssim"])
def test_reprojection_loss_matches_jax(use_ssim):
    pred, target = (np.moveaxis(a, -1, 1) for a in _images(2))
    ct = np.random.default_rng(3).normal(size=pred.shape[:1] + (1,) + pred.shape[2:])
    ct = ct.astype(np.float32)
    want, (d_want,) = _vjp_nchw(lambda p: jax_reprojection_loss(p, jnp.asarray(
        np.moveaxis(target, 1, -1)), use_ssim), pred, ct=ct)
    pt = torch.from_numpy(pred).requires_grad_()
    got = reprojection_loss(pt, torch.from_numpy(target), use_ssim)
    (d_got,) = torch.autograd.grad(got, pt, torch.from_numpy(ct))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(d_got.numpy(), d_want, rtol=1e-4, atol=1e-5)


def test_pred_self_images_matches_jax():
    """Disparities from 1 to 40 px at 32x48 sample the right image inside
    it and past both edges (border padding); the stereo pose is jittered so
    no coordinate falls on an integer."""
    h, w = 32, 48
    batch = make_stereo_batch(2, h, w, seed=5)
    jitter = transformation_from_parameters(
        jnp.asarray([[[0.002, -0.001, 0.003]]], jnp.float32),
        jnp.asarray([[[0.001, 0.004, 0.002]]], jnp.float32))
    Rt = np.array(jnp.einsum("bij,njk->bik", batch["Rt_r"], jitter))
    rng = np.random.default_rng(6)
    disp = rng.uniform(1.0, 40.0, (2, 1, h, w)).astype(np.float32)
    right = np.moveaxis(batch["color_r"], -1, 1)
    ct = rng.normal(size=(2, 3, h, w)).astype(np.float32)
    cams = [jnp.asarray(a) for a in (Rt, batch["K"], batch["inv_K"])]
    want, (d_want,) = _vjp_nchw(
        lambda d: jax_pred_self_images(d, jnp.asarray(batch["color_r"]), *cams), disp, ct=ct)
    dt = torch.from_numpy(disp).requires_grad_()
    got = pred_self_images(dt, torch.from_numpy(right), *(torch.from_numpy(np.asarray(a))
                                                          for a in cams))
    (d_got,) = torch.autograd.grad(got, dt, torch.from_numpy(ct))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(d_got.numpy(), d_want, rtol=1e-4, atol=1e-5)
    assert float(np.abs(d_want).max()) > 0


def _configs(warp_type, use_ssim):
    planes = dict(disp_levels=7, disp_min=2, disp_max=16, xz_levels=3, yz_levels=0)
    model = dict(num_layers=18, use_denseaspp=False, use_mixture_loss=True,
                 plane_residual=True, num_ep=0)
    loss = dict(alpha_pc=0.0, automask=True, alpha_self=0.1, use_ssim=use_ssim)
    common = dict(batch_size=1, flip_right=warp_type == "disp_warp", warp_type=warp_type)
    j = jcfg.TrainConfig(
        model=jcfg.ModelConfig(planes=jcfg.PlaneConfig(**planes), **model),
        loss=jcfg.LossConfig(**loss), data=jcfg.DataConfig(height=H, width=W), bf16=False,
        # the sweep: the JAX fused step; the 2-D warp: the JAX oracle step
        fused_sweep=warp_type == "disp_warp", **common)
    t = tcfg.TrainConfig(
        bf16=False,
        model=tcfg.ModelConfig(planes=tcfg.PlaneConfig(**planes), **model),
        loss=tcfg.LossConfig(**loss), data=tcfg.DataConfig(height=H, width=W),
        fused_sweep=True, **common)
    return j, t


@pytest.fixture(scope="module", params=[("disp_warp", False), ("disp_warp", True),
                                        ("homography_warp", False), ("homography_warp", True)],
                ids=["sweep", "sweep_ssim", "warp", "warp_ssim"])
def self_step(request):
    """One training forward and backward of each package from the same
    perturbed weights, and the port's in float64."""
    warp_type, use_ssim = request.param
    jc, tc = _configs(warp_type, use_ssim)
    assert (fused_sweep_ok if warp_type == "disp_warp" else fused_warp2d_ok)(tc)
    bundle = JaxBundle(jc)
    params, stats, _ = perturbed_init(bundle, 0, H, W)
    batch = make_stereo_batch(jc.batch_size, H, W, seed=4)
    if warp_type != "disp_warp":
        jitter = transformation_from_parameters(
            jnp.asarray([[[0.002, -0.001, 0.003]]], jnp.float32),
            jnp.asarray([[[0.001, 0.004, 0.002]]], jnp.float32))
        batch["Rt_r"] = np.array(jnp.einsum("bij,njk->bik", batch["Rt_r"], jitter))
    losses_j, grads_j = jax_losses_and_grads(bundle, params, stats, None, batch)
    losses, grads, port = port_losses_and_grads(tc, params, stats, None, batch)
    _, grads64, _ = port_losses_and_grads(tc, params, stats, None, batch, torch.float64)
    return {"losses": losses, "losses_j": losses_j, "grads": grads, "grads64": grads64,
            "grads_j": grads_as_port(port.model.cfg, grads_j, stats["model"])}


def test_self_losses_match_jax(self_step):
    assert set(self_step["losses"]) == set(self_step["losses_j"])
    for k in LOSS_KEYS:
        np.testing.assert_allclose(self_step["losses"][k], float(self_step["losses_j"][k]),
                                   rtol=2e-4, err_msg=k)
    assert self_step["losses"]["loss/self_loss"] > 0


def test_self_gradients_match_jax(self_step):
    assert_grads_match(self_step["grads"], self_step["grads_j"], self_step["grads64"], True)


@pytest.mark.parametrize("argv", [
    ["--use_ssim", "--alpha_self", "0.1"],
    ["--stage", "stage1", "--render_probability", "--yz_levels", "4", "--alpha_self", "0.1",
     "--use_ssim"],
], ids=["use_ssim", "render_yz_self"])
def test_flags_give_the_jax_config(argv):
    args_j, explicit_j, want = _parse(joptions, argv)
    args_t, explicit_t, got = _parse(toptions, argv)
    assert vars(args_t) == {k: v for k, v in vars(args_j).items() if k in vars(args_t)}
    assert explicit_t == explicit_j
    _same_fields(got, want)
    assert got.loss.use_ssim and got.loss.alpha_self == 0.1
