"""``render_probability`` and yz side planes in the port against the JAX package.

- ``render_probability_from_logits`` and ``plane_dists``: values and VJP at
  rtol 1e-5; ``disp_warp_coords`` (its ``disp_warp_shift`` is the rescue's
  dx) at 1e-6;
- the ResNet decoder (render_probability with yz planes) and PladeNet
  (render_probability) in eval mode at the decoder tolerance, rtol = atol =
  1e-3, with the JAX ``dists``;
- the stereo ``disp_warp`` recipes that the plane sweep cannot take and the
  2-D warp rescues (render_probability, yz_levels=4, each with and without
  the mixture), one training forward and backward of the port's
  ``process_batch`` on the CPU, where the warp and the head epilogue take
  their plain versions, against the JAX package's ``process_batch`` on its
  oracle view synthesis (``fused_sweep=False``; tests/test_warp2d_train.py
  holds the JAX warp2d rescue to that oracle): losses at rtol 2e-4 and every
  gradient leaf by ``tests/_torch_parity.py:assert_grads_match``; with yz
  planes also under self-distillation (the teacher's per-pixel shifts,
  held on their own against JAX's ``shift_sample_x``).  The batch is
  flipped (``flip_right``, 1 -> 2 images), so the sign of the right-view
  shift on the flipped half is held too.

ResNet-18 without DenseASPP, 64x128, no perceptual loss; 7+3 planes (+4
yz at yz_min 1.0, as the JAX package's rescue tests place them), and 7
vertical planes under render_probability.  With ground or side planes the
compositing is ill-conditioned: the distance from the farthest vertical
plane to a nearer ground plane is negative, so ``alpha = 1 - exp(-relu(l) *
d)`` grows without bound (at init, pi reaches ~1e8 and disp ~1e5 at
640x192) and the mixture's plane sum cancels.  There two float32 steps part
by ~1e-3 (at 7+3 planes the JAX step's smoothness loss stands 1.3e-3 off
the port's float64 step, the port's float32 step 1.4e-4), so the render
cases are held on the well-conditioned volume; the render head epilogue's
N - 1 mask slicing is held on its own below.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planedepth_tpu import config as jcfg
from planedepth_tpu.data.synthetic import make_stereo_batch
from planedepth_tpu.geometry.warp import disp_warp_coords as jax_disp_warp_coords
from planedepth_tpu.ops.sampling import shift_sample_x
from planedepth_tpu.models.depth_decoder import plane_dists as jax_plane_dists
from planedepth_tpu.models.depth_decoder import (
    render_probability_from_logits as jax_render,
)
from planedepth_tpu.train import ModelBundle as JaxBundle
from planedepth_tpu_torch import config as tcfg
from planedepth_tpu_torch.geometry.warp import disp_warp_coords
from planedepth_tpu_torch.models.depth_decoder import (
    plane_dists,
    render_probability_from_logits,
)
from planedepth_tpu_torch.models.factory import DepthModel
from planedepth_tpu_torch.ops.head_epilogue import head_epilogue
from planedepth_tpu_torch.ops.sampling import shift_sample_planes
from planedepth_tpu_torch.ops.warp2d import warp2d
from planedepth_tpu_torch.train.mono import fused_warp2d_ok
from planedepth_tpu_torch.train.step import fused_sweep_ok
from planedepth_tpu_torch.utils.weights import load_jax_params
from tests._torch_parity import (
    assert_grads_match,
    grads_as_port,
    inputs,
    jax_losses_and_grads,
    nchw,
    perturbed_init,
    port_losses_and_grads,
)

pytestmark = pytest.mark.heavy
torch.set_num_threads(1)

H, W = 64, 128
CPU = torch.device("cpu")
TOL = dict(rtol=1e-3, atol=1e-3)
PLANES = dict(disp_levels=7, disp_min=2, disp_max=16, yz_min=1.0)


def _configs(render=False, yz=0, mixture=True, net_type="ResNet", distill=0.0):
    planes = dict(PLANES, yz_levels=yz, xz_levels=0 if render else 3)
    model = dict(net_type=net_type, num_layers=18, use_denseaspp=False,
                 use_mixture_loss=mixture, plane_residual=True, num_ep=0,
                 render_probability=render)
    common = dict(batch_size=1, flip_right=True, warp_type="disp_warp")
    j = jcfg.TrainConfig(
        model=jcfg.ModelConfig(planes=jcfg.PlaneConfig(**planes), **model),
        loss=jcfg.LossConfig(alpha_pc=0.0, automask=True, self_distillation=distill),
        data=jcfg.DataConfig(height=H, width=W), bf16=False, fused_sweep=False, **common)
    t = tcfg.TrainConfig(
        bf16=False,
        model=tcfg.ModelConfig(planes=tcfg.PlaneConfig(**planes), **model),
        loss=tcfg.LossConfig(alpha_pc=0.0, automask=True, self_distillation=distill),
        data=tcfg.DataConfig(height=H, width=W), fused_sweep=True, **common)
    return j, t


def _logits_dists(seed=0):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0.0, 2.0, (2, 6, 5, 7)).astype(np.float32)
    logits[:, 2] = 0.0                       # a masked plane: zero alpha
    dists = rng.uniform(-0.2, 3.0, (2, 6, 5, 7)).astype(np.float32)
    return logits, dists


def test_head_epilogue_masks_n_minus_1_logits():
    """Under render_probability the logits head has N - 1 planes beside the
    N of the mask and sigma: the epilogue masks them with the mask's first
    N - 1 planes, with either mask shape."""
    g = torch.Generator().manual_seed(0)
    raw_l, raw_s = torch.randn(2, 5, 4, 8, generator=g), torch.randn(2, 6, 4, 8, generator=g)
    for mask in ((torch.rand(2, 6, 4, 1, generator=g) > 0.4).float(),
                 (torch.rand(2, 6, 4, 8, generator=g) > 0.4).float()):
        logits, sigma = head_epilogue(raw_l, raw_s, mask)
        torch.testing.assert_close(logits, raw_l * mask[:, :5], rtol=0, atol=0)
        torch.testing.assert_close(sigma, torch.sigmoid(raw_s).clamp(0.01, 1.0), rtol=0,
                                   atol=0)
        logits, none = head_epilogue(raw_l, None, mask)
        assert none is None
        torch.testing.assert_close(logits, raw_l * mask[:, :5], rtol=0, atol=0)


def test_render_probability_from_logits_matches_jax():
    logits, dists = _logits_dists()
    ct = np.random.default_rng(1).normal(size=(2, 7, 5, 7)).astype(np.float32)
    to_nhwc = lambda a: jnp.asarray(np.moveaxis(a, 1, -1))
    want, vjp = jax.vjp(jax.jit(jax_render), to_nhwc(logits), to_nhwc(dists))
    d_want = [np.moveaxis(np.asarray(d), -1, 1) for d in vjp(to_nhwc(ct))]
    lt, dt = (torch.from_numpy(a).requires_grad_() for a in (logits, dists))
    got = render_probability_from_logits(lt, dt)
    d_got = torch.autograd.grad(got, (lt, dt), torch.from_numpy(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.moveaxis(np.asarray(want), -1, 1),
                               rtol=1e-5, atol=1e-6)
    for name, a, b in zip(("d_logits", "d_dists"), d_got, d_want):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-6, err_msg=name)
    # the last plane's alpha is 1: every pixel's weights sum to 1
    np.testing.assert_allclose(got.detach().sum(1).numpy(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("full", [False, True], ids=["row_constant", "yz"])
def test_plane_dists_matches_jax(full):
    rng = np.random.default_rng(2)
    B, N, h, w = 2, 6, 8, 12
    disp = rng.uniform(2.0, 40.0, (B, N, h, w if full else 1)).astype(np.float32)
    ct = rng.normal(size=(B, N - 1, h, w)).astype(np.float32)
    jd = jnp.asarray(np.moveaxis(np.broadcast_to(disp, (B, N, h, w)), 1, -1))
    want, vjp = jax.vjp(jax.jit(lambda d: jax_plane_dists(d, w, h)), jd)
    (d_want,) = vjp(jnp.asarray(np.moveaxis(ct, 1, -1)))
    dt = torch.from_numpy(disp).requires_grad_()
    got = plane_dists(dt, w, h)
    (d_got,) = torch.autograd.grad(got, dt, torch.from_numpy(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.moveaxis(np.asarray(want), -1, 1),
                               rtol=1e-5, atol=1e-6)
    d_want = np.moveaxis(np.asarray(d_want), -1, 1)
    if not full:                             # the row-constant map sums its row
        d_want = d_want.sum(-1, keepdims=True)
    np.testing.assert_allclose(d_got.numpy(), d_want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("full", [False, True], ids=["row_constant", "yz"])
@pytest.mark.parametrize("side", ["l", "r"])
def test_disp_warp_coords_match_jax(side, full):
    """The stereo plane-sweep coordinates ``x -/+ disp`` of either side,
    from a row-constant or a full disparity volume."""
    rng = np.random.default_rng(3)
    B, N, h, w = 2, 5, 6, 9
    disp = rng.uniform(0.5, 12.0, (B, N, h, w if full else 1)).astype(np.float32)
    want = jax.jit(jax_disp_warp_coords, static_argnums=(1, 2, 3))(
        jnp.asarray(np.moveaxis(np.broadcast_to(disp, (B, N, h, w)), 1, -1)), side, w, h)
    got = disp_warp_coords(torch.from_numpy(disp), side, w, h)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="stereo side"):
        disp_warp_coords(torch.from_numpy(disp), -1, w, h)


def test_shift_per_pixel_matches_jax():
    """The teacher's per-pixel shift over yz planes: JAX's XLA
    ``shift_sample_x`` (zero padding, no clip), past both edges."""
    rng = np.random.default_rng(4)
    B, N, h, w = 2, 3, 5, 11
    maps = rng.random((B, N, h, w), dtype=np.float32)
    shift = rng.uniform(-14.0, 14.0, (B, N, h, w)).astype(np.float32)
    want = jax.jit(jax.vmap(lambda m, s: shift_sample_x(m[..., None], s[:, None])[:, 0, ..., 0],
                            in_axes=(1, 1), out_axes=1))(jnp.asarray(maps), jnp.asarray(shift))
    got = shift_sample_planes(torch.from_numpy(maps), torch.from_numpy(shift))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("net_type,yz", [("ResNet", 0), ("PladeNet", 0)],
                         ids=["resnet", "pladenet"])
def test_forward_matches_jax(net_type, yz):
    """Eval forward with render_probability: the N - 1 density planes
    (masked by the head epilogue in the ResNet decoder, unmasked in
    PladeNet), the appended plane of ones, dists, the composited
    probability, its mixture reweight and disp."""
    jc, tc = _configs(render=True, yz=yz, net_type=net_type)
    bundle = JaxBundle(jc)
    params, stats, _ = perturbed_init(bundle, 0, H, W)
    image, grid = inputs(2, H, W)
    want, _ = jax.jit(lambda i, g: bundle.depth_forward(params, stats, i, g, train=False))(
        jnp.asarray(image), jnp.asarray(grid))
    port = DepthModel(tc.model)
    load_jax_params(port, params["model"], stats["model"])
    launches = head_epilogue.fwd_launches
    with torch.inference_mode():
        got = port.eval()(nchw(image), nchw(grid))
    assert head_epilogue.fwd_launches == launches                 # CPU: plain path
    N = tc.model.planes.all_levels
    assert got["logits"].shape[1] == N and got["dists"].shape[1] == N - 1
    assert bool((got["logits"][:, -1] == 1).all())
    for key in ("logits", "dists", "pi", "sigma", "probability", "disp", "depth"):
        np.testing.assert_allclose(got[key].numpy(), np.moveaxis(np.asarray(want[key]), -1, 1),
                                   err_msg=key, **TOL)


@pytest.fixture(scope="module", params=[
    dict(render=True), dict(yz=4), dict(render=True, mixture=False), dict(yz=4, mixture=False),
    dict(yz=4, distill=1.0)],
    ids=["render", "yz", "render_nomix", "yz_nomix", "yz_distill"])
def rescue(request):
    """One training forward and backward of each package from the same
    perturbed weights on the flipped stereo batch, and the port's in
    float64; ``yz_distill`` adds the frozen teacher (the same weights), its
    post-processed disparity and occlusion mask over yz planes."""
    jc, tc = _configs(**request.param)
    assert fused_warp2d_ok(tc) and not fused_sweep_ok(tc)
    bundle = JaxBundle(jc)
    params, stats, _ = perturbed_init(bundle, 0, H, W)
    batch = make_stereo_batch(jc.batch_size, H, W, seed=4)
    losses_j, grads_j = jax_losses_and_grads(bundle, params, stats, None, batch,
                                             teacher=jc.loss.self_distillation > 0)
    counts = lambda: (warp2d.fwd_launches, warp2d.bwd_launches, warp2d.nosigma_fwd_launches,
                      warp2d.nosigma_bwd_launches, head_epilogue.fwd_launches,
                      head_epilogue.bwd_launches)
    before = counts()
    losses, grads, port = port_losses_and_grads(tc, params, stats, None, batch)
    assert counts() == before
    _, grads64, _ = port_losses_and_grads(tc, params, stats, None, batch, torch.float64)
    return {"tc": tc, "losses": losses, "losses_j": losses_j, "grads": grads,
            "grads_j": grads_as_port(port.model.cfg, grads_j, stats["model"]),
            "grads64": grads64, "port": port}


def test_rescue_losses_match_jax(rescue):
    assert set(rescue["losses"]) == set(rescue["losses_j"])
    for k in rescue["losses"]:
        np.testing.assert_allclose(rescue["losses"][k], float(rescue["losses_j"][k]),
                                   rtol=2e-4, err_msg=k)


def test_rescue_gradients_match_jax(rescue):
    """Every gradient leaf, the plane-residual head's among them: its
    gradient reaches the warp's dx through ``disp_warp_shift``."""
    assert_grads_match(rescue["grads"], rescue["grads_j"], rescue["grads64"],
                       rescue["tc"].model.use_mixture_loss)
    residual = rescue["port"].model.depth.convs["residualconv"][2].weight.grad
    assert float(residual.abs().max()) > 0


def test_rescue_predicates():
    """The sweep keeps every recipe it can take; the 2-D warp takes the
    stereo disp_warp recipes with render_probability or yz planes."""
    _, tc = _configs()
    assert fused_sweep_ok(tc) and not fused_warp2d_ok(tc)
    for kw in (dict(render=True), dict(yz=4), dict(render=True, yz=4, mixture=False)):
        _, tc = _configs(**kw)
        assert fused_warp2d_ok(tc) and not fused_sweep_ok(tc)
        assert not fused_warp2d_ok(dataclasses.replace(
            tc, loss=dataclasses.replace(tc.loss, use_mom=True)))
