"""The oracle view synthesis's modules in the port against the JAX package.

- ``pred_novel_images`` for each warp (stereo ``disp_warp`` to 'r' and 'l';
  its temporal side through the depth warp's coordinates; ``depth_warp``;
  ``homography_warp`` with its padding mask), with and without the mixture
  and under ``render_probability``, then ``compute_losses`` on its output
  (automask, ``mask_novel``, ``alpha_self``, ``self_distillation``): every
  reconstruction at rtol 1e-4, atol 1e-5 (the JAX side under ``jax.jit``,
  whose fusions round the homography's 3x3 inverse differently),
  the losses at rtol 1e-5, and the gradient of the total loss in the plane
  heads (logits, sigma) and the plane geometry (the disparities, or the
  homography's distances and normals) at 1e-4 of each gradient's largest
  magnitude, on the same seeded inputs (NCHW here, NHWC there); with
  ``sample_dtype=bf16`` (``warp_sample_bf16``) the bf16 samples (and the
  logits and sigma upcast from them) within one bf16 ulp plus that
  tolerance, what is computed from them in float32 at rtol = atol = 1e-3, the losses at rtol 1e-3 and the gradients at 1e-2 of
  scale (the two frameworks round the bf16 products at other places);
- ``multimodal_nll`` (Laplace and Gaussian), ``smooth_loss_probability``,
  ``depth_to_disp`` and the 1-D/2-D samplers of ``ops/sampling.py``;
- ``Resnet18Features`` on the JAX module's variables (BatchNorm statistics
  perturbed, so a dropped leaf shows), through ``load_jax_pc_params``;
- the structured-scene copy of ``data/synthetic.py``, bit-equal.

The 2-D warps' poses are turned slightly off pure translations, so no
sample falls on an integer coordinate, where the bilinear gradient is a
one-sided subgradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planedepth_tpu import config as jcfg
from planedepth_tpu.data import synthetic as jsynthetic
from planedepth_tpu.geometry.camera import depth_to_disp as jax_depth_to_disp
from planedepth_tpu.geometry.pose import transformation_from_parameters
from planedepth_tpu.models.perceptual import Resnet18Features as JaxResnet18Features
from planedepth_tpu.ops import losses as jlosses
from planedepth_tpu.ops import sampling as jsampling
from planedepth_tpu.train.losses import compute_losses as jax_compute_losses
from planedepth_tpu.train.view_synthesis import pred_novel_images as jax_pred_novel_images
from planedepth_tpu_torch import config as tcfg
from planedepth_tpu_torch.data import synthetic
from planedepth_tpu_torch.geometry.camera import depth_to_disp
from planedepth_tpu_torch.models.perceptual import Resnet18Features, make_perceptual_net
from planedepth_tpu_torch.ops import losses
from planedepth_tpu_torch.ops import sampling
from planedepth_tpu_torch.train.losses import compute_losses
from planedepth_tpu_torch.train.view_synthesis import pred_novel_images
from planedepth_tpu_torch.utils.weights import load_jax_pc_params
from tests._torch_parity import _perturb, _stats_rule

torch.set_num_threads(1)

B, N, H, W = 2, 5, 8, 24
TOL = dict(rtol=1e-5, atol=1e-5)
REC_TOL = dict(rtol=1e-4, atol=1e-5)
nhwc = lambda a: jnp.asarray(np.moveaxis(a, 1, -1))          # (B, C, H, W) -> NHWC
planes_last = lambda a: np.moveaxis(np.broadcast_to(a, (B, N, H, W)), 1, -1)


def _pose(seed, tx):
    r = np.random.default_rng(seed).uniform(-0.004, 0.004, (2, 3)).astype(np.float32)
    Rt = transformation_from_parameters(jnp.asarray(r[None, :1]), jnp.asarray(r[None, 1:]))
    Rt = np.array(Rt).repeat(B, 0)
    Rt[:, 0, 3] += tx
    return Rt


@pytest.fixture(scope="module")
def scene():
    """Plane heads and geometry of the decoder's shapes (3 vertical planes,
    2 ground planes whose disparity grows down the rows), the images, the
    poses and the losses' extra inputs, as numpy."""
    rng = np.random.default_rng(0)
    batch = jsynthetic.make_stereo_batch(B, H, W, seed=1, novel_frame_ids=(-1, 1))
    disp = np.concatenate([rng.uniform(1.0, 9.0, (B, 3, 1, 1)).repeat(H, 2),
                           rng.uniform(0.5, 3.0, (B, 2, 1, 1))
                           + 0.7 * np.arange(H)[None, None, :, None]], 1)
    return {
        "batch": batch,
        "logits": rng.normal(0.0, 2.0, (B, N, H, W)).astype(np.float32),
        "sigma": rng.uniform(0.0, 1.05, (B, N, H, W)).astype(np.float32),
        "disp": disp.astype(np.float32),                                # (B, N, H, 1)
        "pmask": (rng.uniform(size=(B, N, H, 1)) > 0.15).astype(np.float32),
        "distance": rng.uniform(2.0, 20.0, (B, N)).astype(np.float32),
        "norm": (np.array([0.0, 0.0, 1.0]) + rng.normal(0.0, 0.1, (B, N, 3))).astype(
            np.float32),
        "dists": rng.uniform(0.0, 2.0, (B, N - 1, H, W)).astype(np.float32),
        "disp_out": rng.uniform(1.0, 9.0, (B, 1, H, W)).astype(np.float32),
        "disp_pp": rng.uniform(1.0, 9.0, (B, 1, H, W)).astype(np.float32),
        "mask_novel": rng.uniform(0.0, 1.0, (B, 1, H, W)).astype(np.float32),
        "self_rec": rng.uniform(0.0, 1.0, (B, 3, H, W)).astype(np.float32),
        "poses": {"r": _pose(2, -0.1), "l": _pose(3, 0.1), -1: _pose(4, -0.03),
                  1: _pose(5, 0.02)},
    }


CASES = {
    # id: (warp_type, sides, mixture, render, loss switches[, bf16 samples])
    "disp_r_l": ("disp_warp", ("r", "l"), True, False, dict(automask=True, alpha_self=0.1)),
    "disp_temporal": ("disp_warp", ("r", -1), True, False,
                      dict(automask=True, self_distillation=0.5)),
    "depth_warp": ("depth_warp", ("r",), True, False, dict(automask=False)),
    "homography": ("homography_warp", ("r", 1), True, False, dict(automask=True)),
    "nomix_mask_novel": ("disp_warp", ("r",), False, False, dict(automask=True)),
    "render": ("disp_warp", ("r",), True, True, dict(automask=True)),
    "disp_temporal_bf16": ("disp_warp", ("r", -1), True, False, dict(automask=True), True),
    "homography_bf16": ("homography_warp", ("r",), True, False, dict(automask=True), True),
}


@pytest.fixture(scope="module")
def resnet18_pc():
    """The JAX ``Resnet18Features`` variables (BatchNorm statistics
    perturbed) and the port's net on them."""
    net = JaxResnet18Features()
    variables = jax.jit(net.init)(jax.random.PRNGKey(3), jnp.zeros((1, H, W, 3)))
    variables = jax.tree.map(np.asarray, variables)
    rng = np.random.default_rng(4)
    variables = {"params": variables["params"],
                 "batch_stats": _perturb(variables["batch_stats"], rng, _stats_rule)}
    port = make_perceptual_net("resnet18")
    load_jax_pc_params(port, variables)
    return net, variables, port


@pytest.mark.parametrize("case", list(CASES))
def test_pred_novel_images_and_compute_losses_match_jax(scene, case):
    warp_type, sides, mix, render, switches, *bf16 = CASES[case]
    sample_dtype = (jnp.bfloat16, torch.bfloat16) if bf16 else (None, None)
    s, batch = scene, scene["batch"]
    jloss, tloss = (c.LossConfig(alpha_pc=0.0, **switches) for c in (jcfg, tcfg))
    logits = s["logits"] * s["pmask"]
    if render:
        logits[:, -1] = 1.0                        # the appended plane of ones
    cams = {k: batch[k] for k in ("K", "inv_K")}
    poses = {side: s["poses"][side] for side in sides}
    extra = {}
    if warp_type != "homography_warp":
        extra["mask_novel"] = s["mask_novel"] if case == "nomix_mask_novel" else None
    extra = {k: v for k, v in extra.items() if v is not None}
    if switches.get("self_distillation"):
        extra["disp_pp"] = s["disp_pp"]

    def jax_total(lg, sg, dsp, dist, nrm):
        outputs = {"logits": lg, "sigma": sg, "disp_layered": dsp, "distance": dist,
                   "norm": nrm, "padding_mask": jnp.asarray(planes_last(s["pmask"])),
                   "dists": nhwc(s["dists"]), "disp": nhwc(s["disp_out"]),
                   **{k: nhwc(v) for k, v in extra.items()}}
        rec = jax_pred_novel_images(
            outputs, jnp.asarray(batch["color_l"]), sides,
            {k: jnp.asarray(v) for k, v in poses.items()},
            *(jnp.asarray(cams[k]) for k in ("K", "inv_K")), warp_type=warp_type,
            use_mixture_loss=mix, render_probability=render, sample_dtype=sample_dtype[0])
        if switches.get("alpha_self"):
            rec[("self_rec", "r")] = nhwc(s["self_rec"])
        out = jax_compute_losses(
            jloss, sides, {k: jnp.asarray(v) for k, v in batch.items()}, outputs, rec,
            None, jloss.alpha_pc, jloss.alpha_smooth, jloss.gamma_smooth,
            jloss.alpha_self, jloss.self_distillation, jloss.automask, mix)
        # string keys: the sides mix names and frame ids, which a pytree sorts
        return out["loss/total_loss"], ({f"{k}|{side}": v for (k, side), v in rec.items()},
                                         out)

    heads = [nhwc(logits), nhwc(s["sigma"]), jnp.asarray(planes_last(s["disp"])),
             jnp.asarray(s["distance"]), jnp.asarray(s["norm"])]
    (_, (jrec, jlosses_)), jgrads = jax.jit(jax.value_and_grad(
        jax_total, argnums=(0, 1, 2, 3, 4), has_aux=True))(*heads)

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    lg, sg, dsp, dist, nrm = (t(a).requires_grad_() for a in (
        logits, s["sigma"], s["disp"], s["distance"], s["norm"]))
    outputs = {"logits": lg, "sigma": sg, "disp_layered": dsp, "distance": dist, "norm": nrm,
               "padding_mask": t(s["pmask"]), "dists": t(s["dists"]),
               "disp": t(s["disp_out"]), **{k: t(v) for k, v in extra.items()}}
    tbatch = {k: (t(np.moveaxis(v, -1, 1)) if v.ndim == 4 else t(v)) for k, v in batch.items()}
    rec = pred_novel_images(outputs, tbatch["color_l"], sides,
                            {k: t(v) for k, v in poses.items()}, tbatch["K"],
                            tbatch["inv_K"], warp_type=warp_type, use_mixture_loss=mix,
                            render_probability=render, sample_dtype=sample_dtype[1])
    for (name, side), got in rec.items():
        want = np.asarray(jrec[f"{name}|{side}"].astype(jnp.float32))
        want = np.moveaxis(want, -1, 2 if name == "rgb_rec_layered" else 1)
        assert str(jrec[f"{name}|{side}"].dtype) == str(got.dtype).split(".")[-1], name
        if bf16 and name in ("pi_rec", "probability_rec", "rgb_rec"):
            # from bf16 samples: a sample one ulp apart on either side moves
            # a logit ~4 by 1.6e-2 and pi by up to ~4e-3
            np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-3, atol=1e-3,
                                       err_msg=f"{name} {side}")
            continue
        if bf16:
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
            err = np.abs(got.detach().float().numpy() - want)
            over = err - (REC_TOL["atol"] + REC_TOL["rtol"] * np.abs(want) + ulp)
            assert (over <= 0).all(), (name, side, float(over.max()), float((over > 0).mean()))
            continue
        np.testing.assert_allclose(got.detach().numpy(), want, err_msg=f"{name} {side}",
                                   **REC_TOL)
    if switches.get("alpha_self"):
        rec[("self_rec", "r")] = t(s["self_rec"])
    assert {f"{k}|{side}" for k, side in rec} == set(jrec)
    got = compute_losses(tloss, sides, tbatch, outputs, rec, None, mix)
    assert set(got) == set(jlosses_)
    for k, v in got.items():
        np.testing.assert_allclose(float(v.detach()), float(jlosses_[k]),
                                   rtol=1e-3 if bf16 else 1e-5, err_msg=k)
    grads = torch.autograd.grad(got["loss/total_loss"], (lg, sg, dsp, dist, nrm),
                                allow_unused=True)
    want_grads = [np.moveaxis(np.asarray(jgrads[0]), -1, 1),
                  np.moveaxis(np.asarray(jgrads[1]), -1, 1),
                  np.moveaxis(np.asarray(jgrads[2]), -1, 1).sum(-1, keepdims=True),
                  np.asarray(jgrads[3]), np.asarray(jgrads[4])]
    names = ("d_logits", "d_sigma", "d_disp_layered", "d_distance", "d_norm")
    for name, g, w in zip(names, grads, want_grads):
        if np.abs(w).max() == 0:
            assert g is None or float(g.abs().max()) == 0, name
            continue
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=(1e-2 if bf16 else 1e-4) * np.abs(w).max(),
                                   err_msg=name)
    moved = [n for n, w in zip(names, want_grads) if np.abs(w).max() > 0]
    assert ("d_distance" in moved) == (warp_type == "homography_warp") and "d_logits" in moved


def test_oracle_refuses_what_is_not_ported(scene):
    outputs = {"logits": torch.zeros(B, N, H, W), "disp_layered": torch.ones(B, N, H, 1)}
    image, K = torch.zeros(B, 3, H, W), torch.eye(4).expand(B, 4, 4)
    with pytest.raises(NotImplementedError, match="row-shift"):
        pred_novel_images(outputs, image, ("r",), {}, K, K, rowshift=True)


@pytest.mark.parametrize("dist", ["lap", "gaussian"])
def test_multimodal_nll_matches_jax(dist):
    rng = np.random.default_rng(7)
    err = rng.uniform(0.0, 1.0, (B, N, H, W)).astype(np.float32)
    sigma = rng.uniform(0.01, 1.0, (B, N, H, W)).astype(np.float32)
    pi = rng.dirichlet(np.ones(N), (B, H, W)).astype(np.float32)
    ct = rng.normal(size=(B, 1, H, W)).astype(np.float32)
    want, vjp = jax.vjp(lambda e, s: jlosses.multimodal_nll(e, s, jnp.asarray(pi), dist=dist),
                        nhwc(err), nhwc(sigma))
    d_want = [np.moveaxis(np.asarray(d), -1, 1) for d in vjp(nhwc(ct))]
    et, st = (torch.from_numpy(a).requires_grad_() for a in (err, sigma))
    got = losses.multimodal_nll(et, st, torch.from_numpy(np.moveaxis(pi, -1, 1)), dist=dist)
    d_got = torch.autograd.grad(got, (et, st), torch.from_numpy(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.moveaxis(np.asarray(want), -1, 1),
                               **TOL)
    for name, a, b in zip(("d_err", "d_sigma"), d_got, d_want):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-5, err_msg=name)


def test_smooth_loss_probability_and_depth_to_disp_match_jax(scene):
    rng = np.random.default_rng(8)
    prob = rng.dirichlet(np.ones(N), (B, H, W)).astype(np.float32)         # (B, H, W, N)
    img = scene["batch"]["color_l"]
    want, vjp = jax.vjp(lambda p: jlosses.smooth_loss_probability(
        p, jnp.asarray(planes_last(scene["disp"])), jnp.asarray(img), 2.0), jnp.asarray(prob))
    pt = torch.from_numpy(np.ascontiguousarray(np.moveaxis(prob, -1, 1))).requires_grad_()
    got = losses.smooth_loss_probability(pt, torch.from_numpy(scene["disp"]),
                                         torch.from_numpy(np.moveaxis(img, -1, 1)), 2.0)
    (d_got,) = torch.autograd.grad(got, pt)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(d_got.numpy(), np.moveaxis(np.asarray(vjp(1.0)[0]), -1, 1),
                               rtol=1e-4, atol=1e-6)
    depth = rng.uniform(0.5, 80.0, (B, 1, H, W)).astype(np.float32)
    np.testing.assert_allclose(depth_to_disp(torch.from_numpy(depth), W).numpy(),
                               np.asarray(jax_depth_to_disp(jnp.asarray(depth), W)), rtol=1e-6)


def test_samplers_match_jax(scene):
    """``shift_sample_x`` past both edges, ``grid_sample`` with either
    padding (coordinates inside and past the image) and
    ``grid_sample_planes``."""
    rng = np.random.default_rng(9)
    image = scene["batch"]["color_l"]                                      # (B, H, W, 3)
    shift = rng.uniform(-30.0, 30.0, (B, N, H, W)).astype(np.float32)
    want = np.asarray(jax.jit(jsampling.shift_sample_x)(jnp.asarray(image),
                                                         jnp.asarray(shift)))
    got = sampling.shift_sample_x(torch.from_numpy(np.moveaxis(image, -1, 1)),
                                  torch.from_numpy(shift))
    np.testing.assert_allclose(got.numpy(), np.moveaxis(want, -1, 2), **TOL)
    coords = rng.uniform(-1.3, 1.3, (B, N, H, W, 2)).astype(np.float32)
    want = np.asarray(jax.jit(jsampling.grid_sample_planes)(jnp.asarray(image),
                                                             jnp.asarray(coords)))
    got = sampling.grid_sample_planes(torch.from_numpy(np.moveaxis(image, -1, 1)),
                                      torch.from_numpy(coords))
    np.testing.assert_allclose(got.numpy(), np.moveaxis(want, -1, 2), **TOL)
    for mode in ("zeros", "border"):
        want = np.asarray(jax.jit(jsampling.grid_sample, static_argnums=2)(
            jnp.asarray(image), jnp.asarray(coords[:, 0]), mode))
        got = sampling.grid_sample(torch.from_numpy(np.moveaxis(image, -1, 1)),
                                   torch.from_numpy(coords[:, 0]), mode)
        np.testing.assert_allclose(got.numpy(), np.moveaxis(want, -1, 1), err_msg=mode, **TOL)


def test_resnet18_features_match_jax(resnet18_pc):
    net, variables, port = resnet18_pc
    image = np.random.default_rng(10).random((2, 32, 48, 3), dtype=np.float32)
    want = jax.jit(net.apply)(variables, jnp.asarray(image))
    got = port(torch.from_numpy(np.ascontiguousarray(np.moveaxis(image, -1, 1))))
    assert len(got) == len(want) == 3
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.moveaxis(np.asarray(w), -1, 1), rtol=1e-4,
                                   atol=1e-4, err_msg=f"feature {i}")
    assert not any(p.requires_grad for p in port.parameters()) and not port.train().training
    assert isinstance(port, Resnet18Features)
    with pytest.raises(ValueError, match="unknown perceptual net"):
        make_perceptual_net("alexnet")


def test_structured_batch_is_bit_equal():
    for name in ("structured_disparity", "structured_left_gt"):
        for a, b in zip(np.atleast_1d(getattr(synthetic, name)(40, 56)),
                        np.atleast_1d(getattr(jsynthetic, name)(40, 56))):
            np.testing.assert_array_equal(a, b, err_msg=name)
    got = synthetic.make_structured_batch(2, 32, 48, seed=3)
    want = jsynthetic.make_structured_batch(2, 32, 48, seed=3)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
