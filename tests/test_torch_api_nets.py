"""The networks kept for API parity against their JAX modules, on carried weights.

``PladePoseNet`` (with and without BatchNorm), ``Monov2Decoder`` and
``DepthDecoderContinuous`` get seeded numpy weights in the trees of their
flax modules (every leaf: kernels, biases, BatchNorm scales and
statistics), carried into the port with ``utils/weights.py``; both then run
the same seeded numpy inputs, the JAX module under ``jax.jit``.  Float32
convolutions in two libraries sum in another order: outputs agree at rtol =
atol = 1e-4 (of the output's largest magnitude for the pose, whose
0.01-scaled mean is near 0).  In training
mode ``PladePoseNet``'s shared stage convs run once an image, and flax,
like torch and the reference, updates their BatchNorm statistics on every
call: the running means agree, and the running variances part by torch's
unbiased n / (n - 1) on each update (ROADMAP C3).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planedepth_tpu.config import PlaneConfig as JaxPlaneConfig
from planedepth_tpu.models.depth_decoder import DepthDecoderContinuous as JaxContinuous
from planedepth_tpu.models.monov2_decoder import Monov2Decoder as JaxMonov2
from planedepth_tpu.models.pose_net import PladePoseNet as JaxPladePose
from planedepth_tpu_torch.config import PlaneConfig
from planedepth_tpu_torch.models.depth_decoder import DepthDecoderContinuous
from planedepth_tpu_torch.models.monov2_decoder import Monov2Decoder
from planedepth_tpu_torch.models.pose_net import PladePoseNet
from planedepth_tpu_torch.utils.weights import (
    jax_leaf_shapes,
    load_jax_continuous_params,
    load_jax_monov2_params,
    load_jax_plade_pose_params,
)
from tests._torch_parity import _param_rule, _stats_rule, nchw

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)
ENC_CH = (64, 64, 128, 256, 512)                 # ResNet-18's pyramid
H, W = 64, 128


def _features(seed, batch=1):
    """A ResNet-18-shaped pyramid for an H x W image, NHWC numpy."""
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, (batch, H >> (i + 1), W >> (i + 1), c)).astype(np.float32)
            for i, c in enumerate(ENC_CH)]


def _grid(seed, batch=1):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (batch, H, W, 2)).astype(np.float32)


def _variables(module, seed, *args, **kw):
    """Seeded numpy ``params`` and ``batch_stats`` trees of the flax
    ``module``'s structure (``jax.eval_shape`` of its init, which compiles
    nothing): kernels normal with variance 1 / fan-in, biases, BatchNorm
    scales and statistics perturbed as ``tests/_torch_parity.py`` perturbs
    an initialised tree."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kw))

    def fill(node, name=""):
        if isinstance(node, dict):
            return {k: fill(v, k) for k, v in node.items()}
        if name == "kernel":
            return rng.normal(0, 1 / np.sqrt(np.prod(node.shape[:-1])),
                              node.shape).astype(np.float32)
        init = {"bias": np.zeros, "scale": np.ones, "mean": np.zeros, "var": np.ones}
        value = init[name](node.shape, np.float32)
        return (_stats_rule if name in ("mean", "var") else _param_rule)(name, value, rng)

    return fill(shapes["params"]), fill(shapes.get("batch_stats", {}))


def _flat_shapes(trees):
    """``collection/module/.../leaf`` -> shape of the JAX trees."""
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                out[prefix + k] = tuple(np.shape(v))

    for collection, tree in trees.items():
        walk(tree, f"{collection}/")
    return out


def _assert_every_leaf_maps(port, params, stats):
    """The port's leaves are the JAX module's, shape for shape."""
    assert jax_leaf_shapes(port) == _flat_shapes(
        {"params": params, **({"batch_stats": stats} if stats else {})})


def _close(got, want, scale=1.0):
    np.testing.assert_allclose(got, want, rtol=TOL["rtol"], atol=TOL["atol"] * scale)


def test_monov2_decoder_matches_jax():
    module = JaxMonov2(num_ch_enc=ENC_CH)
    feats = [jnp.asarray(f) for f in _features(1)]
    params, _ = _variables(module, 2, feats)
    want = jax.jit(module.apply)({"params": params}, feats)
    port = Monov2Decoder(ENC_CH)
    _assert_every_leaf_maps(port, params, {})
    load_jax_monov2_params(port, params)
    with torch.no_grad():
        got = port([nchw(f) for f in _features(1)])
    assert sorted(got) == sorted(want) == [("disp", i) for i in range(4)]
    for key, value in want.items():
        assert got[key].dtype == torch.float32
        _close(got[key].numpy(), np.moveaxis(np.asarray(value), -1, 1))


def _bn_moments(model):
    """Records each BatchNorm2d call's biased batch variance and count."""
    calls = {}

    def hook(mod, args, name):
        x = args[0].detach().double()
        calls.setdefault(name, []).append(
            (x.var(dim=(0, 2, 3), unbiased=False), x.numel() // x.shape[1]))

    for name, mod in model.named_modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            mod.register_forward_pre_hook(functools.partial(hook, name=name))
    return calls


@pytest.mark.parametrize("batch_norm", [True, False])
def test_plade_pose_net_matches_jax(batch_norm):
    """Eval-mode poses, then one training-mode call: its poses (batch
    moments) and, with BatchNorm, the running statistics it leaves."""
    B = 2
    module = JaxPladePose(batch_norm=batch_norm, num_ep=8)
    rng = np.random.default_rng(5)
    x, y = (rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32) for _ in range(2))
    grid = _grid(6, B)
    jin = (jnp.asarray(x), jnp.asarray(y), jnp.asarray(grid))
    params, stats = _variables(module, 7, *jin, train=False)
    variables = {"params": params, **({"batch_stats": stats} if batch_norm else {})}
    want_eval = jax.jit(module.apply, static_argnames="train")(variables, *jin, train=False)
    want_train, updated = jax.jit(lambda v, *a: module.apply(
        v, *a, train=True, mutable=["batch_stats"]))(variables, *jin)

    port = PladePoseNet(batch_norm=batch_norm, num_ep=8)
    _assert_every_leaf_maps(port, params, stats)
    load_jax_plade_pose_params(port, params, stats)
    tin = (nchw(x), nchw(y), nchw(grid))
    with torch.no_grad():
        got_eval = port.eval()(*tin)
        calls = _bn_moments(port)
        got_train = port.train()(*tin)
    for got, want in ((got_eval, want_eval), (got_train, want_train)):
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert g.shape == (B, 1, 1, 3)
            _close(g.numpy(), w, float(np.abs(w).max()))
    if not batch_norm:
        assert not calls and not updated
        return
    # the stage convs of both images update twice, conv6 once
    assert {len(v) for v in calls.values()} == {1, 2}
    new = {k: v.detach().numpy() for k, v in port.state_dict().items()}
    for name, moments in calls.items():
        node = updated["batch_stats"]
        for part in name.split(".") + ["bn"]:
            node = node[part]
        np.testing.assert_allclose(new[f"{name}.running_mean"], np.asarray(node["mean"]),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
        # torch: r <- 0.9 r + 0.1 v n / (n - 1) on each call; flax the same
        # with v; the two part by 0.1 v / (n - 1) on each call, decayed
        gap = sum(0.1 * 0.9 ** (len(moments) - 1 - k) * v.numpy() / (n - 1)
                  for k, (v, n) in enumerate(moments))
        np.testing.assert_allclose(new[f"{name}.running_var"], np.asarray(node["var"]) + gap,
                                   rtol=1e-5, atol=1e-5, err_msg=name)


CONTINUOUS = {
    "mixture": dict(),
    "no_mixture": dict(use_mixture_loss=False),
    "render": dict(render_probability=True),
    "render_no_mixture": dict(render_probability=True, use_mixture_loss=False),
    "frequency": dict(pe_type="frequency"),
    "frequency_no_skips_no_aspp": dict(pe_type="frequency", use_skips=False,
                                       use_denseaspp=False),
}
CONTINUOUS_KEYS = ("disp_levels", "disp_layered", "logits", "sigma", "pi", "probability",
                   "disp", "depth", "dists")


@pytest.mark.parametrize("case", CONTINUOUS)
def test_depth_decoder_continuous_matches_jax(case):
    kw = CONTINUOUS[case]
    levels = dict(disp_levels=7, xz_levels=2, yz_levels=0)
    module = JaxContinuous(num_ch_enc=ENC_CH, planes=JaxPlaneConfig(**levels), **kw)
    feats = [jnp.asarray(f) for f in _features(3)]
    grid = jnp.asarray(_grid(4))
    params, stats = _variables(module, 8, feats, grid, train=False)
    want = jax.jit(module.apply, static_argnames="train")(
        {"params": params, "batch_stats": stats}, feats, grid, train=False)

    port = DepthDecoderContinuous(ENC_CH, planes=PlaneConfig(**levels), **kw).eval()
    _assert_every_leaf_maps(port, params, stats)
    load_jax_continuous_params(port, params, stats)
    with torch.no_grad():
        got = port([nchw(np.asarray(f)) for f in feats], nchw(np.asarray(grid)))
    assert sorted(got) == sorted(want)
    for key in CONTINUOUS_KEYS:
        if key not in want:
            continue
        w = np.moveaxis(np.asarray(want[key]), -1, 1)
        assert got[key].dtype == torch.float32, key
        np.testing.assert_allclose(got[key].numpy(), w, err_msg=key, rtol=TOL["rtol"],
                                   atol=TOL["atol"] * max(1.0, float(np.abs(w).max())))
