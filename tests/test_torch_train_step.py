"""The port's stereo training step against the JAX package's, on the same weights.

One fused step (flip_right, mixture NLL, VGG19 perceptual loss at alpha_pc
0.1, smoothness, Adam) of ``planedepth_tpu_torch.train.step`` on the CPU,
where the sweep takes its plain twin, is held to ``make_train_step`` of the
JAX package with the Pallas kernels in interpret mode, in float32, with the
small configuration of tests/test_fused_train.py (ResNet-18 without
DenseASPP, whose dropout masks differ between the two frameworks; 7+3
planes; 64x96).  Losses agree at rtol 2e-4 and the post-Adam parameters at
atol 5e-5, the tolerances tests/test_fused_train.py holds the JAX fused step
to its oracle with, wherever the step's direction is determined (see the
test).  BatchNorm running variances differ by design: flax
updates them with the biased batch variance, torch with the unbiased one, so
the JAX update term is scaled by n/(n-1) before comparing (ROADMAP C3).
The step's modules are held to their JAX counterparts one by one as well.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from planedepth_tpu import config as jcfg
from planedepth_tpu.data.synthetic import make_stereo_batch
from planedepth_tpu.models.denseaspp import DenseAspp as JaxDenseAspp
from planedepth_tpu.ops.losses import smooth_loss_disp as jax_smooth
from planedepth_tpu.train import ModelBundle as JaxBundle
from planedepth_tpu.train import create_train_state
from planedepth_tpu.train import make_optimizer as jax_make_optimizer
from planedepth_tpu.train import make_train_step as jax_make_train_step
from planedepth_tpu.train.flip import add_flip_right_inputs as jax_flip
from planedepth_tpu.train.losses import compute_depth_metrics as jax_metrics
from planedepth_tpu.train.losses import perceptual_loss as jax_perceptual
from planedepth_tpu.train.state import multistep_lr
from planedepth_tpu.utils.torch_convert import convert_vgg19_features
from planedepth_tpu_torch import config as tcfg
from planedepth_tpu_torch.models.denseaspp import DenseAspp
from planedepth_tpu_torch.models.factory import DepthModel
from planedepth_tpu_torch.models.perceptual import Vgg19Features
from planedepth_tpu_torch.ops.losses import smooth_loss_disp
from planedepth_tpu_torch.ops.plane_sweep import plane_sweep
from planedepth_tpu_torch.train.flip import add_flip_right_inputs
from planedepth_tpu_torch.train.losses import compute_depth_metrics, perceptual_loss
from planedepth_tpu_torch.train.mono import fused_warp2d_ok
from planedepth_tpu_torch.train.state import make_optimizer
from planedepth_tpu_torch.train.step import (
    ModelBundle,
    batch_to_tensors,
    fused_mixed_ok,
    fused_sweep_ok,
    make_eval_step,
    make_train_step,
)
from planedepth_tpu_torch.utils.weights import load_jax_params, load_jax_pc_params
from tests._torch_parity import (
    _param_rule,
    _perturb,
    _stats_rule,
    assert_step_matches,
    bn_sizes,
    jax_init,
    nchw,
)

pytestmark = pytest.mark.heavy
torch.set_num_threads(1)

H, W = 64, 96
CPU = torch.device("cpu")
LOSS_KEYS = ("loss/ph_loss", "loss/pc_loss", "loss/smooth_loss", "loss/total_loss")


def _configs(automask):
    planes = dict(disp_levels=7, disp_min=2, disp_max=24, xz_levels=3, yz_levels=0)
    model = dict(num_layers=18, use_denseaspp=False, use_mixture_loss=True,
                 plane_residual=True, num_ep=0)
    common = dict(batch_size=2, flip_right=True, fused_sweep=True)
    j = jcfg.TrainConfig(
        model=jcfg.ModelConfig(planes=jcfg.PlaneConfig(**planes), **model),
        loss=jcfg.LossConfig(alpha_pc=0.1, automask=automask),
        data=jcfg.DataConfig(height=H, width=W),
        optim=jcfg.OptimConfig(learning_rate=1e-4), bf16=False,
        allow_random_pc=True, **common)
    t = tcfg.TrainConfig(
        bf16=False,
        model=tcfg.ModelConfig(planes=tcfg.PlaneConfig(**planes), **model),
        loss=tcfg.LossConfig(alpha_pc=0.1, automask=automask),
        data=tcfg.DataConfig(height=H, width=W),
        optim=tcfg.OptimConfig(learning_rate=1e-4), **common)
    return j, t


@pytest.fixture(scope="module", params=[False, True], ids=["automask_off", "automask_on"])
def steps(request):
    """One step of each package from the same perturbed weights."""
    jc, tc = _configs(request.param)
    bundle = JaxBundle(jc)
    params, stats, pc_params = jax_init(bundle, 0, H, W)
    rng = np.random.default_rng(3)
    params_np = {"model": _perturb(jax.tree.map(np.asarray, params["model"]), rng, _param_rule)}
    stats_np = {"model": _perturb(jax.tree.map(np.asarray, stats["model"]), rng, _stats_rule)}
    pc_np = _perturb(jax.tree.map(np.asarray, pc_params), rng, _param_rule)
    tx = jax_make_optimizer(jc, 10)
    state = jax.jit(lambda p, s, pc: create_train_state(p, s, tx, pc_params=pc))(
        jax.tree.map(jnp.asarray, params_np), jax.tree.map(jnp.asarray, stats_np),
        jax.tree.map(jnp.asarray, pc_np))
    batch = make_stereo_batch(1, H, W, seed=4)
    new_state, metrics = jax.jit(jax_make_train_step(bundle, tx))(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))

    port = ModelBundle(tc, CPU)
    load_jax_params(port.model, params_np["model"], stats_np["model"])
    load_jax_pc_params(port.pc, pc_np)
    before = {k: v.clone() for k, v in port.model.state_dict().items()}
    sizes = bn_sizes(port.model)
    optimizer, scheduler = make_optimizer(tc, port.model.parameters(), 10)
    launches = (plane_sweep.fwd_launches, plane_sweep.bwd_launches)
    losses = make_train_step(port, optimizer, scheduler)(batch_to_tensors(batch, CPU))
    assert (plane_sweep.fwd_launches, plane_sweep.bwd_launches) == launches

    want = DepthModel(port.model.cfg)
    load_jax_params(want, jax.tree.map(np.asarray, new_state.params["model"]),
                    jax.tree.map(np.asarray, new_state.batch_stats["model"]))
    return {"losses": losses, "metrics": metrics, "port": port, "before": before,
            "sizes": sizes, "want": want.state_dict(), "batch": batch}


def test_step_losses_match_jax(steps):
    for k in LOSS_KEYS:
        np.testing.assert_allclose(steps["losses"][k], float(steps["metrics"][k]),
                                   rtol=2e-4, err_msg=k)
    assert steps["losses"]["loss/pc_loss"] > 0


def test_step_parameters_and_bn_statistics_match_jax(steps):
    """Post-Adam parameters at atol 5e-5 wherever the step's direction is
    determined (2 * lr elsewhere); BatchNorm statistics with torch's
    unbiased variance (``assert_step_matches``: ~40% of the weights are held
    at 5e-5 here)."""
    assert_step_matches(steps["port"].model, steps["want"], steps["before"],
                        steps["sizes"], steps["port"].cfg.optim.learning_rate)


def test_eval_step_metrics_are_finite(steps):
    batch = batch_to_tensors(steps["batch"], CPU)
    metrics = make_eval_step(steps["port"])(batch)
    assert set(metrics) == {"de/abs_rel", "de/sq_rel", "de/rms", "de/log_rms",
                            "da/a1", "da/a2", "da/a3"}
    assert all(np.isfinite(v) for v in metrics.values())


def test_flip_right_matches_jax():
    batch = make_stereo_batch(2, 32, 48, seed=1)
    want = jax.jit(jax_flip)({k: jnp.asarray(v) for k, v in batch.items()})
    got = add_flip_right_inputs(batch_to_tensors(batch, CPU))
    assert set(got) == set(want)
    for k, v in got.items():
        w = np.asarray(want[k])
        np.testing.assert_array_equal(v.numpy(), np.moveaxis(w, -1, 1) if w.ndim == 4 else w,
                                      err_msg=k)


@pytest.mark.parametrize("gamma", [1.0, 2.0])
def test_smooth_loss_matches_jax(gamma):
    rng = np.random.default_rng(2)
    disp = rng.uniform(0, 50, (2, 12, 20, 1)).astype(np.float32)
    img = rng.uniform(0, 1, (2, 12, 20, 3)).astype(np.float32)
    np.testing.assert_allclose(
        float(smooth_loss_disp(nchw(disp), nchw(img), gamma)),
        float(jax.jit(jax_smooth, static_argnums=2)(jnp.asarray(disp), jnp.asarray(img),
                                                     gamma)), rtol=1e-6)


@pytest.fixture(scope="module")
def vgg_pair():
    from planedepth_tpu.models.perceptual import Vgg19Features as JaxVgg

    net = JaxVgg()
    tree = jax.jit(net.init)(jax.random.PRNGKey(1), jnp.zeros((1, 32, 48, 3)))
    tree = _perturb(jax.tree.map(np.asarray, tree), np.random.default_rng(4), _param_rule)
    vgg = Vgg19Features()
    load_jax_pc_params(vgg, tree)
    return net, tree, vgg


@pytest.mark.parametrize("automask", [False, True])
def test_perceptual_loss_matches_jax(vgg_pair, automask):
    net, tree, vgg = vgg_pair
    rng = np.random.default_rng(6)
    pred, tgt, src = (rng.uniform(0, 1, (2, 32, 48, 3)).astype(np.float32) for _ in range(3))
    pc_apply = lambda img: net.apply(tree, img)
    want_v, want_g = jax.value_and_grad(
        lambda p: jax_perceptual(pc_apply, p, jnp.asarray(tgt),
                                 jnp.asarray(src) if automask else None))(jnp.asarray(pred))
    p = nchw(pred).requires_grad_()
    got = perceptual_loss(vgg, p, nchw(tgt), nchw(src) if automask else None, remat=True)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want_v), rtol=1e-5)
    g = np.moveaxis(np.asarray(want_g), -1, 1)
    np.testing.assert_allclose(p.grad.numpy(), g, rtol=0, atol=1e-4 * np.abs(g).max())
    assert not any(q.requires_grad for q in vgg.parameters())


def test_vgg_loader_reads_a_torchvision_state_dict(vgg_pair):
    """A torchvision ``features.{i}`` state dict and the JAX tree it converts
    to (``convert_vgg19_features``) load into the same weights."""
    _, _, vgg = vgg_pair
    sd = {f"features.{k}": v.clone() for k, v in vgg.features.state_dict().items()}
    sd["features.28.weight"] = torch.zeros(512, 512, 3, 3)     # layers past pool3
    from_sd, from_tree = Vgg19Features(), Vgg19Features()
    load_jax_pc_params(from_sd, sd)
    load_jax_pc_params(from_tree, convert_vgg19_features(
        {k: v.numpy() for k, v in sd.items()}))
    for a, b, c in zip(vgg.state_dict().values(), from_sd.state_dict().values(),
                       from_tree.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        torch.testing.assert_close(a, c, rtol=0, atol=0)


@pytest.mark.parametrize("stereo_scale", [True, False])
def test_depth_metrics_match_jax(stereo_scale):
    rng = np.random.default_rng(8)
    pred = rng.uniform(0.5, 60, (2, 24, 40, 1)).astype(np.float32)
    gt = rng.uniform(1, 70, (2, 24, 40, 1)).astype(np.float32)
    gt[:, :, :5] = 0.0                                          # invalid GT
    gx, gy = np.meshgrid(np.linspace(-0.8, 0.9, 40), np.linspace(-1, 1, 24))
    grid = np.broadcast_to(np.stack([gx, gy], -1), (2, 24, 40, 2)).astype(np.float32)
    want = jax.jit(jax_metrics, static_argnums=3)(jnp.asarray(pred), jnp.asarray(gt),
                                                  jnp.asarray(grid), stereo_scale)
    got = compute_depth_metrics(nchw(pred), nchw(gt), nchw(grid), stereo_scale)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)


def test_denseaspp_train_mode_matches_jax():
    """Rate 0, BatchNorm on batch statistics: output and running statistics
    (running_var with the n/(n-1) of torch's unbiased update)."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 6, 10, 16)).astype(np.float32)
    net = JaxDenseAspp(dropout0=0.0)
    variables = jax.jit(lambda key: net.init(key, jnp.asarray(x), train=False))(
        jax.random.PRNGKey(2))
    params = _perturb(jax.tree.map(np.asarray, variables["params"]), rng, _param_rule)
    stats = _perturb(jax.tree.map(np.asarray, variables["batch_stats"]), rng, _stats_rule)
    out, mut = jax.jit(lambda v, x: net.apply(v, x, train=True, mutable=["batch_stats"]))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))

    port = DenseAspp(16, dropout=0.0)
    trees = {"params": params, "batch_stats": stats}
    leaf = {"weight": ("params", "scale"), "bias": ("params", "bias"),
            "running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var")}
    with torch.no_grad():
        for key, tensor in port.state_dict().items():
            parts = key.split(".")
            if parts[-1] == "num_batches_tracked":
                continue
            if parts[0] == "classification":
                v = params["classification"][{"weight": "kernel"}.get(parts[-1], "bias")]
            elif parts[1].startswith("norm"):
                coll, name = leaf[parts[-1]]
                v = trees[coll][parts[0].lower()][parts[1]]["bn"][name]
            else:
                v = params[parts[0].lower()][parts[1]][{"weight": "kernel"}.get(parts[-1], "bias")]
            v = np.asarray(v)
            tensor.copy_(torch.from_numpy(np.array(np.transpose(v, (3, 2, 0, 1)) if v.ndim == 4 else v)))
    before = {k: v.clone() for k, v in port.state_dict().items()}
    port.train()
    got = port(nchw(x))
    np.testing.assert_allclose(got.detach().numpy(), np.moveaxis(np.asarray(out), -1, 1),
                               rtol=1e-4, atol=1e-4)
    n, m = 2 * 6 * 10, 0.0003
    for key, value in port.state_dict().items():
        parts = key.split(".")
        if not parts[-1].startswith("running"):
            continue
        w = torch.from_numpy(np.array(
            mut["batch_stats"][parts[0].lower()][parts[1]]["bn"][leaf[parts[-1]][1]]))
        if parts[-1] == "running_var":
            w = (1 - m) * before[key] + (w - (1 - m) * before[key]) * n / (n - 1)
        torch.testing.assert_close(value, w, rtol=0, atol=1e-6, msg=key)


def test_denseaspp_dropout_draws_from_the_generator():
    port = DenseAspp(16).train()
    x = torch.ones(2, 16, 4, 6)
    a = port(x, torch.Generator().manual_seed(0))
    b = port(x, torch.Generator().manual_seed(0))
    c = port(x, torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    with pytest.raises(ValueError, match="Generator"):
        port(x)
    port.eval()
    torch.testing.assert_close(port(x), port(x), rtol=0, atol=0)


def test_lr_schedule_matches_optax():
    cfg = tcfg.TrainConfig(optim=tcfg.OptimConfig(milestones=(2, 3), lr_gamma=0.5))
    param = torch.nn.Parameter(torch.zeros(1))
    optimizer, scheduler = make_optimizer(cfg, [param], steps_per_epoch=4)
    sched = multistep_lr(1e-4, (2, 3), 0.5, 4)
    for t in range(16):
        assert optimizer.param_groups[0]["lr"] == pytest.approx(float(sched(t)), rel=1e-6), t
        optimizer.step()
        scheduler.step()
    # one Adam update equals optax.adam's with the same betas
    g = np.array([0.3, -2.0, 1e-3], np.float32)
    p = torch.nn.Parameter(torch.ones(3))
    opt, _ = make_optimizer(cfg, [p], 4)
    p.grad = torch.from_numpy(g.copy())
    opt.step()
    tx = optax.adam(1e-4, b1=0.5, b2=0.999)
    upd, _ = tx.update(jnp.asarray(g), tx.init(jnp.ones(3)))
    np.testing.assert_allclose(p.detach().numpy(), 1.0 + np.asarray(upd), rtol=0, atol=1e-9)


@pytest.mark.parametrize("override,item", [
    # ported with the oracle view synthesis (A4): these now build
    pytest.param(dict(novel_frame_ids=(-1, 1), loss=tcfg.LossConfig(use_mom=True)), None,
                 id="use_mom_temporal-A4"),
    pytest.param(dict(fused_sweep=False), None, id="fused_sweep_off-A4"),
    pytest.param(dict(model=tcfg.ModelConfig(net_type="PladeNet", planes=tcfg.PlaneConfig(
        yz_levels=4))), "left out on purpose", id="pladenet_yz-A10"),
    pytest.param(dict(model=tcfg.ModelConfig(net_type="FalNet", render_probability=True)),
                 "FalNet has no render_probability head", id="falnet_render"),
])
def test_unported_recipes_name_their_roadmap_item(override, item):
    """A recipe the port does not reach raises naming its ROADMAP item; the
    A4 recipes, ported since, build: ``fused_sweep=False`` trains through
    the oracle view synthesis, ``use_mom`` with temporal sides through the
    mixed route (as in the JAX package)."""
    cfg = tcfg.stage1_config(**override)
    if item is None:
        ModelBundle(cfg, CPU)
        assert fused_mixed_ok(cfg) == bool(cfg.novel_frame_ids)
        assert not (fused_sweep_ok(cfg) or fused_warp2d_ok(cfg))
        return
    with pytest.raises(NotImplementedError, match=item):
        ModelBundle(cfg, CPU)


def test_bundle_needs_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ModelBundle(tcfg.stage1_config())
