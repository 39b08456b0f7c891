"""Stage 3 of the port (``train/distill.py`` and the distillation step) against the JAX package.

- ``generate_post_process_disp`` with a fake teacher whose outputs depend on
  the image and grid it is given (so the two halves differ and a swapped or
  unflipped half shows), ``mirror_occlusion_mask`` and
  ``fused_mom_mask_novel`` on seeded volumes with per-row shifts past the W
  edges: rtol 1e-4 / atol 1e-5.  The JAX side takes its XLA gather path on
  the CPU (no clip); every shift here is inside the port's clip.
- One stage-3 step (``self_distillation`` 1.0, VGG19 at alpha_pc 0.1, a
  teacher whose weights differ from the student's) and one ``use_mom`` step
  (alpha_pc 0) of the port on the CPU against ``make_train_step`` of the JAX
  package with ``state.teacher`` set, in the small configuration of
  ``tests/test_torch_train_step.py``: losses at rtol 2e-4, post-Adam
  parameters at atol 5e-5 where the step's direction is fixed and 2·lr
  elsewhere (``assert_step_matches``); the teacher is unchanged bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planedepth_tpu import config as jcfg
from planedepth_tpu.data.synthetic import make_stereo_batch
from planedepth_tpu.train import ModelBundle as JaxBundle
from planedepth_tpu.train import create_train_state
from planedepth_tpu.train import make_optimizer as jax_make_optimizer
from planedepth_tpu.train import make_train_step as jax_make_train_step
from planedepth_tpu.train import distill as jdistill
from planedepth_tpu_torch import config as tcfg
from planedepth_tpu_torch.models.factory import DepthModel
from planedepth_tpu_torch.ops.plane_sweep import plane_sweep
from planedepth_tpu_torch.ops.row_shift import row_shift
from planedepth_tpu_torch.train import distill
from planedepth_tpu_torch.train.state import make_optimizer
from planedepth_tpu_torch.train.step import ModelBundle, batch_to_tensors, make_train_step
from planedepth_tpu_torch.utils.weights import load_jax_params, load_jax_pc_params
from tests._torch_parity import (
    _param_rule,
    _perturb,
    _stats_rule,
    assert_step_matches,
    bn_sizes,
    nchw,
)

pytestmark = pytest.mark.heavy
torch.set_num_threads(1)

CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-5)
PAD = 16                                  # clip at ±126, beyond every shift here
B, N, H, W = 2, 6, 8, 40


def _volume(rng, b):
    """Softmax-normalised ``(b, H, W, N)`` volume."""
    x = np.exp(rng.normal(0, 1.5, (b, H, W, N)))
    return (x / x.sum(-1, keepdims=True)).astype(np.float32)


def _rows(rng, b):
    """Per-row plane disparities ``(b, H, N)`` up to 1.3 W: past the W edge."""
    return rng.uniform(0.0, 1.3 * W, (b, H, N)).astype(np.float32)


def test_generate_post_process_disp_matches_jax():
    rng = np.random.default_rng(0)
    base_logits = rng.normal(0, 2, (2 * B, H, W, N)).astype(np.float32)
    base_prob = _volume(rng, 2 * B)
    base_disp = rng.uniform(1, 30, (2 * B, H, W, 1)).astype(np.float32)
    rows = _rows(rng, 2 * B)
    image = rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32)
    grid = np.stack(np.meshgrid(np.linspace(-0.9, 0.8, W), np.linspace(-1, 1, H)), -1)
    grid = np.broadcast_to(grid, (B, H, W, 2)).astype(np.float32).copy()
    grid[1] *= 0.7

    def jax_teacher(images, grids):
        a = images[..., :1] + 0.5 * grids[..., :1]               # order-sensitive
        return {"logits": base_logits + 3.0 * a, "probability": base_prob * (1.0 + a),
                "disp": base_disp + 4.0 * a,
                "disp_layered": jnp.asarray(rows)[:, :, None, :]}

    def port_teacher(images, grids):
        a = images[:, :1] + 0.5 * grids[:, :1]
        return {"logits": nchw(base_logits) + 3.0 * a,
                "probability": nchw(base_prob) * (1.0 + a),
                "disp": nchw(base_disp) + 4.0 * a, "disp_rows": torch.from_numpy(rows)}

    want = jdistill.generate_post_process_disp(jax_teacher, jnp.asarray(image),
                                               jnp.asarray(grid), 0)
    launches = row_shift.launches
    got = distill.generate_post_process_disp(port_teacher, nchw(image), nchw(grid), PAD)
    assert row_shift.launches == launches                       # CPU: the twin
    for name, g, w in zip(("disp_pp", "mask_novel"), got, want):
        w = np.moveaxis(np.asarray(w), -1, 1)
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **TOL)
        assert g.shape == (B, 1, H, W) and np.ptp(w) > 0.1, name


def test_mirror_occlusion_mask_matches_jax():
    rng = np.random.default_rng(1)
    prob, prob_rec = _volume(rng, 2 * B), _volume(rng, 2 * B)
    rows = _rows(rng, 2 * B)
    want = jdistill.mirror_occlusion_mask(
        {"probability": jnp.asarray(prob), "disp_layered": jnp.asarray(rows)[:, :, None, :]},
        {("probability_rec", "r"): jnp.asarray(prob_rec)})
    got = distill.mirror_occlusion_mask(nchw(prob), nchw(prob_rec), torch.from_numpy(rows),
                                        PAD)
    w = np.moveaxis(np.asarray(want), -1, 1)
    np.testing.assert_allclose(got.numpy(), w, **TOL)
    assert np.ptp(w) > 0.1


@pytest.mark.parametrize("use_mixture_loss", [True, False])
def test_fused_mom_mask_novel_matches_jax(use_mixture_loss):
    rng = np.random.default_rng(2)
    logits = rng.normal(0, 2, (2 * B, H, W, N)).astype(np.float32)
    sigma = rng.uniform(0.01, 1.0, (2 * B, H, W, N)).astype(np.float32)
    pmask = (rng.uniform(0, 1, (2 * B, H, 1, N)) > 0.25).astype(np.float32)
    logits *= pmask
    rows = _rows(rng, 2 * B)
    want = jdistill.fused_mom_mask_novel(
        {"logits": jnp.asarray(logits), "sigma": jnp.asarray(sigma),
         "padding_mask": jnp.asarray(pmask),
         "disp_layered": jnp.asarray(rows)[:, :, None, :]}, use_mixture_loss)
    launches = row_shift.launches
    got = distill.fused_mom_mask_novel(
        {"logits": nchw(logits), "sigma": nchw(sigma), "padding_mask": nchw(pmask),
         "disp_rows": torch.from_numpy(rows)}, use_mixture_loss, PAD)
    assert row_shift.launches == launches
    w = np.moveaxis(np.asarray(want), -1, 1)
    np.testing.assert_allclose(got.numpy(), w, **TOL)
    assert np.ptp(w) > 0.1


# --- whole steps ------------------------------------------------------------

SH, SW = 64, 96


def _configs(recipe):
    planes = dict(disp_levels=7, disp_min=2, disp_max=24, xz_levels=3, yz_levels=0)
    model = dict(num_layers=18, use_denseaspp=False, use_mixture_loss=True,
                 plane_residual=True, num_ep=0)
    loss = (dict(alpha_pc=0.1, self_distillation=1.0) if recipe == "distill"
            else dict(alpha_pc=0.0, use_mom=True))
    common = dict(batch_size=2, flip_right=recipe == "mom", fused_sweep=True)
    j = jcfg.TrainConfig(
        model=jcfg.ModelConfig(planes=jcfg.PlaneConfig(**planes), **model),
        loss=jcfg.LossConfig(**loss), data=jcfg.DataConfig(height=SH, width=SW),
        optim=jcfg.OptimConfig(learning_rate=1e-4), bf16=False,
        allow_random_pc=True, **common)
    t = tcfg.TrainConfig(
        model=tcfg.ModelConfig(planes=tcfg.PlaneConfig(**planes), **model),
        loss=tcfg.LossConfig(**loss), data=tcfg.DataConfig(height=SH, width=SW),
        optim=tcfg.OptimConfig(learning_rate=1e-4), **common)
    return j, t


@pytest.fixture(scope="module")
def jax_init():
    """The JAX variables of the distill configuration (depth net and VGG),
    initialised once under jit (the eager init takes ~4x longer); the mom
    configuration has the same depth net."""
    bundle = JaxBundle(_configs("distill")[0])
    return jax.jit(bundle.init, static_argnums=(1, 2))(jax.random.PRNGKey(0), SH, SW)


@pytest.fixture(scope="module", params=["distill", "mom"])
def steps(request, jax_init):
    """One step of each package from the same perturbed weights; the
    teacher's weights are perturbed from another seed."""
    jc, tc = _configs(request.param)
    bundle = JaxBundle(jc)
    params, stats, pc_params = jax_init
    if bundle.pc is None:
        pc_params = None
    rng = np.random.default_rng(3)
    tree = lambda t: jax.tree.map(np.asarray, t["model"])
    params_np = {"model": _perturb(tree(params), rng, _param_rule)}
    stats_np = {"model": _perturb(tree(stats), rng, _stats_rule)}
    teacher = None
    if request.param == "distill":
        trng = np.random.default_rng(7)
        teacher = {"params": {"model": _perturb(tree(params), trng, _param_rule)},
                   "batch_stats": {"model": _perturb(tree(stats), trng, _stats_rule)}}
        head = teacher["params"]["model"]["depth"]["dispconv"]["conv"]
        head["kernel"] = head["kernel"] * 1.5
    pc_np = (_perturb(jax.tree.map(np.asarray, pc_params), rng, _param_rule)
             if pc_params is not None else None)
    tx = jax_make_optimizer(jc, 10)
    to_j = lambda t: None if t is None else jax.tree.map(jnp.asarray, t)
    state = create_train_state(to_j(params_np), to_j(stats_np), tx, teacher=to_j(teacher),
                               pc_params=to_j(pc_np))
    batch = make_stereo_batch(jc.per_step_batch, SH, SW, seed=4)
    new_state, metrics = jax.jit(jax_make_train_step(bundle, tx))(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))

    port = ModelBundle(tc, CPU)
    load_jax_params(port.model, params_np["model"], stats_np["model"])
    if teacher is not None:
        load_jax_params(port.freeze_teacher(), teacher["params"]["model"],
                        teacher["batch_stats"]["model"])
    if pc_np is not None:
        load_jax_pc_params(port.pc, pc_np)
    before = {k: v.clone() for k, v in port.model.state_dict().items()}
    teacher_before = ({k: v.clone() for k, v in port.teacher.state_dict().items()}
                      if port.teacher is not None else None)
    sizes = bn_sizes(port.model)
    optimizer, scheduler = make_optimizer(tc, port.model.parameters(), 10)
    launches = (plane_sweep.fwd_launches, row_shift.launches)
    losses = make_train_step(port, optimizer, scheduler)(batch_to_tensors(batch, CPU))
    assert (plane_sweep.fwd_launches, row_shift.launches) == launches

    want = DepthModel(port.model.cfg)
    load_jax_params(want, jax.tree.map(np.asarray, new_state.params["model"]),
                    jax.tree.map(np.asarray, new_state.batch_stats["model"]))
    return {"recipe": request.param, "losses": losses, "metrics": metrics, "port": port,
            "before": before, "teacher_before": teacher_before, "sizes": sizes,
            "want": want.state_dict()}


def test_step_losses_match_jax(steps):
    keys = ["loss/ph_loss", "loss/pc_loss", "loss/smooth_loss", "loss/total_loss"]
    if steps["recipe"] == "distill":
        keys.append("loss/disp_loss")
        assert steps["losses"]["loss/disp_loss"] > 0 and steps["losses"]["loss/pc_loss"] > 0
    assert set(steps["losses"]) == set(keys)
    for k in keys:
        np.testing.assert_allclose(steps["losses"][k], float(steps["metrics"][k]),
                                   rtol=2e-4, err_msg=k)


def test_step_parameters_match_jax(steps):
    assert_step_matches(steps["port"].model, steps["want"], steps["before"],
                        steps["sizes"], steps["port"].cfg.optim.learning_rate)


def test_teacher_is_frozen(steps):
    teacher = steps["port"].teacher
    if steps["recipe"] == "mom":
        assert teacher is None
        return
    assert not teacher.training and not any(p.requires_grad for p in teacher.parameters())
    assert all(p.grad is None for p in teacher.parameters())
    for k, v in teacher.state_dict().items():
        assert torch.equal(v, steps["teacher_before"][k]), k
    assert any(not torch.equal(v, steps["before"][k])
               for k, v in teacher.state_dict().items())           # not the student
