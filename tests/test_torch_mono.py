"""The port's monocular and mixed training steps against the JAX package's, on the same weights.

One step of the homography recipe (sides r, -1, 1: pose nets, the crop
rotation, per-plane homographies through the 2-D warp, automask, VGG19
perceptual loss at alpha_pc 0.1) and one of the mixed ``disp_warp`` recipe
(side r through the plane sweep, the temporal sides through depth warps) of
``planedepth_tpu_torch`` on the CPU, where the warp, the sweep and the disp
head take their plain versions, are held to the JAX package's oracle step
(``fused_sweep=False``: ``pred_novel_images`` + ``compute_losses``, XLA's
grid_sample), which tests/test_warp2d_train.py holds to the JAX warp2d step.
Same carried weights (depth model, pose encoder and decoder, VGG), float32,
the small configuration of tests/test_warp2d_train.py at 64x128 (ResNet-18
without DenseASPP, 7+3 planes, the pose decoder's 8-channel PE).  The
stereo pose is jittered off the pure x-translation, whose integer y
coordinates make the bilinear y-gradient a subgradient.

- losses at rtol 2e-4;
- every gradient leaf, pose nets included, at tests/test_warp2d_train.py's
  rule: max error over max(|leaf|, 1e-3 x the largest gradient) <= 1e-3.
  Train-mode BatchNorm makes float32 steps disagree in some encoder leaves
  by several percent of their largest element (flax takes the batch
  variance as E[x^2] - E[x]^2; ROADMAP C4).  A leaf may miss the rule only
  in the two ResNet encoders (the only BatchNorm of these nets) and where
  the port's float64 step shows float32 rounding of that size in one of the
  two steps; there both float32 gradients are held to each other, and the
  JAX one to the float64 one, at relative L2 error <= 1e-2.  Every decoder
  leaf, depth and pose, is held at the max-error rule;
- post-Adam weights by ``tests/_torch_parity.py:assert_step_matches`` (and
  its rule for the pose nets' parameters); the pose encoder's BatchNorm
  statistics with both of the step's updates, as the reference makes them
  (the JAX package keeps the last one), each with torch's unbiased variance.

tests/test_torch_mono_nomix.py runs the same three checks on the
homography recipe without the mixture.  The ``depth_warp`` and
``no_stereo`` variants are held by their losses.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planedepth_tpu import config as jcfg
from planedepth_tpu.data.synthetic import make_stereo_batch
from planedepth_tpu.geometry.pose import transformation_from_parameters
from planedepth_tpu.train import ModelBundle as JaxBundle
from planedepth_tpu.train import make_optimizer as jax_make_optimizer
from planedepth_tpu.train.step import process_batch as jax_process_batch
from planedepth_tpu_torch import config as tcfg
from planedepth_tpu_torch.models.factory import DepthModel
from planedepth_tpu_torch.models.pose_net import PoseDecoder
from planedepth_tpu_torch.models.resnet import ResnetPoseEncoder
from planedepth_tpu_torch.ops.warp2d import warp2d
from planedepth_tpu_torch.train.state import make_optimizer
from planedepth_tpu_torch.train.step import (
    ModelBundle,
    batch_to_tensors,
    make_train_step,
)
from planedepth_tpu_torch.train.step import process_batch as port_process_batch
from planedepth_tpu_torch.utils.weights import (
    load_jax_params,
    load_jax_pc_params,
    load_jax_pose_params,
)
from tests._torch_parity import (
    _param_rule,
    _perturb,
    _stats_rule,
    assert_step_matches,
    bn_sizes,
    jax_init,
)

pytestmark = pytest.mark.heavy
torch.set_num_threads(1)

H, W = 64, 128
CPU = torch.device("cpu")
LOSS_KEYS = ("loss/ph_loss", "loss/pc_loss", "loss/smooth_loss", "loss/total_loss")
BN_NETS = ("model.encoder.", "pose_encoder.")         # the nets with BatchNorm


def _configs(warp_type="homography_warp", no_stereo=False, alpha_pc=0.1, mixture=True):
    planes = dict(disp_levels=7, disp_min=2, disp_max=16, xz_levels=3, yz_levels=0)
    model = dict(num_layers=18, use_denseaspp=False, use_mixture_loss=mixture,
                 plane_residual=True, num_ep=0, pose_num_layers=18, pose_num_ep=8)
    common = dict(batch_size=2, flip_right=False, warp_type=warp_type,
                  novel_frame_ids=(-1, 1), no_stereo=no_stereo)
    j = jcfg.TrainConfig(
        model=jcfg.ModelConfig(planes=jcfg.PlaneConfig(**planes), **model),
        loss=jcfg.LossConfig(alpha_pc=alpha_pc, automask=True),
        data=jcfg.DataConfig(height=H, width=W),
        optim=jcfg.OptimConfig(learning_rate=1e-4), bf16=False, fused_sweep=False,
        allow_random_pc=True, **common)
    t = tcfg.TrainConfig(
        bf16=False,
        model=tcfg.ModelConfig(planes=tcfg.PlaneConfig(**planes), **model),
        loss=tcfg.LossConfig(alpha_pc=alpha_pc, automask=True),
        data=tcfg.DataConfig(height=H, width=W),
        optim=tcfg.OptimConfig(learning_rate=1e-4), fused_sweep=True, **common)
    return j, t


def _jax_setup(jc, seed=0):
    """Perturbed JAX variables (numpy) and the jittered batch."""
    bundle = JaxBundle(jc)
    params, stats, pc = jax_init(bundle, seed, H, W)
    rng = np.random.default_rng(seed + 3)
    params = {k: _perturb(jax.tree.map(np.asarray, v), rng, _param_rule)
              for k, v in params.items()}
    stats = {k: _perturb(jax.tree.map(np.asarray, v), rng, _stats_rule)
             for k, v in stats.items()}
    pc = _perturb(jax.tree.map(np.asarray, pc), rng, _param_rule) if pc else None
    batch = make_stereo_batch(jc.batch_size, H, W, seed=4, novel_frame_ids=jc.novel_frame_ids)
    jitter = transformation_from_parameters(
        jnp.asarray([[[0.002, -0.001, 0.003]]], jnp.float32),
        jnp.asarray([[[0.001, 0.004, 0.002]]], jnp.float32))
    batch["Rt_r"] = np.array(jnp.einsum("bij,njk->bik", batch["Rt_r"], jitter))
    return bundle, params, stats, pc, batch


def _port(tc, params, stats, pc):
    port = ModelBundle(tc, CPU)
    load_jax_params(port.model, params["model"], stats["model"])
    load_jax_pose_params(port.pose_encoder, port.pose, params, stats)
    if pc is not None:
        load_jax_pc_params(port.pc, pc)
    return port


def _as_port(jc, tree, stats):
    """A JAX params-shaped tree (weights or gradients) as port state dicts
    keyed like ``ModelBundle.named_parameters``."""
    model = DepthModel(tcfg.ModelConfig(
        planes=tcfg.PlaneConfig(**dataclasses.asdict(jc.model.planes)),
        **{k: getattr(jc.model, k) for k in ("num_layers", "num_ep", "use_denseaspp",
                                             "use_mixture_loss", "plane_residual")}))
    load_jax_params(model, tree["model"], stats["model"])
    enc = ResnetPoseEncoder(jc.model.pose_num_layers, 2)
    dec = PoseDecoder(enc.num_ch_enc, jc.model.pose_num_ep)
    load_jax_pose_params(enc, dec, tree, stats)
    return {"model": model.state_dict(), "pose_encoder": enc.state_dict(),
            "pose": dec.state_dict()}


@pytest.fixture(scope="module", params=["homography_warp", "disp_warp"],
                ids=["homography", "mixed"])
def steps(request):
    """One step of each package from the same perturbed weights."""
    return step_pair(*_configs(request.param))


def step_pair(jc, tc):
    """One step of the JAX package's oracle and of the port from the same
    perturbed weights, and the port's step in float64 (see the docstring)."""
    bundle, params, stats, pc, batch = _jax_setup(jc)
    tx = jax_make_optimizer(jc, 10)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    @jax.jit
    def jax_step(params, stats, pc):
        def loss_fn(p):
            losses, _, new_stats = jax_process_batch(bundle, p, stats, None, pc, jbatch,
                                                     jax.random.PRNGKey(0), train=True)
            return losses["loss/total_loss"], (losses, new_stats)

        (_, (losses, new_stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, _ = tx.update(grads, tx.init(params), params)
        new_params = jax.tree.map(lambda p, u: p + u, params, updates)
        # the pose encoder on the first frame pair alone, for its own BN update
        pair = jnp.concatenate([jbatch["color_aug_-1"], jbatch["color_aug_l"]], -1)
        _, first = bundle.pose_encoder.apply(
            {"params": params["pose_encoder"], "batch_stats": stats["pose_encoder"]},
            pair, train=True, mutable=["batch_stats"])
        return losses, grads, new_stats, new_params, first["batch_stats"]

    losses_j, grads_j, stats_j, params_j, first_j = jax.tree.map(
        np.asarray, jax_step(params, stats, pc))

    port = _port(tc, params, stats, pc)
    before = {name: {k: v.clone() for k, v in net.state_dict().items()}
              for name, net in port.nets().items()}
    sizes = {name: bn_sizes(net) for name, net in port.nets().items()}
    optimizer, scheduler = make_optimizer(tc, port.parameters(), 10)
    counts = lambda: (warp2d.fwd_launches, warp2d.bwd_launches,
                      warp2d.nosigma_fwd_launches, warp2d.nosigma_bwd_launches)
    launches = counts()
    losses = make_train_step(port, optimizer, scheduler)(batch_to_tensors(batch, CPU))
    assert counts() == launches
    # the same step in float64, to tell float32 rounding from a fault
    ref = _port(tc, params, stats, pc)
    for net in (*ref.nets().values(), ref.pc):
        net.double()
    out = port_process_batch(ref.train(), {
        k: v.double() for k, v in batch_to_tensors(batch, CPU).items()},
        torch.Generator().manual_seed(tc.seed << 32))
    out["loss/total_loss"].backward()
    first = ResnetPoseEncoder(jc.model.pose_num_layers, 2)
    load_jax_pose_params(first, PoseDecoder(first.num_ch_enc, jc.model.pose_num_ep),
                         params, {"pose_encoder": first_j})
    return {"jc": jc, "port": port, "losses": losses, "losses_j": losses_j,
            "grads": _as_port(jc, grads_j, stats), "want": _as_port(jc, params_j, stats_j),
            "first": first.state_dict(), "before": before, "sizes": sizes,
            "grads64": {k: p.grad for k, p in ref.named_parameters()}}


def test_step_losses_match_jax(steps):
    for k in LOSS_KEYS:
        np.testing.assert_allclose(steps["losses"][k], float(steps["losses_j"][k]),
                                   rtol=2e-4, err_msg=k)
    assert steps["losses"]["loss/pc_loss"] > 0


def test_step_gradients_match_jax(steps):
    """Every gradient leaf, the pose nets' included: the max-error rule at
    1e-3, or relative L2 <= 1e-2 on a leaf whose gap float32 rounding
    explains (see the module docstring).  Without the mixture the loss is an
    L1 with an automask minimum, whose kinks float32 and float64 may take on
    different sides: there the float64 step is no referee, so such a leaf's
    two float32 gradients are held to each other at relative L2 <= 1e-3 and
    must stand equally far (within 1e-3) from the float64 one."""
    port = steps["port"]
    mixture = steps["jc"].model.use_mixture_loss
    got = dict(port.named_parameters())
    want = {f"{name}.{k}": torch.as_tensor(sd[k]) for name, sd in steps["grads"].items()
            for k in dict(port.nets()[name].named_parameters())}
    assert set(got) == set(want) == set(steps["grads64"])
    gmax = max(float(w.abs().max()) for w in want.values())
    for k, w in want.items():
        g, g64 = got[k].grad.double(), steps["grads64"][k]
        w = w.double()
        scale = max(float(w.abs().max()), 1e-3 * gmax, 1e-6)
        err = float((g - w).abs().max()) / scale
        if err <= 1e-3:
            continue
        # past the rule only behind train-mode BatchNorm (the two ResNet
        # encoders), where float32 rounding is as large (see above)
        rounding = max(float((g - g64).abs().max()), float((w - g64).abs().max())) / scale
        assert k.startswith(BN_NETS) and rounding > 1e-3, (k, err, rounding)
        rel = lambda a, b: float((a - b).norm() / max(float(b.norm()), 1e-12))
        if mixture:
            assert rel(g, w) <= 1e-2 and rel(w, g64) <= 1e-2, (k, rel(g, w), rel(w, g64))
        else:
            assert rel(g, w) <= 1e-3, (k, rel(g, w))
            assert abs(rel(g, g64) - rel(w, g64)) <= 1e-3, (k, rel(g, g64), rel(w, g64))
    # apply_rc: the temporal poses lose their translation, so only the
    # axis-angle half of the pose head's output layer learns
    pose_out = got["pose.net.4.weight"].grad
    assert pose_out[:3].abs().max() > 0 and (pose_out[3:] == 0).all()


def test_step_parameters_and_bn_statistics_match_jax(steps):
    """Post-Adam weights where the step's direction is fixed (2 * lr
    elsewhere); the depth model's BN statistics with torch's unbiased
    variance; the pose encoder's with both of the step's updates."""
    port, lr = steps["port"], steps["jc"].optim.learning_rate
    assert_step_matches(port.model, steps["want"]["model"], steps["before"]["model"],
                        steps["sizes"]["model"], lr)
    for name in ("pose_encoder", "pose"):
        net, want, before = port.nets()[name], steps["want"][name], steps["before"][name]
        for key, value in net.named_parameters():
            g = value.grad.abs()
            err = (value.detach() - want[key]).abs()
            fixed = g >= 0.05 * g.max()
            if fixed.any():
                assert float(err[fixed].max()) <= 5e-5, key
            assert float(err.max()) <= 2 * lr + 5e-5, key
    # the pose encoder's BN: torch runs its two updates in sequence, the JAX
    # package keeps the second (from the original statistics); the first is
    # the JAX encoder on the pair (-1, l) alone
    first, state = steps["first"], port.pose_encoder.state_dict()
    sizes, before = steps["sizes"]["pose_encoder"], steps["before"]["pose_encoder"]
    last = steps["want"]["pose_encoder"]
    for key in state:
        if not key.endswith(("running_mean", "running_var")):
            continue
        n = sizes[key.rsplit(".", 1)[0]]
        fix = n / (n - 1) if key.endswith("running_var") else 1.0
        b0 = before[key]
        u1 = (first[key] - 0.9 * b0) / 0.1 * fix
        u2 = (last[key] - 0.9 * b0) / 0.1 * fix
        expect = 0.9 * (0.9 * b0 + 0.1 * u1) + 0.1 * u2
        torch.testing.assert_close(state[key], expect, rtol=0, atol=5e-5, msg=key)


@pytest.mark.parametrize("warp_type,no_stereo", [("depth_warp", False),
                                                 ("homography_warp", True)],
                         ids=["depth_warp", "no_stereo"])
def test_variant_losses_match_jax(warp_type, no_stereo):
    """The depth warp (sides r, -1, 1) and pure mono (sides -1, 1): losses
    of one training-mode forward at rtol 2e-4, without the perceptual loss."""
    jc, tc = _configs(warp_type, no_stereo, alpha_pc=0.0)
    bundle, params, stats, pc, batch = _jax_setup(jc, seed=1)
    want, _, _ = jax.jit(lambda p, s: jax_process_batch(
        bundle, p, s, None, None, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0), train=True))(params, stats)
    port = _port(tc, params, stats, None).train()
    with torch.no_grad():
        got = port_process_batch(port, batch_to_tensors(batch, CPU),
                                 torch.Generator().manual_seed(0))
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=2e-4, err_msg=k)
