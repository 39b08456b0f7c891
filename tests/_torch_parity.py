"""Shared set-up of the port-against-JAX tests: one seeded model in both packages.

The JAX ``DepthModel`` is initialised through ``ModelBundle(cfg).init``; its
variables go to numpy, BatchNorm statistics, BN scales and every bias are
perturbed from a numpy seed (so a swapped or dropped leaf shows in the
forward), and ``load_jax_params`` carries them into the port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from planedepth_tpu import config as jcfg
from planedepth_tpu.train.step import ModelBundle
from planedepth_tpu_torch import config as tcfg
from planedepth_tpu_torch.models.factory import DepthModel
from planedepth_tpu_torch.utils.weights import load_jax_params

MODEL_FIELDS = ("net_type", "num_layers", "num_ep", "pe_type", "use_denseaspp",
                "use_mixture_loss", "plane_residual", "render_probability")


def _perturb(tree, rng, leaf_rule):
    if isinstance(tree, dict):
        return {k: (_perturb(v, rng, leaf_rule) if isinstance(v, dict)
                    else leaf_rule(k, np.asarray(v), rng))
                for k, v in tree.items()}
    return tree


def _param_rule(name, v, rng):
    if name == "bias":
        return (v + rng.normal(0.0, 0.05, v.shape)).astype(np.float32)
    if name == "scale":
        return (v * rng.uniform(0.8, 1.2, v.shape)).astype(np.float32)
    return v


def _stats_rule(name, v, rng):
    if name == "mean":
        return rng.normal(0.0, 0.1, v.shape).astype(np.float32)
    return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)        # var


_INITS = {}


def jax_init(bundle, seed, height, width):
    """``bundle.init`` under ``jax.jit``, as numpy trees, once a process for
    each set of networks: the init depends only on the model, pose and
    perceptual configs, the seed and the size, so configurations that
    differ in their losses or warps share it."""
    cfg = bundle.cfg
    key = (cfg.model, cfg.use_pose_net, cfg.loss.alpha_pc > 0, cfg.loss.pc_net,
           seed, height, width)
    if key not in _INITS:
        out = jax.jit(bundle.init, static_argnums=(1, 2))(
            jax.random.PRNGKey(seed), height, width)
        _INITS[key] = jax.tree.map(np.asarray, out)
    return _INITS[key]


def make_models(height, width, fused_head="off", seed=0, **model_kw):
    """-> (jax_forward, params_np, stats_np, port_model) for one config."""
    cfg = jcfg.TrainConfig(
        model=jcfg.ModelConfig(fused_head=fused_head, **model_kw),
        loss=jcfg.LossConfig(alpha_pc=0.0),
        data=jcfg.DataConfig(height=height, width=width),
        bf16=False,
    )
    bundle = ModelBundle(cfg)
    params, stats, _ = jax.jit(bundle.init, static_argnums=(1, 2))(
        jax.random.PRNGKey(seed), height, width)
    rng = np.random.default_rng(seed)
    params_np = _perturb(jax.tree.map(np.asarray, params["model"]), rng, _param_rule)
    stats_np = _perturb(jax.tree.map(np.asarray, stats["model"]), rng, _stats_rule)

    @jax.jit
    def jax_forward(image, grid):
        out, _ = bundle.depth_forward({"model": params_np}, {"model": stats_np},
                                      image, grid, train=False)
        return out

    port = DepthModel(tcfg.ModelConfig(
        planes=tcfg.PlaneConfig(**dataclasses.asdict(cfg.model.planes)),
        **{k: getattr(cfg.model, k) for k in MODEL_FIELDS}))
    load_jax_params(port, params_np, stats_np)
    return jax_forward, params_np, stats_np, port.eval()


def inputs(batch, height, width, seed=0):
    """NHWC numpy image in [0, 1] and a cropped augmentation grid."""
    rng = np.random.default_rng(seed)
    image = rng.random((batch, height, width, 3), dtype=np.float32)
    gx, gy = np.meshgrid(np.linspace(-0.9, 0.95, width), np.linspace(-0.8, 1.0, height))
    grid = np.broadcast_to(np.stack([gx, gy], -1)[None], (batch, height, width, 2))
    return image, np.ascontiguousarray(grid, dtype=np.float32)


def bn_sizes(model):
    """Records n = B*H*W of every BatchNorm2d input during the next forward."""
    sizes = {}
    for name, mod in model.named_modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            mod.register_forward_pre_hook(
                lambda m, a, name=name: sizes.__setitem__(name, a[0].numel() // a[0].shape[1]))
    return sizes


def assert_step_matches(model, want, before, sizes, lr, min_share=0.3, c3_visible=True):
    """Post-Adam parameters of ``model`` against the JAX step's (``want``, a
    port state dict) at atol 5e-5 wherever the step's direction is
    determined; BatchNorm statistics with torch's unbiased variance.

    The first Adam step moves each weight by ~lr * sign(g).  Float32
    rounding through train-mode BatchNorm leaves the JAX package's encoder
    gradients of these weights off by about a percent of a leaf's largest
    |g| (ROADMAP C4), so where |g| is under 5% of the leaf's largest the
    sign, and with it the step, is not fixed: there the two may differ by
    one step each way, 2 * lr.  At least ``min_share`` of the weights must
    be held at 5e-5.  Returns their number.  ``c3_visible`` also requires
    torch's and flax's running variances to differ beyond ``allclose``,
    which over a large batch (the correction ~0.1 var / n) they do not.
    """
    got = model.state_dict()
    grads = {k: p.grad for k, p in model.named_parameters()}
    moved = 0
    for key, value in got.items():
        if key.endswith("num_batches_tracked"):
            continue
        if key.endswith("running_var"):
            # flax: rv0 + m*(var_b - rv0); torch: rv0 + m*(var_b*n/(n-1) - rv0)
            n = sizes[key.rsplit(".", 1)[0]]
            rv0 = before[key]
            term = want[key] - 0.9 * rv0                  # ResNet BN momentum 0.1
            expect = 0.9 * rv0 + term * n / (n - 1)
            torch.testing.assert_close(value, expect, rtol=0, atol=5e-5, msg=key)
            assert not c3_visible or not torch.allclose(want[key], expect), key
            continue
        err = (value - want[key]).abs()
        if key in grads:
            g = grads[key].abs()
            fixed = g >= 0.05 * g.max()
            assert float(err[fixed].max()) <= 5e-5, key
            assert float(err.max()) <= 2 * lr + 5e-5, key
            moved += int(fixed.sum())
        else:
            assert float(err.max()) <= 5e-5, key                 # running_mean
    assert moved > min_share * sum(g.numel() for g in grads.values())
    return moved


def stereo_step_pair(jc, tc, height, width, seed=0):
    """One stereo training step of each package from the same perturbed
    weights (depth model and VGG) on ``make_stereo_batch(1, ..., seed=4)``:
    the JAX package's ``make_train_step`` under ``jax.jit`` (its Pallas
    kernels in interpret mode) and the port's on the CPU (the kernels'
    plain versions).  Returns the two loss dicts, the stepped port bundle,
    its weights before the step, its BatchNorm input sizes and the JAX
    step's weights as a port state dict."""
    from planedepth_tpu.data.synthetic import make_stereo_batch
    from planedepth_tpu.train import create_train_state
    from planedepth_tpu.train import make_optimizer as jax_make_optimizer
    from planedepth_tpu.train import make_train_step as jax_make_train_step
    from planedepth_tpu_torch.train.state import make_optimizer
    from planedepth_tpu_torch.train.step import ModelBundle as PortBundle
    from planedepth_tpu_torch.train.step import batch_to_tensors, make_train_step
    from planedepth_tpu_torch.utils.weights import load_jax_pc_params

    bundle = ModelBundle(jc)
    params, stats, pc = jax_init(bundle, seed, height, width)
    rng = np.random.default_rng(seed + 3)
    params_np = {"model": _perturb(jax.tree.map(np.asarray, params["model"]), rng, _param_rule)}
    stats_np = {"model": _perturb(jax.tree.map(np.asarray, stats["model"]), rng, _stats_rule)}
    pc_np = _perturb(jax.tree.map(np.asarray, pc), rng, _param_rule) if pc else None
    tx = jax_make_optimizer(jc, 10)
    # under jit: Adam's zero moments as one program, not one a leaf shape
    state = jax.jit(lambda p, s, pc: create_train_state(p, s, tx, pc_params=pc))(
        jax.tree.map(jnp.asarray, params_np), jax.tree.map(jnp.asarray, stats_np),
        None if pc_np is None else jax.tree.map(jnp.asarray, pc_np))
    batch = make_stereo_batch(1, height, width, seed=4)
    new_state, metrics = jax.jit(jax_make_train_step(bundle, tx))(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))

    cpu = torch.device("cpu")
    port = PortBundle(tc, cpu)
    load_jax_params(port.model, params_np["model"], stats_np["model"])
    if pc_np is not None:
        load_jax_pc_params(port.pc, pc_np)
    before = {k: v.clone() for k, v in port.model.state_dict().items()}
    sizes = bn_sizes(port.model)
    optimizer, scheduler = make_optimizer(tc, port.model.parameters(), 10)
    losses = make_train_step(port, optimizer, scheduler)(batch_to_tensors(batch, cpu))
    want = DepthModel(port.model.cfg)
    load_jax_params(want, jax.tree.map(np.asarray, new_state.params["model"]),
                    jax.tree.map(np.asarray, new_state.batch_stats["model"]))
    return {"losses": losses, "metrics": {k: float(v) for k, v in metrics.items()},
            "port": port, "before": before, "sizes": sizes, "want": want.state_dict(),
            "batch": batch}


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def jnp_in(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def perturbed_init(bundle, seed, height, width):
    """``jax_init``'s variables with every bias, BN scale and BN statistic
    perturbed from a numpy seed: (params, stats, pc) as numpy trees."""
    params, stats, pc = jax_init(bundle, seed, height, width)
    rng = np.random.default_rng(seed + 3)
    params = {k: _perturb(jax.tree.map(np.asarray, v), rng, _param_rule)
              for k, v in params.items()}
    stats = {k: _perturb(jax.tree.map(np.asarray, v), rng, _stats_rule)
             for k, v in stats.items()}
    pc = _perturb(jax.tree.map(np.asarray, pc), rng, _param_rule) if pc else None
    return params, stats, pc


def jax_losses_and_grads(bundle, params, stats, pc, batch, teacher=False):
    """The JAX package's ``process_batch`` in training mode under ``jax.jit``
    and its gradient in the depth model: (losses, model gradients) as numpy.
    ``teacher``: the frozen teacher is the model with these variables."""
    from planedepth_tpu.train.step import process_batch

    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    frozen = {"params": params, "batch_stats": stats} if teacher else None

    @jax.jit
    def step(params):
        def loss_fn(p):
            losses, _, _ = process_batch(bundle, p, stats, frozen, pc, jbatch,
                                         jax.random.PRNGKey(0), train=True)
            return losses["loss/total_loss"], losses
        (_, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return losses, grads["model"]

    return jax.tree.map(np.asarray, step(params))


def port_losses_and_grads(tc, params, stats, pc, batch, dtype=torch.float32):
    """The port's ``process_batch`` on the CPU from the same variables, in
    ``dtype``: (losses as floats, {"model.<name>": gradient}, the bundle).
    Under ``self_distillation`` the teacher is frozen from the loaded model."""
    from planedepth_tpu_torch.train.step import ModelBundle as PortBundle
    from planedepth_tpu_torch.train.step import batch_to_tensors, process_batch
    from planedepth_tpu_torch.utils.weights import load_jax_pc_params

    port = PortBundle(tc, torch.device("cpu"))
    load_jax_params(port.model, params["model"], stats["model"])
    if pc is not None:
        load_jax_pc_params(port.pc, pc)
        port.pc.to(dtype)
    port.model.to(dtype)
    if tc.loss.self_distillation > 0:
        port.freeze_teacher()
    tensors = {k: (v.to(dtype) if v.is_floating_point() else v)
               for k, v in batch_to_tensors(batch, torch.device("cpu")).items()}
    losses = process_batch(port.train(), tensors, torch.Generator().manual_seed(tc.seed << 32))
    losses["loss/total_loss"].backward()
    grads = {k: p.grad for k, p in port.named_parameters()}
    return {k: float(v) for k, v in losses.items()}, grads, port


def grads_as_port(model_cfg, grads, stats):
    """A JAX depth-model gradient tree as ``{"model.<name>": tensor}``."""
    model = DepthModel(model_cfg)
    load_jax_params(model, grads, stats)
    names = dict(model.named_parameters())
    return {f"model.{k}": v for k, v in model.state_dict().items() if k in names}


def assert_grads_match(got, want, grads64, mixture, bn_prefixes=("model.encoder.",)):
    """Every gradient leaf of the port (``got``) against the JAX step's
    (``want``) at the max-error rule: max |got - want| over max(|want|, 1e-3
    x the largest gradient) <= 1e-3.  A leaf may miss it only behind
    train-mode BatchNorm (``bn_prefixes``), where the port's float64 step
    ``grads64`` shows float32 rounding of that size in one of the two steps
    (flax takes the batch variance as E[x^2] - E[x]^2; ROADMAP C4): there
    both float32 gradients are held to each other, and the JAX one to the
    float64 one, at relative L2 <= 1e-2.  Without the mixture the loss is an
    L1 with an automask minimum, whose kinks float32 and float64 may take on
    different sides, so such a leaf's two float32 gradients are held to each
    other at relative L2 <= 1e-3 and must stand equally far (within 1e-3)
    from the float64 one; or, where the port's stands within 1e-3 of the
    float64 one, the JAX one is held to it at 5e-2: one pixel on the other
    side of a kink moves a deep encoder leaf that much (in the yz step of
    tests/test_torch_render.py, 1e-6 of noise on the input images moves
    the float64 step's layer4.0.bn2 gradient by 2.9%, the JAX step's gap)."""
    assert set(got) == set(want) == set(grads64)
    gmax = max(float(w.abs().max()) for w in want.values())
    rel = lambda a, b: float((a - b).norm() / max(float(b.norm()), 1e-12))
    for k, w in want.items():
        g, g64, w = got[k].double(), grads64[k].double(), w.double()
        scale = max(float(w.abs().max()), 1e-3 * gmax, 1e-6)
        err = float((g - w).abs().max()) / scale
        if err <= 1e-3:
            continue
        rounding = max(float((g - g64).abs().max()), float((w - g64).abs().max())) / scale
        assert k.startswith(bn_prefixes) and rounding > 1e-3, (k, err, rounding)
        if mixture:
            assert rel(g, w) <= 1e-2 and rel(w, g64) <= 1e-2, (k, rel(g, w), rel(w, g64))
        elif rel(g, g64) <= 1e-3 < rel(w, g64):
            assert rel(w, g64) <= 5e-2, (k, rel(g, g64), rel(w, g64))
        else:
            assert rel(g, w) <= 1e-3, (k, rel(g, w), rel(g, g64), rel(w, g64))
            assert abs(rel(g, g64) - rel(w, g64)) <= 1e-3, (k, rel(g, g64), rel(w, g64))
