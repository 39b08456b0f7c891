"""The JAX package's bf16 reference for the port's bf16 tests, computed in a process of its own.

XLA's CPU compiler drops the bf16 rounding of a convolution's output where
the consumer upcasts it at once (BatchNorm, which normalises in float32; a
float32 cast of a head) unless ``--xla_allow_excess_precision=false``.  The
flax modules declare those roundings (``nn.Conv(dtype=bf16)`` returns bf16),
and the port rounds where they are declared, so the reference is computed
with that flag, which must be set before JAX starts: hence a process of its
own (``reference``), whose results come back as an ``.npz``.

    python -m tests._torch_bf16_ref <kind> <out.npz>

``kind`` is ``stage1`` (a fused stage-1 step: losses, depth-model
gradients, train-mode heads; the train-mode forward of the same networks
outside the fused sweep, float32 heads and a disp; and the eval forward) or
``mono`` (a homography step through the oracle with bf16 samples, the
bf16 counterpart of the port's 2-D warp route: losses and the gradients of
every network).  Each writes its perturbed variables and its batch too.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

H, W = 64, 96
REPO = Path(__file__).resolve().parents[1]
PLANES = dict(disp_levels=7, disp_min=2, disp_max=24, xz_levels=3, yz_levels=0)
MODEL = dict(num_layers=18, use_denseaspp=False, use_mixture_loss=True, plane_residual=True,
             num_ep=0)


def configs(kind, bf16):
    """(JAX config, port config) of ``kind``; ``bf16`` for both."""
    from planedepth_tpu import config as jcfg
    from planedepth_tpu_torch import config as tcfg

    if kind == "stage1":
        extra = dict(batch_size=2, flip_right=True, fused_sweep=True)
        jextra, textra = extra, extra
        model = MODEL
    else:
        model = dict(MODEL, pose_num_layers=18, pose_num_ep=8)
        common = dict(batch_size=2, warp_type="homography_warp", novel_frame_ids=(-1, 1))
        # the JAX oracle with bf16 samples is the bf16 twin of the port's warp route
        jextra = dict(common, fused_sweep=False, warp_sample_bf16=bf16)
        textra = dict(common, fused_sweep=True)
    j = jcfg.TrainConfig(
        model=jcfg.ModelConfig(planes=jcfg.PlaneConfig(**PLANES), **model),
        loss=jcfg.LossConfig(alpha_pc=0.1, automask=True),
        data=jcfg.DataConfig(height=H, width=W), bf16=bf16, allow_random_pc=True, **jextra)
    t = tcfg.TrainConfig(
        bf16=bf16, model=tcfg.ModelConfig(planes=tcfg.PlaneConfig(**PLANES), **model),
        loss=tcfg.LossConfig(alpha_pc=0.1, automask=True),
        data=tcfg.DataConfig(height=H, width=W), **textra)
    return j, t


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        out.update(flatten(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


def unflatten(flat, prefix):
    tree = {}
    for key, v in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        *path, leaf = key[len(prefix) + 1:].split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _compute(kind, out_path):
    import jax
    import jax.numpy as jnp

    from planedepth_tpu.data.synthetic import make_stereo_batch
    from planedepth_tpu.geometry.pose import transformation_from_parameters
    from planedepth_tpu.train.step import ModelBundle, process_batch
    from tests._torch_parity import perturbed_init

    jc, _ = configs(kind, True)
    bundle = ModelBundle(jc)
    # the same networks outside the fused sweep: float32 heads and a disp
    plain = ModelBundle(jc.replace(fused_sweep=False))
    params, stats, pc = perturbed_init(bundle, 0, H, W)
    if kind == "stage1":
        batch = make_stereo_batch(1, H, W, seed=4)
    else:
        batch = make_stereo_batch(2, H, W, seed=4, novel_frame_ids=(-1, 1))
        # off the pure x-translation: no sample on an integer y coordinate
        jitter = transformation_from_parameters(
            jnp.asarray([[[0.002, -0.001, 0.003]]], jnp.float32),
            jnp.asarray([[[0.001, 0.004, 0.002]]], jnp.float32))
        batch["Rt_r"] = np.array(jnp.einsum("bij,njk->bik", batch["Rt_r"], jitter))

    @jax.jit
    def run(params, stats, pc, jbatch):
        def loss_fn(p):
            losses, _, _ = process_batch(bundle, p, stats, None, pc, jbatch,
                                         jax.random.PRNGKey(0), train=True)
            return losses["loss/total_loss"], losses
        (_, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        out = {}
        if kind == "stage1":
            train, _ = bundle.depth_forward(params, stats, jbatch["color_aug_l"],
                                            jbatch["grid"], train=True)
            ev, _ = bundle.depth_forward(params, stats, jbatch["color_l"], jbatch["grid"],
                                         train=False)
            full, _ = plain.depth_forward(params, stats, jbatch["color_aug_l"],
                                          jbatch["grid"], train=True)
            out = {"train_logits": train["logits"], "train_sigma": train["sigma"],
                   "eval_logits": ev["logits"], "eval_sigma": ev["sigma"],
                   "eval_disp": ev["disp"], "full_logits": full["logits"],
                   "full_sigma": full["sigma"], "full_disp": full["disp"]}
        return losses, grads, out

    losses, grads, out = run(params, stats, pc, {k: jnp.asarray(v) for k, v in batch.items()})
    dtypes = {f"dtype/{k}": np.array(str(v.dtype)) for k, v in out.items()}
    losses = {k.replace("/", "|"): v for k, v in losses.items()}
    flat = {**flatten(jax.tree.map(np.asarray, losses), "losses"),
            **flatten(jax.tree.map(np.asarray, grads), "grads"),
            **flatten(jax.tree.map(np.asarray, params), "params"),
            **flatten(jax.tree.map(np.asarray, stats), "stats"),
            **(flatten(jax.tree.map(np.asarray, pc), "pc") if pc is not None else {}),
            **{f"out/{k}": np.asarray(v.astype(jnp.float32)) for k, v in out.items()},
            **flatten(batch, "batch"), **dtypes}
    np.savez(out_path, **flat)


def reference(kind, out_path):
    """``kind``'s JAX bf16 reference, computed by a process of its own with
    the flag set, as nested dicts of numpy arrays."""
    env = dict(os.environ, XLA_FLAGS="--xla_allow_excess_precision=false",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    subprocess.run([sys.executable, "-m", "tests._torch_bf16_ref", kind, str(out_path)],
                   cwd=str(REPO), env=env, check=True)
    with np.load(out_path) as f:
        flat = {k: f[k] for k in f.files}
    ref = {name: unflatten(flat, name) for name in ("losses", "grads", "params", "stats",
                                                     "pc", "out", "batch", "dtype")}
    ref["pc"] = ref["pc"] or None
    ref["losses"] = {k.replace("|", "/"): float(v) for k, v in ref["losses"].items()}
    return ref


if __name__ == "__main__":
    _compute(sys.argv[1], sys.argv[2])
