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

MODEL_FIELDS = ("num_layers", "num_ep", "pe_type", "use_denseaspp",
                "use_mixture_loss", "plane_residual")


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


def make_models(height, width, fused_head="off", seed=0, **model_kw):
    """-> (jax_forward, params_np, stats_np, port_model) for one config."""
    cfg = jcfg.TrainConfig(
        model=jcfg.ModelConfig(fused_head=fused_head, **model_kw),
        loss=jcfg.LossConfig(alpha_pc=0.0),
        data=jcfg.DataConfig(height=height, width=width),
        bf16=False,
    )
    bundle = ModelBundle(cfg)
    params, stats, _ = bundle.init(jax.random.PRNGKey(seed), height, width)
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


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def jnp_in(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)
