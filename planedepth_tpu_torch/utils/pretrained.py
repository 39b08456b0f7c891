"""Converted ImageNet weights for training (``planedepth_tpu/utils/pretrained.py``).

The reference trains from ImageNet-pretrained torchvision encoders
(reference networks/resnet_encoder.py:35) and a frozen ImageNet VGG19
perceptual net (reference layers.py:381).  The JAX package converts them
offline into flat-key ``.npz`` files (its ``scripts/convert_torch_weights.py``
and ``utils/torch_convert.py:save_converted``); this module reads those same
files with numpy and copies them into a fresh ``ModelBundle`` when the
``Trainer`` is built, through the JAX-tree mappers of ``utils/weights.py``.

Files in ``TrainConfig.weights_dir``:

  ``resnet{num_layers}.npz``       depth encoder trunk (net_type ResNet)
  ``resnet{pose_num_layers}.npz``  pose encoder trunk, conv1 tiled and
                                   averaged for the two-frame input
                                   (reference pose_net.py:57-60)
  ``vgg19.npz`` / ``resnet18.npz`` perceptual net per ``LossConfig.pc_net``

A file whose tree does not match the live network, in structure or in a
shape, raises :class:`PretrainedWeightsError` before anything is copied.
"""
from __future__ import annotations

import os
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch.nn as nn

from planedepth_tpu_torch.utils.weights import (
    jax_leaf_shapes,
    load_jax_encoder_params,
    load_jax_pc_params,
)


class PretrainedWeightsError(RuntimeError):
    pass


def load_converted(path: str) -> Dict:
    """An ``.npz`` of ``/``-joined keys back into a nested variables dict
    (``{"params": ..., "batch_stats": ...}``)."""
    tree: Dict = {}
    with np.load(path) as flat:
        for key in flat.files:
            node = tree
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = flat[key]
    return tree


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(_flatten(v, key))
        else:
            flat[key] = v
    return flat


def _check_tree(want: Dict[str, Tuple[int, ...]], tree: Mapping, what: str) -> None:
    """The converted ``tree`` must have exactly the leaves ``want`` names
    (``/``-joined JAX keys), each of its JAX shape: a mismatch means the
    offline conversion and the live network disagree."""
    got = _flatten(tree)
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    if missing or extra:
        raise PretrainedWeightsError(
            f"{what}: converted tree does not match the live model (missing from "
            f"npz: {missing[:8]}, unexpected in npz: {extra[:8]})")
    bad = [k for k in want if tuple(np.shape(got[k])) != want[k]]
    if bad:
        raise PretrainedWeightsError(
            f"{what}: shape mismatch at {bad[:8]}: "
            f"{[(tuple(np.shape(got[k])), want[k]) for k in bad[:4]]}")


def _vgg_leaf_shapes(vgg: nn.Module) -> Dict[str, Tuple[int, ...]]:
    """The JAX ``pc_params`` leaves of the port's VGG: ``conv_{i}`` in
    order, HWIO kernels."""
    convs = [m for m in vgg.features if isinstance(m, nn.Conv2d)]
    shapes = {}
    for i, conv in enumerate(convs):
        o, ci, kh, kw = conv.weight.shape
        shapes[f"params/conv_{i}/kernel"] = (kh, kw, ci, o)
        shapes[f"params/conv_{i}/bias"] = (o,)
    return shapes


def _tile_conv1(tree: Dict, num_input_images: int) -> Dict:
    """Tile and average the trunk's conv1 kernel (HWIO) for stacked-frame
    input (reference pose_net.py:57-60)."""
    out = dict(tree)
    enc = dict(out["encoder"])
    conv1 = dict(enc["conv1"])
    k = np.asarray(conv1["kernel"])
    if k.shape[2] == 3 and num_input_images > 1:
        conv1["kernel"] = np.concatenate([k] * num_input_images, axis=2) / num_input_images
    enc["conv1"] = conv1
    out["encoder"] = enc
    return out


def _load_encoder(encoder: nn.Module, params: Mapping, batch_stats: Mapping,
                  what: str) -> None:
    _check_tree(jax_leaf_shapes(encoder), {"params": params, "batch_stats": batch_stats},
                what)
    load_jax_encoder_params(encoder, params, batch_stats)


def apply_pretrained(cfg, bundle) -> List[str]:
    """Copy the converted ImageNet weights of ``cfg.weights_dir`` into the
    networks of ``bundle`` (a ``ModelBundle``, in place); returns what was
    loaded, in the JAX package's names (``encoder<-resnet50``,
    ``pose_encoder<-resnet18``, ``pc<-vgg19.npz``)."""
    loaded: List[str] = []
    wd = cfg.weights_dir
    if wd is None:
        return loaded
    if not os.path.isdir(wd):
        raise PretrainedWeightsError(f"weights_dir does not exist: {wd}")

    # depth encoder (ResNet family only; PladeNet/FalNet train from scratch
    # in the reference, trainer.py:205-224)
    if cfg.model.net_type == "ResNet":
        name = f"resnet{cfg.model.num_layers}"
        path = os.path.join(wd, f"{name}.npz")
        if not os.path.exists(path):
            raise PretrainedWeightsError(
                f"net_type ResNet with weights_dir set requires {path} (converted by "
                f"the JAX package's scripts/convert_torch_weights.py {name} <pth> {wd})")
        tree = load_converted(path)
        _load_encoder(bundle.model.encoder, tree.get("params", {}),
                      tree.get("batch_stats", {}), "depth encoder")
        loaded.append(f"encoder<-{name}")

    # pose encoder (two-frame stacked input)
    if cfg.use_pose_net and bundle.pose_encoder is not None:
        name = f"resnet{cfg.model.pose_num_layers}"
        path = os.path.join(wd, f"{name}.npz")
        if os.path.exists(path):
            tree = load_converted(path)
            params = tree.get("params", {})
            if "conv1" in params.get("encoder", {}):
                params = _tile_conv1(params, num_input_images=2)
            _load_encoder(bundle.pose_encoder, params, tree.get("batch_stats", {}),
                          "pose encoder")
            loaded.append(f"pose_encoder<-{name}")

    # perceptual net
    if cfg.loss.alpha_pc > 0 and bundle.pc is not None:
        fname = "vgg19.npz" if cfg.loss.pc_net == "vgg19" else "resnet18.npz"
        path = os.path.join(wd, fname)
        if not os.path.exists(path):
            raise PretrainedWeightsError(
                f"alpha_pc={cfg.loss.alpha_pc} > 0 requires ImageNet perceptual weights, "
                f"but {path} is missing (converted by the JAX package's "
                f"scripts/convert_torch_weights.py {cfg.loss.pc_net} <pth> {wd})")
        tree = load_converted(path)
        want = (_vgg_leaf_shapes(bundle.pc) if cfg.loss.pc_net == "vgg19"
                else jax_leaf_shapes(bundle.pc))
        _check_tree(want, tree, "perceptual")
        load_jax_pc_params(bundle.pc, tree)
        loaded.append(f"pc<-{fname}")
    return loaded


def check_perceptual_weights(cfg, loaded: List[str]) -> None:
    """Raise when the perceptual loss would backpropagate through a random
    net: the reference always uses ImageNet features (layers.py:381) and
    alpha_pc = 0.1 is every preset's, so silently training against noise is
    the single most damaging misconfiguration."""
    if cfg.loss.alpha_pc <= 0 or cfg.allow_random_pc:
        return
    if any(name.startswith("pc<-") for name in loaded):
        return
    raise PretrainedWeightsError(
        f"alpha_pc={cfg.loss.alpha_pc} > 0 but no converted {cfg.loss.pc_net} ImageNet "
        "weights were loaded: set weights_dir to a directory holding the converted .npz, "
        "set alpha_pc to 0, or set allow_random_pc to accept a random perceptual net.")
