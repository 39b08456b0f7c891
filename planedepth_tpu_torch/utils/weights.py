"""Weights into the port: the JAX package's trees and the reference's ``.pth`` files.

``load_jax_params`` is the inverse of ``planedepth_tpu/utils/torch_convert.py``:
a JAX ``DepthModel`` tree (``{"encoder": {"encoder": trunk}, "depth": decoder}``,
as numpy) goes into the port's ``state_dict``.  Conv kernels are transposed
HWIO -> OIHW; BatchNorm ``scale``/``bias`` (params) and ``mean``/``var``
(batch stats) become ``weight``/``bias``/``running_mean``/``running_var``.
``load_jax_pc_params`` does the same for the frozen perceptual VGG.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

_BN_LEAF = {"weight": ("params", "scale"), "bias": ("params", "bias"),
            "running_mean": ("batch_stats", "mean"),
            "running_var": ("batch_stats", "var")}
_CONV_LEAF = {"weight": "kernel", "bias": "bias"}


def _encoder_path(parts) -> Tuple[str, ...]:
    """``conv1`` / ``bn1`` / ``layer2.0.conv3`` / ``layer2.0.downsample.1``
    (module path inside the trunk) -> JAX module path."""
    if parts[0].startswith("layer"):
        block = f"{parts[0]}_{parts[1]}"
        rest = parts[2:]
        if rest[0] == "downsample":
            return (block, "downsample_conv" if rest[1] == "0" else "downsample_bn")
        return (block, rest[0])
    return (parts[0],)


def _decoder_path(names, parts) -> Tuple[str, ...]:
    """``{idx}.<sub...>`` of the decoder ModuleList -> JAX module path."""
    name, sub = names[int(parts[0])], parts[1:]
    if name == "epconv":
        return ("epconv", "conv0" if sub[0] == "0" else "conv1")
    if name == "residualconv":
        return ("residualconv_0" if sub[0] == "0" else "residualconv_1",)
    if name == "denseaspp":
        if sub[0] == "classification":
            return ("denseaspp", "classification")
        return ("denseaspp", sub[0].lower(), sub[1])
    return (name,) + tuple(sub)       # upconv: conv.conv, dispconv: conv


def _jax_key(model: nn.Module, key: str) -> Tuple[str, Tuple[str, ...], str]:
    """Port ``state_dict`` key -> (collection, JAX module path, leaf name)."""
    parts = key.split(".")
    leaf = parts[-1]
    if parts[0] == "encoder":
        path = ("encoder", "encoder") + _encoder_path(parts[2:-1])
    elif parts[0] == "depth":
        path = ("depth",) + _decoder_path(list(model.depth.convs), parts[2:-1])
    else:
        raise KeyError(key)
    if re.fullmatch(r"(bn\d|norm\d|downsample_bn)", path[-1]):
        collection, jleaf = _BN_LEAF[leaf]
        return collection, path + ("bn",), jleaf
    return "params", path, _CONV_LEAF[leaf]


@torch.no_grad()
def load_jax_params(model: nn.Module, params: Mapping, batch_stats: Mapping) -> None:
    """Copy a JAX ``DepthModel``'s variables (numpy leaves) into ``model``.

    Every parameter and running statistic of the port must be found in the
    trees; BatchNorm's ``num_batches_tracked`` has no JAX counterpart.
    """
    trees = {"params": params, "batch_stats": batch_stats}
    for key, tensor in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        collection, path, leaf = _jax_key(model, key)
        node = trees[collection]
        for p in path:
            node = node[p]
        value = np.asarray(node[leaf])
        if value.ndim == 4:
            value = np.transpose(value, (3, 2, 0, 1))          # HWIO -> OIHW
        if tuple(value.shape) != tuple(tensor.shape):
            raise ValueError(f"{key}: JAX {value.shape} vs port {tuple(tensor.shape)}")
        tensor.copy_(torch.from_numpy(np.array(value)))


def load_reference_state_dicts(model: nn.Module, encoder_sd: Dict,
                               depth_sd: Dict) -> None:
    """Load the reference's ``encoder.pth`` and ``depth.pth`` state dicts.

    ``encoder.pth`` also holds torchvision's unused ``fc`` head and the
    ``height``/``width``/``use_stereo`` metadata; only the trunk's keys are
    taken, and each of them must be present.
    """
    enc_keys = model.encoder.state_dict().keys()
    model.encoder.load_state_dict({k: torch.as_tensor(encoder_sd[k]) for k in enc_keys})
    model.depth.load_state_dict({k: torch.as_tensor(v) for k, v in depth_sd.items()})


# torchvision ``features`` indices of the VGG-19 convs, in JAX ``conv_{i}`` order
VGG19_CONV_IDS = (0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25)


@torch.no_grad()
def load_jax_pc_params(vgg: nn.Module, tree: Mapping) -> None:
    """Weights into the port's ``Vgg19Features``, from either the JAX
    ``pc_params`` tree (``{"params": {"conv_{i}": {kernel, bias}}}``, the
    inverse of ``utils/torch_convert.py:convert_vgg19_features``) or a
    torchvision-layout state dict (``features.{i}.weight`` or ``{i}.weight``).
    Every conv of ``vgg`` must be found.
    """
    if "params" in tree:
        src = {}
        for i, cid in enumerate(VGG19_CONV_IDS):
            leaf = tree["params"].get(f"conv_{i}")
            if leaf is None:
                break
            src[f"{cid}.weight"] = np.transpose(np.asarray(leaf["kernel"]), (3, 2, 0, 1))
            src[f"{cid}.bias"] = np.asarray(leaf["bias"])
    else:
        src = {k.removeprefix("features."): v for k, v in tree.items()}
    for key, tensor in vgg.features.state_dict().items():
        value = torch.from_numpy(np.array(src[key], dtype=np.float32))
        if tuple(value.shape) != tuple(tensor.shape):
            raise ValueError(f"features.{key}: source {tuple(value.shape)} vs "
                             f"port {tuple(tensor.shape)}")
        tensor.copy_(value)
