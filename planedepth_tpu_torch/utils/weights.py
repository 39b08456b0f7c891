"""Weights into the port: the JAX package's trees and the reference's ``.pth`` files.

``load_jax_params`` is the inverse of ``planedepth_tpu/utils/torch_convert.py``:
a JAX ``DepthModel`` tree (``{"encoder": {"encoder": trunk}, "depth": decoder}``,
or ``{"plade": ...}`` / ``{"fal": ...}`` for PladeNet and FalNet, as numpy)
goes into the port's ``state_dict``; the PladeNet/FalNet modules carry the
JAX module names, so their paths map one to one.  Conv kernels are transposed
HWIO -> OIHW; BatchNorm ``scale``/``bias`` (params) and ``mean``/``var``
(batch stats) become ``weight``/``bias``/``running_mean``/``running_var``.
``load_jax_pose_params`` does the same for the pose networks (the names of
``convert_resnet_encoder(num_input_images=2)`` and ``convert_pose_decoder``),
``load_jax_pc_params`` for the frozen perceptual net (VGG-19, or the
ResNet-18 trunk, whose tree is a ResNet encoder's), and
``load_jax_encoder_params`` for one ResNet trunk alone (the converted ImageNet
files of ``utils/pretrained.py``).  The API-parity networks take their JAX
modules' trees: ``load_jax_plade_pose_params`` (``PladePoseNet``, whose
module names are the flax ones), ``load_jax_monov2_params``
(``Monov2Decoder``, the same) and ``load_jax_continuous_params``
(``DepthDecoderContinuous``, the ``DepthDecoder`` ladder's reference names).
``jax_leaf_shapes`` lists the JAX leaves a module takes, with their JAX
shapes.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

from planedepth_tpu_torch.models.depth_decoder import DepthDecoderContinuous
from planedepth_tpu_torch.models.monov2_decoder import Monov2Decoder
from planedepth_tpu_torch.models.pose_net import PladePoseNet

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


# the pose decoder's ``net`` ModuleList in the reference's order, without and
# with the positional encoding (``convert_pose_decoder``)
_POSE_NAMES = {False: ("squeeze_0", "pose_0", "pose_1", "pose_2"),
               True: ("squeeze_0", "epconv", "pose_0", "pose_1", "pose_2")}


def _pose_path(num_ep: int, parts) -> Tuple[str, ...]:
    """``{idx}[.<0|2>]`` of the pose decoder's ``net`` -> JAX module path."""
    name = _POSE_NAMES[num_ep > 0][int(parts[0])]
    if name == "epconv":
        return ("epconv", "conv0" if parts[1] == "0" else "conv1")
    return (name,)


def _trunk_path(parts) -> Tuple[str, ...]:
    """``encoder.<trunk path>`` inside a ``ResnetEncoder`` -> JAX module path."""
    return ("encoder",) + _encoder_path(parts[1:])


def _depth_model_path(model: nn.Module, parts) -> Tuple[str, ...]:
    if parts[0] in ("plade", "fal"):
        return tuple(parts)
    if parts[0] == "encoder":
        return ("encoder", "encoder") + _encoder_path(parts[2:])
    if parts[0] == "depth":
        return ("depth",) + _decoder_path(list(model.depth.convs), parts[2:])
    raise KeyError(".".join(parts))


def _leaf(path: Tuple[str, ...], leaf: str) -> Tuple[str, Tuple[str, ...], str]:
    """(collection, JAX module path, leaf name) of a port leaf at ``path``."""
    if re.fullmatch(r"(bn\d|norm\d*|downsample_bn)", path[-1]):
        collection, jleaf = _BN_LEAF[leaf]
        return collection, path + ("bn",), jleaf
    return "params", path, _CONV_LEAF[leaf]


def _leaves(module: nn.Module, module_path):
    """``(state_dict key, tensor, collection, JAX module path, JAX leaf)`` of
    every parameter and running statistic of ``module``; BatchNorm's
    ``num_batches_tracked`` has no JAX counterpart."""
    for key, tensor in module.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        parts = key.split(".")
        yield (key, tensor) + _leaf(module_path(parts[:-1]), parts[-1])


def _flax_path(parts) -> Tuple[str, ...]:
    """A module whose names are the flax ones: the path as it is."""
    return tuple(parts)


def _module_path(module: nn.Module):
    """The JAX module path of ``module``'s leaves: the API-parity networks'
    own, a ResNet trunk's for any other."""
    if isinstance(module, (PladePoseNet, Monov2Decoder)):
        return _flax_path
    if isinstance(module, DepthDecoderContinuous):
        return lambda parts: _decoder_path(list(module.convs), parts[1:])
    return _trunk_path


def jax_leaf_shapes(module: nn.Module, module_path=None) -> Dict[str, Tuple[int, ...]]:
    """The ``/``-joined JAX key (``params/encoder/conv1/kernel``) and the JAX
    shape (HWIO kernels) of every leaf ``module`` takes; ``module_path`` as
    in :func:`_copy_leaves`, by default the API-parity networks' own and a
    ``ResnetEncoder``'s for any other module."""
    module_path = module_path or _module_path(module)
    shapes = {}
    for _, tensor, collection, path, leaf in _leaves(module, module_path):
        shape = tuple(tensor.shape)
        if len(shape) == 4:
            shape = (shape[2], shape[3], shape[1], shape[0])            # OIHW -> HWIO
        shapes["/".join((collection,) + path + (leaf,))] = shape
    return shapes


@torch.no_grad()
def _copy_leaves(module: nn.Module, trees: Mapping, module_path) -> None:
    """Copy every parameter and running statistic of ``module`` from the JAX
    ``trees`` (``{"params": ..., "batch_stats": ...}``, numpy leaves);
    ``module_path(parts)`` maps a ``state_dict`` key's module parts to the
    JAX module path.  BatchNorm's ``num_batches_tracked`` has no JAX
    counterpart."""
    for key, tensor, collection, path, leaf in _leaves(module, module_path):
        node = trees[collection]
        for p in path:
            node = node[p]
        value = np.asarray(node[leaf])
        if value.ndim == 4:
            value = np.transpose(value, (3, 2, 0, 1))          # HWIO -> OIHW
        if tuple(value.shape) != tuple(tensor.shape):
            raise ValueError(f"{key}: JAX {value.shape} vs port {tuple(tensor.shape)}")
        tensor.copy_(torch.from_numpy(np.array(value)))


def load_jax_params(model: nn.Module, params: Mapping, batch_stats: Mapping) -> None:
    """Copy a JAX ``DepthModel``'s variables (numpy leaves) into ``model``;
    every parameter and running statistic of the port must be found."""
    _copy_leaves(model, {"params": params, "batch_stats": batch_stats},
                 lambda parts: _depth_model_path(model, parts))


def load_jax_pose_params(pose_encoder: nn.Module, pose: nn.Module, params: Mapping,
                         batch_stats: Mapping) -> None:
    """Copy the JAX ``params["pose_encoder"]``, ``batch_stats["pose_encoder"]``
    and ``params["pose"]`` (the trees of the JAX ``ModelBundle``, numpy
    leaves) into the port's ``ResnetPoseEncoder`` and ``PoseDecoder``."""
    load_jax_encoder_params(pose_encoder, params["pose_encoder"], batch_stats["pose_encoder"])
    _copy_leaves(pose, {"params": params["pose"]},
                 lambda parts: _pose_path(pose.num_ep, parts[1:]))


def load_jax_encoder_params(encoder: nn.Module, params: Mapping,
                            batch_stats: Mapping) -> None:
    """Copy one JAX ``ResnetEncoder``'s variables (``{"encoder": trunk}``
    each, numpy leaves) into the port's ``ResnetEncoder`` or
    ``ResnetPoseEncoder``."""
    _copy_leaves(encoder, {"params": params, "batch_stats": batch_stats}, _trunk_path)


def load_jax_plade_pose_params(model: PladePoseNet, params: Mapping,
                               batch_stats: Mapping) -> None:
    """Copy a JAX ``PladePoseNet``'s variables (its ``params`` and, with
    BatchNorm, ``batch_stats`` trees, numpy leaves) into the port's."""
    _copy_leaves(model, {"params": params, "batch_stats": batch_stats}, _flax_path)


def load_jax_monov2_params(model: Monov2Decoder, params: Mapping) -> None:
    """Copy a JAX ``Monov2Decoder``'s ``params`` (numpy leaves) into the port's."""
    _copy_leaves(model, {"params": params}, _flax_path)


def load_jax_continuous_params(model: DepthDecoderContinuous, params: Mapping,
                               batch_stats: Mapping) -> None:
    """Copy a JAX ``DepthDecoderContinuous``'s variables (``params`` and, with
    DenseASPP, ``batch_stats``, numpy leaves) into the port's."""
    _copy_leaves(model, {"params": params, "batch_stats": batch_stats},
                 _module_path(model))


def load_reference_state_dicts(model: nn.Module, encoder_sd: Dict,
                               depth_sd: Dict) -> None:
    """Load the reference's ``encoder.pth`` and ``depth.pth`` state dicts
    into a ResNet ``DepthModel``.

    ``encoder.pth`` also holds torchvision's unused ``fc`` head and the
    ``height``/``width``/``use_stereo`` metadata; only the trunk's keys are
    taken, and each of them must be present.  The reference's ``plade.pth``
    and ``fal.pth`` key layouts are not known here (no copy of the
    reference code); PladeNet and FalNet load from the JAX trees only.
    """
    enc_keys = model.encoder.state_dict().keys()
    model.encoder.load_state_dict({k: torch.as_tensor(encoder_sd[k]) for k in enc_keys})
    model.depth.load_state_dict({k: torch.as_tensor(v) for k, v in depth_sd.items()})


# torchvision ``features`` indices of the VGG-19 convs, in JAX ``conv_{i}`` order
VGG19_CONV_IDS = (0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25)


@torch.no_grad()
def load_jax_pc_params(pc: nn.Module, tree: Mapping) -> None:
    """Weights into the port's perceptual net.  A ``Resnet18Features`` takes
    the JAX ``pc_params`` tree (``{"params": {"encoder": trunk},
    "batch_stats": {"encoder": trunk}}``, the layout of a converted
    ``resnet18.npz``).  A ``Vgg19Features`` takes either the JAX tree
    (``{"params": {"conv_{i}": {kernel, bias}}}``, the inverse of
    ``utils/torch_convert.py:convert_vgg19_features``) or a
    torchvision-layout state dict (``features.{i}.weight`` or
    ``{i}.weight``).  Every weight of ``pc`` must be found.
    """
    if not hasattr(pc, "features"):
        load_jax_encoder_params(pc, tree["params"], tree.get("batch_stats", {}))
        return
    vgg = pc
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
