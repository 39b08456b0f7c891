"""Checkpoint save and restore (``planedepth_tpu/utils/checkpoint.py``, reference trainer.py:869-913).

Layout of one save, the reference's: ``<log_dir>/<tag>/encoder.pth`` (the
encoder's state dict with the training ``height`` and ``width``),
``depth.pth`` (the decoder's), or one ``plade.pth`` / ``fal.pth`` for
PladeNet and FalNet (with the resolution), with the pose networks
``pose_encoder.pth`` and ``pose.pth``, and ``adam.pth`` (the optimizer's), plus, as
the JAX package writes them, ``<log_dir>/<tag>.meta.json`` (resolution,
step and config) and ``<log_dir>/opt.json`` (the config).  ``last_models``
and ``best_models`` are the reference's tags.  ``utils/weights.py:
load_reference_state_dicts`` reads the ``.pth`` pair.

``restore_submodules`` is the reference's ``--models_to_load`` restore: the
named networks (``encoder``, ``depth`` of a ResNet ``DepthModel``, ``plade``
or ``fal`` of the other families; ``pose_encoder`` and ``pose`` when the run
has pose networks) are loaded whole, every key present and every shape
equal, and a restore that would load nothing raises.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn as nn

_META_KEYS = ("height", "width", "use_stereo")


def _networks(model: nn.Module, pose_nets: Optional[Mapping[str, nn.Module]]
              ) -> Dict[str, nn.Module]:
    """Checkpoint name -> network: the ``DepthModel``'s ``encoder`` and
    ``depth`` (or its ``plade`` / ``fal``, the JAX package's names), then
    ``pose_nets`` (``pose_encoder``, ``pose``)."""
    depth = {name: getattr(model, name) for name in ("encoder", "depth", "plade", "fal")
             if hasattr(model, name)}
    return {**depth, **(pose_nets or {})}


def _cpu_state(module: nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in module.state_dict().items()}


def save_checkpoint(log_dir: str, tag: str, model: nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    config_json: Optional[str] = None,
                    height: Optional[int] = None, width: Optional[int] = None,
                    step: Optional[int] = None,
                    pose_nets: Optional[Mapping[str, nn.Module]] = None) -> str:
    """Save ``model`` (a ``DepthModel``), the ``pose_nets`` by name and
    ``optimizer`` under ``<log_dir>/<tag>``; returns that path."""
    path = os.path.abspath(os.path.join(log_dir, tag))
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    for i, (name, net) in enumerate(_networks(model, pose_nets).items()):
        state = _cpu_state(net)
        if i == 0:
            # the reference embeds the train resolution in the first network's
            # file, encoder.pth (trainer.py:879-882), so the evaluator can run
            # at the right size
            state.update(height=height, width=width, use_stereo=True)
        torch.save(state, os.path.join(path, f"{name}.pth"))
    if optimizer is not None:
        torch.save(optimizer.state_dict(), os.path.join(path, "adam.pth"))
    meta: Dict[str, Any] = {"height": height, "width": width, "step": step}
    if config_json is not None:
        meta["config"] = json.loads(config_json)
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f)
    if config_json is not None:
        with open(os.path.join(log_dir, "opt.json"), "w") as f:
            f.write(config_json)
    return path


def load_checkpoint_meta(path: str) -> Optional[Dict[str, Any]]:
    """Read ``<path>.meta.json`` (train resolution, step, config); the config
    falls back to the run's ``opt.json`` one directory up.  None when
    neither exists (a foreign checkpoint)."""
    path = os.path.abspath(path).rstrip("/")
    meta: Dict[str, Any] = {}
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            meta = json.load(f)
    if "config" not in meta:
        opt_path = os.path.join(os.path.dirname(path), "opt.json")
        if os.path.exists(opt_path):
            with open(opt_path) as f:
                meta["config"] = json.load(f)
    return meta or None


def load_checkpoint(path: str) -> Dict[str, Dict]:
    """``{name: state dict}`` of every ``.pth`` file in the checkpoint
    folder (``encoder``, ``depth``, ``adam``, or a reference folder's)."""
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoint folder {path}")
    return {name[:-4]: torch.load(os.path.join(path, name), map_location="cpu",
                                  weights_only=True)
            for name in sorted(os.listdir(path)) if name.endswith(".pth")}


def _adam_shapes_match(optimizer: torch.optim.Optimizer, saved: Dict) -> bool:
    params = [p for g in optimizer.param_groups for p in g["params"]]
    n_saved = sum(len(g["params"]) for g in saved.get("param_groups", ()))
    state = saved.get("state", {})
    if n_saved != len(params) or not set(state) <= set(range(len(params))):
        return False
    return all(tuple(s[k].shape) == tuple(params[i].shape)
               for i, s in state.items() for k in ("exp_avg", "exp_avg_sq"))


@torch.no_grad()
def restore_submodules(model: nn.Module, payload: Dict[str, Dict],
                       models_to_load: Sequence[str],
                       optimizer: Optional[torch.optim.Optimizer] = None,
                       restore_optimizer: bool = False,
                       pose_nets: Optional[Mapping[str, nn.Module]] = None
                       ) -> Tuple[str, ...]:
    """Filtered restore (reference trainer.py:888-913): load the named
    networks of ``model`` (a ``DepthModel``) and ``pose_nets`` from
    ``payload`` (:func:`load_checkpoint`) and,
    with ``restore_optimizer``, the Adam moments and step counts when their
    shapes match the optimizer's parameters (else Adam starts afresh, as in
    the JAX package).  The optimizer keeps this run's LR and betas, as the
    JAX package's schedule does.  Returns the names loaded.

    Raises on a name that is not one of these networks, on a named network
    missing from the checkpoint or whose keys or shapes differ from the
    model's, and when ``models_to_load`` is empty.
    """
    if not models_to_load:
        raise ValueError("restore_submodules: models_to_load is empty; nothing "
                         "would be loaded")
    nets = _networks(model, pose_nets)
    for name in models_to_load:
        if name not in nets:
            raise ValueError(f"restore_submodules: no network {name!r} here "
                             f"(has {tuple(nets)})")
        if name not in payload:
            raise KeyError(f"restore_submodules: the checkpoint has no {name}.pth "
                           f"(has {sorted(payload)})")
    for name in models_to_load:
        sub = nets[name]
        saved = {k: v for k, v in payload[name].items() if k not in _META_KEYS}
        want = sub.state_dict()
        missing = sorted(set(want) - set(saved))
        if missing:
            raise KeyError(f"restore_submodules: {name}.pth lacks {len(missing)} of "
                           f"{len(want)} keys, e.g. {missing[:3]}")
        for k, v in want.items():
            if tuple(saved[k].shape) != tuple(v.shape):
                raise ValueError(f"restore_submodules: {name}.{k}: checkpoint "
                                 f"{tuple(saved[k].shape)} vs model {tuple(v.shape)}")
        # keys of the reference's file the port does not have (the encoder's
        # unused fc head) are not read
        sub.load_state_dict({k: saved[k] for k in want})
    if restore_optimizer and optimizer is not None and "adam" in payload:
        if _adam_shapes_match(optimizer, payload["adam"]):
            optimizer.load_state_dict({
                "state": payload["adam"]["state"],
                "param_groups": optimizer.state_dict()["param_groups"]})
        else:
            print("[checkpoint] optimizer state incompatible (parameter count or "
                  "shapes differ), Adam re-initialized")
    return tuple(models_to_load)
