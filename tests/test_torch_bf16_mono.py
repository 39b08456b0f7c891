"""The port's bf16 monocular step against the JAX package's bf16 one.

One step of the homography recipe (sides r, -1, 1: pose nets, per-plane
homographies, automask, VGG19 perceptual loss at alpha_pc 0.1) of the port
in bf16 on the CPU, where the 2-D warp takes its plain version on bf16
images and heads, is held to the JAX package's bf16 step through its
oracle view synthesis with bf16 samples (``warp_sample_bf16``: the XLA
grid_sample computes in float32 and rounds each sample to bf16, as the
warp kernels do; tests/test_warp2d_train.py holds the JAX warp2d step to
that oracle), from the same perturbed weights, computed with the bf16
roundings the flax modules declare (``tests/_torch_bf16_ref.py``), at
tests/test_torch_mono.py's small configuration (ResNet-18 without
DenseASPP, 7+3 planes, the pose decoder's 8-channel PE; 64x96).  The
port's float32 step from the same weights is the yardstick, as in
tests/test_torch_bf16_step.py:

- the losses at rtol 2e-3;
- the gradients of every network (depth model, pose encoder and decoder):
  every leaf within relative L2 max(1.5 x the float32 step's distance from
  the JAX bf16 step, 0.05), and the whole gradient nearer the JAX bf16 step
  than the float32 step is.
"""
import numpy as np
import pytest
import torch

from planedepth_tpu_torch.models.factory import DepthModel
from planedepth_tpu_torch.models.pose_net import PoseDecoder
from planedepth_tpu_torch.models.resnet import ResnetPoseEncoder
from planedepth_tpu_torch.ops.warp2d import warp2d
from planedepth_tpu_torch.train.step import ModelBundle, batch_to_tensors, process_batch
from planedepth_tpu_torch.utils.weights import (
    load_jax_params,
    load_jax_pc_params,
    load_jax_pose_params,
)
from tests._torch_bf16_ref import configs, reference

torch.set_num_threads(1)
CPU = torch.device("cpu")
LOSS_KEYS = ("loss/ph_loss", "loss/pc_loss", "loss/smooth_loss", "loss/total_loss")


def _port_step(tc, ref):
    """The port's losses and ``{"<net>.<name>": gradient}`` from ``ref``'s
    variables and batch."""
    params, stats = ref["params"], ref["stats"]
    port = ModelBundle(tc, CPU)
    load_jax_params(port.model, params["model"], stats["model"])
    load_jax_pose_params(port.pose_encoder, port.pose, params, stats)
    load_jax_pc_params(port.pc, ref["pc"])
    losses = process_batch(port.train(), batch_to_tensors(ref["batch"], CPU),
                           torch.Generator().manual_seed(tc.seed << 32))
    losses["loss/total_loss"].backward()
    return ({k: float(v) for k, v in losses.items()},
            {k: p.grad for k, p in port.named_parameters()}, port)


def _as_port(port, grads, stats):
    """The JAX gradient trees of the three networks as port-named tensors."""
    model = DepthModel(port.model.cfg)
    load_jax_params(model, grads["model"], stats["model"])
    enc = ResnetPoseEncoder(port.cfg.model.pose_num_layers, 2)
    dec = PoseDecoder(enc.num_ch_enc, port.cfg.model.pose_num_ep)
    load_jax_pose_params(enc, dec, grads, stats)
    out = {}
    for name, net in (("model", model), ("pose_encoder", enc), ("pose", dec)):
        names = dict(net.named_parameters())
        out.update({f"{name}.{k}": v for k, v in net.state_dict().items() if k in names})
    return out


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    ref = reference("mono", tmp_path_factory.mktemp("bf16") / "mono.npz")
    out = {"ref": ref}
    for name, bf16 in (("bf16", True), ("f32", False)):
        launches = warp2d.bf16_fwd_launches, warp2d.fwd_launches
        losses, grads, port = _port_step(configs("mono", bf16)[1], ref)
        assert (warp2d.bf16_fwd_launches, warp2d.fwd_launches) == launches   # CPU: plain
        out[name] = {"losses": losses, "grads": grads}
    out["want"] = _as_port(port, ref["grads"], ref["stats"])
    return out


def test_bf16_mono_losses_match_jax(steps):
    for k in LOSS_KEYS:
        np.testing.assert_allclose(steps["bf16"]["losses"][k], steps["ref"]["losses"][k],
                                   rtol=2e-3, err_msg=k)


def test_bf16_mono_gradients_match_jax(steps):
    want = steps["want"]
    got, f32 = steps["bf16"]["grads"], steps["f32"]["grads"]
    assert set(got) == set(want)
    rel = lambda a, b: float((a.double() - b.double()).norm()     # noqa: E731
                             / max(float(b.double().norm()), 1e-30))
    for k, w in want.items():
        assert rel(got[k], w) <= max(1.5 * rel(f32[k], w), 0.05), (k, rel(got[k], w),
                                                                    rel(f32[k], w))
    flat = lambda d: torch.cat([d[k].double().flatten() for k in sorted(want)])   # noqa
    assert rel(flat(got), flat(want)) < rel(flat(f32), flat(want))
