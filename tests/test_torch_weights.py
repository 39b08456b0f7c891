"""Weight layouts: the port uses the reference's state_dict names.

A JAX tree carried into the port with ``load_jax_params`` and read back out
through the JAX package's own torch converters (``convert_resnet_encoder``,
``convert_depth_decoder``) must come back identical, leaf for leaf.  A
reference-layout ``encoder.pth``/``depth.pth`` pair loads into the port
directly and through the converters alike.
"""
import numpy as np
import pytest
import torch

from planedepth_tpu.utils.torch_convert import (
    convert_depth_decoder,
    convert_resnet_encoder,
)
from planedepth_tpu_torch.config import ModelConfig
from planedepth_tpu_torch.models.factory import DepthModel, init_weights_
from planedepth_tpu_torch.utils.weights import (
    load_jax_params,
    load_reference_state_dicts,
)
from tests._torch_parity import make_models

pytestmark = pytest.mark.heavy
torch.set_num_threads(1)

VARIANT = dict(pe_type="frequency", use_denseaspp=False,
               use_mixture_loss=False, plane_residual=False)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _numpy_sd(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def _converted(encoder_sd, depth_sd, c):
    """Reference-layout state dicts -> JAX (params, batch_stats) trees."""
    encoder_sd = {k: np.asarray(v) for k, v in encoder_sd.items()}
    depth_sd = {k: np.asarray(v) for k, v in depth_sd.items()}
    enc = convert_resnet_encoder(encoder_sd)
    dec_p, dec_s = convert_depth_decoder(
        depth_sd, num_ep=c.num_ep, pe_type=c.pe_type,
        use_denseaspp=c.use_denseaspp, use_mixture_loss=c.use_mixture_loss,
        plane_residual=c.plane_residual)
    return ({"encoder": enc["params"], "depth": dec_p},
            {"encoder": enc["batch_stats"], "depth": dec_s})


@pytest.mark.parametrize("num_layers,model_kw", [(18, {}), (50, {}), (18, VARIANT)])
def test_jax_tree_round_trips_through_torch_convert(num_layers, model_kw):
    _, params_np, stats_np, port = make_models(64, 192, num_layers=num_layers,
                                               **model_kw)
    params_back, stats_back = _converted(
        _numpy_sd(port.encoder), _numpy_sd(port.depth), port.cfg)
    for want, got in ((params_np, params_back), (stats_np, stats_back)):
        want, got = _flat(want), _flat(got)
        assert sorted(want) == sorted(got)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_reference_pth_files_load(tmp_path):
    cfg = ModelConfig(num_layers=18)
    src = init_weights_(DepthModel(cfg), torch.Generator().manual_seed(3))
    for m in src.modules():                  # non-trivial BN statistics
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.uniform_(-0.1, 0.1)
            m.running_var.uniform_(0.5, 1.5)
    # the reference's files: torchvision's fc head and metadata ride along
    enc = dict(src.encoder.state_dict())
    enc.update({"encoder.fc.weight": torch.zeros(1000, 512),
                "encoder.fc.bias": torch.zeros(1000),
                "height": 192, "width": 640, "use_stereo": True})
    torch.save(enc, tmp_path / "encoder.pth")
    torch.save(src.depth.state_dict(), tmp_path / "depth.pth")
    enc_sd = torch.load(tmp_path / "encoder.pth", weights_only=False)
    dep_sd = torch.load(tmp_path / "depth.pth")

    direct = DepthModel(cfg)
    load_reference_state_dicts(direct, enc_sd, dep_sd)
    via_jax = DepthModel(cfg)
    params, stats = _converted(enc_sd, dep_sd, cfg)
    load_jax_params(via_jax, params, stats)
    want = src.state_dict()
    for model in (direct, via_jax):
        got = model.state_dict()
        for k, v in want.items():
            if not k.endswith("num_batches_tracked"):
                torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)
