"""The port's DepthModel forward against the JAX package's, on the same weights.

The JAX model is built with ``ModelBundle(cfg).init`` and its variables are
carried into the port with ``load_jax_params``.  Logits, sigma, probability
and disp agree at rtol = atol = 1e-3, the tolerance
tests/test_reference_parity.py holds the JAX package to the reference
torch code with (f32 convolutions in two libraries, through a ResNet).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planedepth_tpu.config import PlaneConfig
from planedepth_tpu.models.layers import frequency_embed as jax_frequency_embed
from planedepth_tpu.ops.resize import resize_bilinear_align_corners as jax_bilinear
from planedepth_tpu.ops.resize import upsample2x_nearest as jax_up2
from planedepth_tpu_torch.models.layers import (
    frequency_embed,
    resize_bilinear_align_corners,
    upsample2x_nearest,
)
from planedepth_tpu_torch.ops.disp_head import disp_head
from tests._torch_parity import inputs, jnp_in, make_models, nchw

pytestmark = pytest.mark.heavy
torch.set_num_threads(1)

H, W = 64, 192
TOL = dict(rtol=1e-3, atol=1e-3)
NHWC_KEYS = ("logits", "sigma", "probability", "disp")


@pytest.mark.parametrize("num_layers,fused_head,batch,model_kw", [
    (18, "interpret", 2, {}),
    (18, "off", 2, {}),
    (50, "off", 1, {}),
    (18, "off", 1, dict(pe_type="frequency", use_denseaspp=False,
                        use_mixture_loss=False, plane_residual=False)),
    (18, "off", 1, dict(planes=PlaneConfig(yz_levels=4))),   # plain head
])
def test_forward_matches_jax(num_layers, fused_head, batch, model_kw):
    jax_forward, _, _, port = make_models(H, W, fused_head, num_layers=num_layers,
                                          **model_kw)
    image, grid = inputs(batch, H, W)
    want = jax_forward(*jnp_in(image, grid))
    launches = disp_head.launches
    with torch.inference_mode():
        got = port(nchw(image), nchw(grid))
    assert disp_head.launches == launches          # CPU tensors: plain path
    for key in NHWC_KEYS:
        if key not in got:
            assert key == "sigma" and "sigma" not in want
            continue
        np.testing.assert_allclose(got[key].numpy(),
                                   np.moveaxis(np.asarray(want[key]), -1, 1),
                                   err_msg=key, **TOL)
    np.testing.assert_allclose(
        np.broadcast_to(got["disp_layered"].numpy(), got["logits"].shape),
        np.moveaxis(np.asarray(want["disp_layered"]), -1, 1), rtol=2e-5,
        err_msg="disp_layered")
    np.testing.assert_allclose(got["depth"].numpy(),
                               np.moveaxis(np.asarray(want["depth"]), -1, 1),
                               err_msg="depth", **TOL)


def test_resize_ops_match_jax():
    x = np.random.default_rng(0).standard_normal((2, 5, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        upsample2x_nearest(nchw(x)).numpy(),
        np.moveaxis(np.asarray(jax_up2(jnp.asarray(x))), -1, 1))
    for size in ((5, 7), (10, 14), (24, 40), (3, 4)):
        np.testing.assert_allclose(
            resize_bilinear_align_corners(nchw(x), size).numpy(),
            np.moveaxis(np.asarray(jax.jit(jax_bilinear, static_argnums=1)(jnp.asarray(x),
                                                                           size)), -1, 1),
            rtol=1e-6, atol=1e-6, err_msg=str(size))


@pytest.mark.parametrize("num_ep", [4, 8, 12])
def test_frequency_embed_matches_jax(num_ep):
    g = np.random.default_rng(1).uniform(-1, 1, (1, 6, 9, 2)).astype(np.float32)
    np.testing.assert_allclose(
        frequency_embed(nchw(g), num_ep).numpy(),
        np.moveaxis(np.asarray(jax_frequency_embed(jnp.asarray(g), num_ep)), -1, 1),
        rtol=1e-6, atol=1e-6)


def test_other_net_types_name_the_roadmap():
    """PladeNet and FalNet are built (tests/test_torch_fal_plade.py); what
    they leave out raises, naming its ROADMAP item or why, and an unknown
    family is refused."""
    from planedepth_tpu_torch.config import ModelConfig, PlaneConfig
    from planedepth_tpu_torch.models.factory import DepthModel

    for net in ("PladeNet", "FalNet"):
        assert hasattr(DepthModel(ModelConfig(net_type=net, planes=PlaneConfig(
            disp_levels=3, xz_levels=0))), {"PladeNet": "plade", "FalNet": "fal"}[net])
    # render_probability: PladeNet builds its N - 1 density planes
    # (tests/test_torch_render.py); the JAX FalNet has no such head
    plade = DepthModel(ModelConfig(net_type="PladeNet", render_probability=True,
                                   planes=PlaneConfig(disp_levels=3, xz_levels=2)))
    assert plade.plade.conv0.out_channels == 4
    with pytest.raises(NotImplementedError, match="FalNet has no render_probability head"):
        DepthModel(ModelConfig(net_type="FalNet", render_probability=True))
    with pytest.raises(NotImplementedError, match="left out on purpose"):
        DepthModel(ModelConfig(net_type="PladeNet", planes=PlaneConfig(yz_levels=4)))
    with pytest.raises(ValueError, match="unknown net_type"):
        DepthModel(ModelConfig(net_type="Monodepth2"))
