"""The port's PladeNet/FalNet layers and models against the JAX package's, on the same weights.

``ConvELU``, ``ResidualBlock``, ``Deconv`` and ``resize_nearest`` are held to
their JAX counterparts at integer and non-integer resize ratios (a stride-2
stage maps 5 columns to 3, its deconv 3 back to 5) at rtol = atol = 1e-5;
the ``FalNet`` and ``PladeNet`` forwards (through ``DepthModel`` and
``load_jax_params``, the JAX ``{"fal": ...}`` / ``{"plade": ...}`` trees) at
64x192 with 7 and 7+3 planes at the tolerance of tests/test_torch_models.py,
rtol = atol = 1e-3, on logits, sigma, probability, disp and depth.
PladeNet runs with the mixture and an 8-channel PE and without either.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planedepth_tpu.models.layers import ConvELU as JaxConvELU
from planedepth_tpu.models.layers import Deconv as JaxDeconv
from planedepth_tpu.models.layers import ResidualBlock as JaxResidualBlock
from planedepth_tpu.ops.resize import resize_nearest as jax_resize_nearest
from planedepth_tpu_torch.config import ModelConfig, PlaneConfig
from planedepth_tpu_torch.models.factory import DepthModel
from planedepth_tpu_torch.models.layers import ConvELU, Deconv, ResidualBlock, resize_nearest
from tests._torch_parity import _param_rule, _perturb, inputs, jnp_in, make_models, nchw

pytestmark = pytest.mark.heavy
torch.set_num_threads(1)

H, W = 64, 192
TOL = dict(rtol=1e-3, atol=1e-3)
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
PLANES = dict(disp_levels=7, disp_min=2, disp_max=24, yz_levels=0)


@pytest.mark.parametrize("src,size", [((5, 7), (10, 14)), ((3, 5), (5, 9)), ((3, 3), (5, 5)),
                                      ((6, 10), (3, 5)), ((4, 6), (4, 6)), ((2, 20), (6, 192))])
def test_resize_nearest_matches_jax(src, size):
    x = np.random.default_rng(0).standard_normal((2, *src, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        resize_nearest(nchw(x), size).numpy(),
        np.moveaxis(np.asarray(jax_resize_nearest(jnp.asarray(x), size)), -1, 1))


def _copy_convs(tree, port, names):
    """Flax conv leaves (HWIO kernels) into the port module's convs."""
    with torch.no_grad():
        for name in names:
            conv = port.get_submodule(name)
            leaf = tree[name]
            conv.weight.copy_(torch.from_numpy(
                np.ascontiguousarray(np.transpose(np.asarray(leaf["kernel"]), (3, 2, 0, 1)))))
            if conv.bias is not None:
                conv.bias.copy_(torch.from_numpy(np.asarray(leaf["bias"])))


# name -> (JAX module, port module, the port's conv names, input (H, W, C), resize size)
LAYERS = {
    "convelu_3x3": (lambda: JaxConvELU(8), lambda: ConvELU(6, 8), ("conv",), (5, 7, 6), None),
    "convelu_3x3_stride2_odd": (lambda: JaxConvELU(8, stride=2),
                                lambda: ConvELU(6, 8, stride=2), ("conv",), (5, 7, 6), None),
    "convelu_1x1": (lambda: JaxConvELU(8, 1, pad=0), lambda: ConvELU(6, 8, 1, pad=0),
                    ("conv",), (5, 7, 6), None),
    "residual": (lambda: JaxResidualBlock(8), lambda: ResidualBlock(8), ("conv1", "conv2"),
                 (5, 7, 8), None),
    "deconv_3_to_5": (lambda: JaxDeconv(8), lambda: Deconv(6, 8), ("conv1",), (3, 4, 6), (5, 7)),
    "deconv_x2": (lambda: JaxDeconv(8), lambda: Deconv(6, 8), ("conv1",), (3, 4, 6), (6, 8)),
}


@pytest.mark.parametrize("layer", list(LAYERS))
def test_layers_match_jax(layer):
    make_jax, make_port, names, shape, size = LAYERS[layer]
    jax_mod, port = make_jax(), make_port()
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((2, *shape)).astype(np.float32))
    if size is not None:                                  # Deconv(x, ref_hw)
        call = lambda variables: jax_mod.apply(variables, x, size)
        init = jax.jit(lambda key: jax_mod.init(key, x, size))
    elif layer == "residual":
        call = lambda variables: jax_mod.apply(variables, x)
        init = jax.jit(lambda key: jax_mod.init(key, x))
    else:                                                 # ConvELU(x, train)
        call = lambda variables: jax_mod.apply(variables, x, False)
        init = jax.jit(lambda key: jax_mod.init(key, x, False))
    params = _perturb(jax.tree.map(np.asarray, init(jax.random.PRNGKey(0))["params"]),
                      rng, _param_rule)
    _copy_convs(params, port, names)
    want = np.moveaxis(np.asarray(call({"params": params})), -1, 1)
    with torch.no_grad():
        xt = nchw(np.asarray(x))
        got = port(xt) if size is None else port(xt, size)
    np.testing.assert_allclose(got.numpy(), want, **LAYER_TOL)


def test_convelu_batch_norm_is_not_built():
    with pytest.raises(NotImplementedError, match="BatchNorm"):
        ConvELU(3, 8, batch_norm=True)


MODELS = {
    "falnet": dict(net_type="FalNet", use_mixture_loss=False, plane_residual=False,
                   planes=PlaneConfig(xz_levels=0, **PLANES)),
    "pladenet_mixture_pe8": dict(net_type="PladeNet", num_ep=8, use_mixture_loss=True,
                                 plane_residual=True, planes=PlaneConfig(xz_levels=3, **PLANES)),
    "pladenet_nomix_pe0": dict(net_type="PladeNet", num_ep=0, use_mixture_loss=False,
                               plane_residual=False, planes=PlaneConfig(xz_levels=3, **PLANES)),
}


@pytest.mark.parametrize("name", list(MODELS))
def test_forward_matches_jax(name):
    from planedepth_tpu.config import PlaneConfig as JaxPlaneConfig

    kw = dict(MODELS[name])
    kw["planes"] = JaxPlaneConfig(**{f: getattr(kw["planes"], f) for f in (
        "disp_levels", "disp_min", "disp_max", "xz_levels", "yz_levels")})
    jax_forward, params, _, port = make_models(H, W, **kw)
    family = "fal" if name == "falnet" else "plade"
    assert set(params) == {family} and hasattr(port, family)
    image, grid = inputs(2, H, W)
    want = jax_forward(*jnp_in(image, grid))
    with torch.inference_mode():
        got = port(nchw(image), nchw(grid))
    keys = ("logits", "probability", "disp", "depth") + (
        ("sigma", "pi") if MODELS[name]["use_mixture_loss"] else ())
    assert ("sigma" in got) == ("sigma" in want) == MODELS[name]["use_mixture_loss"]
    for key in keys:
        np.testing.assert_allclose(got[key].numpy(), np.moveaxis(np.asarray(want[key]), -1, 1),
                                   err_msg=key, **TOL)
    np.testing.assert_allclose(
        np.broadcast_to(got["disp_layered"].numpy(), got["logits"].shape),
        np.moveaxis(np.asarray(want["disp_layered"]), -1, 1), rtol=2e-5, err_msg="disp_layered")
    np.testing.assert_array_equal(got["padding_mask"][..., 0].numpy(),
                                  np.moveaxis(np.asarray(want["padding_mask"]), -1, 1)[..., 0])
    np.testing.assert_allclose(got["disp_rows"].numpy(), np.asarray(want["disp_rows"]),
                               rtol=2e-5)


def test_flax_module_names_are_the_ports():
    """The JAX PladeNet's module tree (with the PE) names exactly the port's
    convs, so ``load_jax_params`` misses none and invents none."""
    from planedepth_tpu.config import PlaneConfig as JaxPlaneConfig
    from planedepth_tpu.models.plade_net import PladeNet as JaxPladeNet

    net = JaxPladeNet(planes=JaxPlaneConfig(xz_levels=3, **PLANES), num_ep=8,
                      use_mixture_loss=True, plane_residual=True)
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 96, 3)),
                            jnp.zeros((1, 64, 96, 2)), False)["params"]
    flat = {"/".join(k.key for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    port = DepthModel(ModelConfig(net_type="PladeNet", num_ep=8, use_mixture_loss=True,
                                  plane_residual=True,
                                  planes=PlaneConfig(xz_levels=3, **PLANES))).plade
    names = {k.replace(".", "/").replace("weight", "kernel") for k in port.state_dict()}
    assert flat == names
