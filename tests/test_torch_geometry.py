"""The port's plane geometry, camera constants and config against the JAX package's.

Plane volumes are compared at rtol 2e-5 (float32 pow/div evaluated by two
libraries) and the padding mask exactly.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planedepth_tpu import config as jcfg
from planedepth_tpu.geometry import camera as jcam
from planedepth_tpu.geometry.planes import build_plane_volume as jax_volume
from planedepth_tpu_torch import config as tcfg
from planedepth_tpu_torch.geometry import camera as tcam
from planedepth_tpu_torch.geometry.planes import build_plane_volume

torch.set_num_threads(1)


def _grid(b, h, w, seed):
    """A cropped, non-identity augmentation grid per image (NHWC)."""
    rng = np.random.default_rng(seed)
    grids = []
    for _ in range(b):
        x0, x1 = rng.uniform(-1.0, -0.6), rng.uniform(0.6, 1.0)
        y0, y1 = rng.uniform(-1.0, -0.5), rng.uniform(0.7, 1.0)
        gx, gy = np.meshgrid(np.linspace(x0, x1, w), np.linspace(y0, y1, h))
        grids.append(np.stack([gx, gy], -1))
    return np.stack(grids).astype(np.float32)


@pytest.mark.parametrize("yz_levels", [0, 4])
@pytest.mark.parametrize("residual", [False, True])
def test_plane_volume_matches_jax(yz_levels, residual):
    cfg_j = jcfg.PlaneConfig(yz_levels=yz_levels)
    cfg_t = tcfg.PlaneConfig(yz_levels=yz_levels)
    B, H, W = 2, 24, 40
    grid = _grid(B, H, W, seed=3)
    res = None
    if residual:
        res = np.random.default_rng(4).uniform(
            -0.5, 0.5, (B, cfg_t.all_levels)).astype(np.float32)
    vj = jax_volume(jnp.asarray(grid), cfg_j, 1280,
                    None if res is None else jnp.asarray(res))
    vt = build_plane_volume(torch.from_numpy(grid).permute(0, 3, 1, 2), cfg_t,
                            1280, None if res is None else torch.from_numpy(res))
    w_b = 1 if yz_levels == 0 else W
    assert vt.disp_layered.shape == (B, cfg_t.all_levels, H, w_b)
    dl = np.moveaxis(np.asarray(vj.disp_layered), -1, 1)      # (B, N, H, W)
    pm = np.moveaxis(np.asarray(vj.padding_mask), -1, 1)
    np.testing.assert_allclose(
        np.broadcast_to(vt.disp_layered.numpy(), dl.shape), dl, rtol=2e-5)
    np.testing.assert_array_equal(
        np.broadcast_to(vt.padding_mask.numpy(), pm.shape), pm)
    np.testing.assert_allclose(vt.distance.numpy(), np.asarray(vj.distance),
                               rtol=2e-5)
    np.testing.assert_allclose(vt.normal.numpy(), np.asarray(vj.normal),
                               rtol=2e-5, atol=1e-7)
    assert pm.min() == 0 and pm.max() == 1         # both mask values occur


@pytest.mark.parametrize("name", ["PlaneConfig", "ModelConfig", "DataConfig"])
def test_config_copies_match_jax_defaults(name):
    """Every field the port keeps has the JAX package's name and default."""
    port = getattr(tcfg, name)()
    ref = getattr(jcfg, name)()
    for f in dataclasses.fields(port):
        if f.name == "planes":
            assert dataclasses.asdict(port.planes) == dataclasses.asdict(ref.planes)
        else:
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
    if name == "PlaneConfig":
        assert port.all_levels == ref.all_levels == 63


def test_camera_constants_match_jax():
    np.testing.assert_array_equal(tcam.NORMALIZED_K, jcam.NORMALIZED_K)
    assert (tcam.BASELINE, tcam.FX_NORM) == (jcam.BASELINE, jcam.FX_NORM)
    assert tcam.STEREO_SCALE_FACTOR == jcam.STEREO_SCALE_FACTOR
    disp = np.array([2.0, 37.5, 300.0], np.float32)
    # torch divides a scalar by a tensor as reciprocal-then-multiply: 1 ulp
    np.testing.assert_allclose(
        tcam.disp_to_depth(torch.from_numpy(disp), 1280).numpy(),
        np.asarray(jcam.disp_to_depth(jnp.asarray(disp), 1280)), rtol=2e-7)
