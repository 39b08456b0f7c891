"""The port's pose algebra, 2-D warp geometry, pose networks and temporal flip
against the JAX package's, on the same seeded numpy inputs.

Tolerances: the pose algebra at rtol 1e-5 (float32 trigonometry and 4x4
products in two libraries); warp coordinates at rtol 1e-4 of their
normalised value with atol 1e-5 (a pixel coordinate through a 3x3 inverse,
summed in another order: ~1e-4 px at these sizes), masks exactly; the pose
networks at rtol 1e-4 over a ResNet-18 (the tolerance of
tests/test_torch_models.py); the flip exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planedepth_tpu.geometry import camera as jcam
from planedepth_tpu.geometry import pose as jpose
from planedepth_tpu.geometry import warp as jwarp
from planedepth_tpu.models.pose_net import PoseDecoder as JaxPoseDecoder
from planedepth_tpu.models.resnet import ResnetPoseEncoder as JaxPoseEncoder
from planedepth_tpu.models.resnet import encoder_channels
from planedepth_tpu.train.flip import add_flip_right_inputs as jax_flip
from planedepth_tpu.train.mono import _coords_to_disp as jax_coords_to_disp
from planedepth_tpu_torch.data.synthetic import make_stereo_batch
from planedepth_tpu_torch.geometry import camera as tcam
from planedepth_tpu_torch.geometry import pose as tpose
from planedepth_tpu_torch.geometry import warp as twarp
from planedepth_tpu_torch.models.pose_net import PoseDecoder
from planedepth_tpu_torch.models.resnet import ResnetPoseEncoder
from planedepth_tpu_torch.train.flip import add_flip_right_inputs
from planedepth_tpu_torch.train.mono import _coords_to_disp
from planedepth_tpu_torch.train.step import batch_to_tensors
from planedepth_tpu_torch.utils.weights import load_jax_pose_params
from tests._torch_parity import _param_rule, _perturb, _stats_rule, nchw

torch.set_num_threads(1)
CPU = torch.device("cpu")
POSE_TOL = dict(rtol=1e-5, atol=1e-6)
COORD_TOL = dict(rtol=1e-4, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _pose_params(seed, b=3):
    rng = np.random.default_rng(seed)
    aa = rng.uniform(-0.3, 0.3, (b, 1, 3)).astype(np.float32)
    aa[0] = 0.0                                      # the zero rotation
    t = rng.uniform(-0.2, 0.2, (b, 1, 3)).astype(np.float32)
    return aa, t


def test_rot_from_axisangle_matches_jax():
    aa, _ = _pose_params(0)
    np.testing.assert_allclose(tpose.rot_from_axisangle(_t(aa)).numpy(),
                               np.asarray(jax.jit(jpose.rot_from_axisangle)(jnp.asarray(aa))),
                               **POSE_TOL)


@pytest.mark.parametrize("invert", [False, True])
def test_transformation_from_parameters_matches_jax(invert):
    aa, t = _pose_params(1)
    got = tpose.transformation_from_parameters(_t(aa), _t(t), invert=invert)
    want = jax.jit(jpose.transformation_from_parameters, static_argnames="invert")(
        jnp.asarray(aa), jnp.asarray(t), invert=invert)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **POSE_TOL)


def _grid(b, h, w, seed):
    """A cropped augmentation grid per image, NHWC."""
    rng = np.random.default_rng(seed)
    grids = []
    for _ in range(b):
        x0, x1 = rng.uniform(-1.0, -0.6), rng.uniform(0.6, 1.0)
        y0, y1 = rng.uniform(-1.0, -0.5), rng.uniform(0.7, 1.0)
        gx, gy = np.meshgrid(np.linspace(x0, x1, w), np.linspace(y0, y1, h))
        grids.append(np.stack([gx, gy], -1))
    return np.stack(grids).astype(np.float32)


@pytest.mark.parametrize("rotate_translation", [False, True])
def test_rc_correction_and_apply_rc_match_jax(rotate_translation):
    grid = _grid(3, 12, 20, 2)
    aa, t = _pose_params(3)
    Rt = jax.jit(jpose.transformation_from_parameters)(jnp.asarray(aa), jnp.asarray(t))
    rc_want = jax.jit(jpose.rc_correction)(jnp.asarray(grid))
    rc_got = tpose.rc_correction(nchw(grid))
    np.testing.assert_allclose(rc_got.numpy(), np.asarray(rc_want), **POSE_TOL)
    got = tpose.apply_rc(_t(np.asarray(Rt)), rc_got, rotate_translation)
    want = jax.jit(jpose.apply_rc, static_argnums=2)(Rt, rc_want, rotate_translation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **POSE_TOL)
    assert (got[:, 3] == 0).all()                     # the reference's T[3, 3] = 0
    if not rotate_translation:
        assert (got[:, :3, 3] == 0).all()


def test_inv3x3_matches_jax():
    rng = np.random.default_rng(4)
    m = (np.eye(3) + rng.uniform(-0.5, 0.5, (5, 3, 3))).astype(np.float32)
    np.testing.assert_allclose(twarp.inv3x3(_t(m)).numpy(),
                               np.asarray(jax.jit(jwarp.inv3x3)(jnp.asarray(m))), rtol=1e-5,
                               atol=1e-6)


def _camera(b, h, w):
    batch = make_stereo_batch(b, h, w, seed=0)
    return batch["K"], batch["inv_K"]


def test_camera_grids_and_projection_match_jax():
    """pixel_grid exactly, identity_norm_grid to one float32 ulp (the two
    libraries' linspace round differently); a depth map backprojected and
    projected through a pose at the warp coordinates' tolerance."""
    H, W = 12, 20
    np.testing.assert_array_equal(tcam.pixel_grid(H, W).numpy(),
                                  np.asarray(jcam.pixel_grid(H, W)))
    np.testing.assert_allclose(tcam.identity_norm_grid(H, W).numpy(),
                               np.asarray(jcam.identity_norm_grid(H, W)), rtol=0, atol=1.2e-7)
    depth = np.random.default_rng(11).uniform(0.5, 20.0, (2, H, W)).astype(np.float32)
    aa, t = _pose_params(12, 2)
    T = np.asarray(jax.jit(jpose.transformation_from_parameters)(jnp.asarray(aa),
                                                                 jnp.asarray(t)))
    K, inv_K = _camera(2, H, W)
    points = tcam.backproject_depth(_t(depth), _t(inv_K))
    jpoints = jax.jit(jcam.backproject_depth)(jnp.asarray(depth), jnp.asarray(inv_K))
    np.testing.assert_allclose(points.numpy(), np.asarray(jpoints), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tcam.project_3d(points, _t(K), _t(T), H, W).numpy(),
                               np.asarray(jax.jit(jcam.project_3d, static_argnums=(3, 4))(
                                   jpoints, jnp.asarray(K), jnp.asarray(T), H, W)),
                               **COORD_TOL)


def test_homography_warp_coords_match_jax():
    """Plane distances and unit normals, some facing away and some planes
    behind the camera after the motion: coordinates, the facing and z masks,
    and the 2.0 pin of masked samples."""
    B, N, H, W = 2, 6, 16, 40
    rng = np.random.default_rng(5)
    distance = rng.uniform(0.05, 3.0, (B, N)).astype(np.float32)
    normal = rng.normal(0.0, 1.0, (B, N, 3))
    normal[:, :3, 2] = np.abs(normal[:, :3, 2]) + 1.0         # fronto-parallel-ish
    normal[:, 3, :] = (0.0, 0.0, -1.0)                        # facing away
    normal = (normal / np.linalg.norm(normal, axis=-1, keepdims=True)).astype(np.float32)
    aa = rng.uniform(-0.05, 0.05, (B, 1, 3)).astype(np.float32)
    t = np.array([[[0.02, -0.01, 0.3]], [[-0.05, 0.02, -0.4]]], np.float32)
    T = np.asarray(jax.jit(jpose.transformation_from_parameters)(jnp.asarray(aa),
                                                                 jnp.asarray(t)))
    K, inv_K = _camera(B, H, W)
    coords, mask = twarp.homography_warp_coords(_t(distance), _t(normal), _t(T), _t(K),
                                                _t(inv_K), H, W)
    jc, jm = jwarp.homography_warp_coords(*(jnp.asarray(a) for a in
                                            (distance, normal, T, K, inv_K)), H, W)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jm))
    assert 0.0 < float(mask.mean()) < 1.0
    np.testing.assert_allclose(coords.numpy(), np.asarray(jc), **COORD_TOL)
    assert (coords[mask == 0] == 2.0).all()


def test_depth_warp_coords_match_jax():
    """Plane-first disparities (row-constant, W_b = 1, as the port's volume
    holds them) against the JAX plane-last layout."""
    B, N, H, W = 2, 5, 12, 32
    rng = np.random.default_rng(6)
    disp = rng.uniform(2.0, 30.0, (B, N, H, 1)).astype(np.float32)
    aa, t = _pose_params(7, B)
    T = np.asarray(jax.jit(jpose.transformation_from_parameters)(jnp.asarray(aa),
                                                                 jnp.asarray(t)))
    K, inv_K = _camera(B, H, W)
    got = twarp.depth_warp_coords(_t(disp), _t(T), _t(K), _t(inv_K), W)
    want = jax.jit(jwarp.depth_warp_coords, static_argnums=4)(
        jnp.asarray(np.broadcast_to(np.moveaxis(disp, 1, -1), (B, H, W, N))),
        *(jnp.asarray(a) for a in (T, K, inv_K)), W)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **COORD_TOL)


def test_coords_to_disp_matches_jax():
    rng = np.random.default_rng(8)
    coords = rng.uniform(-1.3, 1.3, (2, 3, 10, 24, 2)).astype(np.float32)
    for got, want in zip(_coords_to_disp(_t(coords), 10, 24),
                         jax.jit(jax_coords_to_disp, static_argnums=(1, 2))(
                             jnp.asarray(coords), 10, 24)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)


def test_temporal_flip_matches_jax():
    batch = make_stereo_batch(2, 16, 24, seed=1, novel_frame_ids=(-1, 1))
    want = jax.jit(jax_flip, static_argnums=1)({k: jnp.asarray(v) for k, v in batch.items()},
                                               (-1, 1))
    got = add_flip_right_inputs(batch_to_tensors(batch, CPU), (-1, 1))
    assert set(got) == set(want)
    for k, v in got.items():
        w = np.asarray(want[k])
        np.testing.assert_array_equal(v.numpy(), np.moveaxis(w, -1, 1) if w.ndim == 4 else w,
                                      err_msg=k)


@pytest.mark.parametrize("num_ep", [0, 8])
def test_pose_networks_match_jax(num_ep):
    """ResnetPoseEncoder(18) + PoseDecoder on a frame pair, eval mode, with
    weights carried by ``load_jax_pose_params`` from perturbed JAX trees."""
    B, H, W = 2, 64, 96
    enc = JaxPoseEncoder(18, num_input_images=2)
    dec = JaxPoseDecoder(num_ch_enc=tuple(encoder_channels(18)), num_ep=num_ep)
    rng = np.random.default_rng(9)
    pair = rng.uniform(0, 1, (B, H, W, 6)).astype(np.float32)
    grid = _grid(B, H, W, 10)

    @jax.jit
    def init(key):
        ev = enc.init(key, jnp.zeros((1, H, W, 6)), train=False)
        feats = enc.apply(ev, jnp.zeros((1, H, W, 6)), train=False)
        return ev, dec.init(key, [feats], jnp.zeros((1, H, W, 2)))

    ev, dv = init(jax.random.PRNGKey(0))
    params = {"pose_encoder": _perturb(jax.tree.map(np.asarray, ev["params"]), rng, _param_rule),
              "pose": _perturb(jax.tree.map(np.asarray, dv["params"]), rng, _param_rule)}
    stats = {"pose_encoder": _perturb(jax.tree.map(np.asarray, ev["batch_stats"]), rng,
                                      _stats_rule)}

    @jax.jit
    def forward(x, g):
        feats = enc.apply({"params": params["pose_encoder"],
                           "batch_stats": stats["pose_encoder"]}, x, train=False)
        return dec.apply({"params": params["pose"]}, [feats], g)

    want = forward(jnp.asarray(pair), jnp.asarray(grid))
    encoder, decoder = ResnetPoseEncoder(18, 2).eval(), PoseDecoder(encoder_channels(18), num_ep)
    load_jax_pose_params(encoder, decoder, params, stats)
    with torch.no_grad():
        got = decoder(encoder(nchw(pair)), nchw(grid))
    for g, w in zip(got, want):
        assert g.shape == (B, 1, 1, 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4 * float(np.abs(np.asarray(w)).max()))


def test_colmap_poses_match_jax():
    """Under ``use_colmap`` the temporal poses are the batch's ``Rt_{f}``,
    conjugated with their translation rotated (no pose nets are built)."""
    from planedepth_tpu import config as jcfg
    from planedepth_tpu.train.step import ModelBundle as JaxBundle
    from planedepth_tpu_torch import config as tcfg
    from planedepth_tpu_torch.train.step import ModelBundle

    common = dict(warp_type="homography_warp", novel_frame_ids=(-1, 1), fused_sweep=True)
    jc = jcfg.TrainConfig(data=jcfg.DataConfig(height=32, width=64, use_colmap=True),
                          **common)
    tc = tcfg.TrainConfig(bf16=False,
                          model=tcfg.ModelConfig(num_layers=18, use_denseaspp=False),
                          data=tcfg.DataConfig(height=32, width=64, use_colmap=True),
                          **common)
    batch = make_stereo_batch(2, 32, 64, seed=2, novel_frame_ids=(-1, 1))
    batch["grid"] = _grid(2, 32, 64, 13)
    for f in (-1, 1):
        aa, t = _pose_params(14 + f, 2)
        batch[f"Rt_{f}"] = np.array(jpose.transformation_from_parameters(
            jnp.asarray(aa), jnp.asarray(t)))
    want, _ = JaxBundle(jc).predict_poses({}, {}, {k: jnp.asarray(v) for k, v in
                                                   batch.items()}, train=False)
    port = ModelBundle(tc, CPU)
    assert not tc.use_pose_net and set(port.nets()) == {"model"}
    got = port.predict_poses(batch_to_tensors(batch, CPU))
    assert set(got) == set(want) == {"r", -1, 1}
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **POSE_TOL)
    assert (got[1][:, :3, 3] != 0).any()                      # translation kept
