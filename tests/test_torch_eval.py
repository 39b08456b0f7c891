"""The whole inference slice against the JAX package: prediction, metrics, data.

``predict_disparities(post_process=True)`` is held to a JAX forward composed
as ``planedepth_tpu/eval/evaluator.py:49-76`` composes it (the mirrored
batch, the flipped grid with x negated, the plain-mean post-process, the
``prob_max`` read-out), at the model tolerance rtol = atol = 1e-3.  The port's
Eigen metrics resize with ``F.interpolate`` where the JAX package uses
``cv2.resize``; they agree at rtol 1e-4.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planedepth_tpu.data.synthetic import make_stereo_batch as jax_make_batch
from planedepth_tpu.eval.metrics import batch_post_process_disparity as jax_post
from planedepth_tpu.eval.metrics import evaluate_disparities as jax_evaluate
from planedepth_tpu_torch.data.synthetic import make_stereo_batch
from planedepth_tpu_torch.eval.evaluator import predict_disparities
from planedepth_tpu_torch.eval.metrics import evaluate_disparities
from tests._torch_parity import make_models

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 64, 192


def _jax_predict(forward, batches):
    """evaluator.py:56-77 without the KITTI loader."""
    disps, prob_max = [], []
    for batch in batches:
        image = jnp.asarray(batch["color_l"])
        grid = jnp.asarray(batch["grid"])
        image = jnp.concatenate([image, image[:, :, ::-1]], axis=0)
        grid = jnp.concatenate(
            [grid, grid.at[..., 0].multiply(-1.0)[:, :, ::-1]], axis=0)
        out = forward(image, grid)
        disp = np.asarray(out["disp"][..., 0])
        n = disp.shape[0] // 2
        disp = jax_post(disp[:n], disp[n:, :, ::-1])
        disps.append(disp)
        prob_max.append(
            np.asarray(out["probability"]).max(-1).mean((-2, -1))[: disp.shape[0]])
    return np.concatenate(disps), np.concatenate(prob_max)


@pytest.mark.heavy
def test_predict_disparities_matches_jax_evaluator():
    forward, _, _, port = make_models(H, W, "interpret", num_layers=18)
    seeds = (0, 1)
    got_d, got_p = predict_disparities(
        port, [make_stereo_batch(2, H, W, seed=s) for s in seeds],
        post_process=True, device=torch.device("cpu"))
    want_d, want_p = _jax_predict(forward, [jax_make_batch(2, H, W, seed=s)
                                            for s in seeds])
    assert got_d.shape == (4, H, W) and got_p.shape == (4,)
    np.testing.assert_allclose(got_d, want_d, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got_p, want_p, rtol=1e-3, atol=1e-3)
    assert np.isfinite(got_d).all() and ((got_p > 0) & (got_p <= 1)).all()


@pytest.mark.parametrize("eval_split,stereo", [
    ("eigen_raw", True), ("eigen_raw", False), ("eigen_benchmark", True)])
def test_evaluate_disparities_matches_jax(eval_split, stereo):
    rng = np.random.default_rng(7)
    preds = rng.uniform(2.0, 60.0, (3, 48, 160)).astype(np.float32)
    gts = []
    for gt_hw in ((94, 310), (48, 160), (37, 121)):   # up, identity, down
        gt = rng.uniform(0.5, 90.0, gt_hw).astype(np.float32)
        gt[rng.random(gt_hw) < 0.6] = 0.0            # sparse lidar GT
        gts.append(gt)
    got = evaluate_disparities(preds, gts, 160, eval_split=eval_split, stereo=stereo)
    want = jax_evaluate(preds, gts, 160, eval_split=eval_split, stereo=stereo)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("kw", [dict(batch_size=2, height=64, width=96, seed=3),
                                dict(batch_size=1, height=32, width=64, seed=1,
                                     constant_disp=3.5, novel_frame_ids=(-1, 1))])
def test_make_stereo_batch_bit_equal_to_jax(kw):
    got, want = make_stereo_batch(**kw), jax_make_batch(**kw)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_port_imports_no_jax():
    """Every module of the port (the KITTI reader, the evaluator, the CLIs
    with the export among them, and the API-parity networks),
    chip_smoke.py and the port's profile script import without JAX or the
    JAX package, and without PIL or OpenCV."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import planedepth_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods + ['chip_smoke', 'scripts.profile_torch_step']:\n"
        "    importlib.import_module(m)\n"
        "assert len(mods) >= 43, mods\n"
        "for m in ('train.step', 'cli.options', 'cli.train', 'cli.evaluate', 'cli.export',\n"
        "          'models.monov2_decoder', 'models.pose_net', 'data.kitti',\n"
        "          'data.kitti_utils', 'data.transforms', 'data.native', 'data.image_io',\n"
        "          'data.kitti_tree', 'eval.export_gt', 'eval.evaluator', 'ops.ssim',\n"
        "          'train.view_synthesis'):\n"
        "    assert 'planedepth_tpu_torch.' + m in mods, (m, mods)\n"
        "assert 'PIL' not in sys.modules and 'cv2' not in sys.modules\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax',"
        " 'planedepth_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok', len(mods))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
