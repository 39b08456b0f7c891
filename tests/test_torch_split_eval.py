"""The port's split evaluation and ground-truth export against the JAX package's.

- ``export_eigen_raw_gt`` and ``export_eigen_improved_gt`` write the same
  arrays as the JAX exporters (exactly) on one tree;
- ``evaluate`` on the ``eigen_raw`` protocol (every 17th frame of the
  repository's test list, 41 over its five dates, a tiny KITTI-shaped tree, a tiny seeded model
  on the CPU, with post-processing) gives the metrics that the JAX
  ``evaluate`` gives for the disparities it saved, within 1e-5 (the two
  resize each prediction to its ground truth with torch in float64 and with
  OpenCV);
- a frame of the test list that cannot be read stops the prediction with
  the reader's error (no other frame is scored in its place), and ``.jpg``
  frames without PIL stop it with an error that names ``--png``;
- the benchmark split: the eigen -> benchmark remap and the saved ``.npy``
  are exact, ``resize_bilinear`` is within 1e-6 of ``cv2.resize`` at the
  benchmark's size, and the 16-bit PNGs within 1 LSB of the JAX export's.
"""
import os
import sys

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from planedepth_tpu import config as jcfg
from planedepth_tpu.eval import evaluator as jevaluator
from planedepth_tpu.eval import export_gt as jexport
from planedepth_tpu_torch import config as tcfg
from planedepth_tpu_torch.data.image_io import resize_bilinear
from planedepth_tpu_torch.data.kitti import readlines, split_path
from planedepth_tpu_torch.data.kitti_tree import DATE_SIZES, write_tree
from planedepth_tpu_torch.eval import evaluator as tevaluator
from planedepth_tpu_torch.eval import export_gt as texport
from planedepth_tpu_torch.models.factory import DepthModel, init_weights_

torch.set_num_threads(1)
DATE = "2011_09_26"
DRIVE = f"{DATE}/{DATE}_drive_0002_sync"
H, W = 64, 128


def _split(tmp_path, lines):
    split = tmp_path / "split"
    split.mkdir()
    (split / "test_files.txt").write_text("".join(f"{ln}\n" for ln in lines))
    return split


def test_export_eigen_raw_gt_equals_jax(tmp_path):
    lines = [f"{DRIVE} {f} l" for f in (0, 1, 2)]
    root = tmp_path / "kitti"
    write_tree(str(root), lines, scan_points=4000, sizes={DATE: (1242, 375)})
    split = _split(tmp_path, lines)
    got = np.load(texport.export_eigen_raw_gt(str(root), str(split), str(tmp_path / "t.npz")),
                  allow_pickle=True)["data"]
    want = np.load(jexport.export_eigen_raw_gt(str(root), str(split), str(tmp_path / "j.npz")),
                   allow_pickle=True)["data"]
    assert len(got) == len(want) == 3 and got.dtype == want.dtype
    for g, w in zip(got, want):
        g = np.asarray(g, np.float32)        # npz object-array round trip
        np.testing.assert_array_equal(g, np.asarray(w, np.float32))
        assert (g > 0).sum() > 1000


def test_export_eigen_improved_gt_equals_jax(tmp_path):
    lines = [f"{DRIVE} {f} l" for f in (0, 1)]
    split = _split(tmp_path, lines)
    d = tmp_path / "depth" / DRIVE.split("/")[1] / "proj_depth" / "groundtruth" / "image_02"
    d.mkdir(parents=True)
    rng = np.random.default_rng(2)
    for f in (0, 1):
        Image.fromarray(rng.integers(0, 20000, (370, 1224), dtype=np.uint16)).save(
            d / f"{f:010d}.png")
    got = np.load(texport.export_eigen_improved_gt(str(tmp_path / "depth"), str(split),
                                                   str(tmp_path / "t.npz")),
                  allow_pickle=True)["data"]
    want = np.load(jexport.export_eigen_improved_gt(str(tmp_path / "depth"), str(split),
                                                    str(tmp_path / "j.npz")),
                   allow_pickle=True)["data"]
    assert got.dtype == want.dtype
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g, np.float32), np.asarray(w, np.float32))


def _tiny_model():
    cfg = tcfg.ModelConfig(num_layers=18, use_denseaspp=False, num_ep=0,
                           planes=tcfg.PlaneConfig(disp_levels=5, disp_max=24, xz_levels=0))
    return init_weights_(DepthModel(cfg), torch.Generator().manual_seed(0)), cfg


@pytest.mark.parametrize("fault", ["missing_frame", "jpg_without_pil"])
def test_split_prediction_raises_where_a_frame_does_not_load(tmp_path, monkeypatch, fault):
    lines = [f"{DRIVE} {f} l" for f in range(5)]
    root = tmp_path / "kitti"
    write_tree(str(root), lines, sizes={DATE: (160, 48)})
    frames = root / DRIVE / "image_02" / "data"
    if fault == "missing_frame":
        os.remove(frames / "0000000003.png")
        want = "0000000003.png"
    else:
        for f in range(5):
            os.rename(frames / f"{f:010d}.png", frames / f"{f:010d}.jpg")
        monkeypatch.setitem(sys.modules, "PIL", None)
        monkeypatch.setitem(sys.modules, "PIL.Image", None)
        want = "--png"
    model, model_cfg = _tiny_model()
    cfg = tcfg.TrainConfig(model=model_cfg, data=tcfg.DataConfig(
        data_path=str(root), height=H, width=W, png=fault == "missing_frame", num_workers=2))
    with pytest.raises(RuntimeError, match=want):
        tevaluator.predict_split_disparities(model, cfg, lines, post_process=True)


def test_evaluate_eigen_raw_equals_jax_given_the_same_disparities(tmp_path, monkeypatch):
    lines = readlines(split_path("eigen_raw", "test"))[::17]
    (tmp_path / "test_files.txt").write_text("".join(f"{ln}\n" for ln in lines))
    monkeypatch.setattr(tevaluator, "split_path",
                        lambda split, which: str(tmp_path / f"{which}_files.txt"))
    sizes = {d: (160, 48) for d in DATE_SIZES}
    root = tmp_path / "kitti"
    write_tree(str(root), lines, sizes=sizes)
    splits = tmp_path / "splits"
    (splits / "eigen_raw").mkdir(parents=True)
    rng = np.random.default_rng(1)
    gts = []
    for line in lines:                      # KITTI's size per date, cut by 330 x 1100
        w, h = DATE_SIZES[line.split("/")[0]]
        gt = rng.uniform(1.0, 90.0, (h - 330, w - 1100)).astype(np.float32)
        gt[rng.random(gt.shape) < 0.7] = 0.0
        gts.append(gt)
    np.savez_compressed(splits / "eigen_raw" / "gt_depths.npz",
                        data=np.array(gts, dtype=object))

    model, model_cfg = _tiny_model()
    cfg = tcfg.TrainConfig(model=model_cfg, data=tcfg.DataConfig(
        data_path=str(root), height=H, width=W, png=True, num_workers=2))
    saved = str(tmp_path / "disps.npy")
    got = tevaluator.evaluate(cfg, model, post_process=True, save_pred_disps=saved,
                              splits_dir=str(splits))
    disps = np.load(saved)
    assert disps.shape == (41, H, W) and np.isfinite(disps).all()
    want = jevaluator.evaluate(jcfg.TrainConfig(data=jcfg.DataConfig(height=H, width=W)),
                               None, None, ext_disp_to_eval=saved, splits_dir=str(splits))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)


def test_benchmark_export_within_one_lsb_of_jax(tmp_path):
    rng = np.random.default_rng(0)
    disps = rng.uniform(0.01, 0.3, (3, 192, 640)).astype(np.float32)
    for disp in disps[:1]:
        np.testing.assert_allclose(resize_bilinear(disp, 352, 1216),
                                   cv2.resize(disp, (1216, 352)), rtol=0, atol=1e-6)
    ext = tmp_path / "disps.npy"
    np.save(ext, disps)
    splits = tmp_path / "splits"
    (splits / "benchmark").mkdir(parents=True)
    np.save(splits / "benchmark" / "eigen_to_benchmark_ids.npy", np.array([2, 0], np.int64))
    kw = dict(eval_split="benchmark", ext_disp_to_eval=str(ext), eval_eigen_to_benchmark=True,
              splits_dir=str(splits))
    cfg = tcfg.TrainConfig(data=tcfg.DataConfig(height=192, width=640))
    assert tevaluator.evaluate(cfg, None, save_pred_disps=str(tmp_path / "t"), **kw) == {}
    assert jevaluator.evaluate(jcfg.TrainConfig(), None, None,
                               save_pred_disps=str(tmp_path / "j"), **kw) == {}
    np.testing.assert_array_equal(np.load(tmp_path / "t.npy"), disps[[2, 0]])
    np.testing.assert_array_equal(np.load(tmp_path / "t.npy"), np.load(tmp_path / "j.npy"))
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == names and len(names) == 2
    for name in names:
        got = np.asarray(Image.open(tmp_path / "t" / name)).astype(np.int64)
        want = np.asarray(Image.open(tmp_path / "j" / name)).astype(np.int64)
        assert got.shape == (352, 1216) and got.max() > 0
        assert np.abs(got - want).max() <= 1
