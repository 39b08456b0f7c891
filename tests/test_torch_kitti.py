"""The port's KITTI reader, its transforms and its image files, against the JAX package's.

The JAX package decodes with PIL; the port with ``data/image_io.py``.  On
the same files and the same ``np.random.Generator`` (seeded from the
dataset's seed, the epoch and the index):

- every sample of the three ``DATASETS`` readers, train and eval, with the
  COLMAP poses, from 8-bit RGB PNGs, a JPEG and a 16-bit depth PNG, is
  bit-equal (``assert_array_equal``) to the JAX reader's;
- the compiled row unfilter gives the numpy wavefront's bytes;
- the transforms are bit-equal, with the native library and with its numpy
  fallbacks; the calibration, the velodyne projection and its resize too;
- ``read_png`` gives PIL's pixels exactly, for 8-bit RGB and 16-bit grey,
  under each of the five PNG row filters and OpenCV's adaptive filtering;
  ``write_png``'s files read back as written, in the port and in PIL;
- ``resize_nearest_pil`` is PIL's NEAREST resize of a 16-bit image,
  exactly, at KITTI's sizes;
- ``split_path`` is the JAX one's for a split's name and for a directory,
  and the vendored splits have the reference's line counts.
"""
import functools
import os

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from planedepth_tpu.data import kitti as jkitti
from planedepth_tpu.data import kitti_utils as jutils
from planedepth_tpu.data import native as jnative
from planedepth_tpu.data import transforms as jtransforms
from planedepth_tpu_torch.data import image_io
from planedepth_tpu_torch.data import kitti as tkitti
from planedepth_tpu_torch.data import kitti_utils as tutils
from planedepth_tpu_torch.data import native as tnative
from planedepth_tpu_torch.data import transforms as ttransforms
from planedepth_tpu_torch.data.kitti_tree import velodyne_scan, write_calib, write_tree
from planedepth_tpu_torch.train.trainer import split_datasets

torch.set_num_threads(1)
DATE = "2011_09_26"
DRIVE = f"{DATE}/{DATE}_drive_0001_sync"
SIZE = (150, 46)                      # (W, H) of the tree's frames: small, odd
FRAMES = (4, 5, 6, 7)


def _no_native(monkeypatch):
    """Both packages take their numpy fallbacks."""
    monkeypatch.setattr(jnative, "_load", lambda: None)
    monkeypatch.setattr(tnative, "_load", lambda: None)


# --- the image files ------------------------------------------------------------

@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4, "rows"])
@pytest.mark.parametrize("kind", ["rgb8", "grey16"])
def test_png_round_trip_and_pil(tmp_path, kind, filter_type):
    """One filter for every row, or ("rows") one drawn for each row."""
    rng = np.random.default_rng(5 if filter_type == "rows" else filter_type)
    if kind == "rgb8":
        img = rng.integers(0, 256, (23, 37, 3), dtype=np.uint8)
        img[5:9] = img[4]                       # runs that the filters predict
    else:
        img = rng.integers(0, 65536, (19, 31), dtype=np.uint16)
    if filter_type == "rows":
        filter_type = rng.integers(0, 5, img.shape[0])
        assert set(filter_type) == {0, 1, 2, 3, 4}
    path = str(tmp_path / "x.png")
    image_io.write_png(path, img, filter_type)
    got = image_io.read_png(path)
    assert got.dtype == img.dtype
    np.testing.assert_array_equal(got, img)
    with Image.open(path) as pil:
        assert pil.mode == ("RGB" if kind == "rgb8" else "I;16")
        np.testing.assert_array_equal(np.asarray(pil), img)


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_compiled_unfilter_equals_numpy(bpp):
    """The C row unfilter that ``read_png`` runs gives the numpy
    wavefront's bytes, on seeded rows of every filter type mixed; both
    refuse a filter type that does not exist."""
    fn = image_io.png_unfilter_library()
    if fn is None and "no C compiler" in image_io.png_decoder():
        pytest.skip(image_io.png_decoder())
    assert fn is not None, image_io.png_decoder()
    rng = np.random.default_rng(bpp)
    height, stride = 29, 17 * bpp
    raw = rng.integers(0, 256, (height, 1 + stride), dtype=np.uint8)
    raw[:, 0] = rng.integers(0, 5, height)
    raw[3, 0], raw[4, 0] = 3, 4                # Average and Paeth rows in any draw
    want = image_io._unfilter(raw[:, 0], raw[:, 1:], bpp)
    got = np.empty_like(want)
    assert fn(raw, height, stride, bpp, got) == -1
    np.testing.assert_array_equal(got, want)
    raw[7, 0] = 5
    assert fn(raw, height, stride, bpp, got) == 7
    with pytest.raises(ValueError, match="filter type 5"):
        image_io._unfilter(raw[:, 0], raw[:, 1:], bpp)


@pytest.mark.parametrize("shape", [(41, 67, 3), (33, 52)])
def test_read_png_of_opencv_files(tmp_path, shape):
    """OpenCV (libpng) picks a filter per row: all five types mix."""
    rng = np.random.default_rng(3)
    dtype = np.uint8 if len(shape) == 3 else np.uint16
    smooth = np.cumsum(rng.integers(0, 3, shape), axis=1) % np.iinfo(dtype).max
    img = (smooth + rng.integers(0, 2, shape)).astype(dtype)
    path = str(tmp_path / "cv.png")
    cv2.imwrite(path, img[..., ::-1] if img.ndim == 3 else img)
    raw = image_io.read_png(path)
    with Image.open(path) as pil:
        np.testing.assert_array_equal(raw, np.asarray(pil))
    np.testing.assert_array_equal(raw, img)


def test_read_image_is_pil_convert_rgb(tmp_path, monkeypatch):
    rng = np.random.default_rng(5)
    for name, img in (("grey.png", rng.integers(0, 256, (9, 13), dtype=np.uint8)),
                      ("rgba.png", rng.integers(0, 256, (9, 13, 4), dtype=np.uint8)),
                      ("rgb.png", rng.integers(0, 256, (9, 13, 3), dtype=np.uint8))):
        path = str(tmp_path / name)
        image_io.write_png(path, img)
        with Image.open(path) as pil:
            np.testing.assert_array_equal(image_io.read_image(path), np.asarray(pil.convert("RGB")))
    jpg = str(tmp_path / "x.jpg")
    Image.fromarray(rng.integers(0, 256, (9, 13, 3), dtype=np.uint8)).save(jpg)
    with Image.open(jpg) as pil:
        np.testing.assert_array_equal(image_io.read_image(jpg), np.asarray(pil.convert("RGB")))
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)     # no PIL
    with pytest.raises(ImportError, match="--png"):
        image_io.read_image(jpg)


@pytest.mark.parametrize("size", [(1242, 375), (1224, 370), (1238, 374), (1226, 370),
                                  (1241, 376), (97, 31)])
def test_resize_nearest_pil_is_pil(size):
    img = np.random.default_rng(size[0]).integers(0, 65536, size[::-1], dtype=np.uint16)
    want = np.asarray(Image.fromarray(img, mode="I;16").resize((1242, 375), Image.NEAREST))
    np.testing.assert_array_equal(image_io.resize_nearest_pil(img, (1242, 375)), want)


# --- calibration, velodyne, transforms --------------------------------------------

@pytest.mark.parametrize("native", [True, False])
def test_kitti_utils_equal_jax(tmp_path, monkeypatch, native):
    if not native:
        _no_native(monkeypatch)
    write_calib(str(tmp_path), (1242, 375))
    scan = velodyne_scan((1242, 375), 3000, np.random.default_rng(0))
    scan[:50, 0] *= -1.0                                      # behind the car
    scan[50:60] = scan[60:70]                                 # duplicate hits
    scan.tofile(tmp_path / "scan.bin")
    path = str(tmp_path / "calib_cam_to_cam.txt")
    got, want = tutils.read_calib_file(path), jutils.read_calib_file(path)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    for cam, vel_depth in ((2, False), (3, False), (2, True)):
        depth = tutils.generate_depth_map(str(tmp_path), str(tmp_path / "scan.bin"), cam,
                                          vel_depth)
        np.testing.assert_array_equal(depth, jutils.generate_depth_map(
            str(tmp_path), str(tmp_path / "scan.bin"), cam, vel_depth))
        assert (depth > 0).sum() > 1000
        np.testing.assert_array_equal(tutils.resize_depth_nearest(depth, (192, 640)),
                                      jutils.resize_depth_nearest(depth, (192, 640)))


@pytest.mark.parametrize("use_crop,native", [(True, True), (False, True), (True, False)])
def test_train_augmentation_bit_equal_to_jax(monkeypatch, use_crop, native):
    if not native:
        _no_native(monkeypatch)
    rng = np.random.default_rng(9)
    base = {"color_l": rng.uniform(0, 1, (46, 150, 3)).astype(np.float32),
            "color_r": rng.uniform(0, 1, (46, 150, 3)).astype(np.float32),
            "color_-1": rng.uniform(0, 1, (46, 150, 3)).astype(np.float32),
            "depth_gt_l": rng.uniform(0, 80, (46, 150, 1)).astype(np.float32)}
    for seed in range(4):                      # draws on every branch of the augs
        outs = [mod.train_augmentation({k: v.copy() for k, v in base.items()},
                                       np.random.default_rng([1, seed, 3]), (32, 96),
                                       use_crop=use_crop)
                for mod in (ttransforms, jtransforms)]
        assert sorted(outs[0]) == sorted(outs[1])
        for k in outs[1]:
            np.testing.assert_array_equal(outs[0][k], outs[1][k], err_msg=k)
    img = base["color_l"]
    for out_hw in ((17, 61), (92, 300)):
        np.testing.assert_array_equal(ttransforms.resize_bicubic(img, out_hw),
                                      jtransforms.resize_bicubic(img, out_hw))
        np.testing.assert_array_equal(ttransforms.resize_nearest_np(img, out_hw),
                                      jtransforms.resize_nearest_np(img, out_hw))


# --- the readers -------------------------------------------------------------------

def _raw_tree(root, ext=".png"):
    """A raw tree with scans on frames 4 and 5, and a JPEG twin of frame 6."""
    sizes = {DATE: SIZE}
    write_tree(str(root), [f"{DRIVE} {f} l" for f in (4, 5)], scan_points=2000, sizes=sizes)
    write_tree(str(root), [f"{DRIVE} {f} l" for f in (3, 6, 7, 8)], sizes=sizes)
    for cam in (2, 3):
        d = root / DRIVE / f"image_0{cam}" / "data"
        Image.open(d / "0000000006.png").save(d / "0000000006.jpg", quality=90)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti")
    _raw_tree(root)
    # odometry: sequences/09/image_{2,3}/<frame:06d>.png
    rng = np.random.default_rng(2)
    for cam in (2, 3):
        d = root / "sequences" / "09" / f"image_{cam}"
        d.mkdir(parents=True)
        for f in FRAMES:
            image_io.write_png(str(d / f"{f:06d}.png"),
                               rng.integers(0, 256, (SIZE[1], SIZE[0], 3), dtype=np.uint8))
    # annotated depth: <drive>/proj_depth/groundtruth/image_0{2,3}/<frame>.png (16 bit)
    for cam in (2, 3):
        d = root / DRIVE / "proj_depth" / "groundtruth" / f"image_0{cam}"
        d.mkdir(parents=True)
        for f in (4, 5):
            raw = rng.integers(0, 20000, (370, 1224), dtype=np.uint16)
            raw[rng.random(raw.shape) < 0.9] = 0
            Image.fromarray(raw, mode="I;16").save(d / f"{f:010d}.png")
    # COLMAP poses of frames 5 and 6 (none for 4: the reader drops it)
    for f in (5, 6):
        d = root / "colmap" / DRIVE / f"{f:010d}"
        d.mkdir(parents=True)
        for name in ("poses.npy", "poses_flip.npy"):
            poses = {("Rt", s): rng.normal(size=(4, 4)).astype(np.float32) for s in (-1, 1)}
            np.save(d / name, poses, allow_pickle=True)
    return root


CASES = {
    "kitti": dict(lines=[f"{DRIVE} {f} l" for f in FRAMES]),
    "kitti_jpg": dict(lines=[f"{DRIVE} 6 l"], img_ext=".jpg"),
    "kitti_odom": dict(lines=[f"9 {f} l" for f in FRAMES]),
    "kitti_depth": dict(lines=[f"{DRIVE} {f} r" for f in FRAMES]),
    "kitti_colmap": dict(lines=[f"{DRIVE} {f} l" for f in (4, 5, 6)], use_colmap=True,
                         novel_frame_ids=(-1, 1)),
}


@pytest.mark.parametrize("is_train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_reader_samples_bit_equal_to_jax(tree, case, is_train):
    spec = dict(CASES[case])
    lines = spec.pop("lines")
    name = case if case in tkitti.DATASETS else "kitti"
    kw = dict(novel_frame_ids=spec.pop("novel_frame_ids", ()), is_train=is_train,
              use_crop=True, img_ext=spec.pop("img_ext", ".png"), seed=3,
              colmap_path=str(tree / "colmap"), **spec)
    port = tkitti.DATASETS[name](str(tree), lines, 32, 96, **kw)
    ref = jkitti.DATASETS[name](str(tree), lines, 32, 96, **kw)
    assert port.filenames == ref.filenames and len(port) > 0
    depth_seen = 0
    for epoch in (0, 1):
        for index in range(len(ref)):
            got, want = port.getitem(index, epoch), ref.getitem(index, epoch)
            assert (got is None) == (want is None)
            if want is None:
                continue
            assert sorted(got) == sorted(want), (sorted(got), sorted(want))
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            depth_seen += "depth_gt_l" in want
    if case in ("kitti", "kitti_depth"):
        assert depth_seen >= 2                 # the velodyne and the 16-bit PNG depth
    if case == "kitti_colmap" and is_train:
        assert len(port) == 2                  # frame 4 has no poses


def test_split_datasets_apply_the_config_ranges(tree, tmp_path, monkeypatch):
    """``Trainer``'s datasets take ``DataConfig``'s crop factor and
    photometric ranges: their samples are the JAX reader's under the JAX
    ``train_augmentation`` given the same ranges, bit-equal, and differ
    from the default ranges' samples."""
    from planedepth_tpu_torch import config as tcfg

    (tmp_path / "train_files.txt").write_text(f"{DRIVE} 4 l\n{DRIVE} 5 l\n")
    (tmp_path / "val_files.txt").write_text(f"{DRIVE} 5 l\n")
    ranges = dict(crop_factor=(0.9, 1.1), gamma_range=(1.3, 1.4),
                  brightness_range=(0.6, 0.7), color_range=(0.9, 1.0))
    cfg = tcfg.TrainConfig(seed=3, data=tcfg.DataConfig(
        data_path=str(tree), split=str(tmp_path), height=32, width=96, png=True, **ranges))
    train, val = split_datasets(cfg)
    default, _ = split_datasets(cfg.replace(data=tcfg.DataConfig(
        data_path=str(tree), split=str(tmp_path), height=32, width=96, png=True)))
    assert train.is_train and not val.is_train
    monkeypatch.setattr(jkitti, "train_augmentation", functools.partial(
        jtransforms.train_augmentation,
        **{k: v for k, v in ranges.items() if k != "crop_factor"}))
    ref = jkitti.KITTIRAWDataset(str(tree), train.filenames, 32, 96, is_train=True,
                                 img_ext=".png", seed=3, crop_factor=ranges["crop_factor"])
    for index in range(len(ref)):
        got, want = train.getitem(index, 0), ref.getitem(index, 0)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert not np.array_equal(got["color_aug_l"], default.getitem(index, 0)["color_aug_l"])


def test_split_path_and_vendored_splits_equal_jax(tmp_path):
    for split in ("eigen_zhou", str(tmp_path / "mine")):
        for which in ("train", "val", "test"):
            assert tkitti.split_path(split, which) == jkitti.split_path(split, which)
    assert tkitti.split_path(str(tmp_path), "val") == str(tmp_path / "val_files.txt")
    counts = {("eigen_full", "train"): 45200, ("eigen_full_left", "train"): 22600,
              ("eigen_zhou", "train"): 39810, ("eigen_raw", "test"): 697,
              ("eigen_improved", "test"): 652, ("benchmark", "test"): 500}
    for (split, which), n in counts.items():
        lines = tkitti.readlines(tkitti.split_path(split, which))
        assert len(lines) == n
        assert lines == jkitti.readlines(jkitti.split_path(split, which))
    ids = os.path.join(os.path.dirname(tkitti.split_path("benchmark", "test")),
                       "eigen_to_benchmark_ids.npy")
    assert np.load(ids).shape[0] > 0
