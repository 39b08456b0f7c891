"""KITTI datasets (reference datasets/kitti_dataset.py + mono_dataset.py;
``planedepth_tpu/data/kitti.py``, whose samples ``tests/test_torch_kitti.py``
holds these bit-equal to).

Index-based, torch-free loaders returning the framework's flat key
convention (``color_l``, ``color_aug_r``, ``grid``, ``K`` ...) as numpy
arrays.  Differences from the reference, by design:

  * randomness is explicit: each __getitem__ takes an ``epoch`` and derives
    ``np.random.Generator(seed, epoch, index)`` — any sample reproducible;
  * COLMAP is an OFFLINE preprocessing step (scripts/colmap_preprocess.py)
    — the loader only reads the cached ``poses.npy`` (the reference shells
    out to the colmap binary inside the DataLoader worker,
    mono_dataset.py:233-238);
  * images decode straight to float32 HWC;
  * PNGs decode through ``data/image_io.py`` (no PIL), JPEGs through PIL;
  * the photometric ranges are arguments (``DataConfig``'s), as the crop
    factor is in both packages; their defaults are the JAX ones.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from planedepth_tpu_torch.data.image_io import read_image, read_png, resize_nearest_pil
from planedepth_tpu_torch.data.kitti_utils import (
    generate_depth_map,
    resize_depth_nearest,
)
from planedepth_tpu_torch.data.transforms import (
    eval_preprocess,
    train_augmentation,
)
from planedepth_tpu_torch.geometry.camera import NORMALIZED_K

KITTI_FULL_RES = (1242, 375)        # (W, H) (kitti_dataset.py:34)
SIDE_MAP = {"2": 2, "3": 3, "l": 2, "r": 3}


def load_image(path: str) -> np.ndarray:
    """Decode an image to float32 HWC in [0, 1]."""
    return np.asarray(read_image(path), dtype=np.float32) / 255.0


class KITTIDataset:
    """Base KITTI loader (reference kitti_dataset.py:18-55)."""

    def __init__(
        self,
        data_path: str,
        filenames: Sequence[str],
        height: int,
        width: int,
        novel_frame_ids: Sequence[int] = (),
        is_train: bool = False,
        use_crop: bool = True,
        use_colmap: bool = False,
        colmap_path: str = "./kitti_colmap",
        img_ext: str = ".jpg",
        seed: int = 1,
        crop_factor: Tuple[float, float] = (0.75, 1.5),
        gamma_range: Tuple[float, float] = (0.8, 1.2),
        brightness_range: Tuple[float, float] = (0.5, 2.0),
        color_range: Tuple[float, float] = (0.8, 1.2),
    ):
        self.data_path = data_path
        self.filenames = list(filenames)
        self.height = height
        self.width = width
        self.novel_frame_ids = list(novel_frame_ids)
        self.is_train = is_train
        self.use_crop = use_crop
        self.use_colmap = use_colmap and is_train
        self.colmap_path = colmap_path
        self.img_ext = img_ext
        self.seed = seed
        self.crop_factor = crop_factor
        self.gamma_range = gamma_range
        self.brightness_range = brightness_range
        self.color_range = color_range
        self.K = NORMALIZED_K.copy()

        if self.use_colmap:
            # keep only samples with precomputed poses (mono_dataset.py:97-111)
            kept = []
            for line in self.filenames:
                parts = line.split()
                folder = parts[0]
                fidx = int(parts[1]) if len(parts) == 3 else 0
                pose_dir = os.path.join(
                    self.colmap_path, folder, f"{fidx:010d}"
                )
                if os.path.exists(os.path.join(pose_dir, "poses.npy")) and \
                   os.path.exists(os.path.join(pose_dir, "poses_flip.npy")):
                    kept.append(line)
            self.filenames = kept

    # --- paths (overridden per subclass) ------------------------------------
    def get_image_path(self, folder: str, frame_index: int, side: str) -> str:
        raise NotImplementedError

    def get_depth(self, folder, frame_index, side, do_flip):
        raise NotImplementedError

    def check_depth(self, index: int) -> bool:
        return False

    def __len__(self) -> int:
        return len(self.filenames)

    # --- item ---------------------------------------------------------------
    def _rng(self, epoch: int, index: int) -> np.random.Generator:
        return np.random.default_rng([self.seed, epoch, index])

    def get_color(self, folder, frame_index, side, do_flip) -> np.ndarray:
        img = load_image(self.get_image_path(folder, frame_index, side))
        if do_flip:
            img = img[:, ::-1].copy()
        return img

    def getitem(self, index: int, epoch: int = 0) -> Optional[Dict]:
        rng = self._rng(epoch, index)
        do_flip = self.is_train and rng.random() > 0.5

        parts = self.filenames[index].split()
        folder = parts[0]
        frame_index = int(parts[1]) if len(parts) == 3 else 0

        inputs: Dict[str, np.ndarray] = {}
        # 50% flip implemented as L/R swap (mono_dataset.py:162-171)
        sides = ("r", "l") if do_flip else ("l", "r")
        inputs["color_l"] = self.get_color(folder, frame_index, sides[0],
                                           do_flip)
        inputs["color_r"] = self.get_color(folder, frame_index, sides[1],
                                           do_flip)
        for f in self.novel_frame_ids:
            inputs[f"color_{f}"] = self.get_color(
                folder, frame_index + f, sides[0], do_flip
            )

        if self.check_depth(index):
            d_l = self.get_depth(folder, frame_index, sides[0], do_flip)
            d_r = self.get_depth(folder, frame_index, sides[1], do_flip)
            inputs["depth_gt_l"] = d_l.astype(np.float32)[..., None]
            inputs["depth_gt_r"] = d_r.astype(np.float32)[..., None]

        if self.is_train:
            inputs = train_augmentation(
                inputs, rng, (self.height, self.width),
                use_crop=self.use_crop, crop_factor=self.crop_factor,
                gamma_range=self.gamma_range, brightness_range=self.brightness_range,
                color_range=self.color_range,
            )
        else:
            inputs = eval_preprocess(inputs, (self.height, self.width))

        K = self.K.copy()
        K[0, :] *= self.width
        K[1, :] *= self.height
        inputs["K"] = K.astype(np.float32)
        inputs["inv_K"] = np.linalg.pinv(K).astype(np.float32)

        Rt_l = np.eye(4, dtype=np.float32)
        Rt_l[0, 3] = 0.1
        Rt_r = np.eye(4, dtype=np.float32)
        Rt_r[0, 3] = -0.1
        inputs["Rt_l"] = Rt_l
        inputs["Rt_r"] = Rt_r

        if self.use_colmap:
            pose_dir = os.path.join(
                self.colmap_path, folder, f"{frame_index:010d}"
            )
            # NOTE: flip loads "poses.npy" and no-flip loads "poses_flip.npy"
            # — reproducing the reference's swapped pairing
            # (mono_dataset.py:253-262).  By their names the pairing is
            # backwards: poses_flip.npy holds the mirrored sequence's poses
            # relative to the right camera (scripts/colmap_preprocess.py:
            # 77-82).  It is kept so that a run trains on the poses the
            # reference's runs trained on, and the samples stay bit-equal
            # to the JAX package's.
            fname = "poses.npy" if do_flip else "poses_flip.npy"
            try:
                poses = np.load(
                    os.path.join(pose_dir, fname), allow_pickle=True
                ).item()
            except Exception:
                return None
            for (key, f), Rt in poses.items():
                inputs[f"Rt_{f}"] = np.asarray(Rt, dtype=np.float32)
        elif self.novel_frame_ids:
            for f in self.novel_frame_ids:
                inputs[f"Rt_{f}"] = np.eye(4, dtype=np.float32)

        return inputs

    def __getitem__(self, index):
        return self.getitem(index, epoch=0)


class KITTIRAWDataset(KITTIDataset):
    """Raw KITTI with velodyne ground truth (kitti_dataset.py:58-85)."""

    def get_image_path(self, folder, frame_index, side):
        return os.path.join(
            self.data_path, folder, f"image_0{SIDE_MAP[side]}/data",
            f"{frame_index:010d}{self.img_ext}",
        )

    def check_depth(self, index):
        parts = self.filenames[index].split()
        if len(parts) < 2:
            return False
        velo = os.path.join(
            self.data_path, parts[0],
            f"velodyne_points/data/{int(parts[1]):010d}.bin",
        )
        return os.path.isfile(velo)

    def get_depth(self, folder, frame_index, side, do_flip):
        calib_path = os.path.join(self.data_path, folder.split("/")[0])
        velo = os.path.join(
            self.data_path, folder,
            f"velodyne_points/data/{frame_index:010d}.bin",
        )
        depth = generate_depth_map(calib_path, velo, SIDE_MAP[side])
        depth = resize_depth_nearest(depth, KITTI_FULL_RES[::-1])
        if do_flip:
            depth = np.fliplr(depth).copy()
        return depth


class KITTIOdomDataset(KITTIDataset):
    """KITTI odometry sequences (kitti_dataset.py:88-101)."""

    def get_image_path(self, folder, frame_index, side):
        return os.path.join(
            self.data_path, f"sequences/{int(folder):02d}",
            f"image_{SIDE_MAP[side]}", f"{frame_index:06d}{self.img_ext}",
        )


class KITTIDepthDataset(KITTIDataset):
    """KITTI with official annotated depth PNGs (kitti_dataset.py:104-134)."""

    def get_image_path(self, folder, frame_index, side):
        return os.path.join(
            self.data_path, folder, f"image_0{SIDE_MAP[side]}/data",
            f"{frame_index:010d}{self.img_ext}",
        )

    def check_depth(self, index):
        parts = self.filenames[index].split()
        if len(parts) < 2:
            return False
        path = os.path.join(
            self.data_path, parts[0],
            f"proj_depth/groundtruth/image_02/{int(parts[1]):010d}.png",
        )
        return os.path.isfile(path)

    def get_depth(self, folder, frame_index, side, do_flip):
        path = os.path.join(
            self.data_path, folder,
            f"proj_depth/groundtruth/image_0{SIDE_MAP[side]}",
            f"{frame_index:010d}.png",
        )
        depth = np.asarray(resize_nearest_pil(read_png(path), KITTI_FULL_RES),
                           dtype=np.float32) / 256.0
        if do_flip:
            depth = np.fliplr(depth).copy()
        return depth


DATASETS = {
    "kitti": KITTIRAWDataset,
    "kitti_odom": KITTIOdomDataset,
    "kitti_depth": KITTIDepthDataset,
}


def readlines(path: str) -> List[str]:
    with open(path, "r") as f:
        return [ln.rstrip() for ln in f if ln.strip()]


def split_path(split: str, which: str) -> str:
    """Path to a split file list under the repo's splits/ directory; an
    absolute ``split`` names a directory of its own (``os.path.join``
    drops the root before it)."""
    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))), "splits")
    return os.path.join(root, split, f"{which}_files.txt")
