"""A KITTI-shaped raw tree with seeded content, for drives without KITTI.

``write_tree(root, lines)`` writes what the KITTI raw reader
(``data/kitti.py:KITTIRAWDataset``) and the eigen_raw ground-truth export
(``eval/export_gt.py``) read, for each split line ``"<date>/<drive> <frame>
<side>"``:

- ``<date>/calib_cam_to_cam.txt`` and ``calib_velo_to_cam.txt`` in KITTI's
  format, with the date's real image size (``DATE_SIZES``), a pinhole camera
  of KITTI's focal length and its two colour cameras' baseline;
- ``<date>/<drive>/image_02/data/<frame>.png`` and ``image_03``: a seeded
  texture of 16x16-pixel blocks (so that the PNGs compress to ~1/100 of the raw
  bytes) and the right view the left one shifted by ``DISPARITY`` pixels.
  Each row is filtered by Sub, Up, Average or Paeth, drawn from the seed:
  KITTI's PNGs, written by libpng's adaptive filtering, mix the four row by
  row, and a reader of these frames takes the paths that KITTI's take;
- with ``scan_points``, ``velodyne_points/data/<frame>.bin``: that many
  points drawn in the left camera's view (depth 4-78 m, the lower 60% of
  the rows) and carried back into the velodyne frame, so that every scan
  projects into the Eigen crop.

Everything is made from the seed and the line, so two calls write the same
bytes.
"""
from __future__ import annotations

import os
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Tuple

import numpy as np

from planedepth_tpu_torch.data.image_io import write_png

# (W, H) of the rectified frames of each KITTI raw date
DATE_SIZES: Dict[str, Tuple[int, int]] = {
    "2011_09_26": (1242, 375), "2011_09_28": (1224, 370), "2011_09_29": (1238, 374),
    "2011_09_30": (1226, 370), "2011_10_03": (1241, 376)}
FOCAL = 721.5377                       # px, KITTI's rectified colour cameras
BASELINES = {2: 0.06, 3: -0.4706}      # m, P_rect_0k[0, 3] / focal
DISPARITY = 12                         # px between the two views
BLOCK = 16                             # texture block, px
# velodyne (x forward, y left, z up) -> camera 0 (x right, y down, z forward)
VELO_R = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])
VELO_T = np.array([-0.004, -0.076, -0.272])


def projection(size: Tuple[int, int], cam: int) -> np.ndarray:
    """``P_rect_0<cam>`` of a date whose frames are ``size`` (W, H)."""
    width, height = size
    return np.array([[FOCAL, 0.0, width / 2, FOCAL * BASELINES[cam]],
                     [0.0, FOCAL, height / 2, 0.0],
                     [0.0, 0.0, 1.0, 0.0]])


def write_calib(date_dir: str, size: Tuple[int, int]) -> None:
    """KITTI's two calibration files for one date."""
    os.makedirs(date_dir, exist_ok=True)

    def row(a):
        return " ".join(f"{v:.12e}" for v in np.ravel(a))

    with open(os.path.join(date_dir, "calib_cam_to_cam.txt"), "w") as f:
        f.write("calib_time: 09-Jan-2012 13:57:47\ncorner_dist: 9.950000e-02\n")
        f.write(f"S_rect_02: {size[0]:.6e} {size[1]:.6e}\n")
        f.write(f"R_rect_00: {row(np.eye(3))}\n")
        for cam in (2, 3):
            f.write(f"P_rect_0{cam}: {row(projection(size, cam))}\n")
    with open(os.path.join(date_dir, "calib_velo_to_cam.txt"), "w") as f:
        f.write("calib_time: 15-Mar-2012 11:37:16\n")
        f.write(f"R: {row(VELO_R)}\nT: {row(VELO_T)}\n")


def frame_pair(size: Tuple[int, int], rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """A left frame of 16x16 blocks and its right view, uint8 (H, W, 3)."""
    width, height = size
    blocks = rng.integers(0, 256, (height // BLOCK + 1, (width + DISPARITY) // BLOCK + 1, 3),
                          dtype=np.uint8)
    scene = np.repeat(np.repeat(blocks, BLOCK, axis=0), BLOCK, axis=1)[:height]
    return scene[:, :width], scene[:, DISPARITY:DISPARITY + width]


def velodyne_scan(size: Tuple[int, int], n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` velodyne points (x, y, z, reflectance) float32 that the left
    camera sees in the lower 60% of its rows, 4-78 m away."""
    width, height = size
    z = rng.uniform(4.0, 78.0, n)
    u = rng.uniform(0.0, width, n)
    v = rng.uniform(0.4 * height, height, n)
    P = projection(size, 2)
    x_cam = np.stack([((u - P[0, 2]) * z - P[0, 3]) / FOCAL, (v - P[1, 2]) * z / FOCAL, z])
    velo = VELO_R.T @ (x_cam - VELO_T[:, None])
    return np.concatenate([velo.T, rng.uniform(0, 1, (n, 1))], axis=1).astype(np.float32)


def write_tree(root: str, lines: Iterable[str], scan_points: int = 0, seed: int = 0,
               sizes: Dict[str, Tuple[int, int]] = DATE_SIZES, workers: int = 8) -> int:
    """Write each line's two frames (and a scan of ``scan_points``) under
    ``root``, and each date's calibration; returns the bytes written."""
    lines = sorted(set(" ".join(ln.split()[:2]) for ln in lines))
    for date in sorted(set(ln.split("/")[0] for ln in lines)):
        write_calib(os.path.join(root, date), sizes[date])

    def write(line):
        folder, frame = line.split()
        size = sizes[folder.split("/")[0]]
        rng = np.random.default_rng([seed, zlib.crc32(folder.encode()), int(frame)])
        left, right = frame_pair(size, rng)
        for cam, img in ((2, left), (3, right)):
            d = os.path.join(root, folder, f"image_0{cam}", "data")
            os.makedirs(d, exist_ok=True)
            filters = np.random.default_rng(
                [seed, zlib.crc32(folder.encode()), int(frame), cam]).integers(1, 5, size[1])
            write_png(os.path.join(d, f"{int(frame):010d}.png"), img, filter_type=filters)
        if scan_points:
            d = os.path.join(root, folder, "velodyne_points", "data")
            os.makedirs(d, exist_ok=True)
            velodyne_scan(size, scan_points, rng).tofile(
                os.path.join(d, f"{int(frame):010d}.bin"))

    with ThreadPoolExecutor(workers) as pool:
        list(pool.map(write, lines))
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(root) for f in files)
