"""Host-side pair transforms (reference datasets/pair_transforms.py:8-141;
``planedepth_tpu/data/transforms.py``, a copy held bit-equal to it under
the same generator by ``tests/test_torch_kitti.py``).

Numpy implementations with an EXPLICIT ``np.random.Generator`` — the
reference's hidden global ``random``/``np.random`` state (seeded per worker,
trainer.py:132-135) becomes a per-sample generator derived from
``(seed, epoch, index)``, so any sample is reproducible in isolation.

The geometric resample is bicubic with align_corners=True and A=-0.75 —
bit-matching torch ``F.interpolate(..., mode='bicubic',
align_corners=True)`` (validated in tests/test_data.py against the torch
oracle), because the aug distribution and the emitted virtual-camera
``grid`` define the plane geometry downstream.

All images are numpy float32 HWC in [0, 1]; the transforms operate on a dict
with keys ``color_l``, ``color_r``, ``color_<f>`` (temporal), adding
``color_aug_*`` and ``grid``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

_A = -0.75  # torch/Catmull-Rom-style bicubic coefficient


def _cubic_kernel(d: np.ndarray) -> np.ndarray:
    d = np.abs(d)
    d2 = d * d
    d3 = d2 * d
    w = np.where(
        d <= 1.0,
        (_A + 2.0) * d3 - (_A + 3.0) * d2 + 1.0,
        np.where(
            d < 2.0,
            _A * d3 - 5.0 * _A * d2 + 8.0 * _A * d - 4.0 * _A,
            0.0,
        ),
    )
    return w


def _interp_matrix_bicubic(s_in: int, s_out: int) -> np.ndarray:
    """(s_out, s_in) bicubic interpolation matrix, align_corners=True."""
    if s_out == 1:
        src = np.zeros((1,))
    else:
        src = np.arange(s_out, dtype=np.float64) * ((s_in - 1) / (s_out - 1))
    i0 = np.floor(src).astype(np.int64)
    m = np.zeros((s_out, s_in), dtype=np.float32)
    rows = np.arange(s_out)
    for tap in (-1, 0, 1, 2):
        idx = i0 + tap
        w = _cubic_kernel(src - idx).astype(np.float32)
        np.add.at(m, (rows, np.clip(idx, 0, s_in - 1)), w)
    return m


_matrix_cache: Dict[Tuple[int, int], np.ndarray] = {}


def _get_matrix(s_in: int, s_out: int) -> np.ndarray:
    key = (s_in, s_out)
    if key not in _matrix_cache:
        if len(_matrix_cache) > 512:
            _matrix_cache.clear()
        _matrix_cache[key] = _interp_matrix_bicubic(s_in, s_out)
    return _matrix_cache[key]


def resize_bicubic(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """Bicubic align_corners=True resize of (H, W, C) float32.

    Uses the native C++ kernel (native/pdnative.cpp) when built; the numpy
    matrix path below is the bit-equivalent fallback and test oracle.
    """
    from planedepth_tpu_torch.data import native

    fast = native.resize_bicubic_native(img, out_hw)
    if fast is not None:
        return fast
    H, W, C = img.shape
    Ho, Wo = out_hw
    my = _get_matrix(H, Ho)
    mx = _get_matrix(W, Wo)
    out = np.einsum("oh,hwc->owc", my, img)
    out = np.einsum("ow,hwc->hoc", mx, out)
    return out


def resize_nearest_np(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """torch 'nearest' semantics: src = floor(dst * s_in / s_out)."""
    H, W = img.shape[:2]
    Ho, Wo = out_hw
    iy = np.floor(np.arange(Ho) * (H / Ho)).astype(np.int64)
    ix = np.floor(np.arange(Wo) * (W / Wo)).astype(np.int64)
    return img[iy][:, ix]


def _color_keys(inputs: Dict) -> list:
    return [k for k in inputs if k.startswith("color") and "aug" not in k]


def identity_grid(height: int, width: int) -> np.ndarray:
    gx, gy = np.meshgrid(
        np.linspace(-1.0, 1.0, width, dtype=np.float32),
        np.linspace(-1.0, 1.0, height, dtype=np.float32),
    )
    return np.stack([gx, gy], axis=-1)


def random_resize_crop(
    inputs: Dict[str, np.ndarray],
    rng: np.random.Generator,
    target_size: Tuple[int, int],
    factor: Tuple[float, float] = (0.75, 1.5),
) -> Dict[str, np.ndarray]:
    """Scale-crop aug emitting the virtual-camera grid
    (reference pair_transforms.py:20-56)."""
    th, tw = target_size
    H, W = inputs["color_r"].shape[:2]
    min_factor = max(max((th + 1) / H, (tw + 1) / W), factor[0])
    f = rng.uniform(min_factor, factor[1])
    Hs, Ws = int(H * f), int(W * f)
    h0 = int(rng.integers(0, Hs - th + 1))
    w0 = int(rng.integers(0, Ws - tw + 1))

    gx, gy = np.meshgrid(
        np.linspace(-1.0, 1.0, Ws, dtype=np.float32),
        np.linspace(-1.0, 1.0, Hs, dtype=np.float32),
    )
    grid = np.stack([gx, gy], axis=-1)
    inputs["grid"] = grid[h0 : h0 + th, w0 : w0 + tw].copy()

    for k in _color_keys(inputs):
        img = resize_bicubic(inputs[k], (Hs, Ws))
        img = np.clip(img, 0.0, 1.0)
        img = img[h0 : h0 + th, w0 : w0 + tw]
        inputs[k] = img.astype(np.float32)
        inputs[k.replace("color", "color_aug", 1)] = img.astype(np.float32).copy()

    for k in list(inputs):
        if k.startswith("depth_gt"):
            d = resize_nearest_np(inputs[k], (Hs, Ws))
            inputs[k] = d[h0 : h0 + th, w0 : w0 + tw].copy()
    return inputs


def resize_to_target(
    inputs: Dict[str, np.ndarray], target_size: Tuple[int, int]
) -> Dict[str, np.ndarray]:
    """No-crop path: bicubic to target + identity grid
    (reference pair_transforms.py:58-84)."""
    th, tw = target_size
    inputs["grid"] = identity_grid(th, tw)
    for k in _color_keys(inputs):
        img = np.clip(resize_bicubic(inputs[k], (th, tw)), 0.0, 1.0)
        inputs[k] = img.astype(np.float32)
        inputs[k.replace("color", "color_aug", 1)] = img.astype(np.float32).copy()
    for k in list(inputs):
        if k.startswith("depth_gt"):
            inputs[k] = resize_nearest_np(inputs[k], (th, tw)).copy()
    return inputs


def random_gamma(inputs, rng, lo=0.8, hi=1.2, p=0.5):
    """(reference pair_transforms.py:86-102)"""
    if rng.random() < p:
        g = rng.uniform(lo, hi)
        for k in list(inputs):
            if k.startswith("color_aug"):
                inputs[k] = inputs[k] ** g
    return inputs


def random_brightness(inputs, rng, lo=0.5, hi=2.0, p=0.5):
    """(reference pair_transforms.py:105-121)"""
    if rng.random() < p:
        b = rng.uniform(lo, hi)
        for k in list(inputs):
            if k.startswith("color_aug"):
                inputs[k] = np.minimum(inputs[k] * b, 1.0)
    return inputs


def random_color_brightness(inputs, rng, lo=0.8, hi=1.2, p=0.5):
    """Per-channel brightness (reference pair_transforms.py:124-141)."""
    if rng.random() < p:
        for c in range(3):
            f = rng.uniform(lo, hi)
            for k in list(inputs):
                if k.startswith("color_aug"):
                    inputs[k][..., c] = np.minimum(inputs[k][..., c] * f, 1.0)
    return inputs


def train_augmentation(
    inputs: Dict[str, np.ndarray],
    rng: np.random.Generator,
    target_size: Tuple[int, int],
    use_crop: bool = True,
    crop_factor: Tuple[float, float] = (0.75, 1.5),
    gamma_range=(0.8, 1.2),
    brightness_range=(0.5, 2.0),
    color_range=(0.8, 1.2),
) -> Dict[str, np.ndarray]:
    """Full train-time pipeline (reference mono_dataset.py:77-87)."""
    if use_crop:
        inputs = random_resize_crop(inputs, rng, target_size, crop_factor)
    else:
        inputs = resize_to_target(inputs, target_size)
    inputs = random_gamma(inputs, rng, *gamma_range)
    inputs = random_brightness(inputs, rng, *brightness_range)
    inputs = random_color_brightness(inputs, rng, *color_range)
    return inputs


def eval_preprocess(inputs, target_size):
    """Validation/eval path: resize only (reference mono_dataset.py:89-90)."""
    return resize_to_target(inputs, target_size)
