"""Image files and resizes without PIL or OpenCV.

The JAX package decodes KITTI frames and depth PNGs with PIL
(``planedepth_tpu/data/kitti.py:37-40, 254-255``) and writes the benchmark
PNGs with OpenCV (``planedepth_tpu/eval/evaluator.py:118-133``).  This
module stands in for both:

- :func:`read_png` / :func:`write_png`: non-interlaced PNGs of 8 or 16 bits
  a sample, grey, grey + alpha, RGB or RGBA (KITTI's frames are 8-bit RGB,
  its depth maps and the benchmark's predictions 16-bit grey).  Reading
  undoes all five row filters, in C (``png_unfilter.c``, compiled with the
  host's C compiler at first use into ``build/``; ctypes lets go of the GIL
  while it runs, so loader threads decode in parallel) or, where no
  compiler is found, in numpy: None, Sub and Up vectorised along the row;
  Average and Paeth depend on the decoded pixel to the left as well as the
  row above, so they run as a wavefront: step ``k`` decodes pixel column
  ``k - r`` of every row ``r`` at once, ``rows + width`` steps in all.
  :func:`png_decoder` says which one runs.  The writer uses filter 0 unless
  asked for another, for all rows or row by row;
- :func:`read_image`: a KITTI frame as 8-bit RGB; ``.png`` through
  :func:`read_png`, anything else through PIL, imported only then;
- :func:`resize_nearest_pil`: PIL's ``Image.resize(size, Image.NEAREST)``
  of a 16-bit grey image (PIL's mode ``I;16``);
- :func:`resize_bilinear`: ``cv2.resize``'s default half-pixel bilinear.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
import zlib
from pathlib import Path
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}          # PNG colour type -> samples a pixel
_UNFILTER_SRC = Path(__file__).with_name("png_unfilter.c")
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "planedepth_tpu_torch"
_U8 = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
_unfilter_lock = threading.Lock()
_unfilter_state: dict = {}


def png_unfilter_library():
    """The compiled row unfilter, or None where it cannot be built
    (:func:`png_decoder` says why); built once a process."""
    with _unfilter_lock:
        if "fn" not in _unfilter_state:
            _unfilter_state["fn"], _unfilter_state["why"] = _build_unfilter()
        return _unfilter_state["fn"]


def _build_unfilter():
    """Compile ``png_unfilter.c`` into ``build/planedepth_tpu_torch/png-<hash>/``
    (kept across runs; a file of its own per process until it is in place)."""
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        return None, "no C compiler on PATH"
    source = _UNFILTER_SRC.read_bytes()
    path = _BUILD_DIR / f"png-{hashlib.sha256(source).hexdigest()[:16]}" / "libpdt_png.so"
    try:
        if not path.exists():
            path.parent.mkdir(parents=True, exist_ok=True)
            tmp = path.with_name(f"{path.name}.{os.getpid()}")
            subprocess.run([cc, "-O2", "-shared", "-fPIC", "-o", str(tmp), str(_UNFILTER_SRC)],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, path)
        fn = ctypes.CDLL(str(path)).pdt_png_unfilter
    except (OSError, subprocess.SubprocessError) as e:
        detail = (getattr(e, "stderr", None) or b"").decode(errors="replace").strip()
        return None, f"the C build failed: {e} {detail}".strip()
    fn.argtypes = [_U8, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _U8]
    fn.restype = ctypes.c_int64
    return fn, str(path)


def png_decoder() -> str:
    """Which row unfilter :func:`read_png` runs, and where it was built or
    why it was not."""
    fn = png_unfilter_library()
    return f"{'compiled C' if fn else 'numpy'} ({_unfilter_state['why']})"


def read_png(path: str) -> np.ndarray:
    """Decode a PNG to ``(H, W)`` (grey) or ``(H, W, C)``, ``uint8`` or
    ``uint16`` as its bit depth says."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    if color not in _CHANNELS or depth not in (8, 16) or interlace:
        raise ValueError(f"{path}: colour type {color}, bit depth {depth}, interlace "
                         f"{interlace}: only non-interlaced 8/16-bit grey, grey+alpha, "
                         f"RGB and RGBA PNGs are read")
    channels = _CHANNELS[color]
    bpp = channels * depth // 8                    # bytes a pixel
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw[:height * (1 + width * bpp)].reshape(height, 1 + width * bpp)
    unfilter = png_unfilter_library()
    if unfilter is None:
        rows = _unfilter(raw[:, 0], raw[:, 1:], bpp)
    else:
        rows = np.empty((height, width * bpp), np.uint8)
        bad = unfilter(raw, height, width * bpp, bpp, rows)
        if bad >= 0:
            raise ValueError(f"PNG filter type {raw[bad, 0]} does not exist")
    if depth == 16:
        out = rows.view(">u2").astype(np.uint16)
    else:
        out = rows
    out = out.reshape(height, width, channels)
    return out[..., 0] if channels == 1 else out


def _unfilter(ftypes: np.ndarray, rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the row filters: rows without Average or Paeth one at a time,
    the span from the first to the last row with one as a wavefront."""
    if ftypes.max(initial=0) > 4:
        raise ValueError(f"PNG filter type {int(ftypes.max())} does not exist")
    height, stride = rows.shape
    out = np.empty_like(rows)
    slow = np.flatnonzero(ftypes >= 3)
    first, last = (slow[0], slow[-1] + 1) if len(slow) else (height, height)
    prior = np.zeros(stride, np.uint8)
    for y in range(first):
        prior = out[y] = _unfilter_row(ftypes[y], rows[y], prior, bpp)
    if first < last:
        out[first:last] = _wavefront(ftypes[first:last], rows[first:last], prior, bpp)
        prior = out[last - 1]
    for y in range(last, height):
        prior = out[y] = _unfilter_row(ftypes[y], rows[y], prior, bpp)
    return out


def _unfilter_row(ftype, row, prior, bpp):
    """One row of filter None (0), Sub (1) or Up (2); uint8 sums wrap mod 256."""
    if ftype == 0:
        return row
    if ftype == 1:
        return np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
    return row + prior


def _wavefront(ftypes, rows, prior, bpp):
    """Rows of any filter type, decoded a skewed column at a time.

    The rows, with ``prior`` above them and a zero pixel column on their
    left, are skewed so that padded row ``r`` starts ``r`` columns further
    right: a pixel's left, upper and upper-left neighbours then lie in the
    two skewed columns before its own, which hold only decoded pixels.
    """
    n, width = rows.shape[0], rows.shape[1] // bpp
    # skew[k, r]: skewed column k of padded row r (row 0 is prior, column 0 zero)
    skew = np.zeros((width + n + 1, n + 1, bpp), np.int16)
    data = np.zeros_like(skew)
    col = np.arange(1, width + 1)[None, :]
    row = np.arange(1, n + 1)[:, None]
    skew[1:width + 1, 0] = prior.reshape(width, bpp)
    data[col + row, row] = rows.reshape(n, width, bpp)
    kinds = [t for t in (1, 2, 3, 4) if (ftypes == t).any()]
    # one filter in the span: no per-row selection
    weights = {t: (ftypes == t).astype(np.int16)[:, None] for t in kinds} \
        if len(kinds) > 1 else {t: None for t in kinds}
    for k in range(2, width + n + 1):
        hi = min(n, k - 1)                     # padded rows 1..hi have a pixel here
        a = skew[k - 1, 1:hi + 1]              # left
        b = skew[k - 1, 0:hi]                  # up
        c = skew[k - 2, 0:hi]                  # up-left
        x = data[k, 1:hi + 1].copy()
        for t, w in weights.items():
            if t == 1:
                term = a
            elif t == 2:
                term = b
            elif t == 3:
                term = (a + b) >> 1
            else:
                da, db = a - c, b - c
                pa, pb, pc = np.abs(db), np.abs(da), np.abs(da + db)
                term = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
            x += term if w is None else w[:hi] * term
        np.bitwise_and(x, 0xFF, out=skew[k, 1:hi + 1])
    return skew[col + row, row].astype(np.uint8).reshape(n, width * bpp)


def _filter_rows(rows: np.ndarray, bpp: int, ftype: int, which: np.ndarray) -> np.ndarray:
    """Apply one PNG filter to the rows ``which`` of ``rows`` (int16, before
    the mod 256), each against the row above it in ``rows``."""
    x = rows[which].astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]                                   # left
    b = np.where((which > 0)[:, None], rows[which - 1], 0).astype(np.int16)   # up
    c = np.zeros_like(x)
    c[:, bpp:] = b[:, :-bpp]                                   # up-left
    if ftype == 0:
        pred = 0
    elif ftype == 1:
        pred = a
    elif ftype == 2:
        pred = b
    elif ftype == 3:
        pred = (a + b) >> 1
    elif ftype == 4:
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    else:
        raise ValueError(f"PNG filter type {ftype} does not exist")
    return ((x - pred) & 0xFF).astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray, filter_type=0) -> None:
    """Write ``(H, W)`` or ``(H, W, C)`` (C of 1-4), ``uint8`` or
    ``uint16``, as a PNG with every row under ``filter_type`` (0: None), or
    row ``y`` under ``filter_type[y]`` where it is a sequence of H types."""
    image = np.asarray(image)
    if image.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"write_png: dtype {image.dtype}; uint8 or uint16 expected")
    if image.ndim == 2:
        image = image[..., None]
    height, width, channels = image.shape
    color = {1: 0, 2: 4, 3: 2, 4: 6}[channels]
    depth = 8 * image.dtype.itemsize
    samples = image.astype(">u2") if depth == 16 else image
    rows = np.ascontiguousarray(samples).view(np.uint8).reshape(height, -1)
    ftypes = np.broadcast_to(np.asarray(filter_type, np.uint8), (height,))
    filtered = np.empty_like(rows)
    for t in np.unique(ftypes):
        which = np.flatnonzero(ftypes == t)
        filtered[which] = _filter_rows(rows, channels * depth // 8, int(t), which)
    raw = np.concatenate([ftypes[:, None], filtered], axis=1)
    header = struct.pack(">IIBBBBB", width, height, depth, color, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes()))
                + _chunk(b"IEND", b""))


def read_image(path: str) -> np.ndarray:
    """A frame as ``(H, W, 3)`` uint8 RGB, as PIL's ``convert("RGB")``
    gives it: grey repeated, alpha dropped."""
    if path.lower().endswith(".png"):
        img = read_png(path)
        if img.dtype != np.uint8:
            raise ValueError(f"{path}: a 16-bit PNG is not a colour frame")
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[2] in (1, 2):
            return np.repeat(img[..., :1], 3, axis=2)
        return img[..., :3]
    try:
        from PIL import Image
    except ImportError:
        raise ImportError(
            f"reading {path} needs PIL, which is not installed: write the frames "
            f"as .png and pass --png (DataConfig.png)") from None
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"))


def resize_nearest_pil(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``Image.resize((W, H), Image.NEAREST)`` of an ``(h, w)`` 16-bit grey
    image: output pixel ``x`` takes input ``floor((x + 0.5) * w / W)``, as
    PIL's generic affine transform takes it for mode ``I;16``.  (PIL resizes
    8-bit images by another routine, which sums the step and can land one
    pixel off this.)"""
    width, height = size
    h, w = image.shape[:2]
    ix = np.floor((np.arange(width) + 0.5) * (w / width)).astype(np.int64)
    iy = np.floor((np.arange(height) + 0.5) * (h / height)).astype(np.int64)
    return image[np.minimum(iy, h - 1)][:, np.minimum(ix, w - 1)]


def resize_bilinear(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """``(h, w)`` -> ``(height, width)`` float32, as
    ``cv2.resize(img, (width, height))`` (INTER_LINEAR, half-pixel) gives it
    for an image of more than one row: OpenCV takes the source coordinates
    in double precision there, so this interpolates in float64 (within 1e-7
    of OpenCV on values in [0, 1])."""
    t = torch.from_numpy(np.asarray(img, dtype=np.float64))[None, None]
    out = F.interpolate(t, size=(height, width), mode="bilinear", align_corners=False)
    return out[0, 0].numpy().astype(np.float32)
