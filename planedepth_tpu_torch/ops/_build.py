"""Builds the port's CUDA kernels with ``nvcc`` at first use and loads them with ctypes.

Each ``planedepth_tpu_torch/csrc/*.cu`` is compiled for ``sm_90a`` by its own
``nvcc`` process, all started together, and the objects are linked into one
shared library with a plain C interface.  The library lands in
``build/planedepth_tpu_torch/<hash>/`` under the repository root, keyed by a
hash of the sources and the flags, so an unchanged tree builds once.  Only
sources in the repository are compiled and nothing is fetched.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR.parent / "build" / "planedepth_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libpdt_kernels.so"


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            candidates.append(os.path.join(os.environ[env], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> dict:
    """Compile the kernels unless the library for these sources exists.

    Returns ``{"path", "seconds", "cached", "log"}``; ``log`` holds the
    compiler's output (``-Xptxas -v``: registers, shared memory, spills).
    """
    path = library_path()
    log_path = path.with_suffix(".log")
    if path.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return {"path": str(path), "seconds": 0.0, "cached": True, "log": log}
    path.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    tmp = path.with_name(f".{LIB_NAME}.{tag}")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in _sources():
        obj = path.with_name(f".{src.stem}.{tag}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
    steps = [(cmd, proc.communicate()[0], proc.returncode) for cmd, proc in procs]
    if all(rc == 0 for _, _, rc in steps):
        cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs)]
        link = subprocess.run(cmd, capture_output=True, text=True)
        steps.append((cmd, link.stdout + link.stderr, link.returncode))
    seconds = time.perf_counter() - t0
    for obj in objs:
        obj.unlink(missing_ok=True)
    log = "".join(out for _, out, _ in steps)
    failed = [(cmd, out, rc) for cmd, out, rc in steps if rc != 0]
    if failed:
        tmp.unlink(missing_ok=True)
        cmd, out, rc = failed[0]
        raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}")
    log_path.write_text(log)
    os.replace(tmp, path)
    return {"path": str(path), "seconds": seconds, "cached": False, "log": log}


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare every C entry point's signature."""
    lib = ctypes.CDLL(build()["path"])
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.pdt_disp_head_fwd.argtypes = [p, p, p, p, p, i, i, i, i, p]
    lib.pdt_disp_head_fwd.restype = i
    lib.pdt_disp_head_bwd.argtypes = [p] * 9 + [i, i, i, i, p]
    lib.pdt_disp_head_bwd.restype = i
    lib.pdt_disp_head_bwd_scratch_floats.argtypes = [i, i, i, i]
    lib.pdt_disp_head_bwd_scratch_floats.restype = ctypes.c_longlong
    lib.pdt_disp_head_bwd_kernel_info.argtypes = [i, i, p]
    lib.pdt_disp_head_bwd_kernel_info.restype = i
    lib.pdt_warp2d_fwd.argtypes = [p] * 9 + [i] * 5 + [p]
    lib.pdt_warp2d_fwd.restype = i
    lib.pdt_warp2d_bwd.argtypes = [p] * 13 + [i] * 5 + [p]
    lib.pdt_warp2d_bwd.restype = i
    lib.pdt_warp2d_fwd_bf16.argtypes = [p] * 10 + [i] * 5 + [p]
    lib.pdt_warp2d_fwd_bf16.restype = i
    lib.pdt_warp2d_fwd_bf16_scratch_bytes.argtypes = [i] * 3
    lib.pdt_warp2d_fwd_bf16_scratch_bytes.restype = ctypes.c_longlong
    lib.pdt_warp2d_bwd_bf16.argtypes = [p] * 14 + [i] * 5 + [p]
    lib.pdt_warp2d_bwd_bf16.restype = i
    lib.pdt_warp2d_bwd_bf16_scratch_bytes.argtypes = [i] * 5
    lib.pdt_warp2d_bwd_bf16_scratch_bytes.restype = ctypes.c_longlong
    lib.pdt_warp2d_bwd_kernel_info.argtypes = [i, p]
    lib.pdt_warp2d_bwd_kernel_info.restype = i
    lib.pdt_warp2d_bwd_kernel_info_bf16.argtypes = [i, p]
    lib.pdt_warp2d_bwd_kernel_info_bf16.restype = i
    lib.pdt_warp2d_fwd_kernel_info.argtypes = [i, p]
    lib.pdt_warp2d_fwd_kernel_info.restype = i
    lib.pdt_warp2d_fwd_kernel_info_bf16.argtypes = [i, p]
    lib.pdt_warp2d_fwd_kernel_info_bf16.restype = i
    lib.pdt_plane_sweep_fwd.argtypes = [p] * 11 + [i, i, i, i, f, i, i, i, p]
    lib.pdt_plane_sweep_fwd.restype = i
    lib.pdt_plane_sweep_bwd.argtypes = [p] * 14 + [i, i, i, i, f, i, i, p]
    lib.pdt_plane_sweep_bwd.restype = i
    lib.pdt_plane_sweep_fwd_bf16.argtypes = [p] * 11 + [i, i, i, i, f, i, i, i, p]
    lib.pdt_plane_sweep_fwd_bf16.restype = i
    lib.pdt_plane_sweep_bwd_bf16.argtypes = [p] * 14 + [i, i, i, i, f, i, i, p]
    lib.pdt_plane_sweep_bwd_bf16.restype = i
    lib.pdt_plane_sweep_bwd_img.argtypes = [p] * 17 + [i, i, i, i, f, i, p]
    lib.pdt_plane_sweep_bwd_img.restype = i
    lib.pdt_plane_sweep_smem_bytes.argtypes = [i, i, i, i, i, i]
    lib.pdt_plane_sweep_smem_bytes.restype = ctypes.c_longlong
    lib.pdt_plane_sweep_smem_limit.argtypes = []
    lib.pdt_plane_sweep_max_w.argtypes = []
    lib.pdt_plane_sweep_max_w.restype = i
    lib.pdt_plane_sweep_smem_limit.restype = i
    lib.pdt_plane_sweep_kernel_info.argtypes = [i, i, i, i, i, p]
    lib.pdt_plane_sweep_kernel_info.restype = i
    lib.pdt_plane_sweep_kernel_info_bf16.argtypes = [i, i, i, i, p]
    lib.pdt_plane_sweep_kernel_info_bf16.restype = i
    lib.pdt_row_shift_fwd.argtypes = [p, p, p, i, i, i, i, f, p]
    lib.pdt_row_shift_fwd.restype = i
    lib.pdt_head_epilogue_fwd.argtypes = [p] * 5 + [i] * 6 + [p]
    lib.pdt_head_epilogue_fwd.restype = i
    lib.pdt_head_epilogue_bwd.argtypes = [p] * 6 + [i] * 6 + [p]
    lib.pdt_head_epilogue_bwd.restype = i
    return lib


def launch(fn: str, *args) -> None:
    """Call the library's entry point ``fn`` with ``args`` (a tensor is
    passed as its data pointer, None as a null pointer) and PyTorch's
    current CUDA stream; raise when the launch failed (the entry point
    returns the launch's ``cudaGetLastError``)."""
    import torch

    # ``args`` keeps every tensor (a temporary copy too) alive through the call
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    rc = getattr(load_library(), fn)(*ptrs, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn} kernel launch failed: CUDA error {rc}")
