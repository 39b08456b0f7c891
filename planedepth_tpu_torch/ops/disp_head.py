"""Expected-disparity head (``planedepth_tpu/ops/pallas_disp.py:disp_head``, forward).

Per pixel over the N planes: ``p = softmax(l)``, ``u = p * m / s``,
``U = sum u``, ``disp = sum(u * d) / U``, and 0 where ``U <= 1e-7`` (the
guarded reciprocal of ``mixture_reweight``).  ``disp_head`` launches the CUDA
kernel of ``csrc/disp_head.cu`` on CUDA tensors and takes ``disp_head_plain``
on CPU tensors.  The backward is not ported yet (ROADMAP B3).
"""
from __future__ import annotations

import torch

EPS = 1e-7


def disp_head_plain(logits: torch.Tensor, sigma: torch.Tensor,
                    disp_rows: torch.Tensor, mask_rows: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the CPU path and the kernel's oracle.

    logits, sigma: ``(B, N, H, W)``, logits already masked; disp_rows,
    mask_rows: ``(B, H, N)`` row-constant plane disparities and 0/1 mask.
    Returns disp ``(B, 1, H, W)``.
    """
    p = torch.softmax(logits.float(), dim=1)
    m = mask_rows.transpose(1, 2)[..., None]                  # (B, N, H, 1)
    d = disp_rows.transpose(1, 2)[..., None]
    u = p * m / sigma.float()
    U = u.sum(dim=1, keepdim=True)
    D = (u * d).sum(dim=1, keepdim=True)
    inv = torch.where(U > EPS, 1.0 / torch.clamp_min(U, EPS), torch.zeros_like(U))
    return D * inv


def _check(logits, sigma, disp_rows, mask_rows):
    if logits.dim() != 4:
        raise ValueError(f"logits must be (B, N, H, W), got {tuple(logits.shape)}")
    B, N, H, W = logits.shape
    want = {"logits": (B, N, H, W), "sigma": (B, N, H, W),
            "disp_rows": (B, H, N), "mask_rows": (B, H, N)}
    for name, t in zip(want, (logits, sigma, disp_rows, mask_rows)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, want {want[name]}")
        if t.device != logits.device:
            raise ValueError(f"{name} on {t.device}, logits on {logits.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if 2 * N * 4 > 48 * 1024:
        raise ValueError(f"N={N} planes exceed the kernel's shared-memory rows")


def disp_head(logits: torch.Tensor, sigma: torch.Tensor,
              disp_rows: torch.Tensor, mask_rows: torch.Tensor) -> torch.Tensor:
    """Expected disparity ``(B, 1, H, W)`` from the plane heads.

    CPU tensors take :func:`disp_head_plain`.  CUDA tensors launch the kernel
    (``disp_head.launches`` counts each launch) or raise.
    """
    if logits.device.type == "cpu":
        return disp_head_plain(logits, sigma, disp_rows, mask_rows)
    if logits.device.type != "cuda":
        raise NotImplementedError(f"disp_head: no kernel for {logits.device}")
    if any(t.requires_grad for t in (logits, sigma, disp_rows, mask_rows)):
        raise NotImplementedError(
            "disp_head: the CUDA backward is not ported yet (ROADMAP B3)")
    _check(logits, sigma, disp_rows, mask_rows)
    from planedepth_tpu_torch.ops._build import load_library

    B, N, H, W = logits.shape
    out = torch.empty((B, 1, H, W), dtype=torch.float32, device=logits.device)
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = load_library().pdt_disp_head_fwd(
            logits.data_ptr(), sigma.data_ptr(), disp_rows.data_ptr(),
            mask_rows.data_ptr(), out.data_ptr(), B, N, H, W, stream)
    if rc != 0:
        raise RuntimeError(f"disp_head kernel launch failed: CUDA error {rc}")
    disp_head.launches += 1
    return out


disp_head.launches = 0
