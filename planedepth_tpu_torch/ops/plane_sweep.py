"""Fused plane sweep of the stereo training step (``planedepth_tpu/ops/pallas_sweep.py``).

For each pixel and plane n the source image, the plane logit and the plane
sigma are sampled with a 2-tap linear filter at ``x + shift[b, h, n]`` (zero
outside [0, W)), the shift clipped to ``[0, round128(pad) - 2]`` as the TPU
kernel clips it.  The planes are composited by their mixture weights into
``rgb``, scored by the mixture-Laplacian NLL against the target, and (with
``with_disp``) the expected disparity is taken over the unshifted samples,
the clipped shift doubling as the plane disparity.

``plane_sweep`` launches the CUDA forward and backward kernels of
``csrc/plane_sweep.cu`` on CUDA tensors (``plane_sweep.fwd_launches`` and
``plane_sweep.bwd_launches`` count the launches) and takes
``plane_sweep_plain``, differentiated by autograd, on CPU tensors.  The
images get no gradient (the train step never differentiates them); the
automask NLL treats pi and sigma as constants, as the reference does.
"""
from __future__ import annotations

import torch

EPS = 1e-7


def shift_max(pad: int) -> float:
    """Upper end of the shift clip: the TPU kernel's lane-rounded pad less 2."""
    return float(((pad + 127) // 128) * 128 - 2)


def _clip_strict(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``clip(x, lo, hi)`` whose gradient passes only where lo < x < hi, as
    the kernel gates it."""
    return torch.where((x > lo) & (x < hi), x, x.detach().clamp(lo, hi))


def _sample(maps: torch.Tensor, k: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """maps ``(B, N, H, W)`` (or ``(B, N, C, H, W)``) at ``x + k + f``, zero
    outside [0, W); k, f ``(B, N, H)`` broadcast over C and W."""
    W = maps.shape[-1]
    if maps.dim() == 5:
        k, f = k[:, :, None], f[:, :, None]
    xs = torch.arange(W, device=maps.device)
    i0 = xs + k[..., None]
    out = 0.0
    for idx, w in ((i0, 1.0 - f), (i0 + 1, f)):
        valid = idx < W                                   # idx >= 0: k >= 0
        g = torch.gather(maps, -1, idx.clamp(max=W - 1).expand(maps.shape))
        out = out + torch.where(valid, w[..., None] * g, torch.zeros_like(g))
    return out


def plane_sweep_plain(src, tgt, logits, sigma, shift, mask, pad: int,
                      with_auto: bool, with_disp: bool):
    """Plain PyTorch version (``oracle_dense`` + ``oracle_disp_center`` with
    the shift clip): the CPU path and the kernels' oracle.

    src, tgt ``(B, 3, H, W)``; logits, sigma ``(B, N, H, W)``; shift, mask
    ``(B, H, N)``.  Returns ``(rgb (B, 3, H, W), nll (B, H, W)[, nll_auto]
    [, disp (B, H, W)])``.  The clip passes the shift's gradient through
    unchanged, as the kernel's backward does.
    """
    shift_t = shift.transpose(1, 2)                                   # (B,N,H)
    shift_c = shift_t + (shift_t.clamp(0.0, shift_max(pad)) - shift_t).detach()
    k = torch.floor(shift_c.detach()).long()
    f = shift_c - k
    m = mask.transpose(1, 2)[..., None]                               # (B,N,H,1)
    B, N = logits.shape[:2]

    l = _sample(logits, k, f) * m
    s = _clip_strict(_sample(sigma, k, f) * m, 0.01, 1.0)
    c = _sample(src[:, None].expand(B, N, *src.shape[1:]), k, f) * m[:, :, None]

    pi = torch.exp(l - torch.logsumexp(l, dim=1, keepdim=True))
    u = pi / s
    U = u.sum(1)
    inv_u = torch.where(U > EPS, 1.0 / U.clamp_min(EPS), torch.zeros_like(U))
    rgb = (u[:, :, None] * c).sum(1) * inv_u[:, None]
    err = (c - tgt[:, None]).abs().sum(2) / 3.0                        # (B,N,H,W)
    M = (pi * 0.5 * torch.exp(-err / s) / s).sum(1)
    out = [rgb, -torch.log(M.clamp_min(0.0) + EPS)]
    if with_auto:
        e_auto = (src - tgt).abs().sum(1, keepdim=True) / 3.0
        sd, pd = s.detach(), pi.detach()
        Ma = (pd * 0.5 * torch.exp(-e_auto / sd) / sd).sum(1)
        out.append(-torch.log(Ma.clamp_min(0.0) + EPS))
    if with_disp:
        p0 = torch.softmax(logits * m, dim=1)
        u0 = p0 * m / _clip_strict(sigma, 0.01, 1.0)
        U0 = u0.sum(1)
        D0 = (u0 * shift_c[..., None]).sum(1)
        # the guard of the kernel's output: U over the MASKED normaliser
        live = U0 > EPS * (p0 * m).sum(1)
        out.append(torch.where(live, D0 / torch.where(live, U0, torch.ones_like(U0)),
                               torch.zeros_like(U0)))
    return tuple(out)


def _check(src, tgt, logits, sigma, shift, mask):
    if logits.dim() != 4:
        raise ValueError(f"logits must be (B, N, H, W), got {tuple(logits.shape)}")
    B, N, H, W = logits.shape
    want = {"src": (B, 3, H, W), "tgt": (B, 3, H, W), "logits": (B, N, H, W),
            "sigma": (B, N, H, W), "shift": (B, H, N), "mask": (B, H, N)}
    for name, t in zip(want, (src, tgt, logits, sigma, shift, mask)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, want {want[name]}")
        if t.device != logits.device:
            raise ValueError(f"{name} on {t.device}, logits on {logits.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {t.dtype}, the kernels take float32")
    if W > 2048 or (2 * N + 5 * W + 32) * 4 > 48 * 1024:
        raise ValueError(f"(N, W) = ({N}, {W}) exceed the kernels' shared-memory row")


def _launch(fn, *args):
    from planedepth_tpu_torch.ops._build import load_library

    rc = getattr(load_library(), fn)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn} kernel launch failed: CUDA error {rc}")


def _ptr(t):
    return None if t is None else t.data_ptr()


class _PlaneSweep(torch.autograd.Function):
    """The two CUDA kernels joined as forward and backward."""

    @staticmethod
    def forward(ctx, src, tgt, logits, sigma, shift, mask, pad, with_auto, with_disp):
        B, N, H, W = logits.shape
        src, tgt, logits, sigma, shift, mask = (
            t.contiguous() for t in (src, tgt, logits, sigma, shift, mask))
        new = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                         device=logits.device)
        rgb, nll = new(B, 3, H, W), new(B, H, W)
        nll_auto = new(B, H, W) if with_auto else None
        disp = new(B, H, W) if with_disp else None
        stats = new(B, 7 if with_disp else 4, H, W)
        _launch("pdt_plane_sweep_fwd", *map(_ptr, (
            src, tgt, logits, sigma, shift, mask, rgb, nll, nll_auto, disp, stats)),
            B, N, H, W, shift_max(pad), int(with_auto), int(with_disp))
        plane_sweep.fwd_launches += 1
        ctx.save_for_backward(src, tgt, logits, sigma, shift, mask, stats, rgb)
        ctx.with_disp, ctx.pad = with_disp, pad
        ctx.mark_non_differentiable(*(o for o in (nll_auto,) if o is not None))
        return tuple(o for o in (rgb, nll, nll_auto, disp) if o is not None)

    @staticmethod
    def backward(ctx, g_rgb, g_nll, *rest):
        src, tgt, logits, sigma, shift, mask, stats, rgb = ctx.saved_tensors
        B, N, H, W = logits.shape
        g_disp = rest[-1].contiguous() if ctx.with_disp else None
        d_logits, d_sigma = torch.empty_like(logits), torch.empty_like(sigma)
        d_shift = torch.empty_like(shift)
        _launch("pdt_plane_sweep_bwd", *map(_ptr, (
            src, tgt, logits, sigma, shift, mask, stats, rgb, g_rgb.contiguous(),
            g_nll.contiguous(), g_disp, d_logits, d_sigma, d_shift)),
            B, N, H, W, shift_max(ctx.pad), int(ctx.with_disp))
        plane_sweep.bwd_launches += 1
        return None, None, d_logits, d_sigma, d_shift, None, None, None, None


def plane_sweep(src, tgt, logits, sigma, shift, mask, pad: int,
                with_auto: bool, with_disp: bool):
    """Fused plane sweep: ``(rgb, nll[, nll_auto][, disp])``, shapes as in
    :func:`plane_sweep_plain`.

    CPU tensors take :func:`plane_sweep_plain`.  CUDA tensors run the
    forward kernel, and the backward kernel when autograd reaches it;
    any other device raises.
    """
    if logits.device.type == "cpu":
        return plane_sweep_plain(src, tgt, logits, sigma, shift, mask, pad,
                                 with_auto, with_disp)
    if logits.device.type != "cuda":
        raise NotImplementedError(f"plane_sweep: no kernel for {logits.device}")
    _check(src, tgt, logits, sigma, shift, mask)
    with torch.cuda.device(logits.device):
        return _PlaneSweep.apply(src, tgt, logits, sigma, shift, mask, pad,
                                 with_auto, with_disp)


plane_sweep.fwd_launches = 0
plane_sweep.bwd_launches = 0
