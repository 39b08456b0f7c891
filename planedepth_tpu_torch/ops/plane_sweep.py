"""Fused plane sweep of the stereo training step (``planedepth_tpu/ops/pallas_sweep.py``).

For each pixel and plane n the source image, the plane logit and the plane
sigma are sampled with a 2-tap linear filter at ``x + shift[b, h, n]`` (zero
outside [0, W)), the shift clipped to ``[0, round128(pad) - 2]`` as the TPU
kernel clips it.  The planes are composited by their mixture weights into
``rgb``, scored by the mixture-Laplacian NLL against the target, and (with
``with_disp``) the expected disparity is taken over the unshifted samples,
the clipped shift doubling as the plane disparity.

``sigma=None`` is the no-mixture mode (``fused_plane_sweep_nomix``: FalNet
and ``use_mixture_loss=False``): sigma is the literal 1, so the composite is
the softmax composite, exact at the image borders; ``nll`` is the b = 1
Laplacian NLL, there is no automask NLL, and the disparity is the plain
softmax expectation over the masked centre logits (``oracle_softmax``).

``plane_sweep`` launches the CUDA forward and backward kernels of
``csrc/plane_sweep.cu`` on CUDA tensors (``plane_sweep.fwd_launches`` and
``plane_sweep.bwd_launches`` count the mixture mode's launches,
``nomix_fwd_launches`` and ``nomix_bwd_launches`` the no-mixture mode's)
and takes ``plane_sweep_plain``, differentiated by autograd, on CPU
tensors.  Where ``src`` or ``tgt`` requires grad, the image-gradient rules
of the JAX package hold on every device, decided before the device is:
the mixture mode with the automask differentiates the images (the TPU
backward's ``image_grads=True``, the JAX default; on CUDA the backward's
image-gradient instance, counted by ``plane_sweep.img_bwd_launches``; no
training recipe differentiates the images); the mixture mode without the
automask raises ``ValueError`` (JAX asserts it); the no-mixture mode gives
the images no cotangent (``fused_plane_sweep_nomix`` returns zeros): the
CPU path detaches them, the CUDA path runs its head-only backward.
The automask NLL treats pi and sigma as constants, as the reference does;
its cotangent reaches only the images.
"""
from __future__ import annotations

import torch

from planedepth_tpu_torch.ops._build import launch, load_library

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
    """Plain PyTorch version (``oracle_dense`` + ``oracle_disp_center``, or
    ``oracle_softmax`` with ``sigma=None``, with the shift clip): the CPU
    path and the kernels' oracle.

    src, tgt ``(B, 3, H, W)``; logits, sigma ``(B, N, H, W)``; shift, mask
    ``(B, H, N)``.  Returns ``(rgb (B, 3, H, W), nll (B, H, W)[, nll_auto]
    [, disp (B, H, W)])``.  The clip passes the shift's gradient through
    unchanged, as the kernel's backward does.
    """
    _check_mode(sigma, with_auto)
    shift_t = shift.transpose(1, 2)                                   # (B,N,H)
    shift_c = shift_t + (shift_t.clamp(0.0, shift_max(pad)) - shift_t).detach()
    k = torch.floor(shift_c.detach()).long()
    f = shift_c - k
    m = mask.transpose(1, 2)[..., None]                               # (B,N,H,1)
    B, N = logits.shape[:2]

    l = _sample(logits, k, f) * m
    c = _sample(src[:, None].expand(B, N, *src.shape[1:]), k, f) * m[:, :, None]
    pi = torch.exp(l - torch.logsumexp(l, dim=1, keepdim=True))
    err = (c - tgt[:, None]).abs().sum(2) / 3.0                        # (B,N,H,W)
    if sigma is None:
        # sigma = 1: the composite weight is the softmax weight
        rgb = (pi[:, :, None] * c).sum(1)
        M = (pi * 0.5 * torch.exp(-err)).sum(1)
        out = [rgb, -torch.log(M.clamp_min(0.0) + EPS)]
        if with_disp:
            p0 = torch.softmax(logits * m, dim=1)
            out.append((p0 * shift_c[..., None]).sum(1))
        return tuple(out)

    s = _clip_strict(_sample(sigma, k, f) * m, 0.01, 1.0)
    u = pi / s
    U = u.sum(1)
    inv_u = torch.where(U > EPS, 1.0 / U.clamp_min(EPS), torch.zeros_like(U))
    rgb = (u[:, :, None] * c).sum(1) * inv_u[:, None]
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


def _check_mode(sigma, with_auto):
    if sigma is None and with_auto:
        raise ValueError("the no-mixture sweep (sigma=None) has no automask NLL: "
                         "the caller takes the L1 automask from the composite")


def _check(src, tgt, logits, sigma, shift, mask, image_grads=False):
    if logits.dim() != 4:
        raise ValueError(f"logits must be (B, N, H, W), got {tuple(logits.shape)}")
    B, N, H, W = logits.shape
    want = {"src": (B, 3, H, W), "tgt": (B, 3, H, W), "logits": (B, N, H, W),
            "sigma": (B, N, H, W), "shift": (B, H, N), "mask": (B, H, N)}
    for name, t in zip(want, (src, tgt, logits, sigma, shift, mask)):
        if t is None and name == "sigma":
            continue
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, want {want[name]}")
        if t.device != logits.device:
            raise ValueError(f"{name} on {t.device}, logits on {logits.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {t.dtype}, the kernels take float32")
    if image_grads and N * H * W >= 2**31:
        raise ValueError(f"(N, H, W) = ({N}, {H}, {W}): the image-gradient backward "
                         "addresses an image's planes with 32-bit offsets")
    lib = load_library()
    mix = int(sigma is not None)
    need = [lib.pdt_plane_sweep_smem_bytes(bwd, mix, int(image_grads), N, W)
            for bwd in (0, 1)]
    if min(need) < 0:
        raise ValueError(f"W = {W}: wider than the kernels' rows")
    need, limit = max(need), lib.pdt_plane_sweep_smem_limit()
    if need > limit:
        raise ValueError(f"(N, W) = ({N}, {W}): the kernels' rows need {need} bytes of "
                         f"shared memory a block, the card allows {limit}")


class _PlaneSweep(torch.autograd.Function):
    """The two CUDA kernels joined as forward and backward; ``sigma=None``
    launches their no-mixture instances, ``image_grads`` the backward's
    image-gradient instance."""

    @staticmethod
    def forward(ctx, src, tgt, logits, sigma, shift, mask, pad, with_auto, with_disp,
                image_grads):
        B, N, H, W = logits.shape
        mix = sigma is not None
        src, tgt, logits, sigma, shift, mask = (
            None if t is None else t.contiguous()
            for t in (src, tgt, logits, sigma, shift, mask))
        new = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                         device=logits.device)
        rgb, nll = new(B, 3, H, W), new(B, H, W)
        nll_auto = new(B, H, W) if with_auto else None
        disp = new(B, H, W) if with_disp else None
        stats = new(B, 7 if with_disp else 4, H, W)
        launch("pdt_plane_sweep_fwd", src, tgt, logits, sigma, shift, mask, rgb, nll,
               nll_auto, disp, stats, B, N, H, W, shift_max(pad), int(with_auto),
               int(with_disp), int(mix))
        if mix:
            plane_sweep.fwd_launches += 1
        else:
            plane_sweep.nomix_fwd_launches += 1
        ctx.save_for_backward(src, tgt, logits, sigma, shift, mask, stats, rgb)
        ctx.with_disp, ctx.pad, ctx.mix = with_disp, pad, mix
        ctx.image_grads = image_grads
        if not image_grads:
            # its only cotangent path is into the images
            ctx.mark_non_differentiable(*(o for o in (nll_auto,) if o is not None))
        return tuple(o for o in (rgb, nll, nll_auto, disp) if o is not None)

    @staticmethod
    def backward(ctx, g_rgb, g_nll, *rest):
        src, tgt, logits, sigma, shift, mask, stats, rgb = ctx.saved_tensors
        B, N, H, W = logits.shape
        g_disp = rest[-1].contiguous() if ctx.with_disp else None
        d_logits = torch.empty_like(logits)
        d_sigma = torch.empty_like(sigma) if ctx.mix else None
        d_shift = torch.empty_like(shift)
        d_src = d_tgt = None
        if ctx.image_grads:
            d_src, d_tgt = torch.empty_like(src), torch.empty_like(tgt)
            launch("pdt_plane_sweep_bwd_img", src, tgt, logits, sigma, shift, mask, stats,
                   rgb, g_rgb.contiguous(), g_nll.contiguous(), rest[0].contiguous(), g_disp,
                   d_src, d_tgt, d_logits, d_sigma, d_shift, B, N, H, W,
                   shift_max(ctx.pad), int(ctx.with_disp))
            plane_sweep.img_bwd_launches += 1
        else:
            launch("pdt_plane_sweep_bwd", src, tgt, logits, sigma, shift, mask, stats, rgb,
                   g_rgb.contiguous(), g_nll.contiguous(), g_disp, d_logits, d_sigma,
                   d_shift, B, N, H, W, shift_max(ctx.pad), int(ctx.with_disp),
                   int(ctx.mix))
            if ctx.mix:
                plane_sweep.bwd_launches += 1
            else:
                plane_sweep.nomix_bwd_launches += 1
        return d_src, d_tgt, d_logits, d_sigma, d_shift, None, None, None, None, None


def plane_sweep(src, tgt, logits, sigma, shift, mask, pad: int,
                with_auto: bool, with_disp: bool):
    """Fused plane sweep: ``(rgb, nll[, nll_auto][, disp])``, shapes as in
    :func:`plane_sweep_plain`; ``sigma=None`` is the no-mixture mode.

    CPU tensors take :func:`plane_sweep_plain`.  CUDA tensors run the
    forward kernel, and the backward kernel when autograd reaches it, of
    the mode ``sigma`` selects; with images that require grad, the
    mixture's backward image-gradient instance, which needs the automask
    (``ValueError`` without it, on every device), while the no-mixture
    mode leaves the images without a cotangent.  Any other device raises.
    """
    _check_mode(sigma, with_auto)
    image_grads = torch.is_grad_enabled() and (src.requires_grad or tgt.requires_grad)
    if image_grads and sigma is not None and not with_auto:
        raise ValueError("plane_sweep: image gradients need the automask adjoint "
                         "(with_auto=True), as the JAX kernel asserts")
    if sigma is None:
        # fused_plane_sweep_nomix returns zero cotangents for the images
        src, tgt, image_grads = src.detach(), tgt.detach(), False
    if logits.device.type == "cpu":
        return plane_sweep_plain(src, tgt, logits, sigma, shift, mask, pad,
                                 with_auto, with_disp)
    if logits.device.type != "cuda":
        raise NotImplementedError(f"plane_sweep: no kernel for {logits.device}")
    with torch.cuda.device(logits.device):
        _check(src, tgt, logits, sigma, shift, mask, image_grads)
        return _PlaneSweep.apply(src, tgt, logits, sigma, shift, mask, pad,
                                 with_auto, with_disp, image_grads)


plane_sweep.fwd_launches = 0
plane_sweep.bwd_launches = 0
plane_sweep.img_bwd_launches = 0
plane_sweep.nomix_fwd_launches = 0
plane_sweep.nomix_bwd_launches = 0
