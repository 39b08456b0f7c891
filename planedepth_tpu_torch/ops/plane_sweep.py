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

bf16 images and heads (the JAX package's default, ``TrainConfig.bf16``) run
the kernels' bf16 instances (``bf16_*`` counters): float32 sums, the
reconstruction and the heads' gradients bf16, the NLL, disp and d_shift
float32.  A row wider than one launch takes (``pdt_plane_sweep_max_w``)
runs in column segments with a right halo (:func:`segmented`), as the JAX
entry takes any W.
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
                      with_auto: bool, with_disp: bool, rounded_rgb=None):
    """Plain PyTorch version (``oracle_dense`` + ``oracle_disp_center``, or
    ``oracle_softmax`` with ``sigma=None``, with the shift clip): the CPU
    path and the kernels' oracle.

    src, tgt ``(B, 3, H, W)``; logits, sigma ``(B, N, H, W)``; shift, mask
    ``(B, H, N)``.  Returns ``(rgb (B, 3, H, W), nll (B, H, W)[, nll_auto]
    [, disp (B, H, W)])``.  The clip passes the shift's gradient through
    unchanged, as the kernel's backward does.

    bf16 operands (the JAX package's default) are upcast, which is exact,
    computed in float32, and ``rgb`` is rounded to bf16; the gradient
    reaches the heads through the rounded reconstruction, as the kernels'
    backward (and the TPU's) reads it, and comes back in bf16.
    ``rounded_rgb``: a bf16 reconstruction to take as the rounded one (the
    kernels' own, so that a check of their backward sees the same rounding
    where the two float32 sums straddle a bf16 rounding point).
    """
    low = logits.dtype if logits.dtype == torch.bfloat16 else None
    if low is None:
        return _plain(src, tgt, logits, sigma, shift, mask, pad, with_auto, with_disp)
    out = _plain(*(None if t is None else t.float() for t in (src, tgt, logits, sigma)),
                 shift, mask, pad, with_auto, with_disp, round_rgb=low,
                 rounded=None if rounded_rgb is None else rounded_rgb.detach().float())
    return (out[0].to(low),) + out[1:]


def _plain(src, tgt, logits, sigma, shift, mask, pad, with_auto, with_disp, round_rgb=None,
           rounded=None):
    """:func:`plane_sweep_plain` in the operands' dtype; ``round_rgb``: the
    dtype the caller rounds ``rgb`` to, whose rounded value (or
    ``rounded``) then anchors rgb's gradient (its value is the rounded one,
    as a float)."""
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
        u, inv_u = pi, None
        rgb = (pi[:, :, None] * c).sum(1)
        M = (pi * 0.5 * torch.exp(-err)).sum(1)
    else:
        s = _clip_strict(_sample(sigma, k, f) * m, 0.01, 1.0)
        u = pi / s
        U = u.sum(1)
        inv_u = torch.where(U > EPS, 1.0 / U.clamp_min(EPS), torch.zeros_like(U))
        rgb = (u[:, :, None] * c).sum(1) * inv_u[:, None]
        M = (pi * 0.5 * torch.exp(-err / s) / s).sum(1)
    if round_rgb is not None:
        # the kernels' backward reads the rounded reconstruction R, in A = U
        # (G . R): G . (c_n - R) / U is the cotangent of u_n, and the softmax
        # projection of the plane adjoints takes G . R where rgb stands, which
        # adds pi_n G . (rgb - R) to d l_n (the gradient of lse(l) (rgb - R));
        # the value stays R
        R = rgb.detach().to(round_rgb).float() if rounded is None else rounded
        if inv_u is None:
            inv_u = 1.0 / u.sum(1)
        g = (u[:, :, None] * (c - R[:, None])).sum(1) * inv_u.detach()[:, None]
        e = torch.logsumexp(l, dim=1)[:, None] * (rgb.detach() - R)
        rgb = R + (g - g.detach()) + (e - e.detach())
    out = [rgb, -torch.log(M.clamp_min(0.0) + EPS)]
    if sigma is None:
        if with_disp:
            p0 = torch.softmax(logits * m, dim=1)
            out.append((p0 * shift_c[..., None]).sum(1))
        return tuple(out)
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
    if logits.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"logits: dtype {logits.dtype}, the kernels take float32 or bfloat16")
    want = {"src": (B, 3, H, W), "tgt": (B, 3, H, W), "logits": (B, N, H, W),
            "sigma": (B, N, H, W), "shift": (B, H, N), "mask": (B, H, N)}
    for name, t in zip(want, (src, tgt, logits, sigma, shift, mask)):
        if t is None and name == "sigma":
            continue
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, want {want[name]}")
        if t.device != logits.device:
            raise ValueError(f"{name} on {t.device}, logits on {logits.device}")
        dtype = torch.float32 if name in ("shift", "mask") else logits.dtype
        if t.dtype != dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, the kernels take {dtype} here")
    lib = load_library()
    seg_w = min(W, lib.pdt_plane_sweep_max_w())
    if image_grads and N * H * seg_w >= 2**31:
        raise ValueError(f"(N, H, W) = ({N}, {H}, {seg_w}): the image-gradient backward "
                         "addresses a launch's planes with 32-bit offsets")
    mix = int(sigma is not None)
    need = max(lib.pdt_plane_sweep_smem_bytes(bwd, mix, int(image_grads),
                                              logits.element_size(), N, W)
               for bwd in (0, 1))
    limit = lib.pdt_plane_sweep_smem_limit()
    if need > limit:
        raise ValueError(f"(N, W) = ({N}, {seg_w}): the kernels' rows need {need} bytes of "
                         f"shared memory a block, the card allows {limit}")


class _PlaneSweep(torch.autograd.Function):
    """The two CUDA kernels joined as forward and backward, one launch each
    (a row of at most ``pdt_plane_sweep_max_w`` columns); ``sigma=None``
    launches their no-mixture instances, bf16 operands their bf16
    instances, ``image_grads`` the backward's image-gradient instance
    (float32 only)."""

    @staticmethod
    def forward(ctx, src, tgt, logits, sigma, shift, mask, pad, with_auto, with_disp,
                image_grads):
        B, N, H, W = logits.shape
        mix, bf16 = sigma is not None, logits.dtype == torch.bfloat16
        src, tgt, logits, sigma, shift, mask = (
            None if t is None else t.contiguous()
            for t in (src, tgt, logits, sigma, shift, mask))
        new = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                         device=logits.device)
        rgb = torch.empty((B, 3, H, W), dtype=logits.dtype, device=logits.device)
        nll = new(B, H, W)
        nll_auto = new(B, H, W) if with_auto else None
        disp = new(B, H, W) if with_disp else None
        stats = new(B, 7 if with_disp else 4, H, W)
        launch("pdt_plane_sweep_fwd_bf16" if bf16 else "pdt_plane_sweep_fwd", src, tgt,
               logits, sigma, shift, mask, rgb, nll, nll_auto, disp, stats, B, N, H, W,
               shift_max(pad), int(with_auto), int(with_disp), int(mix))
        name = ("bf16_" if bf16 else "") + ("fwd_launches" if mix else "nomix_fwd_launches")
        setattr(plane_sweep, name, getattr(plane_sweep, name) + 1)
        ctx.save_for_backward(src, tgt, logits, sigma, shift, mask, stats, rgb)
        ctx.with_disp, ctx.pad, ctx.mix, ctx.bf16 = with_disp, pad, mix, bf16
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
            launch("pdt_plane_sweep_bwd_bf16" if ctx.bf16 else "pdt_plane_sweep_bwd", src,
                   tgt, logits, sigma, shift, mask, stats, rgb, g_rgb.contiguous(),
                   g_nll.contiguous(), g_disp, d_logits, d_sigma, d_shift, B, N, H, W,
                   shift_max(ctx.pad), int(ctx.with_disp), int(ctx.mix))
            name = (("bf16_" if ctx.bf16 else "")
                    + ("bwd_launches" if ctx.mix else "nomix_bwd_launches"))
            setattr(plane_sweep, name, getattr(plane_sweep, name) + 1)
        return d_src, d_tgt, d_logits, d_sigma, d_shift, None, None, None, None, None


def segments(W: int, halo: int, seg_w: int):
    """Column segments ``(x0, x1, xe)`` of a row of width W: the kept
    columns [x0, x1) with a right halo [x1, xe), at most ``seg_w`` wide
    in all.  Shifts are clipped to [0, shift_max], so a kept pixel samples
    only columns [x, x + halo) (``halo`` = floor of the largest clipped
    shift + 2), and a column's reverse window reaches only pixels to its
    left: no left halo is needed."""
    keep = seg_w - halo
    if keep < 1:
        raise ValueError(f"the sweep's shifts (halo {halo}) leave no column of a "
                         f"{seg_w}-wide segment")
    return [(x0, min(x0 + keep, W), min(x0 + keep + halo, W)) for x0 in range(0, W, keep)]


def sweep_halo(shift: torch.Tensor, pad: int) -> int:
    """Columns right of a pixel that its samples reach, plus one."""
    return int(shift.detach().clamp(0.0, shift_max(pad)).max()) + 2


def segmented(sweep, segs, src, tgt, logits, sigma, *rest):
    """The sweep of a row wider than one launch takes (C10): ``sweep`` (one
    launch, or in the tests :func:`plane_sweep_plain`) on each segment's
    columns [x0, xe), its kept columns [x0, x1) joined along W.  Autograd
    gives the dropped halo outputs zero cotangents, adds the segments'
    overlapping windows of the head and image gradients, and sums their
    d_shift."""
    col = lambda t, x0, xe: None if t is None else t[..., x0:xe]   # noqa: E731
    parts = [(sweep(*(col(t, x0, xe) for t in (src, tgt, logits, sigma)), *rest), x1 - x0)
             for x0, x1, xe in segs]
    return tuple(torch.cat([p[i][..., :keep] for p, keep in parts], dim=-1)
                 for i in range(len(parts[0][0])))


def plane_sweep(src, tgt, logits, sigma, shift, mask, pad: int,
                with_auto: bool, with_disp: bool):
    """Fused plane sweep: ``(rgb, nll[, nll_auto][, disp])``, shapes as in
    :func:`plane_sweep_plain`; ``sigma=None`` is the no-mixture mode.

    src, tgt, logits and sigma are float32 or all bf16 (then rgb and the
    heads' gradients are bf16; shift and mask are float32 either way).
    CPU tensors take :func:`plane_sweep_plain`.  CUDA tensors run the
    forward kernel, and the backward kernel when autograd reaches it, of
    the mode ``sigma`` selects and the operands' dtype, one launch a call
    up to ``pdt_plane_sweep_max_w`` columns and column segments beyond
    (C10); with images
    that require grad, the mixture's backward image-gradient instance,
    which needs the automask (``ValueError`` without it, on every device)
    and is float32 (bf16 operands are upcast, exactly, and rgb rounded
    back, on every device), while the no-mixture mode leaves the images
    without a cotangent.  Any other device raises.
    """
    _check_mode(sigma, with_auto)
    image_grads = torch.is_grad_enabled() and (src.requires_grad or tgt.requires_grad)
    if image_grads and sigma is not None and not with_auto:
        raise ValueError("plane_sweep: image gradients need the automask adjoint "
                         "(with_auto=True), as the JAX kernel asserts")
    if sigma is None:
        # fused_plane_sweep_nomix returns zero cotangents for the images
        src, tgt, image_grads = src.detach(), tgt.detach(), False
    if image_grads and logits.dtype == torch.bfloat16:
        out = plane_sweep(src.float(), tgt.float(), logits.float(), sigma.float(), shift,
                          mask, pad, with_auto, with_disp)
        return (out[0].to(logits.dtype),) + out[1:]
    if logits.device.type == "cpu":
        return plane_sweep_plain(src, tgt, logits, sigma, shift, mask, pad,
                                 with_auto, with_disp)
    if logits.device.type != "cuda":
        raise NotImplementedError(f"plane_sweep: no kernel for {logits.device}")
    args = (src, tgt, logits, sigma, shift, mask, pad, with_auto, with_disp, image_grads)
    with torch.cuda.device(logits.device):
        _check(src, tgt, logits, sigma, shift, mask, image_grads)
        W, max_w = logits.shape[-1], load_library().pdt_plane_sweep_max_w()
        if W <= max_w:
            return _PlaneSweep.apply(*args)
        return segmented(lambda *a: _PlaneSweep.apply(*a, image_grads),
                         segments(W, sweep_halo(shift, pad), max_w), *args[:-1])


plane_sweep.fwd_launches = 0
plane_sweep.bwd_launches = 0
plane_sweep.img_bwd_launches = 0
plane_sweep.nomix_fwd_launches = 0
plane_sweep.nomix_bwd_launches = 0
plane_sweep.bf16_fwd_launches = 0
plane_sweep.bf16_bwd_launches = 0
plane_sweep.bf16_nomix_fwd_launches = 0
plane_sweep.bf16_nomix_bwd_launches = 0
