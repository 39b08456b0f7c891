"""The bf16 modes of the port's plane sweep and 2-D warp against the JAX package's.

The JAX package trains in bf16 by default: its Pallas sweep and 2-D warp
take bf16 images and plane heads, compute in float32 inside and give bf16
reconstructions (and warped stacks) and bf16 head gradients
(``pallas_sweep.py:1023-1026``, ``1102-1103``; ``pallas_warp2d.py:369-370``,
``532``).  The port's plain versions in that mode (upcast, the float32
plain version, the bf16 outputs rounded; the CUDA kernels' oracle) are
held to ``fused_plane_sweep`` / ``fused_plane_sweep_nomix`` and
``warp2d_sample`` on the same bf16 operands in interpret mode, forward and
VJP, with the same bf16 cotangents: every bf16 output within one bf16 ulp
of the JAX value plus the float32 tests' tolerance of its scale (a float32
difference may tip a rounding), every float32 output at the float32
tests' tolerance (tests/test_torch_plane_sweep.py, test_torch_warp2d.py).

The sweep of a row wider than one launch (C10) runs in column segments
with a right halo; on the CPU the segmentation is held to the unsegmented
plain version on a 64-pixel row cut three ways, forward, head, shift and
image gradients, in float32 (1e-6 of scale) and in bf16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planedepth_tpu.ops.pallas_sweep import fused_plane_sweep, fused_plane_sweep_nomix
from planedepth_tpu.ops.pallas_warp2d import warp2d_sample
from planedepth_tpu_torch.ops import plane_sweep as ps
from planedepth_tpu_torch.ops.warp2d import warp2d_plain

torch.set_num_threads(1)
BF = torch.bfloat16
B, H, W, N = 2, 8, 64, 6
PAD = 12
KW = dict(n_vertical=0, rows=8, gp_taps=8, nonneg=True)


def bf16_ulp(x):
    """Spacing of bf16 numbers at |x| (8 significant bits)."""
    a = np.maximum(np.abs(np.asarray(x, np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def assert_close(got, want, rel, bf16, name):
    """|got - want| <= rel * max|want| (+ one bf16 ulp of want for a bf16
    output)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bound = rel * max(float(np.abs(want).max()), 1e-12) + (bf16_ulp(want) if bf16 else 0.0)
    over = np.abs(got - want) - bound
    assert (over <= 0).all(), (name, float(over.max()))


def _bf(a):
    """Round a float32 array to bf16 values (kept as float32 numpy)."""
    return torch.from_numpy(a).to(BF).float().numpy()


def _sweep_inputs(seed=17):
    rng = np.random.default_rng(seed)
    src = _bf(rng.uniform(0, 1, (B, 3, H, W)).astype(np.float32))
    tgt = _bf(rng.uniform(0, 1, (B, 3, H, W)).astype(np.float32))
    logits = _bf(rng.standard_normal((B, N, H, W)).astype(np.float32))
    sigma = _bf(rng.uniform(0.0, 1.0, (B, N, H, W)).astype(np.float32))
    vert = rng.uniform(0.0, 30.0, (B, 1, 3)).repeat(H, 1)
    vert[:, :, 2] = W - 2.7
    vert[1, :, 1] = -2.0
    slope = rng.uniform(0.0, 0.9, (B, 1, N - 3))
    ground = rng.uniform(0.0, 20.0, (B, 1, N - 3)) + slope * np.arange(H)[None, :, None]
    shift = np.concatenate([vert, ground], -1).astype(np.float32)
    mask = (rng.uniform(0, 1, (B, H, N)) > 0.2).astype(np.float32)
    mask[:, 5, :] = 0.0
    return src, tgt, logits, sigma, shift, mask


@pytest.mark.parametrize("mixture", [True, False], ids=["mixture", "nomix"])
def test_sweep_bf16_plain_matches_jax_kernel_forward_and_vjp(mixture):
    src, tgt, logits, sigma, shift, mask = _sweep_inputs()
    with_auto = mixture
    rng = np.random.default_rng(5)
    ct_rgb = _bf(rng.standard_normal((B, 3, H, W)).astype(np.float32))
    ct_rows = [rng.standard_normal((B, H, W)).astype(np.float32) for _ in range(3)]
    cts = [ct_rgb, ct_rows[0]] + ([ct_rows[1]] if with_auto else []) + [ct_rows[2]]
    j = lambda a, dt=jnp.bfloat16: jnp.asarray(a).astype(dt)   # noqa: E731

    if mixture:
        def jax_f(lg, sg, sh):
            return fused_plane_sweep(j(src), j(tgt), lg, sg, sh, j(mask, jnp.float32), PAD,
                                     True, KW["n_vertical"], False, True, KW["rows"],
                                     KW["gp_taps"], with_auto, True)
        primals = (j(logits), j(sigma), j(shift, jnp.float32))
    else:
        def jax_f(lg, sh):
            return fused_plane_sweep_nomix(j(src), j(tgt), lg, sh, j(mask, jnp.float32), PAD,
                                           True, KW["n_vertical"], True, KW["rows"],
                                           KW["gp_taps"], True)
        primals = (j(logits), j(shift, jnp.float32))
    want_out, vjp = jax.vjp(jax_f, *primals)
    want_grads = vjp(tuple(jnp.asarray(c).astype(o.dtype) for c, o in zip(cts, want_out)))

    t = lambda a, dt=BF, g=False: torch.from_numpy(a.copy()).to(dt).requires_grad_(g)  # noqa
    lg, sh = t(logits, g=True), t(shift, torch.float32, True)
    sg = t(sigma, g=True) if mixture else None
    outs = ps.plane_sweep(t(src), t(tgt), lg, sg, sh, t(mask, torch.float32), PAD,
                          with_auto, True)
    assert outs[0].dtype == BF and all(o.dtype == torch.float32 for o in outs[1:])
    names = ["rgb", "nll"] + (["nll_auto"] if with_auto else []) + ["disp"]
    for name, g, w in zip(names, outs, want_out):
        assert str(w.dtype) == ("bfloat16" if name == "rgb" else "float32"), name
        assert_close(g.detach().float().numpy(), np.asarray(w.astype(jnp.float32)), 1e-5,
                     name == "rgb", name)
    loss = sum((o.float() * torch.from_numpy(c)).sum() for o, c in zip(outs, cts))
    wrt = (lg, sg, sh) if mixture else (lg, sh)
    got_grads = torch.autograd.grad(loss, wrt)
    for name, g, w in zip(("d_logits", "d_sigma", "d_shift") if mixture
                          else ("d_logits", "d_shift"), got_grads, want_grads):
        assert g.dtype == (torch.float32 if name == "d_shift" else BF), name
        assert_close(g.float().numpy(), np.asarray(w.astype(jnp.float32)), 1e-4,
                     name != "d_shift", name)


@pytest.mark.parametrize("with_sigma", [True, False], ids=["sigma", "nosigma"])
def test_warp2d_bf16_plain_matches_jax_kernel_forward_and_vjp(with_sigma):
    """tests/test_pallas_warp2d.py's operands and tap bounds (inside the
    TPU kernel's envelope), the images and heads in bf16."""
    Bw, Nw, Hw, Ww = 1, 3, 16, 128
    rng = np.random.RandomState(0)
    src = _bf(rng.rand(Bw, 3, Hw, Ww).astype(np.float32))
    logits = _bf(rng.randn(Bw, Nw, Hw, Ww).astype(np.float32))
    sigma = _bf((0.1 + 0.8 * rng.rand(Bw, Nw, Hw, Ww)).astype(np.float32))
    dx = (4.0 * rng.rand(Bw, Nw, 1, 1) + 1.2 * rng.rand(Bw, Nw, Hw, Ww) - 2.0).astype(
        np.float32)
    dy = (1.5 * rng.randn(Bw, Nw, 1, 1) + 0.6 * rng.rand(Bw, Nw, Hw, Ww) - 0.3).astype(
        np.float32)
    mask = np.ones((Bw, Nw, Hw, Ww), np.float32)
    cts = [_bf(rng.randn(*s).astype(np.float32))
           for s in ((Bw, Nw, 3, Hw, Ww), (Bw, Nw, Hw, Ww), (Bw, Nw, Hw, Ww))]
    cts = cts if with_sigma else cts[:2]

    def jax_f(ls, dxj, dyj):
        return warp2d_sample(jnp.asarray(src).astype(jnp.bfloat16), ls, dxj, dyj,
                             jnp.asarray(mask), rows=8, sx=6, sy=4, with_sigma=with_sigma,
                             interpret=True)

    heads = np.stack([logits, sigma], 2).reshape(Bw, 2 * Nw, Hw, Ww) if with_sigma else logits
    want_out, vjp = jax.vjp(jax_f, jnp.asarray(heads).astype(jnp.bfloat16), jnp.asarray(dx),
                            jnp.asarray(dy))
    d_ls, d_dx, d_dy = vjp(tuple(jnp.asarray(c).astype(jnp.bfloat16) for c in cts))
    d_ls = np.asarray(d_ls.astype(jnp.float32))
    want_heads = ((d_ls.reshape(Bw, Nw, 2, Hw, Ww)[:, :, 0], d_ls.reshape(Bw, Nw, 2, Hw, Ww)[
        :, :, 1]) if with_sigma else (d_ls,))

    t = lambda a, dt=BF, g=False: torch.from_numpy(a.copy()).to(dt).requires_grad_(g)  # noqa
    lg, sg = t(logits, g=True), (t(sigma, g=True) if with_sigma else None)
    tdx, tdy = t(dx, torch.float32, True), t(dy, torch.float32, True)
    outs = warp2d_plain(t(src), lg, sg, tdx, tdy, t(mask, torch.float32))
    for name, g, w in zip(("rgb", "logit", "sigma"), outs, want_out):
        assert g.dtype == BF and str(w.dtype) == "bfloat16", name
        assert_close(g.detach().float().numpy(), np.asarray(w.astype(jnp.float32)), 5e-5,
                     True, name)
    loss = sum((o.float() * torch.from_numpy(c)).sum() for o, c in zip(outs, cts))
    wrt = (lg, sg, tdx, tdy) if with_sigma else (lg, tdx, tdy)
    got = torch.autograd.grad(loss, wrt)
    names = ("d_logits", "d_sigma", "d_dx", "d_dy") if with_sigma else ("d_logits", "d_dx",
                                                                          "d_dy")
    for name, g, w in zip(names, got, list(want_heads) + [d_dx, d_dy]):
        bf16 = name in ("d_logits", "d_sigma")
        assert g.dtype == (BF if bf16 else torch.float32), name
        assert_close(g.float().numpy(), np.asarray(w, np.float32), 1e-4, bf16, name)


@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["f32", "bf16"])
@pytest.mark.parametrize("mixture", [True, False], ids=["mixture", "nomix"])
def test_sweep_segments_match_the_unsegmented_sweep(mixture, dtype):
    """C10: a 64-pixel row in three segments of at most 30 columns (24 kept,
    a halo of at most 6: shifts up to 4.9 px), with the plain version as
    each segment's launch; with the mixture and float32 images that require grad, the
    image gradients too.  Forward at 1e-6 of scale; gradients at 1e-5 of
    scale in float32 (sigma near its 0.01 clip sums terms in 1 / sigma^2
    that cancel), and in bf16 within one ulp of the value and one of the
    tensor's largest magnitude (where the windows overlap, two parts rounded
    to bf16 are added)."""
    rng = np.random.default_rng(3)
    Bs, Ns, Hs, Ws = 2, 5, 3, 64
    f = lambda *s: torch.from_numpy(rng.random(s).astype(np.float32))   # noqa: E731
    src, tgt = f(Bs, 3, Hs, Ws).to(dtype), f(Bs, 3, Hs, Ws).to(dtype)
    logits = (f(Bs, Ns, Hs, Ws) * 4 - 2).to(dtype)
    sigma = f(Bs, Ns, Hs, Ws).to(dtype) if mixture else None
    shift, mask = f(Bs, Hs, Ns) * 4.9, (f(Bs, Hs, Ns) > 0.2).float()
    image_grads = mixture and dtype == torch.float32
    segs = ps.segments(Ws, ps.sweep_halo(shift, PAD), 30)
    assert len(segs) == 3 and segs[-1][1] == Ws
    cts = None

    def run(segmented):
        nonlocal cts
        leaves = [None if x is None else x.clone().requires_grad_(i >= 2 or image_grads)
                  for i, x in enumerate((src, tgt, logits, sigma, shift))]
        args = (*leaves, mask, PAD, mixture, True)
        outs = (ps.segmented(ps.plane_sweep_plain, segs, *args) if segmented
                else ps.plane_sweep_plain(*args))
        if cts is None:
            g = torch.Generator().manual_seed(1)
            cts = [torch.randn(o.shape, generator=g).to(o.dtype) for o in outs]
            if mixture and not image_grads:
                cts[2] = torch.zeros_like(cts[2])     # no cotangent path
        loss = sum((o.float() * c.float()).sum() for o, c in zip(outs, cts))
        wrt = [x for x in leaves if x is not None and x.requires_grad]
        return [o.detach() for o in outs], torch.autograd.grad(loss, wrt)

    (want_out, want_g), (got_out, got_g) = run(False), run(True)
    for k, (g, w) in enumerate(zip(got_out, want_out)):
        assert g.dtype == w.dtype
        assert_close(g.float().numpy(), w.float().numpy(), 1e-6, False, f"out {k}")
    for k, (g, w) in enumerate(zip(got_g, want_g)):
        assert g.dtype == w.dtype
        bf16 = g.dtype == BF
        assert_close(g.float().numpy(), w.float().numpy(), 2.0 ** -8 if bf16 else 1e-5, bf16,
                     f"grad {k}")
