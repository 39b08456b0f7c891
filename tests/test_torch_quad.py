"""The port's stage-3 sweep function against the TPU's quad route (``ops/pallas_sweep_quad.py``).

At 1280x384 (stages 2 and 3) the JAX step feeds the decoder's RAW merged
space-to-depth head ``ls_s2d (B, H/2, W/2, 4*2N)`` with its bias to
``fused_plane_sweep_quad_s2d(sigma_epilogue=True)``: the relayout kernel
adds the bias and applies clip(sigmoid) to the sigma channels, the quad
kernels sweep in the phase domain.  The port computes the same function
plane-first at full resolution: ``head_epilogue`` then ``plane_sweep``
(the CUDA kernels; here their plain versions).  This holds
``head_epilogue_plain`` -> ``plane_sweep_plain`` to the quad entry run in
interpret mode: forward (rgb, nll, nll_auto, disp) and the VJP in the raw
logits, the raw sigmas and the shift, under seeded cotangents.

Shapes follow the quad kernel's aligned pattern (``tests/test_pallas_relayout.py``):
W a multiple of 256 (W/2 = 128 lanes), 16-row blocks (rows = 2 x 8).  The
ground planes' shift spread over a block stays under the quad tap grid's
``sweep_gp_taps_quad = 14``; beyond it the TPU clips its taps while the
port samples exactly.  Shifts stay under both clips (the port's
round128(pad) - 2, the quad route's 2 (pad2 - jt) - 6).  Tolerance: forward
rtol = atol = 1e-5, gradients 1e-5 of each gradient's largest magnitude
(float32, the two sum the planes and the row in other orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planedepth_tpu.ops import pallas_sweep_quad as q
from planedepth_tpu_torch.ops.head_epilogue import head_epilogue_plain
from planedepth_tpu_torch.ops.plane_sweep import plane_sweep_plain, shift_max

torch.set_num_threads(1)
B, H, W, N, NV = 1, 16, 256, 6, 4
PAD = 16                        # port clip [0, 126]; quad clip [0, 234]
ROWS, GP_TAPS = 16, 14          # the JAX step's 2 * sweep_rows and sweep_gp_taps_quad
TOL = dict(rtol=1e-5, atol=1e-5)
NAMES = ("rgb", "nll", "nll_auto", "disp")


def _inputs(seed):
    """NHWC images, the raw merged s2d head and its bias, per-row shifts and
    masks, from numpy."""
    rng = np.random.default_rng(seed)
    src, tgt = (rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32) for _ in range(2))
    ls = rng.normal(0, 1.5, (B, H // 2, W // 2, 4, N, 2)).astype(np.float32)
    ls[..., 1] = rng.uniform(-3, 3, ls[..., 1].shape)      # raw sigmas
    ls[:, 0, :4, 0, 2, 1] = -9.0                           # past the lower clip
    bias = rng.normal(0, 0.2, 8 * N).astype(np.float32)
    vert = rng.uniform(0, 60, (B, 1, NV)).repeat(H, 1)
    vert[:, :, 0] = 100.0 + rng.uniform(0, 20, (B, 1))     # taps past the W edge
    rows = np.arange(H)[None, :, None]
    ground = rng.uniform(0, 30, (B, 1, N - NV)) + rng.uniform(0, 0.8, (B, 1, N - NV)) * rows
    shift = np.concatenate([vert, ground], -1).astype(np.float32)
    assert shift.max() < shift_max(PAD)
    assert np.ptp(ground, axis=1).max() < GP_TAPS
    mask = np.ones((B, H, N), np.float32)
    mask[:, :, NV:] = rng.uniform(0, 1, (B, H, N - NV)) > 0.2
    mask[:, 5] = 0.0                                       # a fully masked row
    return src, tgt, ls.reshape(B, H // 2, W // 2, 8 * N), bias, shift, mask


def _full(quad):
    """(B, 4C, H/2, W/2) phase-split -> (B, C, H, W) full resolution."""
    return np.moveaxis(np.asarray(q.d2s_quad(jnp.asarray(quad))), -1, 1)


def _unsplit(x2):
    """(B, 2, H/2, N) py-split rows -> (B, H, N)."""
    return np.asarray(x2).transpose(0, 2, 1, 3).reshape(B, H, -1)


def _jax_quad(data, with_auto, with_disp):
    src, tgt, ls, bias, shift, mask = data
    srcq, tgtq = q.s2d_image(jnp.asarray(src)), q.s2d_image(jnp.asarray(tgt))
    mask2 = q.split_rows(jnp.asarray(mask))

    @jax.jit
    def run(ls_, sh2):
        return q.fused_plane_sweep_quad_s2d(
            srcq, tgtq, ls_, sh2, mask2, jnp.asarray(bias), PAD, True, NV, with_disp,
            ROWS, GP_TAPS, with_auto, True, True)
    return run, q.split_rows(jnp.asarray(shift))


def _port(data, with_auto, with_disp):
    """The port's path from the same raw head: (outputs, raw head, shift)."""
    src, tgt, ls, bias, shift, mask = data
    raw = torch.from_numpy(_full(np.moveaxis(ls + bias, -1, 1)).copy()).requires_grad_()
    sh = torch.from_numpy(shift.copy()).requires_grad_()
    m = torch.from_numpy(mask)
    logits, sigma = head_epilogue_plain(raw[:, 0::2], raw[:, 1::2],
                                        m.transpose(1, 2)[..., None])
    nchw = lambda a: torch.from_numpy(np.moveaxis(a, -1, 1).copy())
    outs = plane_sweep_plain(nchw(src), nchw(tgt), logits, sigma, sh, m, PAD,
                             with_auto, with_disp)
    return outs, raw, sh


@pytest.mark.parametrize("with_auto,with_disp", [(False, True), (True, True), (True, False)])
def test_port_matches_the_quad_route(with_auto, with_disp):
    data = _inputs(11)
    run, sh2 = _jax_quad(data, with_auto, with_disp)
    ls = jnp.asarray(data[2])
    want = run(ls, sh2)
    got, raw, sh = _port(data, with_auto, with_disp)
    names = [n for n in NAMES if (n != "nll_auto" or with_auto) and (n != "disp" or with_disp)]
    assert len(want) == len(got) == len(names)
    for name, w, g in zip(names, want, got):
        np.testing.assert_allclose(g.detach().numpy(), _full(w).reshape(g.shape),
                                   err_msg=name, **TOL)
    assert (got[0].detach().numpy()[:, :, 5] == 0).all()

    rng = np.random.default_rng(3)
    cts = [rng.standard_normal(np.shape(w)).astype(np.float32) for w in want]
    _, vjp = jax.vjp(run, ls, sh2)
    d_ls, d_sh2 = vjp(tuple(jnp.asarray(c) for c in cts))
    d_raw, d_sh = torch.autograd.grad(
        sum((o * torch.from_numpy(_full(c).reshape(o.shape).copy())).sum() for o, c in zip(got, cts)),
        (raw, sh))
    d_full = _full(np.moveaxis(np.asarray(d_ls), -1, 1))
    for name, g, w in (("d_raw_logits", d_raw[:, 0::2], d_full[:, 0::2]),
                       ("d_raw_sigma", d_raw[:, 1::2], d_full[:, 1::2]),
                       ("d_shift", d_sh, _unsplit(d_sh2))):
        scale = np.abs(w).max()
        assert scale > 0, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * scale, err_msg=name)
