"""The port's fused plane sweep (``ops/plane_sweep.py``) against the JAX package.

``plane_sweep_plain`` (the CPU path and the CUDA kernels' oracle) is held to
the JAX oracles (``oracle_dense`` + ``oracle_disp_center`` on the clipped
shift) and to the Pallas forward kernel in interpret mode, at
atol = rtol = 1e-5; its autograd gradients (logits, sigma, shift) are held
to the JAX ``fused_plane_sweep`` VJP (interpret mode, ``image_grads=False``)
at 1e-5 of each gradient's largest magnitude.  Shapes are those of
tests/test_pallas_sweep.py: vertical (row-constant) and ground (per-row)
planes, one fully masked row, shifts past the W edge and below 0, with the
production kernel configuration (``nonneg``, ``gp_taps=8``).

The no-mixture mode (``sigma=None``) is held the same way at the shape of
tests/test_pallas_sweep.py's no-mixture test (2, 7 planes, 16 x 256): the
forward to ``oracle_softmax`` on the clipped shift and to
``fused_plane_sweep_nomix`` in interpret mode at rtol = atol = 1e-5, the
gradients (logits, shift) to that function's VJP at 1e-4 of each
gradient's largest magnitude, with and without the centre disparity.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planedepth_tpu.ops.pallas_sweep import (
    fused_plane_sweep,
    fused_plane_sweep_nomix,
    oracle_dense,
    oracle_disp_center,
    oracle_softmax,
    sweep_forward,
)
from planedepth_tpu_torch.ops.plane_sweep import plane_sweep, plane_sweep_plain, shift_max

pytestmark = pytest.mark.heavy
torch.set_num_threads(1)

B, H, W, N = 2, 8, 64, 6
PAD = 12                       # clip range [0, round128(12) - 2] = [0, 126]
TOL = dict(rtol=1e-5, atol=1e-5)
KW = dict(n_vertical=0, rows=8, gp_taps=8, nonneg=True)


def _inputs(seed=17, shape=(B, H, W, N)):
    B, H, W, N = shape
    rng = np.random.default_rng(seed)
    src = rng.uniform(0, 1, (B, 3, H, W)).astype(np.float32)
    tgt = rng.uniform(0, 1, (B, 3, H, W)).astype(np.float32)
    logits = rng.standard_normal((B, N, H, W)).astype(np.float32)
    sigma = rng.uniform(0.0, 1.0, (B, N, H, W)).astype(np.float32)
    sigma[1, 1, 2, :8] = 1.0                       # on the clip's upper edge
    # planes 0-2 vertical (row-constant), 3-5 ground (linear in the row,
    # spread < 8 per block so the TPU kernel's tap grid holds them)
    vert = rng.uniform(0.0, 30.0, (B, 1, 3)).repeat(H, 1)
    vert[:, :, 2] = W - 2.7                        # taps past the W edge
    vert[1, :, 1] = -2.0                           # clipped to 0
    vert[0, :, 1] = 200.0                          # clipped to 126
    slope = rng.uniform(0.0, 0.9, (B, 1, N - 3))
    ground = rng.uniform(0.0, 20.0, (B, 1, N - 3)) + slope * np.arange(H)[None, :, None]
    shift = np.concatenate([vert, ground], -1).astype(np.float32)
    mask = (rng.uniform(0, 1, (B, H, N)) > 0.2).astype(np.float32)
    mask[:, 5, :] = 0.0                            # a fully masked row
    return src, tgt, logits, sigma, shift, mask


@pytest.fixture(scope="module")
def data():
    return _inputs()


def _torch(arrays, grad=False):
    return [torch.from_numpy(a.copy()).requires_grad_(grad) for a in arrays]


@pytest.mark.parametrize("with_auto", [False, True])
def test_plain_forward_matches_jax_oracle_and_kernel(data, with_auto):
    src, tgt, logits, sigma, shift, mask = data
    got = [t.numpy() for t in plane_sweep_plain(*_torch(data), PAD, with_auto, True)]
    assert len(got) == 3 + with_auto

    clipped = np.clip(shift, 0.0, shift_max(PAD))
    jin = [jnp.asarray(a) for a in (src, tgt, logits, sigma, clipped, mask)]
    rgb, nll, nlla = oracle_dense(*jin)
    disp = oracle_disp_center(jin[2], jin[3], jin[4], jin[5])
    want = [rgb, nll] + ([nlla] if with_auto else []) + [disp]
    for name, g, w in zip(("rgb", "nll", "nll_auto", "disp")[: len(got)], got, want):
        np.testing.assert_allclose(g, np.asarray(w), err_msg=f"oracle {name}", **TOL)

    kernel = sweep_forward(*[jnp.asarray(a) for a in data], pad=PAD,
                           interpret=True, with_disp=True, with_auto=with_auto, **KW)
    for name, g, w in zip(("rgb", "nll", "nll_auto", "disp"), got, kernel):
        np.testing.assert_allclose(g, np.asarray(w), err_msg=f"kernel {name}", **TOL)
    assert (got[-1][:, 5] == 0).all() and (got[0][:, :, 5] == 0).all()


@pytest.mark.parametrize("with_auto", [False, True])
def test_plain_grads_match_jax_vjp(data, with_auto):
    src, tgt, logits, sigma, shift, mask = data
    rng = np.random.default_rng(5)
    cts = [rng.standard_normal(s).astype(np.float32)
           for s in ((B, 3, H, W), (B, H, W), (B, H, W), (B, H, W))]
    cts = cts if with_auto else cts[:2] + cts[3:]

    def jax_f(lg, sg, sh):
        return fused_plane_sweep(jnp.asarray(src), jnp.asarray(tgt), lg, sg, sh,
                                 jnp.asarray(mask), PAD, True, KW["n_vertical"],
                                 False, True, KW["rows"], KW["gp_taps"],
                                 with_auto, True)

    _, vjp = jax.vjp(jax_f, *(jnp.asarray(a) for a in (logits, sigma, shift)))
    want = vjp(tuple(jnp.asarray(c) for c in cts))

    s, t, lg, sg, sh, m = _torch(data, grad=True)
    outs = plane_sweep(s, t, lg, sg, sh, m, PAD, with_auto, True)
    got = torch.autograd.grad(
        sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cts)), (lg, sg, sh))
    for name, g, w in zip(("d_logits", "d_sigma", "d_shift"), got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)
    assert np.abs(np.asarray(want[2])).max() > 0


def test_plane_sweep_takes_the_plain_path_on_the_cpu(data):
    before = (plane_sweep.fwd_launches, plane_sweep.bwd_launches)
    a = plane_sweep(*_torch(data), PAD, False, True)
    b = plane_sweep_plain(*_torch(data), PAD, False, True)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert (plane_sweep.fwd_launches, plane_sweep.bwd_launches) == before
    with pytest.raises(NotImplementedError):
        plane_sweep(*[t.to("meta") for t in _torch(data)], PAD, False, True)


NOMIX = (2, 16, 256, 7)        # (B, H, W, N) of tests/test_pallas_sweep.py:634


@pytest.fixture(scope="module")
def nomix_data():
    src, tgt, logits, _, shift, mask = _inputs(23, NOMIX)
    return src, tgt, logits, shift, mask


def _nomix_jax(src, tgt, mask, with_disp):
    return lambda lg, sh: fused_plane_sweep_nomix(
        jnp.asarray(src), jnp.asarray(tgt), lg, sh, jnp.asarray(mask), PAD, True,
        KW["n_vertical"], with_disp, KW["rows"], KW["gp_taps"], KW["nonneg"])


@pytest.mark.parametrize("with_disp", [False, True])
def test_nomix_plain_forward_matches_jax_oracle_and_kernel(nomix_data, with_disp):
    src, tgt, logits, shift, mask = nomix_data
    s, t, lg, sh, m = _torch(nomix_data)
    got = [o.numpy() for o in plane_sweep_plain(s, t, lg, None, sh, m, PAD, False, with_disp)]
    assert len(got) == 2 + with_disp

    clipped = np.clip(shift, 0.0, shift_max(PAD))
    rgb_o, disp_o = oracle_softmax(*(jnp.asarray(a) for a in (src, tgt, logits, clipped, mask)))
    np.testing.assert_allclose(got[0], np.asarray(rgb_o), err_msg="oracle rgb", **TOL)
    if with_disp:
        np.testing.assert_allclose(got[2], np.asarray(disp_o), err_msg="oracle disp", **TOL)
    kernel = _nomix_jax(src, tgt, mask, with_disp)(jnp.asarray(logits), jnp.asarray(shift))
    for name, g, w in zip(("rgb", "nll", "disp"), got, kernel):
        np.testing.assert_allclose(g, np.asarray(w), err_msg=f"kernel {name}", **TOL)
    assert (got[0][:, :, 5] == 0).all()                   # the fully masked row


@pytest.mark.parametrize("with_disp", [False, True])
def test_nomix_plain_grads_match_jax_vjp(nomix_data, with_disp):
    """d_logits and d_shift under seeded cotangents on every output (nll's
    included, though training gives it none)."""
    src, tgt, logits, shift, mask = nomix_data
    Bn, Hn, Wn, _ = NOMIX
    rng = np.random.default_rng(9)
    cts = [rng.standard_normal(sz).astype(np.float32)
           for sz in ((Bn, 3, Hn, Wn), (Bn, Hn, Wn), (Bn, Hn, Wn))][: 2 + with_disp]
    _, vjp = jax.vjp(_nomix_jax(src, tgt, mask, with_disp), jnp.asarray(logits),
                     jnp.asarray(shift))
    want = vjp(tuple(jnp.asarray(c) for c in cts))

    s, t, lg, sh, m = _torch(nomix_data)
    lg.requires_grad_()
    sh.requires_grad_()
    outs = plane_sweep(s, t, lg, None, sh, m, PAD, False, with_disp)
    got = torch.autograd.grad(
        sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cts)), (lg, sh))
    for name, g, w in zip(("d_logits", "d_shift"), got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)
        assert np.abs(w).max() > 0, name


def test_nomix_takes_the_plain_path_on_the_cpu_and_has_no_automask(nomix_data):
    s, t, lg, sh, m = _torch(nomix_data)
    counts = lambda: (plane_sweep.fwd_launches, plane_sweep.bwd_launches,
                      plane_sweep.nomix_fwd_launches, plane_sweep.nomix_bwd_launches)
    before = counts()
    for x, y in zip(plane_sweep(s, t, lg, None, sh, m, PAD, False, True),
                    plane_sweep_plain(s, t, lg, None, sh, m, PAD, False, True)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert counts() == before
    with pytest.raises(ValueError, match="automask"):
        plane_sweep(s, t, lg, None, sh, m, PAD, True, True)
