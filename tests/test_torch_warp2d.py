"""The port's 2-D plane warp against the JAX package's.

``warp2d_plain`` (the CPU path and the CUDA kernels' oracle) is held to
``oracle_warp2d`` (grid_sample per plane after ``prepare_coords``) on warps
of any spread, boundary-partial and degenerate (1e12, NaN) coordinates
included, and to the Pallas kernel in interpret mode at the shape and tap
bounds of tests/test_pallas_warp2d.py, inside the kernel's envelope.  The
forward at atol 5e-5 (that test's tolerance; normalised float32 coordinates
lose ~2e-5 px at W = 128); gradients with respect to logits, sigma, dx and
dy against ``jax.vjp`` of the oracle at 1e-4 of each gradient's largest
magnitude.  The JAX functions run under ``jax.jit``: one compiled program a
call rather than one an operation.  The mode without sigma (``sigma=None``, the twin of
``with_sigma=False``) is held the same way.  tests/test_torch_cuda.py holds
the CUDA kernels to ``warp2d_plain`` on the card.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planedepth_tpu.ops.pallas_warp2d import oracle_warp2d, prepare_coords, warp2d_sample
from planedepth_tpu_torch.ops.warp2d import warp2d, warp2d_plain

pytestmark = pytest.mark.heavy
torch.set_num_threads(1)

FWD_ATOL = 5e-5
GRAD_REL = 1e-4


def _inputs(shape, seed, spread, degenerate=False):
    """Seeded numpy operands: smooth per-plane displacements of about
    ``spread`` pixels around a per-plane offset, partly outside the image."""
    B, N, H, W = shape
    rng = np.random.default_rng(seed)
    src = rng.uniform(0, 1, (B, 3, H, W)).astype(np.float32)
    logits = rng.standard_normal((B, N, H, W)).astype(np.float32)
    sigma = rng.uniform(0.1, 0.9, (B, N, H, W)).astype(np.float32)
    ramp = np.linspace(-1.0, 1.0, W)[None, None, None, :]
    dx = (rng.uniform(-spread, spread, (B, N, 1, 1)) + 0.5 * spread * ramp
          + rng.uniform(-1.5, 1.5, (B, N, H, W))).astype(np.float32)
    dy = (rng.uniform(-spread / 4, spread / 4, (B, N, 1, 1))
          + rng.uniform(-1.0, 1.0, (B, N, H, W))).astype(np.float32)
    if degenerate:
        blow = rng.uniform(0, 1, (B, N, H, W)) < 0.05
        dx[blow] = 1e12
        dy[blow] = -3e9
        dx[0, 0, 1, :3] = np.nan
    mask = (rng.uniform(0, 1, (B, N, H, W)) > 0.1).astype(np.float32)
    return src, logits, sigma, dx, dy, mask


@jax.jit
def _jax_oracle(src, logits, sigma, dx, dy, mask):
    """oracle_warp2d on the folded coordinates, split into the port's
    outputs; ``sigma=None`` warps the logits alone (``with_sigma=False``)."""
    B, N, H, W = dx.shape
    ls = logits if sigma is None else jnp.stack([logits, sigma], 2).reshape(B, 2 * N, H, W)
    dxp, dyp, mp = prepare_coords(dx, dy, mask, H, W, rows=8)
    return oracle_warp2d(src, ls, dxp, dyp, mp, with_sigma=sigma is not None)


@functools.partial(jax.jit, static_argnames="with_sigma")
def _jax_kernel(src, ls, dx, dy, mask, with_sigma):
    """The Pallas kernel in interpret mode at tests/test_pallas_warp2d.py's
    tap bounds (sx = 6, sy = 4, rows 8), compiled as one program."""
    return warp2d_sample(src, ls, dx, dy, mask, rows=8, sx=6, sy=4, with_sigma=with_sigma,
                         interpret=True)


def _torch(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


@pytest.mark.parametrize("degenerate", [False, True])
def test_plain_matches_oracle_everywhere(degenerate):
    """Spreads of ~40 px per plane, far outside any static tap bound."""
    arrays = _inputs((2, 4, 16, 128), 1 + degenerate, 40.0, degenerate)
    got = warp2d_plain(*_torch(*arrays))
    want = _jax_oracle(*(jnp.asarray(a) for a in arrays))
    for name, g, w in zip(("rgb", "logit", "sigma"), got, want):
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=FWD_ATOL,
                                   err_msg=name)
    if degenerate:
        dead = ~np.isfinite(arrays[3]) | (np.abs(arrays[3]) > 1e6)
        assert dead.any() and (got[1].numpy()[dead] == 0).all()


def test_plain_matches_pallas_kernel_inside_its_envelope():
    """tests/test_pallas_warp2d.py's operands, shape (1, 3, 16, 128) and taps
    sx = 6, sy = 4, rows 8."""
    B, N, H, W = 1, 3, 16, 128
    rng = np.random.RandomState(0)
    src = rng.rand(B, 3, H, W).astype(np.float32)
    logits = rng.randn(B, N, H, W).astype(np.float32)
    sigma = (0.1 + 0.8 * rng.rand(B, N, H, W)).astype(np.float32)
    dx = (4.0 * rng.rand(B, N, 1, 1) + 1.2 * rng.rand(B, N, H, W) - 2.0).astype(np.float32)
    dy = (1.5 * rng.randn(B, N, 1, 1) + 0.6 * rng.rand(B, N, H, W) - 0.3).astype(np.float32)
    mask = np.ones((B, N, H, W), np.float32)
    ls = jnp.stack([jnp.asarray(logits), jnp.asarray(sigma)], 2).reshape(B, 2 * N, H, W)
    want = _jax_kernel(jnp.asarray(src), ls, jnp.asarray(dx), jnp.asarray(dy),
                       jnp.asarray(mask), with_sigma=True)
    got = warp2d_plain(*_torch(src, logits, sigma, dx, dy, mask))
    for name, g, w in zip(("rgb", "logit", "sigma"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=FWD_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("degenerate", [False, True])
def test_plain_gradients_match_jax_vjp(degenerate):
    """d_logits, d_sigma, d_dx, d_dy of seeded cotangents on all three
    outputs; the degenerate samples get zero gradients, not NaN."""
    arrays = _inputs((1, 3, 16, 128), 3 + degenerate, 12.0, degenerate)
    rng = np.random.default_rng(7)
    cts = [rng.standard_normal(s).astype(np.float32)
           for s in ((1, 3, 3, 16, 128), (1, 3, 16, 128), (1, 3, 16, 128))]
    src, logits, sigma, dx, dy, mask = (jnp.asarray(a) for a in arrays)
    _, vjp = jax.vjp(lambda l, s, x, y: _jax_oracle(src, l, s, x, y, mask),
                     logits, sigma, dx, dy)
    want = vjp(tuple(jnp.asarray(c) for c in cts))

    t = _torch(*arrays)
    for i in (1, 2, 3, 4):
        t[i].requires_grad_()
    out = warp2d(*t)
    got = torch.autograd.grad(out, t[1:5], [torch.from_numpy(c) for c in cts])
    for name, g, w in zip(("d_logits", "d_sigma", "d_dx", "d_dy"), got, want):
        w = np.asarray(w)
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_REL * float(np.abs(w).max()), err_msg=name)


def test_wrapper_takes_plain_on_cpu_without_counting():
    arrays = _torch(*_inputs((1, 2, 8, 32), 5, 4.0))
    before = (warp2d.fwd_launches, warp2d.bwd_launches)
    for g, w in zip(warp2d(*arrays), warp2d_plain(*arrays)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert (warp2d.fwd_launches, warp2d.bwd_launches) == before


@pytest.mark.parametrize("degenerate", [False, True])
def test_nosigma_plain_matches_oracle_everywhere(degenerate):
    """Without sigma: ``(rgb, logit)`` against ``oracle_warp2d(with_sigma=
    False)``, spreads of ~40 px, degenerate coordinates included."""
    src, logits, _, dx, dy, mask = _inputs((2, 4, 16, 128), 11 + degenerate, 40.0, degenerate)
    got = warp2d_plain(*_torch(src, logits), None, *_torch(dx, dy, mask))
    want = _jax_oracle(*(jnp.asarray(a) for a in (src, logits)), None,
                       *(jnp.asarray(a) for a in (dx, dy, mask)))
    assert len(got) == len(want) == 2
    for name, g, w in zip(("rgb", "logit"), got, want):
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=FWD_ATOL,
                                   err_msg=name)
    # the sigma mode's rgb and logit are the same samples
    sigma = _torch(_inputs((2, 4, 16, 128), 11 + degenerate, 40.0, degenerate)[2])[0]
    with_sigma = warp2d_plain(*_torch(src, logits), sigma, *_torch(dx, dy, mask))
    for g, w in zip(got, with_sigma[:2]):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_nosigma_plain_matches_pallas_kernel_inside_its_envelope():
    """``warp2d_sample(with_sigma=False)`` in interpret mode at the shape and
    tap bounds of tests/test_pallas_warp2d.py."""
    B, N, H, W = 1, 3, 16, 128
    rng = np.random.RandomState(1)
    src = rng.rand(B, 3, H, W).astype(np.float32)
    logits = rng.randn(B, N, H, W).astype(np.float32)
    dx = (4.0 * rng.rand(B, N, 1, 1) + 1.2 * rng.rand(B, N, H, W) - 2.0).astype(np.float32)
    dy = (1.5 * rng.randn(B, N, 1, 1) + 0.6 * rng.rand(B, N, H, W) - 0.3).astype(np.float32)
    mask = (rng.rand(B, N, H, W) > 0.1).astype(np.float32)
    want = _jax_kernel(*(jnp.asarray(a) for a in (src, logits, dx, dy, mask)),
                       with_sigma=False)
    got = warp2d_plain(*_torch(src, logits), None, *_torch(dx, dy, mask))
    assert len(want) == 2
    for name, g, w in zip(("rgb", "logit"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=FWD_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("degenerate", [False, True])
def test_nosigma_plain_gradients_match_jax_vjp(degenerate):
    """d_logits, d_dx, d_dy without sigma, against ``jax.vjp`` of the oracle."""
    src, logits, _, dx, dy, mask = _inputs((1, 3, 16, 128), 13 + degenerate, 12.0, degenerate)
    rng = np.random.default_rng(17)
    cts = [rng.standard_normal(s).astype(np.float32)
           for s in ((1, 3, 3, 16, 128), (1, 3, 16, 128))]
    j_src, j_mask = jnp.asarray(src), jnp.asarray(mask)
    _, vjp = jax.vjp(lambda l, x, y: _jax_oracle(j_src, l, None, x, y, j_mask),
                     *(jnp.asarray(a) for a in (logits, dx, dy)))
    want = vjp(tuple(jnp.asarray(c) for c in cts))

    t_src, t_logits, t_dx, t_dy, t_mask = _torch(src, logits, dx, dy, mask)
    wrt = [t.requires_grad_() for t in (t_logits, t_dx, t_dy)]
    out = warp2d(t_src, t_logits, None, t_dx, t_dy, t_mask)
    got = torch.autograd.grad(out, wrt, [torch.from_numpy(c) for c in cts])
    for name, g, w in zip(("d_logits", "d_dx", "d_dy"), got, want):
        w = np.asarray(w)
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_REL * float(np.abs(w).max()), err_msg=name)


def test_nosigma_wrapper_takes_plain_on_cpu_without_counting():
    src, logits, _, dx, dy, mask = _torch(*_inputs((1, 2, 8, 32), 6, 4.0))
    counts = lambda: (warp2d.fwd_launches, warp2d.bwd_launches,
                      warp2d.nosigma_fwd_launches, warp2d.nosigma_bwd_launches)
    before = counts()
    got = warp2d(src, logits, None, dx, dy, mask)
    assert len(got) == 2
    for g, w in zip(got, warp2d_plain(src, logits, None, dx, dy, mask)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert counts() == before
