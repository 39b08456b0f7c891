"""The port's bf16 2-D warp forward at the edge shapes its CUDA kernel takes apart.

The bf16 forward kernel (``csrc/warp2d.cu:warp2d_fwd_bf16_kernel``) packs
src pixel-interleaved with a zero border and warps four columns a thread,
element by element where W is not a multiple of four.  Its oracle on the
card is ``warp2d_plain`` on bf16 operands; here that plain version is held
to the JAX package's jitted XLA oracle (``oracle_warp2d`` after the fold of
``prepare_coords``, in float32 on the same bf16 values) at those edges: W
odd (61), W = 3 mod 4 (99) and W = 2 mod 4 (130), samples whose taps fall
at x0 = W - 1 and -1 and at y0 = H - 1 and -1, degenerate coordinates
(1e12, NaN) and a plane masked whole; with and without sigma.  Every bf16 output within one bf16
ulp of the JAX value plus tests/test_torch_warp2d.py's forward tolerance
(normalised float32 coordinates lose ~2e-5 px).  tests/test_torch_cuda.py
holds the kernel to ``warp2d_plain`` at the same edges on the card.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planedepth_tpu.ops.pallas_warp2d import oracle_warp2d
from planedepth_tpu_torch.ops.warp2d import warp2d, warp2d_plain

torch.set_num_threads(1)
BF = torch.bfloat16
FWD_ATOL = 5e-5


def _bf(a):
    """Round a float32 array to bf16 values (kept as float32 numpy)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(BF).float().numpy()


def _edge_inputs(shape, seed):
    """Seeded operands: a smooth warp with sub-pixel noise; rows 0-3 of
    every plane moved to x in (W - 1, W), x in (-1, 0), y in (H - 1, H) and
    y in (-1, 0); 5% of the samples degenerate, a NaN in row 4; plane 1 of
    the first image masked whole.  src, logits and sigma hold bf16 values."""
    B, N, H, W = shape
    rng = np.random.default_rng(seed)
    src = _bf(rng.uniform(0, 1, (B, 3, H, W)).astype(np.float32))
    logits = _bf(2.0 * rng.standard_normal((B, N, H, W)).astype(np.float32))
    sigma = _bf(rng.uniform(0.01, 1.0, (B, N, H, W)).astype(np.float32))
    ramp = np.linspace(-1.0, 1.0, W)[None, None, None, :]
    dx = (rng.uniform(-4, 4, (B, N, 1, 1)) + 6.0 * ramp
          + rng.uniform(0, 0.5, (B, N, H, W))).astype(np.float32)
    dy = (rng.uniform(-1, 1, (B, N, 1, 1)) + rng.uniform(0, 0.5, (B, N, H, W))).astype(
        np.float32)
    x = np.arange(W, dtype=np.float32)
    u = rng.uniform(0.05, 0.95, (B, N, 4, W)).astype(np.float32)
    dx[:, :, 0] = W - 1 + u[:, :, 0] - x
    dx[:, :, 1] = u[:, :, 1] - 1 - x
    dy[:, :, 2] = H - 1 + u[:, :, 2] - 2
    dy[:, :, 3] = u[:, :, 3] - 1 - 3
    blow = rng.uniform(0, 1, (B, N, H, W)) < 0.05
    dx[blow], dy[blow] = 1e12, -3e9
    dx[0, 0, 4, :2] = np.nan
    mask = (rng.uniform(0, 1, (B, N, H, W)) > 0.1).astype(np.float32)
    mask[0, 1] = 0.0
    return src, logits, sigma, dx, dy, mask


@functools.partial(jax.jit, static_argnames="with_sigma")
def _jax_oracle(src, logits, sigma, dx, dy, mask, with_sigma):
    """oracle_warp2d after prepare_coords' fold of fully-outside samples
    (its tile fill, which needs W a multiple of 128, replaced by 0: the
    folded samples are masked either way)."""
    B, N, H, W = dx.shape
    ls = jnp.stack([logits, sigma], 2).reshape(B, 2 * N, H, W) if with_sigma else logits
    xs = dx + jnp.arange(W, dtype=jnp.float32)
    ys = dy + jnp.arange(H, dtype=jnp.float32)[:, None]
    valid = (xs > -1.0) & (xs < W) & (ys > -1.0) & (ys < H)
    return oracle_warp2d(src, ls, jnp.where(valid, dx, 0.0), jnp.where(valid, dy, 0.0),
                         mask * valid.astype(mask.dtype), with_sigma=with_sigma)


def bf16_ulp(x):
    a = np.maximum(np.abs(np.asarray(x, np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


@pytest.mark.parametrize("shape", [(1, 3, 6, 61), (2, 2, 8, 99), (1, 2, 5, 130)],
                         ids=["W61", "W99", "W130"])
@pytest.mark.parametrize("with_sigma", [True, False], ids=["sigma", "nosigma"])
def test_warp2d_bf16_plain_matches_jax_oracle_at_the_edges(shape, with_sigma):
    src, logits, sigma, dx, dy, mask = _edge_inputs(shape, sum(shape) + with_sigma)
    want = _jax_oracle(*(jnp.asarray(a) for a in (src, logits, sigma, dx, dy, mask)),
                       with_sigma=with_sigma)
    t = lambda a, dt=BF: torch.from_numpy(a.copy()).to(dt)             # noqa: E731
    got = warp2d_plain(t(src), t(logits), t(sigma) if with_sigma else None,
                       *(t(a, torch.float32) for a in (dx, dy, mask)))
    # the wrapper takes the plain version on CPU tensors
    same = warp2d(t(src), t(logits), t(sigma) if with_sigma else None,
                  *(t(a, torch.float32) for a in (dx, dy, mask)))
    assert len(got) == len(want) == (3 if with_sigma else 2)
    for name, g, s, w in zip(("rgb", "logit", "sigma"), got, same, want):
        assert g.dtype == BF and torch.equal(g, s), name
        g, w = g.float().numpy().astype(np.float64), np.asarray(w, np.float64)
        assert np.isfinite(g).all(), name
        over = np.abs(g - w) - bf16_ulp(w) - FWD_ATOL
        assert (over <= 0).all(), (name, float(over.max()))
    # the plane masked whole and the degenerate samples are 0
    assert (got[1][0, 1] == 0).all()
    assert (got[1].float().numpy()[dx > 1e6] == 0).all()
