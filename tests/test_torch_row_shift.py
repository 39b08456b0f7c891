"""The port's per-plane row shift (``ops/row_shift.py``) against the JAX package.

The plain twin is held to the TPU kernel ``rowshift_planes_fwd`` in interpret
mode, with signed shifts that are non-integers, exact integers, past both W
edges and beyond the clip at ±(round128(pad) - 2), at rtol 2e-4 / atol 1e-5
(the tolerance ``tests/test_pallas_shift.py`` holds the kernel to its
gather path with), and to the XLA gather ``ops/sampling.shift_sample_x``
inside the clip.  The CUDA kernel is held to the twin in
``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planedepth_tpu.ops.pallas_shift import rowshift_planes_fwd
from planedepth_tpu.ops.sampling import shift_sample_x
from planedepth_tpu_torch.ops.row_shift import row_shift, row_shift_plain, shift_limit

torch.set_num_threads(1)
TOL = dict(rtol=2e-4, atol=1e-5)


def _inputs(B, N, H, W, pad, seed):
    """maps (B, H, W, N) and shifts (B, H, N) covering every edge rule."""
    rng = np.random.default_rng(seed)
    lim = shift_limit(pad)
    maps = rng.uniform(-1, 1, (B, H, W, N)).astype(np.float32)
    shift = rng.uniform(-1.5 * W, 1.5 * W, (B, H, N))
    shift[:, :, 0] = np.round(shift[:, :, 0])             # f = 0
    shift[0, :, 1] = -(lim + 40.5)                        # beyond the clip, left
    shift[1 % B, :, 1] = lim + 7.25                       # beyond the clip, right
    shift[:, 0, 2] = -lim                                 # on the clip
    shift[:, 1, 2] = W - 1.0                              # only x = 0 samples
    shift[:, 2, 2] = -(W - 0.5)                           # only x = W-1 samples
    return maps, shift.astype(np.float32)


# pad 328 is the recipe's (sweep_pad at disp_max 300): clip at 382
@pytest.mark.parametrize("shape,pad", [((2, 5, 8, 48), 16), ((1, 7, 16, 40), 200),
                                       ((2, 3, 8, 130), 16), ((1, 3, 8, 400), 328)])
def test_plain_matches_the_tpu_kernel(shape, pad):
    B, N, H, W = shape
    maps, shift = _inputs(B, N, H, W, pad, sum(shape))
    want = np.asarray(rowshift_planes_fwd(jnp.asarray(maps), jnp.asarray(shift),
                                          pad=pad, interpret=True))
    got = row_shift_plain(torch.from_numpy(np.moveaxis(maps, -1, 1).copy()),
                          torch.from_numpy(shift), pad)
    np.testing.assert_allclose(got.numpy(), np.moveaxis(want, -1, 1), **TOL)
    # the clip is part of the function: unclipped, the two far planes differ
    lim = shift_limit(pad)
    assert np.abs(shift).max() > lim
    if W > lim:
        unclipped = row_shift_plain(torch.from_numpy(np.moveaxis(maps, -1, 1).copy()),
                                    torch.from_numpy(shift), 10 ** 6)
        assert not torch.allclose(unclipped, got, **TOL)


def test_plain_matches_shift_sample_x_inside_the_clip():
    B, N, H, W, pad = 2, 4, 6, 40, 16
    rng = np.random.default_rng(5)
    maps = rng.uniform(0, 1, (B, H, W, N)).astype(np.float32)
    shift = rng.uniform(-60, 60, (B, H, N)).astype(np.float32)
    assert np.abs(shift).max() < shift_limit(pad)
    want = np.stack([
        np.asarray(shift_sample_x(
            jnp.asarray(maps[..., n:n + 1]),
            jnp.broadcast_to(jnp.asarray(shift[:, None, :, n, None]), (B, 1, H, W))))[:, 0, ..., 0]
        for n in range(N)], axis=1)
    got = row_shift_plain(torch.from_numpy(np.moveaxis(maps, -1, 1).copy()),
                          torch.from_numpy(shift), pad)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_row_shift_takes_the_twin_on_cpu_and_refuses_other_devices():
    maps, shift = _inputs(1, 3, 4, 20, 16, 0)
    maps_t = torch.from_numpy(np.moveaxis(maps, -1, 1).copy())
    before = row_shift.launches
    torch.testing.assert_close(row_shift(maps_t, torch.from_numpy(shift), 16),
                               row_shift_plain(maps_t, torch.from_numpy(shift), 16),
                               rtol=0, atol=0)
    assert row_shift.launches == before
    with pytest.raises(NotImplementedError, match="no kernel"):
        row_shift(maps_t.to("meta"), torch.from_numpy(shift).to("meta"), 16)
