"""The port's expected-disparity head against the JAX package's.

``disp_head_plain`` (the CPU path and the CUDA kernel's oracle) is held to
the Pallas kernel in interpret mode and to the decoder's XLA chain, on the
same seeded numpy inputs, at atol = rtol = 1e-5: only the order of the f32
sums differs.  tests/test_torch_cuda.py holds the CUDA kernel to
``disp_head_plain`` on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planedepth_tpu.ops.pallas_disp import disp_head as jax_disp_head
from planedepth_tpu_torch.ops.disp_head import disp_head, disp_head_plain

pytestmark = pytest.mark.heavy
torch.set_num_threads(1)

B, H, W, N = 2, 8, 64, 6
TOL = dict(rtol=1e-5, atol=1e-5)


def xla_chain(logits, sigma, disp_rows, mask_rows):
    """tests/test_pallas_disp.py's composition of the decoder's XLA chain."""
    import jax

    p = jax.nn.softmax(logits, axis=-1)
    w = p * mask_rows[:, :, None, :] / sigma
    s = jnp.sum(w, axis=-1, keepdims=True)
    w = w * jnp.where(s > 1e-7, 1.0 / jnp.maximum(s, 1e-7), 0.0)
    return jnp.sum(w * disp_rows[:, :, None, :], axis=-1, keepdims=True)


def _inputs(seed, zero_row):
    """NHWC numpy inputs (the JAX layout); logits masked as the decoder does."""
    b, h, w, n = B, H, W, N
    rng = np.random.default_rng(seed)
    mask = (rng.uniform(0, 1, (b, h, n)) > 0.3).astype(np.float32)
    if zero_row:
        mask[:, 2, :] = 0.0                 # guarded-reciprocal pixels
    logits = rng.standard_normal((b, h, w, n)).astype(np.float32)
    logits *= mask[:, :, None, :]
    sigma = rng.uniform(0.05, 0.95, (b, h, w, n)).astype(np.float32)
    disp_rows = rng.uniform(2.0, 300.0, (b, h, n)).astype(np.float32)
    return logits, sigma, disp_rows, mask


def _to_port(logits, sigma, disp_rows, mask):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return (t(np.moveaxis(logits, -1, 1)), t(np.moveaxis(sigma, -1, 1)),
            t(disp_rows), t(mask))


@pytest.mark.parametrize("zero_row", [False, True])
def test_plain_matches_pallas_interpret_and_xla_chain(zero_row):
    inputs = _inputs(23, zero_row)
    got = disp_head_plain(*_to_port(*inputs))[:, 0].numpy()       # (B, H, W)
    jin = tuple(jnp.asarray(a) for a in inputs)
    kernel = np.asarray(jax_disp_head(*jin, True))[..., 0]
    chain = np.asarray(xla_chain(*jin))[..., 0]
    np.testing.assert_allclose(got, kernel, **TOL)
    np.testing.assert_allclose(got, chain, **TOL)
    if zero_row:
        assert (got[:, 2] == 0).all()


def test_wrapper_takes_plain_on_cpu_without_counting():
    inputs = _to_port(*_inputs(5, True))
    before = disp_head.launches
    np.testing.assert_array_equal(disp_head(*inputs).numpy(),
                                  disp_head_plain(*inputs).numpy())
    assert disp_head.launches == before
