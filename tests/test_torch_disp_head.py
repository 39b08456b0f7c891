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


def _inputs(seed, zero_row, b=B, h=H, w=W, n=N):
    """NHWC numpy inputs (the JAX layout); logits masked as the decoder does."""
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


def _hold_backward(inputs, g):
    """Autograd through ``disp_head_plain`` against ``disp_head_bwd(
    interpret=True)`` and ``jax.vjp`` of ``disp_head`` (its custom VJP) on
    NHWC ``inputs`` and cotangent ``g``: d_logits and d_sigma at atol = rtol
    = 1e-5 of their largest magnitude, d_disp_rows (a sum over W) at 1e-5 of
    its own.  Returns the port's adjoints in the JAX layout."""
    import jax

    from planedepth_tpu.ops.pallas_disp import disp_head_bwd

    jin = tuple(jnp.asarray(a) for a in inputs)
    kernel = disp_head_bwd(*jin, jnp.asarray(g), interpret=True)
    _, vjp = jax.vjp(lambda l, s, d: jax_disp_head(l, s, d, jin[3], True), *jin[:3])
    via_vjp = vjp(jnp.asarray(g))

    logits, sigma, rows, mask = _to_port(*inputs)
    for t in (logits, sigma, rows):
        t.requires_grad_()
    disp = disp_head_plain(logits, sigma, rows, mask)
    got = torch.autograd.grad(disp, (logits, sigma, rows),
                              torch.from_numpy(np.moveaxis(g, -1, 1).copy()))
    got = [np.moveaxis(got[0].numpy(), 1, -1), np.moveaxis(got[1].numpy(), 1, -1),
           got[2].numpy()]
    for want in (kernel, via_vjp):
        for name, a, b in zip(("d_logits", "d_sigma", "d_disp_rows"), got, want):
            b = np.asarray(b)
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * np.abs(b).max(),
                                       err_msg=name)
    return got


@pytest.mark.parametrize("zero_row", [False, True])
def test_plain_backward_matches_pallas_interpret_and_jax_vjp(zero_row):
    """Autograd through ``disp_head_plain`` (the backward kernel's oracle)
    against the Pallas backward and the custom VJP (``_hold_backward``),
    with a seeded cotangent; row 2 of the zero-row case has U <= 1e-7, where
    every adjoint is 0."""
    g = np.random.default_rng(3).standard_normal((B, H, W, 1)).astype(np.float32)
    got = _hold_backward(_inputs(29, zero_row), g)
    if zero_row:
        assert (got[0][:, 2] == 0).all() and (got[1][:, 2] == 0).all()
        assert (got[2][:, 2] == 0).all()


def test_plain_backward_matches_pallas_interpret_and_jax_vjp_at_127_planes():
    """The same at N = 127, more planes than the CUDA backward stages at once
    (it takes them in chunks there), on (B, H, W) = (1, 8, 64); row 2 fully
    masked."""
    g = np.random.default_rng(4).standard_normal((1, 8, 64, 1)).astype(np.float32)
    got = _hold_backward(_inputs(31, True, 1, 8, 64, 127), g)
    assert (got[0][:, 2] == 0).all() and (got[2][:, 2] == 0).all()
