"""The port's plane-head epilogue (``ops/head_epilogue.py``) against the JAX package.

On the TPU the epilogue rides the relayout of the merged raw head: the
forward inside ``relayout_pad_nchw(sigma_epilogue=True)``, its adjoint as
``_ls_epilogue_vjp_from_post`` on the cotangent brought back to NHWC (the
``relayout_nhwc`` layout).  The plain twin is held to both, run in interpret
mode on an interleaved (logit, sigma) head, with the logits masked as the
sweep masks them, at rtol 1e-6 / atol 1e-7 (float32, one sigmoid apart).
Raw sigmas reach both ends of the clip.  The CUDA kernels are held to the
twin in ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planedepth_tpu.ops.pallas_relayout import relayout_nhwc, relayout_pad_nchw
from planedepth_tpu.ops.pallas_sweep_quad import _ls_epilogue_vjp_from_post
from planedepth_tpu_torch.ops.head_epilogue import head_epilogue, head_epilogue_plain

torch.set_num_threads(1)
TOL = dict(rtol=1e-6, atol=1e-7)


def _inputs(B, N, H, W, full_mask, seed):
    """Raw heads (B, N, H, W), a 0/1 mask and a cotangent pair from numpy;
    raw sigmas past both ends of the clip."""
    rng = np.random.default_rng(seed)
    raw_l = rng.normal(0, 2, (B, N, H, W)).astype(np.float32)
    raw_s = rng.uniform(-8, 8, (B, N, H, W)).astype(np.float32)
    raw_s[:, 0, 0] = 40.0                         # sigmoid rounds to 1
    raw_s[:, 1, 1] = -40.0                        # clipped to 0.01
    mask = (rng.uniform(0, 1, (B, N, H, W if full_mask else 1)) > 0.3).astype(np.float32)
    g_l, g_s = (rng.normal(0, 1, (B, N, H, W)).astype(np.float32) for _ in range(2))
    return raw_l, raw_s, mask, g_l, g_s


def _interleave(l, s):
    """(B, N, H, W) pair -> the merged head's NHWC layout, channel 2n the
    logit of plane n and 2n + 1 its sigma."""
    return np.stack([l, s], -1).transpose(0, 2, 3, 1, 4).reshape(
        l.shape[0], l.shape[2], l.shape[3], 2 * l.shape[1])


@pytest.mark.parametrize("shape,full_mask", [((2, 5, 8, 128), False),
                                             ((1, 3, 16, 256), True)])
def test_plain_matches_the_relayout_kernels(shape, full_mask):
    B, N, H, W = shape
    raw_l, raw_s, mask, g_l, g_s = _inputs(B, N, H, W, full_mask, sum(shape))

    post = relayout_pad_nchw(jnp.asarray(_interleave(raw_l, raw_s)), 0, 0, rows=8,
                             interpret=True, sigma_epilogue=True)   # (B, 2N, H, W)
    post = np.asarray(post)
    # the sweep's cotangent of the merged head, with the logits masked as
    # the sweep masks them, back in NHWC and through the epilogue's adjoint
    g_nchw = np.stack([g_l * mask, g_s], 2).reshape(B, 2 * N, H, W)
    d_raw = _ls_epilogue_vjp_from_post(jnp.moveaxis(jnp.asarray(post), 1, -1),
                                       relayout_nhwc(jnp.asarray(g_nchw), rows=8,
                                                     interpret=True))
    d_raw = np.moveaxis(np.asarray(d_raw), -1, 1)                     # (B, 2N, H, W)

    tl, ts = (torch.from_numpy(a).requires_grad_() for a in (raw_l, raw_s))
    logits, sigma = head_epilogue(tl, ts, torch.from_numpy(mask))    # CPU: the twin
    np.testing.assert_allclose(logits.detach().numpy(), post[:, 0::2] * mask, **TOL)
    np.testing.assert_allclose(sigma.detach().numpy(), post[:, 1::2], **TOL)
    assert sigma.min() == 0.01 and sigma.max() == 1.0
    d_l, d_s = torch.autograd.grad((logits, sigma), (tl, ts),
                                   (torch.from_numpy(g_l), torch.from_numpy(g_s)))
    np.testing.assert_allclose(d_l.numpy(), d_raw[:, 0::2], **TOL)
    np.testing.assert_allclose(d_s.numpy(), d_raw[:, 1::2], **TOL)
    assert (d_s.numpy()[:, 1, 1] == 0).all() and (d_s.numpy()[:, 0, 0] == 0).all()


def test_plain_without_a_sigma_head():
    raw_l, _, mask, _, _ = _inputs(1, 4, 3, 10, False, 0)
    logits, sigma = head_epilogue_plain(torch.from_numpy(raw_l), None,
                                        torch.from_numpy(mask))
    assert sigma is None
    np.testing.assert_array_equal(logits.numpy(), raw_l * mask)


def test_other_devices_raise():
    meta = torch.zeros(1, 2, 3, 4, device="meta")
    with pytest.raises(NotImplementedError, match="no kernel"):
        head_epilogue(meta, meta, torch.zeros(1, 2, 3, 1, device="meta"))
