"""The sweep's image gradients: ``plane_sweep_plain`` against the JAX package's
``image_grads=True`` backward, the no-mixture mode's zero image cotangents,
and the case every device refuses.

``plane_sweep_plain`` (the CPU path and the oracle of the CUDA backward's
image-gradient instance) is differentiated by autograd in src, tgt, logits,
sigma and shift under seeded cotangents on rgb, nll and nll_auto (and the
centre disparity) and held to the JAX ``fused_plane_sweep(...,
image_grads=True)`` VJP in interpret mode at 1e-5 of each gradient's largest
magnitude, on the inputs of tests/test_torch_plane_sweep.py (vertical and
ground planes, a fully masked row, shifts past the W edge and below 0,
``nonneg``, ``gp_taps=8``).  The no-mixture entry on images that require
grad is held to the VJP of ``fused_plane_sweep_nomix`` (interpret mode):
zero d_src and d_tgt, d_logits and d_shift within 1e-5 of their largest
magnitude.  The rules are decided before the device: the mixture without
the automask raises on the CPU and on ``meta`` as on CUDA; the no-mixture
call passes them and only the device decides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planedepth_tpu.ops.pallas_sweep import fused_plane_sweep, fused_plane_sweep_nomix
from planedepth_tpu_torch.ops.plane_sweep import plane_sweep, plane_sweep_plain
from tests.test_torch_plane_sweep import KW, PAD, _inputs

torch.set_num_threads(1)

B, H, W, N = 2, 8, 64, 6


@pytest.fixture(scope="module")
def data():
    return _inputs()


@pytest.mark.parametrize("with_disp", [False, True])
def test_plain_image_grads_match_jax_vjp(data, with_disp):
    src, tgt, logits, sigma, shift, mask = data
    rng = np.random.default_rng(31)
    cts = [rng.standard_normal(s).astype(np.float32)
           for s in ((B, 3, H, W), (B, H, W), (B, H, W), (B, H, W))][: 3 + with_disp]

    def jax_f(s, t, lg, sg, sh):
        return fused_plane_sweep(s, t, lg, sg, sh, jnp.asarray(mask), PAD, True,
                                 KW["n_vertical"], True, with_disp, KW["rows"],
                                 KW["gp_taps"], True, True)

    _, vjp = jax.vjp(jax_f, *(jnp.asarray(a) for a in (src, tgt, logits, sigma, shift)))
    want = vjp(tuple(jnp.asarray(c) for c in cts))

    args = [torch.from_numpy(a.copy()).requires_grad_(i != 5) for i, a in enumerate(data)]
    outs = plane_sweep(*args, PAD, True, with_disp)
    assert all(o.requires_grad for o in outs)          # nll_auto's cotangent reaches the images
    got = torch.autograd.grad(
        sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cts)), args[:5])
    for name, g, w in zip(("d_src", "d_tgt", "d_logits", "d_sigma", "d_shift"), got, want):
        w = np.asarray(w)
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("with_disp", [False, True])
def test_nomix_image_cotangents_match_jax_vjp(data, with_disp):
    src, tgt, logits, _, shift, mask = data
    rng = np.random.default_rng(37)
    cts = [rng.standard_normal(s).astype(np.float32)
           for s in ((B, 3, H, W), (B, H, W), (B, H, W))][: 2 + with_disp]

    def jax_f(s, t, lg, sh):
        return fused_plane_sweep_nomix(s, t, lg, sh, jnp.asarray(mask), PAD, True,
                                       KW["n_vertical"], with_disp, KW["rows"],
                                       KW["gp_taps"], KW["nonneg"])

    _, vjp = jax.vjp(jax_f, *(jnp.asarray(a) for a in (src, tgt, logits, shift)))
    want = [np.asarray(w) for w in vjp(tuple(jnp.asarray(c) for c in cts))]
    assert not want[0].any() and not want[1].any()

    args = [torch.from_numpy(a.copy()).requires_grad_() for a in (src, tgt, logits, shift)]
    outs = plane_sweep(args[0], args[1], args[2], None, args[3], torch.from_numpy(mask),
                       PAD, False, with_disp)
    got = torch.autograd.grad(sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cts)),
                              args, allow_unused=True, materialize_grads=True)
    for name, g, w in zip(("d_src", "d_tgt", "d_logits", "d_shift"), got, want):
        if name in ("d_src", "d_tgt"):
            assert not g.any(), name
            continue
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("case", ["nomix", "no_automask", "no_automask_cpu"])
def test_image_grads_refused_where_jax_has_no_mode(data, case):
    """Only the mixture without the automask refuses image gradients (JAX
    asserts), on the CPU as on every device; the no-mixture call passes
    the rules (its images get no cotangent) and the device decides."""
    device = "cpu" if case == "no_automask_cpu" else "meta"
    src, tgt, logits, sigma, shift, mask = (torch.from_numpy(a).to(device) for a in data)
    src.requires_grad_()
    if case == "nomix":
        with pytest.raises(NotImplementedError, match="no kernel for meta"):
            plane_sweep(src, tgt, logits, None, shift, mask, PAD, False, True)
        return
    with pytest.raises(ValueError, match="with_auto=True"):
        plane_sweep(src, tgt, logits, sigma, shift, mask, PAD, False, True)
    # without an image that requires grad the device decides
    if device == "meta":
        with pytest.raises(NotImplementedError, match="no kernel for meta"):
            plane_sweep(src.detach(), tgt, logits, sigma, shift, mask, PAD, False, True)
    else:
        for got, want in zip(plane_sweep(src.detach(), tgt, logits, sigma, shift, mask, PAD,
                                         False, True),
                             plane_sweep_plain(src.detach(), tgt, logits, sigma, shift, mask,
                                               PAD, False, True)):
            torch.testing.assert_close(got, want, rtol=0, atol=0)
