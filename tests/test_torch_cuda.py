"""The port's CUDA kernels on the card, each held to its plain PyTorch version,
and one training step on the card held to the same step on the CPU.

These tests need an NVIDIA GPU with nvcc (a CUDA kernel has no CPU mode) and
skip without one.  They import neither JAX nor the JAX package, so they run
on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from planedepth_tpu_torch.config import (
    DataConfig,
    LossConfig,
    ModelConfig,
    PlaneConfig,
    stage1_config,
)
from planedepth_tpu_torch.models.factory import DepthModel, init_weights_
from planedepth_tpu_torch.ops.disp_head import disp_head, disp_head_plain
from planedepth_tpu_torch.ops.plane_sweep import plane_sweep, plane_sweep_plain

pytestmark = pytest.mark.cuda
TOL = dict(rtol=1e-5, atol=1e-5)     # only the f32 summation order differs


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel has no CPU mode")
    return torch.device("cuda")


def _head_inputs(shape, seed, device):
    """(B, N, H, W) heads and (B, H, N) rows from numpy; row 2 fully masked."""
    b, n, h, w = shape
    rng = np.random.default_rng(seed)
    mask = (rng.uniform(0, 1, (b, h, n)) > 0.3).astype(np.float32)
    mask[:, 2, :] = 0.0
    logits = 2.0 * rng.standard_normal((b, n, h, w)).astype(np.float32)
    logits *= np.moveaxis(mask, -1, 1)[..., None]
    sigma = rng.uniform(0.01, 1.0, (b, n, h, w)).astype(np.float32)
    disp_rows = rng.uniform(2.0, 300.0, (b, h, n)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (logits, sigma, disp_rows, mask))


# W not a multiple of the block width, N = 63 (the recipe), N > block width
@pytest.mark.parametrize("shape", [(2, 63, 8, 200), (1, 7, 5, 1280),
                                   (1, 300, 3, 129)])
def test_disp_head_kernel_matches_plain(cuda, shape):
    inputs = _head_inputs(shape, sum(shape), cuda)
    before = disp_head.launches
    got = disp_head(*inputs)
    torch.cuda.synchronize()
    assert disp_head.launches == before + 1
    torch.testing.assert_close(got, disp_head_plain(*inputs), **TOL)
    assert (got[:, :, 2] == 0).all()


def test_disp_head_rejects_what_the_kernel_does_not_take(cuda):
    logits, sigma, disp_rows, mask = _head_inputs((1, 4, 3, 16), 0, cuda)
    with pytest.raises(NotImplementedError, match="backward"):
        disp_head(logits.clone().requires_grad_(), sigma, disp_rows, mask)
    with pytest.raises(ValueError, match="contiguous"):
        disp_head(logits.transpose(2, 3).contiguous().transpose(2, 3),
                  sigma, disp_rows, mask)
    with pytest.raises(TypeError):
        disp_head(logits.double(), sigma, disp_rows, mask)


def test_depth_model_on_cuda_matches_cpu(cuda):
    """A small model forward on the card goes through the kernel and agrees
    with the same model on the CPU (plain head) at the model tolerance."""
    torch.backends.cudnn.allow_tf32 = False
    cfg = ModelConfig(num_layers=18, planes=PlaneConfig())
    model = init_weights_(DepthModel(cfg), torch.Generator().manual_seed(0)).eval()
    rng = np.random.default_rng(0)
    image = torch.from_numpy(rng.random((2, 3, 64, 192), dtype=np.float32))
    gx, gy = np.meshgrid(np.linspace(-1, 1, 192), np.linspace(-1, 1, 64))
    grid = torch.from_numpy(np.stack([gx, gy])[None].repeat(2, 0).astype(np.float32))
    with torch.inference_mode():
        want = model(image, grid)
        model.to(cuda)
        before = disp_head.launches
        got = model(image.to(cuda), grid.to(cuda))
        torch.cuda.synchronize()
    assert disp_head.launches == before + 1
    for key in ("logits", "sigma", "probability", "disp"):
        torch.testing.assert_close(got[key].cpu(), want[key], rtol=1e-3, atol=1e-3,
                                   msg=key)


def sweep_inputs(shape, seed, device):
    """Step-like sweep operands from numpy: row-constant vertical shifts up to
    ~320, per-row ground shifts, shifts past the W edge, one fully masked
    row (2); logits, sigma and shift require grad."""
    b, n, h, w = shape
    rng = np.random.default_rng(seed)
    nv = max(1, (7 * n) // 9)
    vert = np.repeat(rng.uniform(0.0, 320.0, (b, 1, nv)), h, 1)
    vert[:, :, 0] = w - 1.5
    ground = (rng.uniform(0.0, 40.0, (b, 1, n - nv))
              + rng.uniform(0.0, 0.9, (b, 1, n - nv)) * np.arange(h)[None, :, None])
    shift = np.concatenate([vert, ground], -1).astype(np.float32)
    mask = (rng.uniform(0, 1, (b, h, n)) > 0.2).astype(np.float32)
    mask[:, :, :nv] = 1.0
    mask[:, 2 % h] = 0.0
    logits = 2.0 * rng.standard_normal((b, n, h, w)).astype(np.float32)
    logits *= np.moveaxis(mask, -1, 1)[..., None]
    sigma = rng.uniform(0.0, 1.0, (b, n, h, w)).astype(np.float32)
    src, tgt = (rng.uniform(0, 1, (b, 3, h, w)).astype(np.float32) for _ in range(2))
    arrays = (src, tgt, logits, sigma, shift, mask)
    return [torch.from_numpy(a).to(device).requires_grad_(i in (2, 3, 4))
            for i, a in enumerate(arrays)]


# W below, at and above the 512 threads of a block; N = 63 (the recipe)
@pytest.mark.parametrize("shape,with_auto", [((2, 6, 8, 64), True),
                                             ((2, 63, 4, 640), False),
                                             ((1, 14, 3, 1280), True),
                                             ((1, 5, 3, 100), False)])
def test_plane_sweep_kernels_match_plain(cuda, shape, with_auto):
    """Forward outputs at atol = rtol = 1e-5; d_logits, d_sigma, d_shift at
    1e-4 of each gradient's largest magnitude (d_shift sums W terms in
    another order)."""
    inputs = sweep_inputs(shape, sum(shape), cuda)
    fwd, bwd = plane_sweep.fwd_launches, plane_sweep.bwd_launches
    got = plane_sweep(*inputs, 328, with_auto, True)
    want = plane_sweep_plain(*inputs, 328, with_auto, True)
    assert plane_sweep.fwd_launches == fwd + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    gen = torch.Generator(device=cuda).manual_seed(0)
    cts = [torch.randn(o.shape, generator=gen, device=cuda) for o in got]
    heads = inputs[2:5]
    d_got = torch.autograd.grad(sum((o * c).sum() for o, c in zip(got, cts)), heads)
    d_want = torch.autograd.grad(sum((o * c).sum() for o, c in zip(want, cts)), heads)
    torch.cuda.synchronize()
    assert plane_sweep.bwd_launches == bwd + 1
    for g, w in zip(d_got, d_want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * float(w.abs().max()))


def test_train_step_on_cuda_matches_cpu(cuda):
    """One stage-1-style step (DenseASPP dropout included: both draw their
    masks from the same CPU generator) on the card and on the CPU, held as
    chip_smoke.py holds the full-size model: losses at rtol 1e-3, gradients
    against a float64 step, post-Adam parameters at atol 1e-4."""
    from chip_smoke import check_step_against_cpu

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = stage1_config(
        model=ModelConfig(num_layers=18, planes=PlaneConfig(disp_levels=7, disp_max=24,
                                                            xz_levels=3)),
        loss=LossConfig(automask=True), data=DataConfig(64, 96), batch_size=2)
    fwd, bwd = plane_sweep.fwd_launches, plane_sweep.bwd_launches
    worst = check_step_against_cpu(cfg, cuda)
    torch.cuda.synchronize()
    assert (plane_sweep.fwd_launches, plane_sweep.bwd_launches) == (fwd + 1, bwd + 1)
    assert worst["share_of_weights_held_at_atol"] > 0.5
