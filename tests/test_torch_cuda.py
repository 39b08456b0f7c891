"""The port's CUDA kernels on the card, each held to its plain PyTorch version.

These tests need an NVIDIA GPU with nvcc (a CUDA kernel has no CPU mode) and
skip without one.  They import neither JAX nor the JAX package, so they run
on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from planedepth_tpu_torch.config import ModelConfig, PlaneConfig
from planedepth_tpu_torch.models.factory import DepthModel, init_weights_
from planedepth_tpu_torch.ops.disp_head import disp_head, disp_head_plain

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
