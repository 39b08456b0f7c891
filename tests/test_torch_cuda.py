"""The port's CUDA kernels on the card, each held to its plain PyTorch version
(the plane sweep and the 2-D warp in both of their modes), and one stage-1,
one stage-3, one mono and one FalNet training step on the card held to the
same step on the CPU.

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
    mono_config,
    self_distillation_config,
    stage1_config,
)
from planedepth_tpu_torch.models.factory import DepthModel, init_weights_
from planedepth_tpu_torch.ops.disp_head import disp_head, disp_head_plain
from planedepth_tpu_torch.ops.head_epilogue import head_epilogue, head_epilogue_plain
from planedepth_tpu_torch.ops.plane_sweep import plane_sweep, plane_sweep_plain
from planedepth_tpu_torch.ops.row_shift import row_shift, row_shift_plain, shift_limit
from planedepth_tpu_torch.ops.warp2d import warp2d, warp2d_plain

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
    with pytest.raises(NotImplementedError, match="mask"):
        disp_head(logits, sigma, disp_rows, mask.clone().requires_grad_())
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


# one, two and four pixels a thread (W up to 1024, 1280, 2048); N = 63 (the
# recipe) and N odd (not a multiple of the planes a barrier); W not a
# multiple of 4 (4-byte copies) and below one warp
@pytest.mark.parametrize("shape,with_auto", [((2, 6, 8, 64), True),
                                             ((2, 63, 4, 640), False),
                                             ((1, 14, 3, 1280), True),
                                             ((1, 5, 3, 100), False),
                                             ((1, 9, 3, 1501), True),
                                             ((2, 7, 3, 37), False),
                                             ((1, 63, 2, 2048), False),
                                             ((1, 3, 4, 18), True)])
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


@pytest.mark.parametrize("mixture", [True, False])
def test_plane_sweep_backward_is_deterministic(cuda, mixture):
    """No atomics and fixed-order d_shift sums: two backward runs are
    bit-identical; a row wider than the kernels take raises."""
    inputs = sweep_inputs((2, 63, 4, 1280), 3, cuda)
    if not mixture:
        inputs[3] = None
    heads = [t for t in inputs[2:5] if t is not None]
    outs = plane_sweep(*inputs, 328, False, True)
    cts = [torch.randn_like(o) for o in outs]
    first = torch.autograd.grad(outs, heads, cts, retain_graph=True)
    second = torch.autograd.grad(outs, heads, cts)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    wide = sweep_inputs((1, 3, 2, 2052), 3, cuda)
    with pytest.raises(ValueError, match="wider"):
        plane_sweep(*wide, 328, False, True)


@pytest.mark.parametrize("image", ["src", "tgt"])
@pytest.mark.parametrize("mixture", [True, False])
def test_plane_sweep_refuses_image_gradients(cuda, image, mixture):
    """The kernels compute no image gradient: an image that requires grad
    raises, naming the unported image_grads mode, before any launch (the
    CPU path differentiates it); under no_grad nothing is lost."""
    inputs = sweep_inputs((1, 5, 3, 100), 7, cuda)
    if not mixture:
        inputs[3] = None
    inputs[("src", "tgt").index(image)].requires_grad_()
    launches = (plane_sweep.fwd_launches, plane_sweep.nomix_fwd_launches)
    with pytest.raises(NotImplementedError, match="image_grads"):
        plane_sweep(*inputs, 16, False, True)
    assert (plane_sweep.fwd_launches, plane_sweep.nomix_fwd_launches) == launches
    with torch.no_grad():
        plane_sweep(*inputs, 16, False, True)
    cpu = [None if t is None else t.detach().cpu().requires_grad_(t.requires_grad)
           for t in inputs]
    outs = plane_sweep(*cpu, 16, False, True)
    grad = torch.autograd.grad(sum(o.sum() for o in outs),
                               cpu[("src", "tgt").index(image)])[0]
    assert grad.abs().sum() > 0


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


# W: the scalar path (W % 4 != 0), the 16-byte path (1280, 64), and a row
# narrower than the block; pads 16 (clip 126) and 328 (the recipe, clip 382)
@pytest.mark.parametrize("shape,pad", [((2, 63, 8, 1280), 328), ((1, 5, 7, 100), 16),
                                       ((2, 3, 4, 64), 16), ((1, 4, 3, 130), 16)])
def test_row_shift_kernel_matches_plain(cuda, shape, pad):
    """Signed shifts, integers, past both W edges and beyond the clip at
    both ends; a sliced (misaligned) input takes the scalar path."""
    b, n, h, w = shape
    rng = np.random.default_rng(sum(shape))
    lim = shift_limit(pad)
    maps = torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32)).to(cuda)
    shift = rng.uniform(-1.2 * lim, 1.2 * lim, (b, h, n))
    shift[:, :, 0] = np.round(shift[:, :, 0])
    shift[:, 0, 1], shift[:, -1, 1] = lim + 3.5, -(lim + 9.25)
    shift = torch.from_numpy(shift.astype(np.float32)).to(cuda)
    before = row_shift.launches
    got = row_shift(maps, shift, pad)
    torch.cuda.synchronize()
    assert row_shift.launches == before + 1
    torch.testing.assert_close(got, row_shift_plain(maps, shift, pad), rtol=1e-5, atol=1e-5)
    sliced = torch.from_numpy(rng.uniform(-1, 1, (b * n * h * w + 1,)).astype(np.float32))
    sliced = sliced.to(cuda)[1:].view(shape)                 # 4-byte aligned only
    torch.testing.assert_close(row_shift(sliced, shift, pad),
                               row_shift_plain(sliced, shift, pad), rtol=1e-5, atol=1e-5)


def test_row_shift_refuses_a_gradient(cuda):
    maps = torch.zeros(1, 2, 3, 8, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="forward only"):
        row_shift(maps, torch.zeros(1, 3, 2, device=cuda), 16)


def test_distillation_step_on_cuda_matches_cpu(cuda):
    """One stage-3 step (the frozen teacher with weights of its own, its
    5 row shifts and disp head) on the card and on the CPU, held as
    chip_smoke.py holds it."""
    from chip_smoke import check_step_against_cpu

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = self_distillation_config(
        model=ModelConfig(num_layers=18, planes=PlaneConfig(disp_levels=7, disp_max=24,
                                                            xz_levels=3)),
        data=DataConfig(64, 96), batch_size=2)
    def counts():
        return (row_shift.launches, disp_head.launches, plane_sweep.fwd_launches,
                head_epilogue.fwd_launches, head_epilogue.bwd_launches)

    before = counts()
    worst = check_step_against_cpu(cfg, cuda)
    torch.cuda.synchronize()
    # the teacher: 5 row shifts, its disp head and head epilogue; the
    # student: the sweep and the head epilogue, forward and backward
    assert tuple(a - b for a, b in zip(counts(), before)) == (5, 1, 1, 2, 1)
    assert worst["share_of_weights_held_at_atol"] > 0.5


# W: the 16-byte path (1280, 64) and the scalar path (W % 4 != 0); the
# row-constant mask of the vertical and ground planes and a full mask
@pytest.mark.parametrize("shape,full_mask", [((2, 63, 8, 1280), False),
                                             ((1, 5, 7, 100), True),
                                             ((2, 3, 4, 63), False),
                                             ((1, 4, 3, 64), True)])
def test_head_epilogue_kernels_match_plain(cuda, shape, full_mask):
    """logits and sigma, then d_raw_logits and d_raw_sigma from autograd
    with seeded cotangents, at rtol = atol = 1e-6; raw sigmas past both
    ends of the clip; a sliced (misaligned) input takes the scalar path."""
    b, n, h, w = shape
    rng = np.random.default_rng(sum(shape))
    raw_s = rng.uniform(-8, 8, shape).astype(np.float32)
    raw_s[:, 0, 0], raw_s[:, -1, -1] = 40.0, -40.0
    heads_np = (rng.normal(0, 2, shape).astype(np.float32), raw_s)
    cts_np = [rng.normal(0, 1, shape).astype(np.float32) for _ in range(2)]
    mask = torch.from_numpy((rng.uniform(0, 1, (b, n, h, w if full_mask else 1)) > 0.3)
                            .astype(np.float32)).to(cuda)

    def aligned(a):
        return torch.from_numpy(a).to(cuda)

    def misaligned(a):              # contiguous, 4 bytes past a 16-byte boundary
        return torch.from_numpy(np.concatenate([[0.0], a.ravel()]).astype(
            np.float32)).to(cuda)[1:].view(a.shape)

    for place in (aligned, misaligned):
        heads = [place(a).requires_grad_() for a in heads_np]
        cts = [place(a) for a in cts_np]
        fwd, bwd = head_epilogue.fwd_launches, head_epilogue.bwd_launches
        got = head_epilogue(*heads, mask)
        want = head_epilogue_plain(*heads, mask)
        for g, wt in zip(got, want):
            torch.testing.assert_close(g, wt, rtol=1e-6, atol=1e-6)
        d_got = torch.autograd.grad(got, heads, cts)
        d_want = torch.autograd.grad(want, heads, cts)
        torch.cuda.synchronize()
        assert (head_epilogue.fwd_launches, head_epilogue.bwd_launches) == (fwd + 1, bwd + 1)
        for g, wt in zip(d_got, d_want):
            torch.testing.assert_close(g, wt, rtol=1e-6, atol=1e-6)
    raw_l = aligned(heads_np[0])
    logits, sigma = head_epilogue(raw_l, None, mask)             # no sigma head
    assert sigma is None
    torch.testing.assert_close(logits, raw_l * mask, rtol=0, atol=0)


# the recipe's N = 63; W not a multiple of the 128-pixel tile, narrower than
# it and not a multiple of 4; N = 94, 95 (one chunk of staged planes) and
# 127 (two chunks)
@pytest.mark.parametrize("shape", [(2, 63, 8, 200), (1, 7, 5, 1280), (1, 94, 3, 129),
                                   (1, 95, 3, 129), (1, 127, 4, 200), (2, 63, 3, 37)])
def test_disp_head_backward_kernel_matches_plain(cuda, shape):
    """d_logits, d_sigma and d_disp_rows against autograd through
    ``disp_head_plain`` at 1e-5 of each gradient's largest magnitude (the
    per-row sum over W runs in another order); the fully masked row 2 gets
    zero adjoints."""
    inputs = list(_head_inputs(shape, sum(shape), cuda))
    for t in inputs[:3]:
        t.requires_grad_()
    g = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (shape[0], 1, shape[2], shape[3])).astype(np.float32)).to(cuda)
    fwd, bwd = disp_head.launches, disp_head.bwd_launches
    d_got = torch.autograd.grad(disp_head(*inputs), inputs[:3], g)
    torch.cuda.synchronize()
    assert (disp_head.launches, disp_head.bwd_launches) == (fwd + 1, bwd + 1)
    d_want = torch.autograd.grad(disp_head_plain(*inputs), inputs[:3], g)
    for a, b in zip(d_got, d_want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * float(b.abs().max()))
    assert (d_got[0][:, :, 2] == 0).all() and (d_got[2][:, 2] == 0).all()


def test_disp_head_backward_is_deterministic(cuda):
    """Two backward runs give bit-identical gradients: the per-row sums of
    d_disp_rows run in a fixed order, with no atomics."""
    inputs = list(_head_inputs((2, 63, 4, 300), 3, cuda))
    for t in inputs[:3]:
        t.requires_grad_()
    out = disp_head(*inputs)
    g = torch.randn_like(out)
    first = torch.autograd.grad(out, inputs[:3], g, retain_graph=True)
    second = torch.autograd.grad(out, inputs[:3], g)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


# zooms up to 200 px at the edges; planes and half-planes of only degenerate
# samples; more planes than the grid's z axis takes (B * N > 65535)
@pytest.mark.parametrize("shape,kw", [((2, 3, 48, 200), dict(zoom=200.0)),
                                      ((2, 3, 24, 100), dict(degenerate=True,
                                                             dead_plane=True)),
                                      ((2, 33000, 2, 5), {})])
@pytest.mark.parametrize("with_sigma", [True, False])
def test_warp2d_backward_wide_zoom_degenerate_planes_and_many_planes(cuda, shape, kw,
                                                                     with_sigma):
    """Both modes at the tolerances of test_warp2d_kernels_match_plain, on the
    cases that stress the scatter and the grid."""
    from chip_smoke import seeded_warp_inputs

    inputs = seeded_warp_inputs(shape, 5, cuda, **kw)
    if not with_sigma:
        inputs[2] = None
    wrt = [t for t in inputs[1:5] if t is not None]
    got = warp2d(*inputs)
    want = warp2d_plain(*inputs)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    gen = torch.Generator(device=cuda).manual_seed(0)
    cts = [torch.randn(o.shape, generator=gen, device=cuda) for o in got]
    d_got = torch.autograd.grad(got, wrt, cts)
    d_want = torch.autograd.grad(want, wrt, cts)
    torch.cuda.synchronize()
    for g, w in zip(d_got, d_want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * float(w.abs().max()))


# W below, at and not a multiple of the 128-thread block
@pytest.mark.parametrize("shape", [(2, 5, 7, 200), (1, 3, 16, 128), (2, 4, 9, 64)])
@pytest.mark.parametrize("degenerate", [False, True])
def test_warp2d_kernels_match_plain(cuda, shape, degenerate):
    """rgb, logit and sigma at atol = rtol = 1e-5; d_logits, d_sigma (summed
    by atomics in no fixed order), d_dx and d_dy at 1e-4 of each gradient's
    largest magnitude; nothing non-finite from degenerate coordinates."""
    from chip_smoke import seeded_warp_inputs

    inputs = seeded_warp_inputs(shape, sum(shape) + degenerate, cuda, degenerate)
    fwd, bwd = warp2d.fwd_launches, warp2d.bwd_launches
    got = warp2d(*inputs)
    want = warp2d_plain(*inputs)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    gen = torch.Generator(device=cuda).manual_seed(0)
    cts = [torch.randn(o.shape, generator=gen, device=cuda) for o in got]
    d_got = torch.autograd.grad(got, inputs[1:5], cts)
    d_want = torch.autograd.grad(want, inputs[1:5], cts)
    torch.cuda.synchronize()
    assert (warp2d.fwd_launches, warp2d.bwd_launches) == (fwd + 1, bwd + 1)
    for g, w in zip(d_got, d_want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * float(w.abs().max()))


def test_mono_step_on_cuda_matches_cpu(cuda):
    """One homography step (pose nets, sides r, -1, 1) on the card and on the
    CPU, held as chip_smoke.py holds the full-size model: 3 warps and 1 disp
    head forward and backward on the card."""
    from chip_smoke import check_step_against_cpu

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = mono_config(
        model=ModelConfig(num_layers=18, planes=PlaneConfig(disp_levels=7, disp_max=24,
                                                            xz_levels=3)),
        data=DataConfig(64, 128), batch_size=2)

    def counts():
        return (warp2d.fwd_launches, warp2d.bwd_launches, disp_head.launches,
                disp_head.bwd_launches, plane_sweep.fwd_launches)

    before = counts()
    worst = check_step_against_cpu(cfg, cuda)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(counts(), before)) == (3, 3, 1, 1, 0)
    assert worst["share_of_weights_held_at_atol"] > 0.5


@pytest.mark.parametrize("shape,with_disp", [((2, 6, 8, 64), True), ((2, 49, 4, 640), False),
                                             ((1, 14, 3, 1280), True), ((1, 5, 3, 100), True),
                                             ((1, 9, 3, 1501), False), ((2, 7, 3, 37), True)])
def test_plane_sweep_nomix_kernels_match_plain(cuda, shape, with_disp):
    """The no-mixture instances (sigma=None): forward at atol = rtol = 1e-5,
    d_logits and d_shift at 1e-4 of their largest magnitude; they count
    apart from the mixture kernels."""
    inputs = sweep_inputs(shape, sum(shape) + 1, cuda)
    inputs[3] = None                                         # no sigma operand
    counts = lambda: (plane_sweep.fwd_launches, plane_sweep.bwd_launches,
                      plane_sweep.nomix_fwd_launches, plane_sweep.nomix_bwd_launches)
    before = counts()
    got = plane_sweep(*inputs, 328, False, with_disp)
    want = plane_sweep_plain(*inputs, 328, False, with_disp)
    assert len(got) == 2 + with_disp
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    gen = torch.Generator(device=cuda).manual_seed(1)
    cts = [torch.randn(o.shape, generator=gen, device=cuda) for o in got]
    heads = (inputs[2], inputs[4])
    d_got = torch.autograd.grad(sum((o * c).sum() for o, c in zip(got, cts)), heads)
    d_want = torch.autograd.grad(sum((o * c).sum() for o, c in zip(want, cts)), heads)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(counts(), before)) == (0, 0, 1, 1)
    for g, w in zip(d_got, d_want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * float(w.abs().max()))
    with pytest.raises(ValueError, match="automask"):
        plane_sweep(*inputs, 328, True, with_disp)


@pytest.mark.parametrize("shape", [(2, 5, 7, 200), (1, 3, 16, 128), (2, 4, 9, 64)])
@pytest.mark.parametrize("degenerate", [False, True])
def test_warp2d_nosigma_kernels_match_plain(cuda, shape, degenerate):
    """The instances without sigma: rgb and logit at atol = rtol = 1e-5,
    d_logits, d_dx, d_dy at 1e-4 of their largest magnitude; they count
    apart from the sigma kernels."""
    from chip_smoke import seeded_warp_inputs

    inputs = seeded_warp_inputs(shape, sum(shape) + 7 + degenerate, cuda, degenerate)
    inputs[2] = None
    counts = lambda: (warp2d.fwd_launches, warp2d.bwd_launches,
                      warp2d.nosigma_fwd_launches, warp2d.nosigma_bwd_launches)
    before = counts()
    got = warp2d(*inputs)
    want = warp2d_plain(*inputs)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    gen = torch.Generator(device=cuda).manual_seed(0)
    cts = [torch.randn(o.shape, generator=gen, device=cuda) for o in got]
    wrt = (inputs[1], inputs[3], inputs[4])
    d_got = torch.autograd.grad(got, wrt, cts)
    d_want = torch.autograd.grad(want, wrt, cts)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(counts(), before)) == (0, 0, 1, 1)
    for g, w in zip(d_got, d_want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * float(w.abs().max()))


def test_falnet_step_on_cuda_matches_cpu(cuda):
    """One FalNet stereo step (the no-mixture sweep, VGG19) on the card and
    on the CPU, held as chip_smoke.py holds the full-size model: one
    no-mixture sweep each way on the card, no other kernel."""
    from chip_smoke import check_step_against_cpu

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = stage1_config(
        model=ModelConfig(net_type="FalNet", use_mixture_loss=False, plane_residual=False,
                          planes=PlaneConfig(disp_levels=7, disp_max=24, xz_levels=0)),
        loss=LossConfig(automask=True), data=DataConfig(64, 96), batch_size=2)

    def counts():
        return (plane_sweep.nomix_fwd_launches, plane_sweep.nomix_bwd_launches,
                plane_sweep.fwd_launches, disp_head.launches, head_epilogue.fwd_launches)

    before = counts()
    worst = check_step_against_cpu(cfg, cuda)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(counts(), before)) == (1, 1, 0, 0, 0)
    assert worst["share_of_weights_held_at_atol"] > 0.5
