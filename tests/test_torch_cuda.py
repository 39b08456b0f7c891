"""The port's CUDA kernels on the card, each held to its plain PyTorch version
(the plane sweep and the 2-D warp in both of their modes and in float32 and
bf16, the head epilogue with N and N - 1 logit planes; the sweep's
image-gradient backward and its rows wider than one launch), and one
stage-1 (fused and oracle), one stage-3, one mono, one FalNet, one
render_probability, one yz-plane and one yz-plane stage-3 training step on
the card held to the same step on the CPU; and the trainer's side-stream
copy of the next batch.

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


@pytest.mark.parametrize("mixture,bf16", [(True, False), (False, False), (True, True),
                                          (False, True)])
def test_plane_sweep_backward_is_deterministic(cuda, mixture, bf16):
    """No atomics and fixed-order d_shift sums: two backward runs are
    bit-identical, in float32 and in bf16; a float32 row wider than one
    launch takes runs in two column segments (C10) and matches the plain
    version (bf16 rows in segments: test_plane_sweep_wide_rows_match_plain)."""
    from chip_smoke import as_bf16

    inputs = sweep_inputs((2, 63, 4, 1280), 3, cuda)
    if bf16:
        inputs = as_bf16(inputs, (4, 5))
    if not mixture:
        inputs[3] = None
    heads = [t for t in inputs[2:5] if t is not None]
    outs = plane_sweep(*inputs, 328, False, True)
    cts = [torch.randn_like(o) for o in outs]
    first = torch.autograd.grad(outs, heads, cts, retain_graph=True)
    second = torch.autograd.grad(outs, heads, cts)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert first[0].dtype == (torch.bfloat16 if bf16 else torch.float32)
    if bf16:
        return
    wide = sweep_inputs((1, 3, 2, 2052), 3, cuda)
    if not mixture:
        wide[3] = None
    launches = plane_sweep.fwd_launches + plane_sweep.nomix_fwd_launches
    got = plane_sweep(*wide, 328, False, True)
    assert plane_sweep.fwd_launches + plane_sweep.nomix_fwd_launches == launches + 2
    for g, w in zip(got, plane_sweep_plain(*wide, 328, False, True)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


# the image-gradient backward: one, two and four pixels a thread (W up to
# 640, 1280, 2048), N odd and 63, W not a multiple of 4 and below one warp
@pytest.mark.parametrize("shape,with_disp", [((2, 6, 8, 64), True),
                                             ((1, 63, 3, 640), True),
                                             ((1, 14, 3, 1280), False),
                                             ((1, 5, 3, 100), True),
                                             ((2, 7, 3, 37), False),
                                             ((1, 3, 4, 18), True),
                                             ((1, 9, 3, 1281), True),
                                             ((1, 9, 3, 1501), False),
                                             ((1, 63, 2, 2048), True)])
def test_plane_sweep_image_gradients_match_plain(cuda, shape, with_disp):
    """With src and tgt requiring grad the mixture sweep with the automask
    runs the backward's image-gradient instance: d_src, d_tgt, d_logits,
    d_sigma and d_shift at 1e-4 of each gradient's largest magnitude
    against the twin's autograd, with seeded cotangents on every output
    (nll_auto's included); its head gradients equal the head-only
    instance's bit for bit on the same cotangents, and a second backward
    run repeats the first bit for bit.  Every W the forward takes runs."""
    inputs = sweep_inputs(shape, sum(shape) + 1, cuda)
    for t in inputs[:2]:
        t.requires_grad_()
    img, bwd = plane_sweep.img_bwd_launches, plane_sweep.bwd_launches
    got = plane_sweep(*inputs, 328, True, with_disp)
    want = plane_sweep_plain(*inputs, 328, True, with_disp)
    gen = torch.Generator(device=cuda).manual_seed(1)
    cts = [torch.randn(o.shape, generator=gen, device=cuda) for o in got]
    wrt = inputs[:5]
    d_got = torch.autograd.grad(sum((o * c).sum() for o, c in zip(got, cts)), wrt)
    d_want = torch.autograd.grad(sum((o * c).sum() for o, c in zip(want, cts)), wrt)
    torch.cuda.synchronize()
    assert (plane_sweep.img_bwd_launches, plane_sweep.bwd_launches) == (img + 1, bwd)
    for g, w in zip(d_got, d_want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * float(w.abs().max()))
    heads = [t.detach().requires_grad_(i in (2, 3, 4)) for i, t in enumerate(inputs)]
    outs = plane_sweep(*heads, 328, True, with_disp)
    d_heads = torch.autograd.grad(
        [o for o in outs if o.requires_grad],
        heads[2:5], [c for o, c in zip(outs, cts) if o.requires_grad])
    assert all(torch.equal(a, b) for a, b in zip(d_got[2:], d_heads))
    outs = plane_sweep(*inputs, 328, True, with_disp)
    first = torch.autograd.grad(outs, wrt, cts, retain_graph=True)
    assert all(torch.equal(a, b) for a, b in zip(first, torch.autograd.grad(outs, wrt, cts)))


@pytest.mark.parametrize("image", ["src", "tgt"])
@pytest.mark.parametrize("mixture", [True, False])
def test_plane_sweep_refuses_image_gradients(cuda, image, mixture):
    """The image-gradient rules of the JAX package on the card and on the
    CPU alike: the mixture without the automask raises before any launch
    (JAX asserts it); the no-mixture sweep runs its head-only backward once
    and gives the image no cotangent (its JAX backward returns zeros);
    under no_grad nothing is refused."""
    inputs = sweep_inputs((1, 5, 3, 100), 7, cuda)
    if not mixture:
        inputs[3] = None
    idx = ("src", "tgt").index(image)
    inputs[idx].requires_grad_()
    cpu = [None if t is None else t.detach().cpu().requires_grad_(t.requires_grad)
           for t in inputs]
    counts = lambda: (plane_sweep.fwd_launches, plane_sweep.nomix_fwd_launches,
                      plane_sweep.bwd_launches, plane_sweep.nomix_bwd_launches,
                      plane_sweep.img_bwd_launches)
    before = counts()
    if mixture:
        for args in (inputs, cpu):
            with pytest.raises(ValueError, match="with_auto=True"):
                plane_sweep(*args, 16, False, True)
        assert counts() == before
    else:
        for args in (inputs, cpu):
            outs = plane_sweep(*args, 16, False, True)
            grads = torch.autograd.grad(sum(o.sum() for o in outs), (args[idx], args[2]),
                                        allow_unused=True, materialize_grads=True)
            assert not grads[0].any() and grads[1].any()
        torch.cuda.synchronize()
        assert counts() == (before[0], before[1] + 1, before[2], before[3] + 1, before[4])
    with torch.no_grad():
        plane_sweep(*inputs, 16, False, True)

def test_train_step_on_cuda_matches_cpu(cuda):
    """One stage-1-style step (DenseASPP dropout included: both draw their
    masks from the same CPU generator) on the card and on the CPU, held as
    chip_smoke.py holds the full-size model: losses at rtol 1e-3, gradients
    against a float64 step, post-Adam parameters at atol 1e-4."""
    from chip_smoke import check_step_against_cpu

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = stage1_config(
        bf16=False,
        model=ModelConfig(num_layers=18, planes=PlaneConfig(disp_levels=7, disp_max=24,
                                                            xz_levels=3)),
        loss=LossConfig(automask=True), data=DataConfig(64, 96), batch_size=2)
    fwd, bwd = plane_sweep.fwd_launches, plane_sweep.bwd_launches
    worst = check_step_against_cpu(cfg, cuda)
    torch.cuda.synchronize()
    assert (plane_sweep.fwd_launches, plane_sweep.bwd_launches) == (fwd + 1, bwd + 1)
    assert worst["share_of_weights_held_at_atol"] > 0.5


def test_oracle_step_on_cuda_matches_cpu(cuda):
    """The stage-1 step through the oracle view synthesis (``fused_sweep``
    off) with ``use_mom``, held to the CPU as above: no sweep and no warp
    launches; the head epilogue and the disp head each way, and the row
    shifts of the mirror occlusion mask."""
    from chip_smoke import check_step_against_cpu, launch_counts, only

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = stage1_config(
        bf16=False,
        model=ModelConfig(num_layers=18, planes=PlaneConfig(disp_levels=7, disp_max=24,
                                                            xz_levels=3)),
        loss=LossConfig(automask=True, use_mom=True), data=DataConfig(64, 96), batch_size=2,
        fused_sweep=False)
    before = launch_counts()
    worst = check_step_against_cpu(cfg, cuda)
    torch.cuda.synchronize()
    delta = {k: v - before[k] for k, v in launch_counts().items()}
    assert delta == only(head_epilogue_fwd=1, head_epilogue_bwd=1, disp_head_fwd=1,
                         disp_head_bwd=1, row_shift_fwd=4)
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
        bf16=False,
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


# render_probability: N - 1 logit planes beside N mask and sigma planes; the
# 16-byte path (1280, 64) and the scalar path (100, 63); the row-constant
# mask and the yz planes' full one (N = 71)
@pytest.mark.parametrize("shape,full_mask", [((2, 63, 8, 1280), False),
                                             ((1, 5, 7, 100), True),
                                             ((2, 3, 4, 63), False),
                                             ((1, 71, 3, 64), True)])
def test_head_epilogue_n_minus_1_kernels_match_plain(cuda, shape, full_mask):
    """logits (N - 1 planes) and sigma, then their gradients, at rtol = atol
    = 1e-6, with and without the sigma head, aligned and misaligned."""
    b, n, h, w = shape
    rng = np.random.default_rng(sum(shape) + 1)
    raw_l = rng.normal(0, 2, (b, n - 1, h, w)).astype(np.float32)
    raw_s = rng.uniform(-8, 8, shape).astype(np.float32)
    raw_s[:, 0, 0], raw_s[:, -1, -1] = 40.0, -40.0
    cts_np = [rng.normal(0, 1, a.shape).astype(np.float32) for a in (raw_l, raw_s)]
    mask = torch.from_numpy((rng.uniform(0, 1, (b, n, h, w if full_mask else 1)) > 0.3)
                            .astype(np.float32)).to(cuda)

    def aligned(a):
        return torch.from_numpy(a).to(cuda)

    def misaligned(a):              # contiguous, 4 bytes past a 16-byte boundary
        return torch.from_numpy(np.concatenate([[0.0], a.ravel()]).astype(
            np.float32)).to(cuda)[1:].view(a.shape)

    for place in (aligned, misaligned):
        for with_sigma in (True, False):
            k = 1 + with_sigma
            heads = [place(a).requires_grad_() for a in (raw_l, raw_s)][:k]
            cts = [place(a) for a in cts_np][:k]
            sigma = heads[1] if with_sigma else None
            fwd, bwd = head_epilogue.fwd_launches, head_epilogue.bwd_launches
            got = head_epilogue(heads[0], sigma, mask)[:k]
            want = head_epilogue_plain(heads[0], sigma, mask)[:k]
            assert got[0].shape == (b, n - 1, h, w)
            for g, wt in zip(got, want):
                torch.testing.assert_close(g, wt, rtol=1e-6, atol=1e-6)
            d_got = torch.autograd.grad(got, heads, cts)
            d_want = torch.autograd.grad(want, heads, cts)
            torch.cuda.synchronize()
            assert (head_epilogue.fwd_launches, head_epilogue.bwd_launches) == (fwd + 1,
                                                                                bwd + 1)
            for g, wt in zip(d_got, d_want):
                torch.testing.assert_close(g, wt, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="planes beside"):
        head_epilogue(aligned(raw_l[:, :-1]), None, mask)


def _rescue_counts():
    return (warp2d.fwd_launches, warp2d.bwd_launches, head_epilogue.fwd_launches,
            head_epilogue.bwd_launches, plane_sweep.fwd_launches, disp_head.launches,
            disp_head.bwd_launches)


@pytest.mark.parametrize("model_kw", [
    dict(render_probability=True, planes=PlaneConfig(disp_levels=7, disp_max=24,
                                                     xz_levels=0)),
    dict(planes=PlaneConfig(disp_levels=7, disp_max=24, xz_levels=3, yz_levels=4,
                            yz_min=1.0)),
], ids=["render", "yz"])
def test_rescue_step_on_cuda_matches_cpu(cuda, model_kw):
    """One stage-1 step with render_probability, and one with yz side planes,
    through the 2-D warp on the card and on the CPU, held as chip_smoke.py
    holds the full-size model: one warp and one head epilogue each way on
    the card (the head epilogue in its N - 1 mode under render_probability),
    no sweep and no disp head."""
    from chip_smoke import check_step_against_cpu

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = stage1_config(bf16=False, model=ModelConfig(num_layers=18, **model_kw),
                        loss=LossConfig(automask=True), data=DataConfig(64, 128),
                        batch_size=2)
    before = _rescue_counts()
    worst = check_step_against_cpu(cfg, cuda)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_rescue_counts(), before)) == (1, 1, 1, 1, 0, 0, 0)
    assert worst["share_of_weights_held_at_atol"] > 0.5


def test_yz_distillation_step_on_cuda_matches_cpu(cuda):
    """One stage-3 step with yz side planes on the card and on the CPU: the
    teacher shifts its maps per pixel (plain tensor code, no row shift),
    the student goes through the 2-D warp; the head epilogue runs in the
    teacher's forward and the student's, each way in the student's."""
    from chip_smoke import check_step_against_cpu

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = self_distillation_config(
        bf16=False,
        model=ModelConfig(num_layers=18, planes=PlaneConfig(disp_levels=7, disp_max=24,
                                                            xz_levels=3, yz_levels=4,
                                                            yz_min=1.0)),
        data=DataConfig(64, 128), batch_size=2)
    before = _rescue_counts() + (row_shift.launches,)
    worst = check_step_against_cpu(cfg, cuda)
    torch.cuda.synchronize()
    after = _rescue_counts() + (row_shift.launches,)
    assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 2, 1, 0, 0, 0, 0)
    assert worst["share_of_weights_held_at_atol"] > 0.5


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
        bf16=False,
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
        bf16=False,
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


# bf16, the JAX package's default (TrainConfig.bf16): the sweep's and the 2-D
# warp's bf16 instances against their plain versions (chip_smoke.HeldBf16:
# bf16 outputs within one bf16 ulp plus the float32 tolerance, float32
# outputs at it), and rows wider than one sweep launch (C10)
# (H >= 6: chip_smoke.seeded_sweep_inputs masks row 5 whole); one, two and
# four pixels a thread with rows staged by 16-byte copies (W % 8 == 0,
# aligned), and element by element (W odd or not a multiple of 8, or
# ``offset``: logits and sigma 2 bytes off a 16-byte boundary at W = 640)
@pytest.mark.parametrize("shape,mixture,offset", [
    ((2, 6, 8, 64), True, 0), ((1, 63, 6, 640), True, 0), ((1, 9, 6, 1501), True, 0),
    ((2, 7, 6, 37), False, 0), ((1, 49, 6, 640), False, 0), ((1, 3, 6, 2048), True, 0),
    ((1, 14, 6, 1280), True, 0), ((1, 14, 6, 1280), False, 0), ((1, 63, 6, 2048), True, 0),
    ((1, 63, 6, 100), True, 0), ((1, 9, 6, 640), True, 1), ((1, 9, 6, 640), False, 1)])
def test_plane_sweep_bf16_kernels_match_plain(cuda, shape, mixture, offset):
    from chip_smoke import HeldBf16, as_bf16, seeded_sweep_inputs

    inputs = as_bf16(seeded_sweep_inputs(shape, sum(shape), cuda), (4, 5))
    if offset:
        # views of flat buffers at storage offset 1: contiguous, so the
        # wrapper passes them as they are, 2 bytes off 16
        for i in (2, 3):
            buf = torch.zeros(inputs[i].numel() + offset, dtype=torch.bfloat16, device=cuda)
            buf[offset:] = inputs[i].detach().flatten()
            inputs[i] = buf[offset:].view(shape).detach().requires_grad_()
            assert inputs[i].is_contiguous() and inputs[i].data_ptr() % 16 == 2
    if not mixture:
        inputs[3] = None
    name = "bf16_fwd_launches" if mixture else "bf16_nomix_fwd_launches"
    before = getattr(plane_sweep, name)
    got = plane_sweep(*inputs, 328, mixture, True)
    assert getattr(plane_sweep, name) == before + 1 and got[0].dtype == torch.bfloat16
    # the gradients against the plain version anchored at the kernel's rounded
    # reconstruction, which the backward reads (chip_smoke.phase_sweep_bf16)
    HeldBf16().hold(
        got, plane_sweep_plain(*inputs, 328, mixture, True), inputs,
        (2, 3, 4) if mixture else (2, 4),
        ("d_logits", "d_sigma", "d_shift") if mixture else ("d_logits", "d_shift"), 0,
        plain_grad_out=plane_sweep_plain(*inputs, 328, mixture, True, rounded_rgb=got[0]))


@pytest.mark.parametrize("shape,with_sigma", [((2, 5, 7, 200), True), ((1, 3, 16, 130), False),
                                              ((2, 63, 6, 640), True)])
def test_warp2d_bf16_kernels_match_plain(cuda, shape, with_sigma):
    from chip_smoke import HeldBf16, as_bf16, seeded_warp_inputs

    inputs = as_bf16(seeded_warp_inputs(shape, sum(shape), cuda, degenerate=True), (3, 4, 5))
    if not with_sigma:
        inputs[2] = None
    name = "bf16_fwd_launches" if with_sigma else "bf16_nosigma_fwd_launches"
    before = getattr(warp2d, name)
    got = warp2d(*inputs)
    assert getattr(warp2d, name) == before + 1 and got[0].dtype == torch.bfloat16
    HeldBf16().hold(got, warp2d_plain(*inputs), inputs,
                    (1, 2, 3, 4) if with_sigma else (1, 3, 4),
                    ("d_logits", "d_sigma", "d_dx", "d_dy") if with_sigma
                    else ("d_logits", "d_dx", "d_dy"), 0)


# the bf16 forward (csrc/warp2d.cu:warp2d_fwd_bf16_kernel: src packed
# pixel-interleaved with a zero border, four columns a thread with vector
# loads and stores, element by element where W % 4 != 0 or a map is
# misaligned): W odd (61, 97), W = 3 mod 4 (99) and W = 2 mod 4 (130) with
# taps at x0 = W - 1 and -1, y0 = H - 1 and -1, degenerate coordinates,
# more planes than 65535, the mono step's shape; src and the heads
# (``views`` (0, 1, 2)), and dx, dy and mask too, as views whose last
# element ends their allocation
@pytest.mark.parametrize("shape,kw,views", [
    ((2, 5, 7, 61), dict(edges=True), ()),
    ((2, 4, 6, 99), dict(edges=True, degenerate=True), ()),
    ((2, 63, 9, 97), dict(degenerate=True), ()), ((1, 3, 16, 130), dict(edges=True), ()),
    ((2, 3, 24, 100), dict(degenerate=True, dead_plane=True), ()), ((2, 33000, 2, 5), {}, ()),
    ((2, 3, 8, 131), dict(edges=True), (0, 1, 2)), ((2, 3, 8, 128), dict(edges=True), (0, 1, 2)),
    ((2, 3, 8, 128), dict(edges=True), (0, 1, 2, 3, 4, 5)), ((8, 63, 192, 640), {}, ())])
@pytest.mark.parametrize("with_sigma", [True, False])
def test_warp2d_bf16_forward_edges_views_and_repeat(cuda, shape, kw, views, with_sigma):
    """The forward twice (bit-identical), its entry over NaN-filled outputs
    and a garbage scratch (every element written, the wrapper's bits), and
    both directions against the plain version at chip_smoke.HeldBf16's
    bounds; plane 1 of the first image masked whole."""
    from chip_smoke import (HeldBf16, as_bf16, at_allocation_end, fwd_writes_every_element,
                            seeded_warp_inputs)

    inputs = as_bf16(seeded_warp_inputs(shape, sum(shape), cuda, **kw), (3, 4, 5))
    if not with_sigma:
        inputs[2] = None
    inputs[5][0, 1 % shape[1]] = 0.0
    for i in views:
        if inputs[i] is not None:
            inputs[i] = at_allocation_end(inputs[i])
    got = warp2d(*inputs)
    again = warp2d(*inputs)
    assert all(torch.equal(a.view(torch.int16), b.view(torch.int16)) for a, b in zip(got, again))
    fwd_writes_every_element(inputs, got, with_sigma)
    assert (got[1][0, 1 % shape[1]] == 0).all()
    HeldBf16().hold(got, warp2d_plain(*inputs), inputs,
                    (1, 2, 3, 4) if with_sigma else (1, 3, 4),
                    ("d_logits", "d_sigma", "d_dx", "d_dy") if with_sigma
                    else ("d_logits", "d_dx", "d_dy"), 0)


# the bf16 backward (csrc/warp2d.cu:warp2d_bwd_pair_kernel and its rounding):
# odd shapes with degenerate coordinates (W odd: the rounding one pixel a
# thread); planes of only degenerate samples and a plane masked whole; a
# zoom of 200 px; more planes than 65535 (launches in whole images); the
# mono step's shape
@pytest.mark.parametrize("shape,kw", [
    ((2, 5, 7, 200), dict(degenerate=True)), ((1, 3, 16, 130), dict(degenerate=True)),
    ((2, 3, 24, 100), dict(degenerate=True, dead_plane=True)),
    ((2, 3, 48, 200), dict(zoom=200.0)), ((2, 63, 9, 97), {}), ((2, 33000, 2, 5), {}),
    ((8, 63, 192, 640), {})])
@pytest.mark.parametrize("with_sigma", [True, False])
def test_warp2d_bf16_backward_writes_every_element(cuda, shape, kw, with_sigma):
    """The bf16 backward's entry point on outputs filled with NaN and a
    scratch of garbage: no NaN left, d_logits and d_sigma within one bf16
    ulp plus 1e-4 of their largest magnitude of the plain version's
    autograd (chip_smoke.HeldBf16's bound), d_dx and d_dy within 1e-4 of
    theirs; plane 1 of the first image is masked whole (its gradients 0)."""
    from chip_smoke import GRAD_TOL, as_bf16, bf16_ulp, seeded_warp_inputs
    from planedepth_tpu_torch.ops import _build
    from planedepth_tpu_torch.ops.warp2d import scratch_bytes

    inputs = as_bf16(seeded_warp_inputs(shape, sum(shape), cuda, **kw), (3, 4, 5))
    if not with_sigma:
        inputs[2] = None
    inputs[5][0, 1 % shape[1]] = 0.0
    src, logits, sigma, dx, dy, mask = inputs
    wrt = [t for t in inputs[1:5] if t is not None]
    want_out = warp2d_plain(*inputs)
    gen = torch.Generator(device=cuda).manual_seed(1)
    cts = [torch.randn(o.shape, generator=gen, device=cuda).to(o.dtype) for o in want_out]
    want = torch.autograd.grad(want_out, wrt, cts)
    del want_out
    B, N, H, W = shape
    nan = lambda t: torch.full_like(t, float("nan"))
    got = [nan(logits), nan(sigma) if with_sigma else None, nan(dx), nan(dy)]
    scratch = torch.full((scratch_bytes(B, N, H, W, with_sigma),), 0xA5, dtype=torch.uint8,
                         device=cuda)
    cts = cts + [None] * (3 - len(cts))
    _build.launch("pdt_warp2d_bwd_bf16", *(t.detach() if t is not None else None
                                           for t in (src, logits, sigma, dx, dy, mask)),
                  *cts, *got, scratch, B, N, H, W, int(with_sigma))
    torch.cuda.synchronize()
    for name, a, b in zip(("d_logits", "d_sigma", "d_dx", "d_dy"),
                          [g for g in got if g is not None], want):
        assert a.dtype == b.dtype and not torch.isnan(a).any(), name
        err = (a.float() - b.float()).abs()
        ulp = bf16_ulp(b) if a.dtype == torch.bfloat16 else 0.0
        over = float((err - ulp).max()) - GRAD_TOL * float(b.float().abs().max())
        assert over <= 0, (name, over)
    assert (got[0][0, 1 % N] == 0).all()


@pytest.mark.parametrize("shape", [(1, 63, 6, 2560), (1, 14, 6, 4096)])
def test_plane_sweep_wide_rows_match_plain(cuda, shape):
    """C10: the forward, the head-only backward (float32 and bf16) and the
    image-gradient backward of rows wider than one launch, in column
    segments with a right halo, against the plain version."""
    from chip_smoke import Held, HeldBf16, as_bf16, image_grad_inputs, seeded_sweep_inputs

    names = ("d_logits", "d_sigma", "d_shift")
    inputs = seeded_sweep_inputs(shape, sum(shape), cuda)
    fwd = plane_sweep.fwd_launches
    got = plane_sweep(*inputs, 328, True, True)
    assert plane_sweep.fwd_launches - fwd >= 2
    Held().hold(got, plane_sweep_plain(*inputs, 328, True, True), inputs, (2, 3, 4), names, 0)
    inputs = as_bf16(inputs, (4, 5))
    fwd = plane_sweep.bf16_fwd_launches
    got = plane_sweep(*inputs, 328, True, True)
    assert plane_sweep.bf16_fwd_launches - fwd >= 2 and got[0].dtype == torch.bfloat16
    HeldBf16().hold(got, plane_sweep_plain(*inputs, 328, True, True), inputs, (2, 3, 4), names,
                    2, segmented=True,
                    plain_grad_out=plane_sweep_plain(*inputs, 328, True, True,
                                                     rounded_rgb=got[0]))
    inputs = image_grad_inputs(shape, sum(shape) + 1, cuda)
    img = plane_sweep.img_bwd_launches
    Held().hold(plane_sweep(*inputs, 328, True, True),
                plane_sweep_plain(*inputs, 328, True, True), inputs, (0, 1, 2, 3, 4),
                ("d_src", "d_tgt") + names, 1)
    assert plane_sweep.img_bwd_launches - img >= 2          # one a segment


def test_prefetch_to_device_hands_over_the_batches_in_order(cuda):
    """``prefetch_to_device``: the batches copied on a side stream, from
    pinned memory, equal the plain copy of each host batch, in order, and
    are ready on the current stream when handed over (the next batch's copy
    in flight meanwhile); a step that writes into them in place does not
    disturb the next."""
    from planedepth_tpu_torch.data.synthetic import make_stereo_batch
    from planedepth_tpu_torch.parallel.mesh import prefetch_to_device

    hosts = [make_stereo_batch(2, 64, 96, seed=i) for i in range(4)]
    got = []
    for host, device_batch in prefetch_to_device(iter(hosts), cuda):
        for t in device_batch.values():
            t.mul_(1)                        # a kernel on the current stream reads it
        got.append((host, {k: v.cpu() for k, v in device_batch.items()}))
    assert len(got) == len(hosts) and all(h is w for (h, _), w in zip(got, hosts))
    for host, device_batch in got:
        for k, v in host.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            want = t.permute(0, 3, 1, 2) if t.dim() == 4 else t
            assert torch.equal(device_batch[k], want), k


def test_custom_ops_on_cuda_match_their_plain_versions(cuda):
    """The ``planedepth_tpu_torch::`` ops called as ops on CUDA tensors: each
    runs its kernel once (its launch counter moves by one) and equals its
    plain version (the disp head's backward: its written-out adjoint, and
    autograd through ``disp_head_plain``)."""
    from planedepth_tpu_torch.ops.disp_head import disp_head_bwd_plain
    from planedepth_tpu_torch.ops.head_epilogue import head_epilogue_bwd_plain

    ops = torch.ops.planedepth_tpu_torch
    inputs = _head_inputs((2, 63, 8, 200), 11, cuda)
    g = torch.from_numpy(np.random.default_rng(12).normal(0, 1, (2, 1, 8, 200))
                         .astype(np.float32)).to(cuda)
    fwd, bwd = disp_head.launches, disp_head.bwd_launches
    got = ops.disp_head(*inputs)
    d_got = ops.disp_head_bwd(*inputs, g)
    torch.cuda.synchronize()
    assert (disp_head.launches, disp_head.bwd_launches) == (fwd + 1, bwd + 1)
    torch.testing.assert_close(got, disp_head_plain(*inputs), **TOL)
    wrt = [t.clone().requires_grad_() for t in inputs[:3]]
    d_auto = torch.autograd.grad(disp_head_plain(*wrt, inputs[3]), wrt, g)
    for got_d, plain_d, auto_d in zip(d_got, disp_head_bwd_plain(*inputs, g), d_auto):
        scale = float(plain_d.abs().max())
        torch.testing.assert_close(got_d, plain_d, rtol=1e-5, atol=1e-5 * scale)
        torch.testing.assert_close(plain_d, auto_d, rtol=1e-5, atol=1e-5 * scale)

    rng = np.random.default_rng(13)
    shape = (2, 63, 8, 1280)
    raw_l, raw_s, g_l, g_s = (torch.from_numpy(rng.normal(0, 4, shape).astype(np.float32))
                              .to(cuda) for _ in range(4))
    mask = torch.from_numpy((rng.uniform(0, 1, (2, 63, 8, 1)) > 0.3).astype(np.float32)).to(cuda)
    for sigma_in, g_sigma in ((raw_s, g_s), (None, None)):
        fwd, bwd = head_epilogue.fwd_launches, head_epilogue.bwd_launches
        logits, sigma = ops.head_epilogue(raw_l, sigma_in, mask)
        want_l, want_s = head_epilogue_plain(raw_l, sigma_in, mask)
        saved = None if sigma_in is None else sigma
        d_l, d_s = ops.head_epilogue_bwd(g_l, g_sigma, saved, mask)
        torch.cuda.synchronize()
        assert (head_epilogue.fwd_launches, head_epilogue.bwd_launches) == (fwd + 1, bwd + 1)
        plain_d_l, plain_d_s = head_epilogue_bwd_plain(g_l, g_sigma, saved, mask)
        torch.testing.assert_close(logits, want_l, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(d_l, plain_d_l, rtol=1e-6, atol=1e-6)
        if sigma_in is None:
            assert sigma.numel() == 0 and d_s.numel() == 0         # the absent sigma
        else:
            torch.testing.assert_close(sigma, want_s, rtol=1e-6, atol=1e-6)
            torch.testing.assert_close(d_s, plain_d_s, rtol=1e-6, atol=1e-6)


def test_export_on_cuda_runs_the_kernels(cuda):
    """A small model's eval forward exported on the card: the disp-head and
    head-epilogue ops stand in its graph, each call of the program launches
    each kernel once, and it equals the eager forward within 1e-6 of its
    largest disparity."""
    from planedepth_tpu_torch.cli.export import EvalForward, export_program
    from planedepth_tpu_torch.config import TrainConfig

    torch.backends.cudnn.allow_tf32 = False
    model = init_weights_(DepthModel(ModelConfig(num_layers=18)),
                          torch.Generator().manual_seed(0)).to(cuda).eval()
    cfg = TrainConfig(data=DataConfig(height=64, width=192), bf16=False)
    program = export_program(cfg, model, batch_size=2)
    targets = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    assert {"planedepth_tpu_torch.disp_head.default",
            "planedepth_tpu_torch.head_epilogue.default"} <= targets
    rng = np.random.default_rng(1)
    image = torch.from_numpy(rng.random((2, 64, 192, 3), dtype=np.float32)).to(cuda)
    grid = torch.from_numpy(rng.uniform(-1, 1, (2, 64, 192, 2)).astype(np.float32)).to(cuda)
    before = (disp_head.launches, head_epilogue.fwd_launches)
    got = program.module()(image, grid)
    torch.cuda.synchronize()
    assert (disp_head.launches, head_epilogue.fwd_launches) == (before[0] + 1, before[1] + 1)
    with torch.no_grad():
        want = EvalForward(model)(image, grid)
    assert got.shape == (2, 64, 192, 1) and not got.requires_grad
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6 * float(want.abs().max()))
