"""Rank processes of the port's spatial-axis tests (``tests/test_torch_spatial.py``).

Each rank is a process of its own (``tests/_torch_ranks.py``: the port and
torch only, a gloo group over a ``file://`` rendezvous), holds its rows of
every image on a ``(D, S)`` mesh (``parallel/mesh.py:make_mesh``) and writes
what it computed to ``rank<r>.pkl``.  The functions that compute an op's or
a step's result (:func:`op_results`, ``tests/_torch_ranks.py:one_step``)
also run in the test's own process without a mesh, where they are the
whole-image op and one process's step.
"""
import dataclasses
import hashlib
import os
import pickle
import time

import numpy as np
import torch
import torch.distributed as dist

from planedepth_tpu_torch import config as tcfg
from planedepth_tpu_torch.data.synthetic import make_stereo_batch
from planedepth_tpu_torch.models.layers import (
    BatchNorm2d,
    Conv2d,
    Conv3x3,
    GlobalAvgPool2d,
    max_pool_3x3_s2,
    resize_bilinear_align_corners,
)
from planedepth_tpu_torch.models.depth_decoder import plane_dists
from planedepth_tpu_torch.ops.losses import smooth_loss_disp
from planedepth_tpu_torch.ops.ssim import ssim
from planedepth_tpu_torch.parallel.halo import (
    gather_rows,
    global_height,
    image_mean,
    own_rows,
    row_halo,
    spatial,
)
from planedepth_tpu_torch.parallel.mesh import make_mesh
from planedepth_tpu_torch.train.step import ModelBundle
from planedepth_tpu_torch.train.trainer import Trainer
from tests._torch_ranks import CPU, finish, join_group, one_step


def _module(build):
    torch.manual_seed(0)
    return build()


# name -> (rows a shard, channels, what the output is, the op): "rows" a
# row-sharded map, ("window", top, bottom) a shard with its halo rows,
# "replicated" the same on every rank, "share" a rank's share of a mean
OPS = {
    "halo_zero_many_hops": (2, 2, ("window", 5, 7), lambda x: row_halo(x, 5, 7, "zero")),
    "halo_reflect_many_hops": (2, 2, ("window", 3, 3), lambda x: row_halo(x, 3, 3, "reflect")),
    "halo_neginf": (2, 2, ("window", 2, 1), lambda x: row_halo(x, 2, 1, "-inf")),
    "conv3x3_stride1": (8, 3, "rows", lambda: Conv2d(3, 4, 3, 1, 1)),
    "conv3x3_stride2": (8, 3, "rows", lambda: Conv2d(3, 4, 3, 2, 1)),
    "stem7x7_stride2": (8, 3, "rows", lambda: Conv2d(3, 4, 7, 2, 3, bias=False)),
    "conv1x1_stride2": (8, 3, "rows", lambda: Conv2d(3, 4, 1, 2, 0)),
    "dilation24": (2, 3, "rows", lambda: Conv2d(3, 4, 3, padding=24, dilation=24)),
    "conv3x3_reflect": (4, 3, "rows", lambda: Conv3x3(3, 4)),
    "maxpool_neginf": (4, 3, "rows", lambda: max_pool_3x3_s2),
    "bilinear_down": (16, 2, "rows", lambda: lambda x: resize_bilinear_align_corners(
        x, (x.shape[-2] // 4, x.shape[-1] // 2))),
    "bilinear_up": (4, 2, "rows", lambda: lambda x: resize_bilinear_align_corners(
        x, (x.shape[-2] * 2, x.shape[-1] + 3))),
    "global_avg_pool": (4, 3, "replicated", lambda: GlobalAvgPool2d()),
    "smoothness": (4, 4, "share", lambda: lambda x: smooth_loss_disp(x[:, :1], x[:, 1:], 0.7)),
    "ssim_reflect": (4, 6, "rows", lambda: lambda x: ssim(x[:, :3], x[:, 3:])),
    "batchnorm_train": (4, 3, "rows", lambda: BatchNorm2d(3)),
    "gather_rows": (4, 3, "replicated", lambda: gather_rows),
    "gather_flip_own_rows": (4, 3, "rows", lambda: lambda x: own_rows(
        torch.flip(gather_rows(x), [-2]) * 1.5)),
    "image_mean": (4, 3, "replicated", lambda: image_mean),
    "plane_dists": (4, 3, "rows", lambda: lambda x: plane_dists(x.abs() + 1.0, WIDTH,
                                                                x.shape[-2])),
    "homography_warp2d": (4, 7, "rows", lambda: homography_warp2d),
}
WIDTH = 7


def homography_warp2d(x):
    """The mono recipe's 2-D warp of one side as ``train/mono.py`` runs it
    on this rank's rows: ``x`` holds the source image, two planes' logits
    and two sigmas; the operands gathered, the homography's ``(dx, dy,
    mask)`` of two tilted planes under a fixed pose computed on the whole
    image, the warp's stacks joined on channels, this rank's rows."""
    from planedepth_tpu_torch.geometry.camera import pixel_intrinsics
    from planedepth_tpu_torch.geometry.pose import transformation_from_parameters
    from planedepth_tpu_torch.ops.warp2d import warp2d
    from planedepth_tpu_torch.train.mono import _side_coords

    B, height, width = x.shape[0], global_height(x.shape[-2]), x.shape[-1]
    K = torch.from_numpy(pixel_intrinsics(width, height)).expand(B, 4, 4)
    pose = transformation_from_parameters(torch.tensor([[[0.01, -0.02, 0.015]]]),
                                          torch.tensor([[[0.05, 0.02, 0.1]]])).expand(B, 4, 4)
    planes = {"distance": torch.tensor([[4.0, 9.0]]).expand(B, 2),
              "norm": torch.nn.functional.normalize(
                  torch.tensor([[[0.0, 0.0, 1.0], [0.0, 0.3, 1.0]]]), dim=-1).expand(B, 2, 3)}
    dx, dy, mask = _side_coords(recipe_config("mono"), planes, -1, {-1: pose}, K,
                                torch.linalg.inv(K), height, width)
    src, logits, sigma = (gather_rows(t) for t in (x[:, :3].detach(), x[:, 3:5],
                                                   x[:, 5:].abs() + 0.1))
    rgb, logit, sig = (own_rows(t) for t in warp2d(src, logits, sigma, dx, dy, mask))
    return torch.cat([rgb.flatten(1, 2), logit, sig], 1)


def _seeded(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def op_input(name, size):
    """The seeded input of ``name`` split over ``size`` ranks."""
    rows, ch, _, _ = OPS[name]
    return _seeded((2, ch, rows * size, WIDTH), 1)


def window_cotangent(shape, rank):
    """The seeded cotangent of rank ``rank``'s halo window."""
    return _seeded(shape, 2 + rank)


def op_results(name, size):
    """The op ``name`` on this process's rows of its seeded input (on
    ``size`` ranks; the whole input without a mesh): its output (a loss's:
    the rank's share) and the input's gradient under a seeded cotangent of
    the whole output (each rank its part), of the rank's window for a
    halo (:func:`window_cotangent`)."""
    _, _, kind, build = OPS[name]
    rank, n_ranks = spatial()
    x_all = op_input(name, size)
    op = build if isinstance(kind, tuple) else _module(build)
    h = x_all.shape[-2] // n_ranks
    x = x_all[..., rank * h:(rank + 1) * h, :].clone().requires_grad_(True)
    y = op(x)
    if kind == "share":
        y.backward()
    elif isinstance(kind, tuple):
        y.backward(window_cotangent(y.shape, rank))
    elif kind == "replicated":
        y.backward(_seeded(y.shape, 2))
    else:
        n = y.shape[-2]
        y.backward(_seeded(y.shape[:-2] + (n * n_ranks, y.shape[-1]), 2)[
            ..., rank * n:(rank + 1) * n, :])
    return {"y": y.detach(), "grad": x.grad}


# --- training steps ----------------------------------------------------------

H, W = 64, 96
LR = 1e-4


def step_config(denseaspp=False, stage3=False, batch_size=4, mesh_shape=()):
    """ResNet-18 with the DepthDecoder's row-coupled parts: the grid's
    encoding at every scale (bilinear), the plane residual (a global mean),
    ground planes (the grid's first and last rows), and under ``denseaspp``
    the dilated convs and channel dropout.  No perceptual net: VGG19's
    convs are ``Conv2d`` and its pools row-local, and the card's spatial
    phase (``chip_smoke.py``) runs it at full size."""
    planes = tcfg.PlaneConfig(disp_levels=7, disp_min=2, disp_max=40, xz_levels=4)
    model = tcfg.ModelConfig(num_layers=18, use_denseaspp=denseaspp, use_mixture_loss=True,
                             plane_residual=True, num_ep=8, planes=planes)
    loss = tcfg.LossConfig(alpha_pc=0.0, self_distillation=1.0 if stage3 else 0.0)
    return tcfg.TrainConfig(model=model, loss=loss, data=tcfg.DataConfig(height=H, width=W),
                            optim=tcfg.OptimConfig(learning_rate=LR), bf16=False,
                            batch_size=batch_size, flip_right=not stage3,
                            fused_sweep=True, mesh_shape=mesh_shape)


def perturbed_state(model, seed):
    """``model``'s state with its BatchNorm statistics and scales and every
    bias drawn from a numpy seed, so that a swapped or dropped term shows."""
    rng = np.random.default_rng(seed)
    draw = lambda f, *a: torch.from_numpy(f(*a)).float()      # noqa: E731
    state = {}
    for k, v in model.state_dict().items():
        if k.endswith("running_mean"):
            v = draw(rng.normal, 0.0, 0.1, v.shape)
        elif k.endswith("running_var"):
            v = draw(rng.uniform, 0.5, 1.5, v.shape)
        elif k.endswith("bias"):
            v = v + draw(rng.normal, 0.0, 0.05, v.shape)
        elif k.endswith("weight") and v.dim() == 1:
            v = v * draw(rng.uniform, 0.8, 1.2, v.shape)
        state[k] = v
    return state


# the recipes beyond the stereo sweep, each one (1, 2) step against one process
RECIPES = ("mono", "mixed", "oracle", "falnet", "pladenet", "render_probability", "yz",
           "alpha_self")
# FalNet and PladeNet: six stride-2 stages, so H % 64 S == 0
H_64 = 128


def recipe_config(name):
    """``step_config`` (batch 2) changed to recipe ``name``: the mono
    homography recipe and the mixed ``disp_warp`` one (sides r, -1, 1: the
    pose nets, the automask, no flip), the oracle view synthesis, FalNet
    (7 planes, no mixture) and PladeNet at ``H_64`` rows,
    ``render_probability`` on vertical planes (float32 compositing is
    ill-posed over ground planes), yz planes, ``alpha_self`` with SSIM."""
    cfg = step_config(batch_size=2)
    model, loss = cfg.model, cfg.loss
    temporal = dict(novel_frame_ids=(-1, 1), flip_right=False,
                    loss=dataclasses.replace(loss, automask=True))
    tall = tcfg.DataConfig(height=H_64, width=W)
    return {
        "mono": lambda: cfg.replace(warp_type="homography_warp", **temporal),
        "mixed": lambda: cfg.replace(**temporal),
        "oracle": lambda: cfg.replace(fused_sweep=False),
        "falnet": lambda: cfg.replace(data=tall, model=tcfg.ModelConfig(
            net_type="FalNet", use_mixture_loss=False, plane_residual=False,
            planes=tcfg.PlaneConfig(disp_levels=7, disp_min=2, disp_max=40, xz_levels=0))),
        "pladenet": lambda: cfg.replace(data=tall, model=dataclasses.replace(
            model, net_type="PladeNet")),
        "render_probability": lambda: cfg.replace(model=dataclasses.replace(
            model, render_probability=True,
            planes=dataclasses.replace(model.planes, xz_levels=0))),
        "yz": lambda: cfg.replace(model=dataclasses.replace(
            model, planes=dataclasses.replace(model.planes, yz_levels=4))),
        "alpha_self": lambda: cfg.replace(loss=dataclasses.replace(loss, alpha_self=0.1,
                                                                   use_ssim=True)),
    }[name]()


def jittered(batch):
    """``batch`` with ``Rt_r`` off the pure x-translation: a 2-D warp's
    integer y coordinates make its bilinear y-gradient a subgradient that
    two correct runs may take on either side."""
    from planedepth_tpu_torch.geometry.pose import transformation_from_parameters

    jitter = transformation_from_parameters(torch.tensor([[[0.002, -0.001, 0.003]]]),
                                            torch.tensor([[[0.001, 0.004, 0.002]]]))[0]
    return dict(batch, Rt_r=np.einsum("bij,jk->bik", batch["Rt_r"], jitter.numpy()))


def recipe_batch(cfg, seed=11):
    """The global batch of ``cfg``'s recipe at its size."""
    batch = make_stereo_batch(cfg.per_step_batch, cfg.data.height, cfg.data.width, seed=seed,
                              novel_frame_ids=cfg.novel_frame_ids)
    return jittered(batch) if cfg.novel_frame_ids else batch


def with_remat(cfg, remat=True):
    return cfg.replace(model=dataclasses.replace(cfg.model, remat=remat))


def without_remat(case):
    """``case`` as one process runs it: the encoder's blocks not recomputed."""
    return dict(case, cfg=with_remat(case["cfg"], False))


def step_cases(mono_weights=None):
    """The steps on a (1, 2) mesh, each from one state and global batch:
    ``plain64`` in float64 (one image and its flip), ``dropout`` and
    ``stage3`` in float32, ``remat`` (``plain64``'s step in float32 with
    the encoder's blocks recomputed); each of :data:`RECIPES` in float32,
    and ``mono64``, the mono recipe with ``alpha_self`` and SSIM, in
    float64.  ``mono_weights`` (the depth model's state and the pose nets',
    from the JAX package's init) replace the mono recipes' seeded ones."""
    cases, states = {}, {}
    for name, cfg in (("plain64", step_config(batch_size=2)),
                      ("dropout", step_config(denseaspp=True)),
                      ("stage3", step_config(stage3=True, batch_size=2)),
                      ("remat", with_remat(step_config(batch_size=2))),
                      *((r, recipe_config(r)) for r in RECIPES)):
        # one state object for the cases of one network (pickled once)
        net = dataclasses.replace(cfg.model, remat=False)
        if net not in states:
            states[net] = perturbed_state(ModelBundle(cfg, CPU).model, 3)
        cases[name] = {"cfg": cfg, "state": states[net], "batch": recipe_batch(cfg),
                       "float64": name == "plain64"}
    if mono_weights is not None:
        cases["mono"].update(mono_weights)
    mono = cases["mono"]
    cases["mono64"] = dict(mono, float64=True, cfg=mono["cfg"].replace(
        loss=dataclasses.replace(mono["cfg"].loss, alpha_self=0.1, use_ssim=True)))
    return cases


# --- the Trainer on a (2, 2) mesh -------------------------------------------

N_TRAIN, N_VAL = 2, 3


class IndexedStereo:
    """Synthetic stereo samples carrying their ``index``."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def getitem(self, index, epoch=0):
        sample = {k: v[0] for k, v in make_stereo_batch(1, H, W, seed=index).items()}
        return dict(sample, index=np.int64(index))


def trainer_config(log_dir, mesh_shape=()):
    cfg = step_config(denseaspp=True, mesh_shape=mesh_shape)
    return cfg.replace(log_dir=log_dir, model_name="spatial", log_frequency=1,
                       data=tcfg.DataConfig(height=H, width=W, num_workers=1),
                       optim=dataclasses.replace(cfg.optim, num_epochs=1))


def drive_trainer(trainer):
    """The epoch's step (its losses and sample indices), the epoch's closing
    validation and the state after it."""
    out = {"losses": [], "indices": []}
    step = trainer.train_step

    def recorded(batch):
        out["indices"].append(batch["index"].tolist())
        metrics = step(batch)
        out["losses"].append({k: float(v) for k, v in metrics.items()})
        return metrics

    trainer.train_step = recorded
    trainer.val = lambda epoch, val=trainer.val: out.setdefault("val_after", val(epoch))
    trainer.train()
    trainer.close()
    out["state"] = {k: v.clone() for k, v in trainer.bundle.model.state_dict().items()}
    out["mesh"] = tuple(trainer.mesh)
    return out


def state_digest(state):
    """A digest of a state dict's names, dtypes, shapes and bytes: equal
    digests, equal states."""
    h = hashlib.sha256()
    for k, v in state.items():
        h.update(f"{k} {v.dtype} {tuple(v.shape)}".encode())
        h.update(v.contiguous().numpy().tobytes())
    return h.hexdigest()


def held(result, rank):
    """``result`` with its state's digest; a rank other than 0 sends the
    digest in place of its state and gradients (rank 0's are held to one
    process, the others' to rank 0's)."""
    result = dict(result, state_digest=state_digest(result["state"]))
    if rank > 0:
        result.pop("state")
        result.pop("grads", None)
        result.pop("pose_grads", None)
    return result


def in_group(rank, size, tmp, name, work):
    """``work()`` in a group of ranks ``0 .. size - 1`` (rendezvous ``name``),
    left after."""
    join_group(rank, size, tmp, name)
    try:
        return work()
    finally:
        dist.destroy_process_group()


def wait_for(path, timeout=120.0):
    """``path`` once it exists (the test writes the cases while the ranks
    train, and renames the file into place when it is whole)."""
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} not written after {timeout} s")
        time.sleep(0.1)
    return path


def spatial_ranks(rank, size, tmp):
    """Four processes, four groups in turn: the Trainer on a (2, 2) mesh of
    all four (then rank 3 alone, in no group, one process's Trainer); then
    two (1, 2) meshes side by side, ranks 0 and 1 and ranks 2 and 3, each
    taking every other case of ``cases.pkl`` (every recipe's step), the
    first every op as well; then ranks 0 to 2, every op at S = 3 (one
    import of the port a process for it all)."""
    assert size == 4

    def trainer(mesh_shape, log):
        return drive_trainer(Trainer(trainer_config(os.path.join(tmp, log), mesh_shape),
                                     datasets=(IndexedStereo(N_TRAIN), IndexedStereo(N_VAL)),
                                     device=CPU))
    out = {"trainer": held(in_group(rank, 4, tmp, "pg4",
                                    lambda: trainer((2, 2), f"rank{rank}")), rank)}
    if rank == 3:
        out["one_trainer"] = trainer((), "one")
    with open(wait_for(os.path.join(tmp, "cases.pkl")), "rb") as f:
        cases = pickle.load(f)
    pair, member = divmod(rank, 2)

    def steps():
        res = {name: held(one_step(dict(case, cfg=dataclasses.replace(
            case["cfg"], mesh_shape=(1, 2))), member, 2), member)
            for name, case in list(cases.items())[pair::2]}
        if pair == 0:
            res["ops"] = {name: op_results(name, 2) for name in OPS}
        return res
    out["s2"] = in_group(member, 2, tmp, f"pg2_{pair}", steps)
    if rank < 3:
        def ops():
            make_mesh(spatial=3)
            return {name: op_results(name, 3) for name in OPS}
        out["s3"] = in_group(rank, 3, tmp, "pg3", ops)
    finish(rank, tmp, out)
