"""Image rows over ranks (the ``spatial`` mesh axis) against one process and the JAX package.

The invariant of ``tests/test_parallel.py``'s spatial mesh: a step over a
``(D, S)`` mesh computes what one process computes on the global batch.
Spawned gloo ranks (``tests/_torch_spatial_ranks.py``: the port alone, one
thread each, float32) hold their rows of every image and are held to

  * (a) the whole-image op, forward and backward, for the halo itself
    (zero, reflect and -inf edges, over more rows than the neighbour
    holds) and every row-coupled op of the stereo path: 3x3 convs at stride
    1 and 2, the 7x7/2 stem, a 1x1/2 conv, a dilation-24 conv on 2-row
    shards, the reflect-padded 3x3, the -inf max-pool, bilinear
    ``align_corners=True`` both ways, the global mean pool, the smoothness
    loss's share, SSIM and train-mode BatchNorm, on S = 2 and S = 3 ranks;
  * (b) one stage-1-shaped step on a (1, 2) mesh (ResNet-18, the grid's
    encoding, plane residuals, ground planes, 64x96) against one process
    on the global batch: in float64 every loss within 1e-12 and every
    gradient leaf within 1e-9 (relative L2); in float32, with DenseASPP's
    dilated convs and dropout, losses at rtol 2e-4, post-Adam parameters
    and BatchNorm statistics within 5e-4, the gradients within 1e-2 (C4);
    both ranks' states bit-equal; at those float32 bounds, the step with
    the encoder's blocks recomputed in the backward pass (``model.remat``:
    their halo exchanges and BatchNorm moments issued again there, the
    statistics updated once) against one process without it;
    ``tests/test_torch_parallel.py`` holds the (1, 2) step to the JAX
    package's step from the same converted weights, beside its
    data-parallel ranks, sharing their JAX step;
  * (c) the Trainer on a (2, 2) mesh of four ranks against one process's
    (run in rank 3 once it has left the group):
    each data rank's samples, the step's losses, the epoch's validation,
    the state after it;
  * (d) one stage-3 step (the frozen teacher, the row shift) on a (1, 2)
    mesh against one process;
  * (e) every other recipe, one (1, 2) step each against one process at
    the float32 bounds of (b): mono (the pose nets' image mean, the
    homography on the whole image, the 2-D warp on gathered rows), mixed
    (side 'r' in the sweep on the shard's rows, the temporal sides' depth
    warps gathered), the oracle view synthesis, FalNet and PladeNet at 128
    rows (H % 64 S), ``render_probability`` (``plane_dists`` in global
    rows), yz planes and ``alpha_self`` (the right image gathered); the
    mono recipe with ``alpha_self`` and SSIM in float64 at (b)'s float64
    bounds, and the float32 mono step's losses held to the JAX package's
    mono step from the same converted weights; the ops of the 2-D warp
    route at S = 2 and 3 in (a): the row gather, a rank's rows of a
    whole-image op, the image mean, ``plane_dists`` and the warp of one
    homography side;
  * (f) the rules: ``H % 32 S``, ``H % 64 S`` for FalNet and PladeNet,
    ``D S`` against the world size.
"""
import dataclasses
import os
import pickle
import shutil

import jax
import numpy as np
import pytest
import torch

from planedepth_tpu import config as jcfg
from planedepth_tpu.train import ModelBundle as JaxBundle
from planedepth_tpu_torch import config as tcfg
from planedepth_tpu_torch.data.loader import EpochSampler
from planedepth_tpu_torch.parallel import mesh
from planedepth_tpu_torch.train.step import ModelBundle, mesh_for, spatial_recipe_gap
from planedepth_tpu_torch.utils.weights import load_jax_params, load_jax_pose_params
from tests import _torch_spatial_ranks as sr
from tests._torch_parity import perturbed_init
from tests._torch_ranks import CPU, collect, one_step, start_ranks

torch.set_num_threads(1)
STEP_CASES = ("plain64", "dropout", "stage3", "mono64", "remat")


def _jax_mono(tc):
    """The JAX package's configuration of the port's mono recipe ``tc``,
    through its oracle view synthesis (``fused_sweep`` off: XLA's
    grid_sample), which tests/test_warp2d_train.py holds to its 2-D warp
    step."""
    m = tc.model
    model = jcfg.ModelConfig(planes=jcfg.PlaneConfig(**dataclasses.asdict(m.planes)),
                             **{k: getattr(m, k) for k in (
                                 "num_layers", "num_ep", "use_denseaspp", "use_mixture_loss",
                                 "plane_residual", "pose_num_layers", "pose_num_ep")})
    return jcfg.TrainConfig(
        model=model, loss=jcfg.LossConfig(alpha_pc=0.0, automask=tc.loss.automask),
        data=jcfg.DataConfig(height=tc.data.height, width=tc.data.width),
        optim=jcfg.OptimConfig(learning_rate=tc.optim.learning_rate), bf16=False,
        fused_sweep=False, batch_size=tc.batch_size, flip_right=tc.flip_right,
        warp_type=tc.warp_type, novel_frame_ids=tc.novel_frame_ids)


def _mono_weights_and_jax_losses(tc, batch):
    """The JAX package's perturbed init of the mono recipe as the port's
    depth model and pose nets (``one_step``'s ``state`` and
    ``pose_states``), and a function that returns its mono step's losses
    on ``batch`` (compiled under ``jax.jit`` when called)."""
    from planedepth_tpu.train.step import process_batch

    bundle = JaxBundle(_jax_mono(tc))
    params, stats, _ = perturbed_init(bundle, 0, tc.data.height, tc.data.width)
    port = ModelBundle(tc, CPU)
    load_jax_params(port.model, params["model"], stats["model"])
    load_jax_pose_params(port.pose_encoder, port.pose, params, stats)
    weights = {"state": port.model.state_dict(),
               "pose_states": {k: getattr(port, k).state_dict() for k in ("pose_encoder", "pose")}}

    def jax_losses():
        step = jax.jit(lambda p, b: process_batch(bundle, p, stats, None, None, b,
                                                  jax.random.PRNGKey(0), train=True)[0])
        return {k: float(v) for k, v in step(params, batch).items()}

    return weights, jax_losses


def _op_reference(name, size):
    """The whole-image op; for a halo, each rank's window of the padded
    input and the gradient of their cotangents' sum."""
    _, _, kind, op = sr.OPS[name]
    if not isinstance(kind, tuple):
        return sr.op_results(name, size)
    _, top, bottom = kind
    x = sr.op_input(name, size).requires_grad_(True)
    padded, h = op(x), x.shape[-2] // size
    windows = [padded[..., t * h:t * h + h + top + bottom, :] for t in range(size)]
    sum((w * sr.window_cotangent(w.shape, t)).sum() for t, w in enumerate(windows)).backward()
    return {"y": [w.detach() for w in windows], "grad": x.grad}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' runs (four processes: the (2, 2) Trainer and, in rank 3
    alone, one process's Trainer; then the S = 2 steps and ops on two (1, 2)
    meshes; then the S = 3 ops), started first; while they run, the cases
    (the mono recipe's weights from the JAX package's init), one process's
    steps, the JAX mono step and the whole-image ops."""
    tmp = tmp_path_factory.mktemp("spatial")
    started = start_ranks(sr.spatial_ranks, 4, tmp)      # the Trainer first
    mono_cfg = sr.recipe_config("mono")
    mono_batch = sr.recipe_batch(mono_cfg)
    mono_weights, jax_losses = _mono_weights_and_jax_losses(mono_cfg, mono_batch)
    cases = sr.step_cases(mono_weights)
    with open(tmp / "cases.part", "wb") as f:
        pickle.dump(cases, f)
    os.replace(tmp / "cases.part", tmp / "cases.pkl")
    one = {name: one_step(sr.without_remat(case), 0, 1) for name, case in cases.items()}
    jax_mono = jax_losses()
    ops = {size: {name: _op_reference(name, size) for name in sr.OPS} for size in (2, 3)}
    got = collect(started, tmp)
    shutil.rmtree(tmp)                  # the cases, the runs' checkpoints: all read
    # rank 0 and rank 1 of the (1, 2) meshes, each holding its cases
    s2 = [{**got[0]["s2"], **got[2]["s2"]}, {**got[1]["s2"], **got[3]["s2"]}]
    assert set(s2[0]) == set(s2[1]) == set(cases) | {"ops"}
    ranks = {"trainer": [r["trainer"] for r in got], "s2": s2,
             "s3": [r["s3"] for r in got[:3]]}
    return {"ranks": ranks, "one": one, "one_trainer": got[3]["one_trainer"], "ops": ops,
            "cases": cases, "jax_mono": jax_mono}


@pytest.mark.parametrize("size", [2, 3])
@pytest.mark.parametrize("name", list(sr.OPS))
def test_halo_ops_equal_the_whole_image_op(runs, name, size):
    """Forward and backward: the ranks' outputs joined are the op's on the
    whole image (a loss: the mean of the ranks' shares; a global pool: the
    same on every rank), and so are the input gradients the ranks' halo
    exchanges send back (a loss's and a pool's: S times, the sum over the
    ranks that DDP's average divides)."""
    _, _, kind, _ = sr.OPS[name]
    ranks = runs["ranks"]["s2" if size == 2 else "s3"]
    got = [r["ops"][name] if size == 2 else r[name] for r in ranks]
    want = runs["ops"][size][name]
    grad = torch.cat([g["grad"] for g in got], -2)
    tol = dict(rtol=1e-5, atol=2e-6)
    if isinstance(kind, tuple):
        for g, w in zip(got, want["y"]):
            torch.testing.assert_close(g["y"], w, rtol=0, atol=0)
    elif kind == "rows":
        torch.testing.assert_close(torch.cat([g["y"] for g in got], -2), want["y"], **tol)
    elif kind == "replicated":
        for g in got:
            torch.testing.assert_close(g["y"], want["y"], **tol)
        grad = grad / size
    else:
        torch.testing.assert_close(sum(g["y"] for g in got) / size, want["y"], **tol)
        grad = grad / size
    torch.testing.assert_close(grad, want["grad"], **tol)


def _assert_step_equals_one_process(runs, case):
    """(b), (d), (e): losses, post-Adam state and averaged gradients (the
    pose nets' too) of the ranks against one process on the global batch,
    the ranks alike.  In float64 every gradient leaf agrees within 1e-9
    (relative L2): the exchanges, the gathers and the loss shares are
    exact.  In float32 the reductions that the shards split (BatchNorm's
    moments, each weight's gradient sum) round in another order, which
    train-mode BatchNorm amplifies in the encoder's gradients as it does
    between the JAX package and the port (ROADMAP C4): 1e-2 there."""
    float64 = runs["cases"][case]["float64"]
    one, (r0, r1) = runs["one"][case], (r[case] for r in runs["ranks"]["s2"])
    assert set(r0["losses"]) == set(one["losses"])
    for k, v in one["losses"].items():
        np.testing.assert_allclose(r0["losses"][k], v, rtol=1e-12 if float64 else 2e-4,
                                   atol=1e-7, err_msg=k)
        assert r1["losses"][k] == r0["losses"][k], k
    assert r1["state_digest"] == r0["state_digest"]
    for k, v in one["state"].items():
        assert float((r0["state"][k].double() - v.double()).abs().max()) < 5e-4, k
    assert r0["sizes"] == one["sizes"]
    assert set(r0["pose_grads"]) == set(one["pose_grads"])
    for k, g in [*one["grads"].items(), *one["pose_grads"].items()]:
        if g is not None and g.abs().max() > 1e-6:
            got = r0["grads"][k] if k in r0["grads"] else r0["pose_grads"][k]
            rel = float((got - g).norm() / g.norm())
            assert rel < (1e-9 if float64 else 1e-2), (k, rel)


@pytest.mark.parametrize("case", STEP_CASES)
def test_one_by_two_mesh_step_equals_one_process(runs, case):
    """(b), (d), the mono recipe in float64, and ``remat`` on the ranks."""
    _assert_step_equals_one_process(runs, case)


@pytest.mark.parametrize("recipe", sr.RECIPES)
def test_spatial_recipe_equals_one_process(runs, recipe):
    """(e): every recipe runs over ranks, for training and evaluation
    (nothing gathers the batch into one process: each rank holds half of
    the rows), and its (1, 2) step is one process's."""
    cfg = runs["cases"][recipe]["cfg"].replace(mesh_shape=(1, 2))
    assert spatial_recipe_gap(cfg) is None and spatial_recipe_gap(cfg, training=False) is None
    _assert_step_equals_one_process(runs, recipe)


def test_one_by_two_mono_step_equals_jax_step(runs):
    """(e): the float32 mono step on a (1, 2) mesh from the JAX package's
    converted weights, held to the JAX mono step's losses at rtol 2e-4, as
    tests/test_torch_mono.py holds one process."""
    r0 = runs["ranks"]["s2"][0]["mono"]
    for k in ("loss/ph_loss", "loss/smooth_loss", "loss/total_loss"):
        np.testing.assert_allclose(r0["losses"][k], runs["jax_mono"][k], rtol=2e-4, err_msg=k)


def test_two_by_two_mesh_trainer_equals_one_process(runs):
    """(c): four ranks, two data ranks of two row shards each.  The spatial
    ranks of a data rank train on the same samples, its sampler's share;
    the data ranks' shares make up one process's batch; the step's losses,
    the epoch's validation (three samples over two data ranks: padded) and
    the final state are one process's (the DDP divisor, the dropout rows of
    the data rank, the gathered rows and samples)."""
    one, ranks = runs["one_trainer"], runs["ranks"]["trainer"]
    for r, run in enumerate(ranks):
        assert run["mesh"] == (r // 2, 2, r % 2, 2)
        want = EpochSampler(sr.N_TRAIN, 1, 2, r // 2, shuffle=True,
                            seed=sr.trainer_config("").seed).host_batches(0)
        assert run["indices"] == want.tolist()
    assert [a + b for a, b in zip(ranks[0]["indices"], ranks[2]["indices"])] == one["indices"]
    for run in ranks:
        assert run["losses"] == ranks[0]["losses"]
        for k, v in one["losses"][0].items():
            np.testing.assert_allclose(run["losses"][0][k], v, rtol=2e-4, atol=1e-7, err_msg=k)
        assert run["val_after"] == ranks[0]["val_after"] and len(run["val_after"]) == 7
        for k, v in one["val_after"].items():
            np.testing.assert_allclose(run["val_after"][k], v, rtol=1e-4, err_msg=k)
        assert run["state_digest"] == ranks[0]["state_digest"]
    for k, v in one["state"].items():
        err = float((ranks[0]["state"][k].double() - v.double()).abs().max())
        assert err < 5e-4, k


@pytest.mark.parametrize("override,match", [
    (dict(data=tcfg.DataConfig(height=96, width=96)), "H % 32S"),
    (dict(), "world size"),
    (dict(mesh_shape=(2, 2)), "world size"),
    (dict(model=tcfg.ModelConfig(net_type="FalNet", use_mixture_loss=False)), "H % 64S"),
    (dict(model=tcfg.ModelConfig(net_type="PladeNet", num_ep=8)), "H % 64S"),
], ids=["height", "one_process", "two_by_two", "falnet_64", "pladenet_64"])
def test_spatial_rules_raise(override, match):
    """(f) in one process: each rule names itself, before any group is
    asked for; nothing falls back to the whole image.  FalNet and
    PladeNet halve the rows six times: 64 rows over 2 ranks are refused
    (128 are taken, (e))."""
    cfg = tcfg.stage1_config(mesh_shape=(1, 2), data=tcfg.DataConfig(height=64, width=96))
    cfg = cfg.replace(**override)
    with pytest.raises(ValueError, match=match):
        mesh_for(cfg)
    if match == "H % 32S":
        with pytest.raises(ValueError, match="32"):
            mesh.make_mesh(spatial=2, height=96)
    if match == "H % 64S":
        with pytest.raises(ValueError, match="64 x S = 128"):
            mesh.make_mesh(spatial=2, height=64, stride=64)


def test_train_cli_takes_mesh_shape(tmp_path, monkeypatch):
    """``--mesh_shape D S`` reaches the Trainer's config: in one process a
    (1, 2) mesh names the world-size rule before any data is read."""
    from planedepth_tpu_torch.cli import train as cli_train

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="world size"):
        cli_train.main(["--stage", "stage1", "--height", "64", "--width", "96",
                        "--mesh_shape", "1", "2", "--log_dir", str(tmp_path)], device=CPU)
