"""The port's data parallelism against one process and against the JAX package.

The invariant of ``tests/test_parallel.py``: a step over ranks computes what
one process computes on the global batch.  Two gloo ranks (spawned
processes that import the port alone, ``tests/_torch_ranks.py``) each take
one stage-1-shaped step (flip_right, the fused sweep's mixture NLL,
smoothness, Adam; ResNet-18, 9 planes, 64x96, float32: ``test_parallel.py``'s
``_cfg()``) on their half of a global batch of 2 (4 images after the flip),
and are held to

  * the port's step on the whole batch in this process, to that file's
    bounds: losses at rtol 2e-4, post-Adam parameters and BatchNorm running
    statistics within 5e-4, and each leaf's gradient, averaged over the
    ranks, within 1e-4 relative L2; with DenseASPP's channel dropout on as well
    (each rank's masks are its rows of the global batch's); with the depth
    encoder's blocks recomputed in the backward pass (``model.remat``: the
    global moments' all-reduce issued again there, the statistics updated
    once) against the one process without it; a parameter no
    forward reaches keeps no gradient and its value, as in one process; the
    two ranks' states are bit-equal;
  * the JAX package's ``make_train_step`` under ``jax.jit`` on the whole
    batch from the same converted weights (dropout off), with the batch
    and with, on a (1, 2) mesh, the images' rows over the two ranks, as
    ``tests/test_torch_train_step.py`` holds the one-process step: losses at
    rtol 2e-4, post-Adam parameters at 5e-5 where the step's direction is
    fixed, BatchNorm statistics with torch's unbiased variance over the
    global count.

The sampler's host sharding is held to the JAX sampler bit for bit.
"""
import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planedepth_tpu import config as jcfg
from planedepth_tpu.data import loader as jloader
from planedepth_tpu.data.synthetic import make_stereo_batch
from planedepth_tpu.train import ModelBundle as JaxBundle
from planedepth_tpu.train import create_train_state
from planedepth_tpu.train import make_optimizer as jax_make_optimizer
from planedepth_tpu.train import make_train_step as jax_make_train_step
from planedepth_tpu_torch import config as tcfg
from planedepth_tpu_torch.data import loader as tloader
from planedepth_tpu_torch.models.factory import DepthModel
from planedepth_tpu_torch.parallel import mesh
from planedepth_tpu_torch.train.flip import add_flip_right_inputs
from planedepth_tpu_torch.train.step import ModelBundle, batch_to_tensors, network_rows
from planedepth_tpu_torch.utils.weights import load_jax_params
from tests._torch_parity import _param_rule, _perturb, _stats_rule, assert_step_matches, jax_init
from tests._torch_ranks import collect, one_step, start_ranks, step_rank

torch.set_num_threads(1)
CPU = torch.device("cpu")
H, W = 64, 96
LR = 1e-4


def _configs(denseaspp=False):
    planes = dict(disp_levels=9, disp_min=2, disp_max=40, xz_levels=0, yz_levels=0)
    model = dict(num_layers=18, use_denseaspp=denseaspp, use_mixture_loss=True,
                 plane_residual=False, num_ep=0)
    common = dict(batch_size=4, flip_right=True, fused_sweep=True)
    j = jcfg.TrainConfig(
        model=jcfg.ModelConfig(planes=jcfg.PlaneConfig(**planes), **model),
        loss=jcfg.LossConfig(alpha_pc=0.0), data=jcfg.DataConfig(height=H, width=W),
        optim=jcfg.OptimConfig(learning_rate=LR), bf16=False, **common)
    t = tcfg.TrainConfig(
        model=tcfg.ModelConfig(planes=tcfg.PlaneConfig(**planes), **model),
        loss=tcfg.LossConfig(alpha_pc=0.0), data=tcfg.DataConfig(height=H, width=W),
        optim=tcfg.OptimConfig(learning_rate=LR), bf16=False, **common)
    return j, t


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """The JAX step, the port's one-process steps and the two ranks' steps
    of each case from the same weights and global batch."""
    tmp = tmp_path_factory.mktemp("ranks")
    jc, tc = _configs()
    bundle = JaxBundle(jc)
    params, stats, _ = jax_init(bundle, 0, H, W)
    rng = np.random.default_rng(3)
    params_np = {"model": _perturb(jax.tree.map(np.asarray, params["model"]), rng, _param_rule)}
    stats_np = {"model": _perturb(jax.tree.map(np.asarray, stats["model"]), rng, _stats_rule)}
    batch = make_stereo_batch(tc.per_step_batch, H, W, seed=11)
    port = ModelBundle(tc, CPU).model
    load_jax_params(port, params_np["model"], stats_np["model"])
    _, tc_drop = _configs(denseaspp=True)
    cases = {"plain": {"cfg": tc, "state": port.state_dict(), "batch": batch, "unused": True},
             "dropout": {"cfg": tc_drop, "state": ModelBundle(tc_drop, CPU).model.state_dict(),
                         "batch": batch}}
    # and the plain step with image rows over the two ranks (a (1, 2) mesh),
    # and with the encoder's blocks recomputed (held to one process without)
    spatial = dict(cases["plain"], cfg=tc.replace(mesh_shape=(1, 2)))
    remat = dict(cases["plain"], cfg=tc.replace(model=dataclasses.replace(tc.model, remat=True)))
    with open(tmp / "cases.pkl", "wb") as f:
        pickle.dump(dict(cases, spatial=spatial, remat=remat), f)
    ranks = start_ranks(step_rank, 2, tmp)          # they run while this process works

    tx = jax_make_optimizer(jc, 10)
    state = jax.jit(lambda p, s: create_train_state(p, s, tx))(
        jax.tree.map(jnp.asarray, params_np), jax.tree.map(jnp.asarray, stats_np))
    new_state, metrics = jax.jit(jax_make_train_step(bundle, tx))(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    want = DepthModel(port.cfg)
    load_jax_params(want, jax.tree.map(np.asarray, new_state.params["model"]),
                    jax.tree.map(np.asarray, new_state.batch_stats["model"]))
    one = {name: one_step(case, 0, 1) for name, case in cases.items()}
    one["remat"] = one["plain"]
    return {"cases": dict(cases, remat=remat), "ranks": collect(ranks, tmp), "one": one,
            "jax": {k: float(v) for k, v in metrics.items()}, "want": want.state_dict()}


@pytest.mark.parametrize("case", ["plain", "dropout", "remat"])
def test_two_ranks_equal_one_process(steps, case):
    one, (r0, r1) = steps["one"][case], (r[case] for r in steps["ranks"])
    assert set(r0["losses"]) == set(one["losses"])
    for k, v in one["losses"].items():
        np.testing.assert_allclose(r0["losses"][k], v, rtol=2e-4, err_msg=k)
        assert r1["losses"][k] == r0["losses"][k], k
    worst = worst_bn = 0.0
    for k, v in one["state"].items():
        assert torch.equal(r0["state"][k], r1["state"][k]), k
        err = float((r0["state"][k].double() - v.double()).abs().max())
        if "running" in k:
            worst_bn = max(worst_bn, err)
        else:
            worst = max(worst, err)
    assert worst < 5e-4, worst
    assert worst_bn < 5e-4, worst_bn
    assert [k for k, g in r0["grads"].items() if g is None] == \
        [k for k, g in one["grads"].items() if g is None]
    for k, g in one["grads"].items():        # the ranks' averaged gradients
        if g is not None and g.abs().max() > 1e-6:
            rel = float((r0["grads"][k] - g).norm() / g.norm())
            assert rel < 1e-4, (k, rel)
    if steps["cases"][case].get("unused"):
        assert one["grads"]["unused"] is None
        assert torch.equal(r0["state"]["unused"], torch.ones(3))


def test_two_ranks_equal_jax_step(steps):
    _held_to_jax(steps, steps["ranks"][0]["plain"])


def test_two_spatial_ranks_equal_jax_step(steps):
    """Image rows over two ranks (``mesh_shape=(1, 2)``, each rank the
    global batch's rows [32 s, 32 (s + 1)) of 64) against the JAX step:
    ``tests/test_torch_spatial.py`` holds the op by op and the one-process
    equalities."""
    _held_to_jax(steps, steps["ranks"][0]["spatial"])


def _held_to_jax(steps, r0):
    for k in ("loss/ph_loss", "loss/smooth_loss", "loss/total_loss"):
        np.testing.assert_allclose(r0["losses"][k], steps["jax"][k], rtol=2e-4, err_msg=k)
    model = DepthModel(ModelBundle(steps["cases"]["plain"]["cfg"], CPU).model.cfg)
    model.load_state_dict({k: v for k, v in r0["state"].items() if k != "unused"})
    for k, p in model.named_parameters():
        p.grad = r0["grads"][k]
    before = {k: v for k, v in steps["cases"]["plain"]["state"].items()}
    assert_step_matches(model, steps["want"], before, r0["sizes"], LR, c3_visible=False)


def test_network_rows_are_the_ranks_rows_of_the_flipped_global_batch():
    """Rank r's flip-doubled batch is the flip-doubled global batch at
    ``network_rows``: the rows its dropout masks are drawn for."""
    batch = batch_to_tensors(make_stereo_batch(6, 8, 16, seed=2), CPU)
    full = add_flip_right_inputs(batch)["color_aug_l"]
    for size in (1, 2, 3):
        b = 6 // size
        for rank in range(size):
            rows, total = network_rows(b, rank, size, flip_right=True)
            own = {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}
            assert total == 12
            assert torch.equal(add_flip_right_inputs(own)["color_aug_l"], full[rows])
            rows, total = network_rows(b, rank, size, flip_right=False)
            assert total == 6 and torch.equal(batch["color_aug_l"][rows], own["color_aug_l"])


@pytest.mark.parametrize("n,batch,hosts,shuffle,drop_last", [
    (10, 3, 1, True, True), (25, 2, 2, True, True), (25, 2, 2, True, False),
    (17, 3, 4, False, False), (17, 3, 4, True, True), (3, 2, 4, True, False),
    (3, 2, 4, False, True), (8, 2, 4, True, False), (40, 5, 3, True, False)])
def test_host_batches_equal_jax(n, batch, hosts, shuffle, drop_last):
    """Every host's batches, the global order and the step count, over
    three epochs, including splits smaller than one chunk of hosts x batch."""
    for host in range(hosts):
        kw = dict(shuffle=shuffle, seed=7, drop_last=drop_last)
        got = tloader.EpochSampler(n, batch, hosts, host, **kw)
        want = jloader.EpochSampler(n, batch, num_hosts=hosts, host_id=host, **kw)
        assert got.steps_per_epoch() == want.steps_per_epoch()
        for epoch in range(3):
            np.testing.assert_array_equal(got.epoch_indices(epoch), want.epoch_indices(epoch))
            np.testing.assert_array_equal(got.host_batches(epoch), want.host_batches(epoch))


def test_mesh_rules(monkeypatch):
    """One process is the group of one, a mesh of one data rank and one
    spatial rank; a spatial axis of two ranks needs two; the backend is
    NCCL only where each local rank has a card of its own."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert mesh.world() == (0, 1) and mesh.make_mesh() == (0, 1, 0, 1)
    assert mesh.current_mesh() == (0, 1, 0, 1)
    assert mesh.launcher_env() is None and not mesh.init_distributed(CPU)
    with pytest.raises(ValueError, match="world size"):
        mesh.make_mesh(spatial=2)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert mesh.choose_backend(CPU, 1) == "gloo"
    assert mesh.choose_backend(torch.device("cuda", 0), 1) == "nccl"
    assert mesh.choose_backend(torch.device("cuda", 0), 2) == "gloo"
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert mesh.launcher_env() == {"rank": 3, "size": 4, "local_rank": 1, "local_size": 4}
