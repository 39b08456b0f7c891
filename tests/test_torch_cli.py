"""The port's CLIs against the JAX package's: flags, stage presets, the checkpoint meta.

- ``build_parser`` has the JAX parser's flags with their defaults, but for
  the TPU-only ones, which it refuses by name (the JAX parser's performance
  flags but ``--fused_sweep``, ``--warp_sample_bf16`` and the two memory
  trades ``--remat`` and ``--remat_warp``, which map as in the JAX
  package); each argv
  below gives a config whose every field equals the JAX config's (the port
  keeps a subset of the JAX fields, which the refused flags do not set);
- ``apply_checkpoint_meta`` adopts what the JAX one adopts;
- ``cli.train.main`` trains one stage-1 step on the CPU over a 64x192
  KITTI-shaped tree through ``Trainer(cfg)`` without datasets (the split's
  reader), validates against the tree's velodyne depth and saves
  ``<model_name>_ResNet/last_models``; ``cli.evaluate.load`` rebuilds that
  model from the checkpoint alone, bit-equal; on ``.jpg`` frames without
  PIL it stops with an error that names ``--png``.
"""
import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from planedepth_tpu.cli import evaluate as jevaluate
from planedepth_tpu.cli import options as joptions
from planedepth_tpu_torch import config as tcfg
from planedepth_tpu_torch.cli import evaluate as tevaluate
from planedepth_tpu_torch.cli import options as toptions
from planedepth_tpu_torch.cli import train as ttrain
from planedepth_tpu_torch.data.kitti_tree import write_tree

torch.set_num_threads(1)
CPU = torch.device("cpu")
TPU_ONLY = {"remat_warp", "rowshift_warp", "fused_head", "s2d_tail", "remat"}
REMAT = {"remat", "remat_warp"}            # memory trades on any backend: ported
REFUSED = TPU_ONLY - REMAT                 # JAX flags that the port's parser refuses


def _parse(mod, argv):
    parser = mod.build_parser()
    parser.add_argument("--stage", type=str, default=None)
    args, explicit = mod.parse_with_explicit(parser, argv)
    return args, explicit, mod.args_to_config(args, explicit=explicit, stage=args.stage)


def _same_fields(port, ref, path="cfg"):
    for f in dataclasses.fields(port):
        got, want = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(got):
            _same_fields(got, want, f"{path}.{f.name}")
        else:
            assert got == want, f"{path}.{f.name}: {got!r} vs {want!r}"


def test_parser_and_flag_map_equal_jax():
    def options(mod):
        return {a.dest: (tuple(a.option_strings), a.default, a.nargs, a.type, a.choices)
                for a in mod.build_parser()._actions}

    assert options(toptions) == {k: v for k, v in options(joptions).items()
                                 if k not in REFUSED}
    assert set(joptions._FLAG_MAP) - set(toptions._FLAG_MAP) == REFUSED
    for dest, (section, field, _) in toptions._FLAG_MAP.items():
        assert joptions._FLAG_MAP[dest][:2] == (section, field), dest
        owner = tcfg.TrainConfig() if section is None else getattr(tcfg.TrainConfig(), section,
                                                                   None)
        if section == "planes":
            owner = tcfg.TrainConfig().model.planes
        assert hasattr(owner, field), dest


@pytest.mark.parametrize("argv", [
    [],
    ["--num_layers", "18", "--png", "--no_crop", "--split", "/data/my_split"],
    ["--stage", "stage1"],
    ["--stage", "hr_finetune", "--batch_size", "4", "--learning_rate", "1e-5",
     "--height", "192", "--width", "640"],
    ["--stage", "self_distillation", "--load_weights_folder", "/run/last_models",
     "--models_to_load", "encoder", "--no_restore_optimizer"],
    ["--novel_frame_ids", "-1", "1", "--use_colmap", "--colmap_path", "/c", "--milestones",
     "5", "--warp_type", "homography_warp", "--automask", "--dataset", "kitti_odom"],
    ["--fused_sweep", "--remat", "--remat_warp", "--warp_sample_bf16", "--no_bf16",
     "--s2d_tail", "off", "--fused_head", "interpret", "--rowshift_warp"],
    ["--no_bf16"],
    ["--stage", "stage1", "--warp_sample_bf16"],
    ["--stage", "self_distillation", "--no_bf16", "--warp_sample_bf16"],
], ids=["defaults", "flags", "stage1", "hr_override", "distill_restore", "mono", "tpu_only",
        "no_bf16", "warp_sample_bf16", "distill_f32"])
def test_flags_give_the_jax_config(argv):
    """The refused flags (``tpu_only``) stop the port's parser; without them
    the port's config equals the JAX config of the whole argv: they set no
    field that the port has."""
    args_j, explicit_j, want = _parse(joptions, argv)
    port_argv = [a for i, a in enumerate(argv) if a[2:] not in REFUSED
                 and not (i and argv[i - 1][2:] in REFUSED and not a.startswith("--"))]
    if port_argv != argv:
        with pytest.raises(SystemExit):
            _parse(toptions, argv)
    args_t, explicit_t, got = _parse(toptions, port_argv)
    assert vars(args_t) == {k: v for k, v in vars(args_j).items() if k not in REFUSED}
    assert explicit_t == explicit_j - REFUSED
    _same_fields(got, want)
    assert (got.model.remat, got.remat_warp) == (want.model.remat, want.remat_warp) == \
        ("--remat" in argv, "--remat_warp" in argv)
    assert tcfg.TrainConfig.from_dict(json.loads(got.to_json())) == got


@pytest.mark.parametrize("flag", sorted(TPU_ONLY))
def test_refused_flag_is_named(flag, capsys):
    """The JAX parser takes the flag; the port's stops and names it, but for
    ``--remat`` and ``--remat_warp``, which both parsers take to the same
    field."""
    argv = [f"--{flag}"] + (["off"] if flag in ("fused_head", "s2d_tail") else [])
    args_j = joptions.build_parser().parse_args(argv)
    if flag in REMAT:
        args_t = toptions.build_parser().parse_args(argv)
        assert getattr(args_t, flag) is getattr(args_j, flag) is True
        assert toptions._FLAG_MAP[flag][:2] == joptions._FLAG_MAP[flag][:2]
        return
    with pytest.raises(SystemExit):
        toptions.build_parser().parse_args(argv)
    assert f"unrecognized arguments: --{flag}" in capsys.readouterr().err


def test_bf16_defaults_and_a_jax_opt_json_keep_bf16():
    """``bf16`` defaults to True and ``warp_sample_bf16`` to False, as in the
    JAX package, in its field order; ``from_dict`` of a JAX ``opt.json``
    keeps both."""
    from planedepth_tpu import config as jcfg

    assert tcfg.TrainConfig().bf16 is True and tcfg.TrainConfig().warp_sample_bf16 is False
    names = lambda cls: [f.name for f in dataclasses.fields(cls)]   # noqa: E731
    jnames = [n for n in names(jcfg.TrainConfig) if n in names(tcfg.TrainConfig)]
    assert jnames == [n for n in names(tcfg.TrainConfig) if n in jnames]
    for bf16, sample in ((False, True), (True, False)):
        opt = json.loads(jcfg.stage1_config(bf16=bf16, warp_sample_bf16=sample).to_json())
        got = tcfg.TrainConfig.from_dict(opt)
        assert (got.bf16, got.warp_sample_bf16) == (bf16, sample)


@pytest.mark.parametrize("remat,remat_warp", [(True, False), (False, True), (True, True)])
def test_a_jax_opt_json_sets_the_remat_switches(remat, remat_warp):
    """``ModelConfig.remat`` and ``TrainConfig.remat_warp`` default to False
    at the JAX package's field positions, and ``from_dict`` of a JAX
    ``opt.json`` that sets them sets them in the port."""
    from planedepth_tpu import config as jcfg

    names = lambda cls: [f.name for f in dataclasses.fields(cls)]   # noqa: E731
    for jc, tc in ((jcfg.ModelConfig, tcfg.ModelConfig), (jcfg.TrainConfig, tcfg.TrainConfig)):
        assert [n for n in names(jc) if n in names(tc)] == names(tc)
    assert tcfg.TrainConfig().model.remat is False and tcfg.TrainConfig().remat_warp is False
    want = jcfg.hr_finetune_config(remat_warp=remat_warp,
                                   model=jcfg.ModelConfig(remat=remat))
    got = tcfg.TrainConfig.from_dict(json.loads(want.to_json()))
    assert (got.model.remat, got.remat_warp) == (remat, remat_warp)
    _same_fields(got, want)


def test_apply_checkpoint_meta_equals_jax():
    saved = tcfg.hr_finetune_config(model=tcfg.ModelConfig(num_layers=101))
    meta = {"height": 384, "width": 1280, "config": json.loads(saved.to_json())}
    for argv, explicit in ((["--eval_stereo"], set()),
                           (["--eval_stereo", "--height", "192", "--num_layers", "18"],
                            {"height", "num_layers"}),
                           (["--eval_stereo", "--width", "320"], {"width"})):
        got = tevaluate.apply_checkpoint_meta(_parse(toptions, argv)[2], meta, explicit)
        want = jevaluate.apply_checkpoint_meta(_parse(joptions, argv)[2], meta, explicit)
        _same_fields(got, want)
    assert tevaluate.apply_checkpoint_meta(saved, None, set()) == saved


def test_train_cli_one_step_on_the_tree_then_evaluate_restores_it(tmp_path):
    drive = "2011_09_26/2011_09_26_drive_0001_sync"
    root, split = tmp_path / "kitti", tmp_path / "split"
    sizes = {"2011_09_26": (250, 76)}
    write_tree(str(root), [f"{drive} 0 l"], sizes=sizes)
    write_tree(str(root), [f"{drive} 1 l"], scan_points=3000, sizes=sizes)
    split.mkdir()
    (split / "train_files.txt").write_text(f"{drive} 0 l\n")
    (split / "val_files.txt").write_text(f"{drive} 1 l\n")
    argv = ["--stage", "stage1", "--data_path", str(root), "--split", str(split), "--png",
            "--height", "64", "--width", "192", "--num_layers", "18", "--disp_levels", "5",
            "--disp_max", "24", "--xz_levels", "0", "--num_ep", "0", "--alpha_pc", "0",
            "--batch_size", "2", "--num_epochs", "1", "--num_workers", "2",
            "--log_dir", str(tmp_path / "log"), "--model_name", "kitti"]
    seen = {}
    val = ttrain.Trainer.val
    trainer_val = lambda self, epoch: seen.setdefault("val", val(self, epoch))   # noqa: E731
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttrain.Trainer, "val", trainer_val)
        trainer = ttrain.main(argv, device=CPU)
    assert trainer.cfg.model_name == "kitti_ResNet" and trainer.step_count == 1
    assert type(trainer.train_dataset).__name__ == "KITTIRAWDataset"
    assert trainer.train_dataset.is_train and not trainer.val_dataset.is_train
    assert seen["val"] and all(np.isfinite(v) for v in seen["val"].values())
    ckpt = tmp_path / "log" / "kitti_ResNet" / "last_models"
    assert sorted(os.listdir(ckpt)) == ["adam.pth", "depth.pth", "encoder.pth"]

    args, cfg, model = tevaluate.load(["--eval_stereo", "--post_process", "--png",
                                       "--data_path", str(root), "--load_weights_folder",
                                       str(ckpt)], device=CPU)
    assert (cfg.data.height, cfg.data.width) == (64, 192)
    assert cfg.model.num_layers == 18 and cfg.model.planes.disp_levels == 5
    assert tevaluate.evaluate_kwargs(args)["post_process"]
    want = trainer.bundle.model.state_dict()
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    header, row = tevaluate.metric_lines({k: 0.5 for k in tevaluate.METRICS})
    assert "abs_rel" in header and row.count("&") == 7


def test_train_cli_on_jpg_frames_without_pil_names_png(tmp_path, monkeypatch):
    """Every training sample fails to load: the loader's error carries the
    reader's, which names ``--png``."""
    drive = "2011_09_26/2011_09_26_drive_0001_sync"
    root, split = tmp_path / "kitti", tmp_path / "split"
    write_tree(str(root), [f"{drive} {f} l" for f in (0, 1)], sizes={"2011_09_26": (250, 76)})
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".png"):
                os.rename(os.path.join(d, f), os.path.join(d, f[:-4] + ".jpg"))
    split.mkdir()
    (split / "train_files.txt").write_text(f"{drive} 0 l\n{drive} 1 l\n")
    (split / "val_files.txt").write_text(f"{drive} 1 l\n")
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    argv = ["--stage", "stage1", "--data_path", str(root), "--split", str(split),
            "--height", "64", "--width", "192", "--num_layers", "18", "--disp_levels", "5",
            "--disp_max", "24", "--xz_levels", "0", "--num_ep", "0", "--alpha_pc", "0",
            "--batch_size", "2", "--num_epochs", "1", "--num_workers", "2",
            "--log_dir", str(tmp_path / "log"), "--model_name", "kitti"]
    with pytest.raises(RuntimeError, match="--png"):
        ttrain.main(argv, device=CPU)
