"""The port's converted ImageNet weights (``utils/pretrained.py``) against the JAX package's.

The ``.npz`` files are written by the JAX package's ``save_converted`` from
seeded trees (``convert_resnet_encoder`` / ``convert_vgg19_features`` of
seeded torchvision-layout state dicts), so nothing is downloaded.  The JAX
``apply_pretrained`` merges them into a jitted JAX init; the port's
``apply_pretrained`` copies them into a port ``ModelBundle``; every leaf the
port loaded must equal the JAX merge after the layout transpose (0 error).
The error cases raise ``PretrainedWeightsError`` in both packages, and a
port ``Trainer`` whose perceptual loss would train on a random VGG19
raises unless ``allow_random_pc`` is set.  Everything runs on the CPU at
64x96 with ResNet-18 encoders.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from planedepth_tpu import config as jcfg
from planedepth_tpu.train.step import ModelBundle as JaxBundle
from planedepth_tpu.utils import pretrained as jpre
from planedepth_tpu.utils.torch_convert import (
    convert_resnet_encoder,
    convert_vgg19_features,
    save_converted,
)
from planedepth_tpu_torch import config as tcfg
from planedepth_tpu_torch.data.synthetic import make_stereo_batch
from planedepth_tpu_torch.models.perceptual import Vgg19Features
from planedepth_tpu_torch.models.resnet import ResnetEncoder, ResnetPoseEncoder
from planedepth_tpu_torch.train.step import ModelBundle
from planedepth_tpu_torch.train.trainer import Trainer
from planedepth_tpu_torch.utils import pretrained as tpre
from planedepth_tpu_torch.utils.weights import load_jax_encoder_params, load_jax_pc_params

torch.set_num_threads(1)
CPU = torch.device("cpu")
H, W = 64, 96
PLANES = dict(disp_levels=7, disp_min=2, disp_max=16, xz_levels=3, yz_levels=0)
MODEL = dict(num_layers=18, use_denseaspp=False, num_ep=0, pose_num_layers=18, pose_num_ep=8)
COMMON = dict(batch_size=2, warp_type="homography_warp", novel_frame_ids=(-1, 1))


def _configs(weights_dir, alpha_pc=0.1):
    """The same mono configuration (depth encoder, pose encoder, VGG19) in
    both packages."""
    j = jcfg.TrainConfig(
        model=jcfg.ModelConfig(planes=jcfg.PlaneConfig(**PLANES), **MODEL),
        loss=jcfg.LossConfig(alpha_pc=alpha_pc, automask=True),
        data=jcfg.DataConfig(height=H, width=W), bf16=False, weights_dir=weights_dir,
        **COMMON)
    t = tcfg.TrainConfig(
        bf16=False,
        model=tcfg.ModelConfig(planes=tcfg.PlaneConfig(**PLANES), **MODEL),
        loss=tcfg.LossConfig(alpha_pc=alpha_pc, automask=True),
        data=tcfg.DataConfig(height=H, width=W), fused_sweep=True, weights_dir=weights_dir,
        **COMMON)
    return j, t


@pytest.fixture(scope="module")
def jax_init():
    """A jitted JAX init of the configuration: (params, batch_stats, pc_params)."""
    j, _ = _configs(None)
    bundle = JaxBundle(j)
    params, stats, pc = jax.jit(bundle.init, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), H, W)
    to_np = lambda tree: jax.tree.map(np.asarray, tree)
    return to_np(params), to_np(stats), to_np(pc)


def _trunk_sd(seed, conv1_size=7):
    """A seeded torchvision-layout ResNet-18 state dict (float32)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in ResnetEncoder(18).encoder.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        shape = tuple(v.shape)
        if k == "conv1.weight":
            shape = shape[:2] + (conv1_size, conv1_size)
        draw = rng.uniform(0.5, 1.5, shape) if k.endswith("running_var") else \
            rng.normal(0.0, 0.1, shape)
        sd[k] = draw.astype(np.float32)
    return sd


def _vgg_sd(seed, n_convs=8):
    """A seeded torchvision ``features`` state dict with the first
    ``n_convs`` convs of VGG19 (8: through conv3_4, the perceptual net's)."""
    rng = np.random.default_rng(seed)
    chans = [64, 64, 128, 128, 256, 256, 256, 256, 512, 512, 512, 512]
    ids = [0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25]
    sd, ci = {}, 3
    for cid, co in zip(ids[:n_convs], chans):
        sd[f"features.{cid}.weight"] = rng.normal(0.0, 0.1, (co, ci, 3, 3)).astype(np.float32)
        sd[f"features.{cid}.bias"] = rng.normal(0.0, 0.1, (co,)).astype(np.float32)
        ci = co
    return sd


def _write(tmp_path, resnet=True, vgg=True):
    sds = {}
    if resnet:
        sds["resnet"] = _trunk_sd(1)
        save_converted(str(tmp_path / "resnet18.npz"), convert_resnet_encoder(sds["resnet"]))
    if vgg:
        sds["vgg"] = _vgg_sd(2)
        save_converted(str(tmp_path / "vgg19.npz"), convert_vgg19_features(sds["vgg"]))
    return sds


def _states_equal(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_weights_land_as_the_jax_merge(tmp_path, jax_init):
    """Depth encoder, pose encoder (conv1 tiled over two frames) and VGG19:
    the port's bundle after ``apply_pretrained`` equals the JAX merge, leaf
    for leaf, exactly; the decoders are untouched."""
    sds = _write(tmp_path)
    jc, tc = _configs(str(tmp_path))
    params, stats, pc = jax_init
    new_p, new_s, new_pc, jloaded = jpre.apply_pretrained(jc, params, stats, pc)

    bundle = ModelBundle(tc, CPU)
    before = ModelBundle(tc, CPU)
    loaded = tpre.apply_pretrained(tc, bundle)
    assert loaded == jloaded == ["encoder<-resnet18", "pose_encoder<-resnet18",
                                 "pc<-vgg19.npz"]

    want = ResnetEncoder(18)
    load_jax_encoder_params(want, new_p["model"]["encoder"], new_s["model"]["encoder"])
    assert _states_equal(bundle.model.encoder.state_dict(), want.state_dict())
    w = torch.from_numpy(sds["resnet"]["conv1.weight"])
    assert torch.equal(bundle.model.encoder.encoder.conv1.weight, w)

    want = ResnetPoseEncoder(18, num_input_images=2)
    load_jax_encoder_params(want, new_p["pose_encoder"], new_s["pose_encoder"])
    assert _states_equal(bundle.pose_encoder.state_dict(), want.state_dict())
    assert torch.equal(bundle.pose_encoder.encoder.conv1.weight, torch.cat([w, w], 1) / 2)

    want = Vgg19Features()
    load_jax_pc_params(want, new_pc)
    assert _states_equal(bundle.pc.state_dict(), want.state_dict())
    assert torch.equal(bundle.pc.features[7].weight,
                       torch.from_numpy(sds["vgg"]["features.7.weight"]))

    assert _states_equal(bundle.model.depth.state_dict(), before.model.depth.state_dict())
    assert _states_equal(bundle.pose.state_dict(), before.pose.state_dict())


def _structure(tmp_path):
    save_converted(str(tmp_path / "resnet18.npz"),
                   {"params": {"encoder": {"conv1": {"kernel": np.zeros((7, 7, 3, 64))}}},
                    "batch_stats": {"encoder": {}}})


def _shape(tmp_path):
    save_converted(str(tmp_path / "resnet18.npz"), convert_resnet_encoder(_trunk_sd(3, 5)))


def _vgg_to_relu4(tmp_path):
    _write(tmp_path, vgg=False)
    save_converted(str(tmp_path / "vgg19.npz"), convert_vgg19_features(_vgg_sd(4, 12)))


# each case: (what the weights directory holds, the message both packages give)
ERROR_CASES = {
    "no_weights_dir": (None, "does not exist"),
    "no_resnet_npz": (lambda p: None, "requires"),
    "no_vgg_npz": (lambda p: _write(p, vgg=False), "alpha_pc"),
    "structure_mismatch": (_structure, "does not match"),
    "shape_mismatch": (_shape, "shape mismatch"),
    "vgg_structure_mismatch": (_vgg_to_relu4, "does not match"),
}


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_errors_mirror_jax(tmp_path, jax_init, case):
    """Each bad weights directory raises ``PretrainedWeightsError`` with the
    JAX package's message, never a bare ``KeyError`` or ``ValueError``."""
    fill, match = ERROR_CASES[case]
    wd = tmp_path / "weights"
    if fill is not None:
        wd.mkdir()
        fill(wd)
    jc, tc = _configs(str(wd))
    with pytest.raises(jpre.PretrainedWeightsError, match=match):
        jpre.apply_pretrained(jc, *jax_init)
    bundle = ModelBundle(tc, CPU)
    encoder = {k: v.clone() for k, v in bundle.model.encoder.state_dict().items()}
    with pytest.raises(tpre.PretrainedWeightsError, match=match):
        tpre.apply_pretrained(tc, bundle)
    if case in ("structure_mismatch", "shape_mismatch"):
        # checked before anything is copied
        assert _states_equal(bundle.model.encoder.state_dict(), encoder)


@pytest.mark.parametrize("alpha_pc,allow,loaded,raises", [
    (0.1, False, [], True), (0.1, True, [], False), (0.0, False, [], False),
    (0.1, False, ["encoder<-resnet18", "pc<-vgg19.npz"], False),
    (0.1, False, ["encoder<-resnet18"], True)])
def test_check_perceptual_weights_equals_jax(alpha_pc, allow, loaded, raises):
    jc, tc = _configs(None, alpha_pc)
    for mod, cfg in ((jpre, jc), (tpre, tc)):
        cfg = cfg.replace(allow_random_pc=allow)
        if raises:
            with pytest.raises(mod.PretrainedWeightsError, match="random perceptual"):
                mod.check_perceptual_weights(cfg, loaded)
        else:
            mod.check_perceptual_weights(cfg, loaded)


class _Stereo:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def getitem(self, index, epoch=0):
        return {k: v[0] for k, v in make_stereo_batch(1, H, W, seed=index).items()}


def _trainer_cfg(tmp_path, **kw):
    model = tcfg.ModelConfig(num_layers=18, use_denseaspp=False, num_ep=0,
                             planes=tcfg.PlaneConfig(disp_levels=7, disp_max=24, xz_levels=3))
    base = tcfg.stage1_config()
    return tcfg.stage1_config(log_dir=str(tmp_path), model=model, batch_size=2,
                              data=tcfg.DataConfig(height=H, width=W, num_workers=1),
                              optim=dataclasses.replace(base.optim, num_epochs=1), **kw)


def test_trainer_refuses_a_random_perceptual_net(tmp_path):
    """alpha_pc = 0.1 (the preset's) with no weights_dir raises; with
    ``allow_random_pc`` the Trainer builds; with converted files it loads
    them before the teacher and the restore."""
    data = (_Stereo(2), _Stereo(2))
    with pytest.raises(tpre.PretrainedWeightsError, match="random perceptual"):
        Trainer(_trainer_cfg(tmp_path / "a"), datasets=data, device=CPU)
    Trainer(_trainer_cfg(tmp_path / "b", allow_random_pc=True), datasets=data,
            device=CPU).close()
    wd = tmp_path / "weights"
    wd.mkdir()
    sds = _write(wd)
    trainer = Trainer(_trainer_cfg(tmp_path / "c", weights_dir=str(wd)), datasets=data,
                      device=CPU)
    trainer.close()
    assert torch.equal(trainer.bundle.model.encoder.encoder.conv1.weight,
                       torch.from_numpy(sds["resnet"]["conv1.weight"]))
    assert torch.equal(trainer.bundle.pc.features[0].bias,
                       torch.from_numpy(sds["vgg"]["features.0.bias"]))
