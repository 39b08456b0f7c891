"""The port's serving export (``cli/export.py``) against its eager forward and the JAX package.

The eval forward is exported with ``torch.export`` at 64x192 (ResNet-18,
DenseASPP, the mixture with its disp head, plane residuals): its graph holds
the ``planedepth_tpu_torch`` disp-head and head-epilogue ops and not the
probability chain beside disp (no softmax: the disp head computes its
own).  It equals the eager forward within 1e-6 relative in float32 (on the
CPU both run the same plain versions, op for op), and again after
``torch.export.save`` and ``torch.export.load`` in a fresh process that
imports ``torch`` and ``planedepth_tpu_torch.ops`` alone; it agrees with the
JAX eval forward on the same weights at the model tolerance of
``tests/test_torch_models.py``, rtol = atol = 1e-3.  The same model with
``remat`` (its encoder blocks recomputed in a training backward) has the
same eval forward and, through ``export_forward``, the same program, bit for
bit.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from planedepth_tpu_torch.cli import export
from planedepth_tpu_torch.config import DataConfig, TrainConfig
from planedepth_tpu_torch.models.factory import DepthModel
from planedepth_tpu_torch.ops.disp_head import disp_head
from planedepth_tpu_torch.ops.head_epilogue import head_epilogue
from tests._torch_parity import inputs, jnp_in, make_models

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, B = 64, 192, 2
OPS = {"planedepth_tpu_torch.disp_head.default",
       "planedepth_tpu_torch.head_epilogue.default"}

LOAD_AND_RUN = """
import sys
import numpy as np
import torch
import planedepth_tpu_torch.ops
program, image, grid, out = sys.argv[1:]
forward = torch.export.load(program).module()
disp = forward(torch.from_numpy(np.load(image)), torch.from_numpy(np.load(grid)))
np.save(out, disp.numpy())
others = [m for m in sys.modules if m.startswith(('planedepth', 'jax', 'flax'))
          and m != 'planedepth_tpu_torch' and not m.startswith('planedepth_tpu_torch.ops')]
assert not others, others
"""


@pytest.fixture(scope="module")
def exported():
    """``(jax_forward, port, program, image, grid)`` for one seeded model."""
    jax_forward, _, _, port = make_models(H, W, num_layers=18)
    cfg = TrainConfig(data=DataConfig(height=H, width=W), bf16=False)
    program = export.export_program(cfg, port, batch_size=B)
    image, grid = inputs(B, H, W)
    return jax_forward, port, program, image, grid


def test_program_holds_the_ops_and_equals_the_eager_forward(exported):
    _, port, program, image, grid = exported
    targets = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    assert OPS <= targets
    assert not [t for t in targets if "softmax" in t], targets
    launches = (disp_head.launches, head_epilogue.fwd_launches)
    got = program.module()(torch.from_numpy(image), torch.from_numpy(grid))
    with torch.no_grad():
        want = export.EvalForward(port)(torch.from_numpy(image), torch.from_numpy(grid))
    assert (disp_head.launches, head_epilogue.fwd_launches) == launches   # CPU: plain path
    assert got.shape == (B, H, W, 1) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0.0)


def test_program_agrees_with_the_jax_eval_forward(exported):
    jax_forward, _, program, image, grid = exported
    got = program.module()(torch.from_numpy(image), torch.from_numpy(grid))
    want = np.asarray(jax_forward(*jnp_in(image, grid))["disp"])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-3)


def test_remat_model_exports_the_same_program(exported, tmp_path, monkeypatch):
    """``remat`` acts in training only: the eval forward and the program that
    ``export_forward`` exports are the plain model's, node for node and bit
    for bit (the saved program's load is held by the test below)."""
    _, port, program, image, grid = exported
    remat = DepthModel(dataclasses.replace(port.cfg, remat=True))
    remat.load_state_dict(port.state_dict())
    remat.eval()
    assert remat.encoder.encoder.remat
    image, grid = torch.from_numpy(image), torch.from_numpy(grid)
    with torch.no_grad():
        want = export.EvalForward(port)(image, grid)
        assert torch.equal(export.EvalForward(remat)(image, grid), want)
    made, real = [], export.export_program
    monkeypatch.setattr(export, "export_program", lambda *a: made.append(real(*a)) or made[-1])
    path = str(tmp_path / "remat.pt2")
    cfg = TrainConfig(data=DataConfig(height=H, width=W), bf16=False)
    assert export.export_forward(cfg, remat, path, batch_size=B) > 0
    nodes = lambda p: [(n.op, str(n.target)) for n in p.graph.nodes]     # noqa: E731
    assert len(made) == 1 and nodes(made[0]) == nodes(program)
    assert torch.equal(made[0].module()(image, grid), program.module()(image, grid))


def test_saved_program_runs_in_a_fresh_process(exported, tmp_path):
    _, _, program, image, grid = exported
    path = tmp_path / "planedepth.pt2"
    torch.export.save(program, str(path))
    np.save(tmp_path / "image.npy", image)
    np.save(tmp_path / "grid.npy", grid)
    proc = subprocess.run(
        [sys.executable, "-c", LOAD_AND_RUN, str(path), str(tmp_path / "image.npy"),
         str(tmp_path / "grid.npy"), str(tmp_path / "disp.npy")],
        cwd=tmp_path, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    want = program.module()(torch.from_numpy(image), torch.from_numpy(grid)).numpy()
    np.testing.assert_array_equal(np.load(tmp_path / "disp.npy"), want)


def test_cli_writes_the_program(tmp_path):
    out = tmp_path / "model.pt2"
    argv = ["--num_layers", "18", "--height", "64", "--width", "64", "--no_bf16",
            "--use_mixture_loss", "--out", str(out), "--export_batch", "2"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            export.main(argv)
    n = export.main(argv, device=torch.device("cpu"))
    assert out.stat().st_size == n
    forward = torch.export.load(str(out)).module()
    disp = forward(torch.rand(2, 64, 64, 3), torch.rand(2, 64, 64, 2) * 2 - 1)
    assert disp.shape == (2, 64, 64, 1) and bool(torch.isfinite(disp).all())
