"""The port's homography step without the mixture against the JAX package's, on the same weights.

``use_mixture_loss=False`` (tests/test_warp2d_train.py:171-178): the 2-D
warp without sigma, the softmax composite and the L1 photometric term with
the ``mask_novel`` blend and the automask minimum.  The step and its three
checks (losses, every gradient leaf, post-Adam weights and BatchNorm
statistics) are tests/test_torch_mono.py's, at its configuration; this file
only gives them the no-mixture step, so that the two files share the load.
"""
import pytest
import torch

from tests.test_torch_mono import (  # noqa: F401  (the checks run here too)
    _configs,
    step_pair,
    test_step_gradients_match_jax,
    test_step_losses_match_jax,
    test_step_parameters_and_bn_statistics_match_jax,
)

pytestmark = pytest.mark.heavy
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def steps():
    return step_pair(*_configs("homography_warp", mixture=False))
