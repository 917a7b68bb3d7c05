"""The dataset-driven eval loop and first-batch training loss of the tiny Part-A2, PointRCNN,
PVSSDA (on PointNet2FSMSG) and DSASNet (on SparsePointBackbone) against the JAX package (tests/torch_eval_loop_cases.py: the states, data
sections and tolerances)."""
import pytest

from tests import torch_eval_loop_cases as cases
from tests.torch_eval_loop_cases import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    return cases.make_roots(tmp_path_factory)


@pytest.fixture(scope="module", params=['parta2', 'pointrcnn', 'pvssda', 'dsasnet'])
def case(request, roots, tmp_path_factory):
    return cases.run_case(request.param, roots, tmp_path_factory)


def test_eval_loop_detections_match_jax(case):
    cases.check_detections_match_jax(case)


def test_eval_loop_ap_dict_is_the_jax_eval(case):
    cases.check_ap_dict_is_the_jax_eval(case)


def test_first_loader_batch_loss_matches_jax(case, roots):
    cases.check_first_loader_batch_loss_matches_jax(case, roots)
