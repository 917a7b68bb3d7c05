"""Data-parallel training of the tiny PointPillars, the tiny CenterPoint,
the tiny Part-A2, the tiny PointRCNN, the tiny SECONDNetIoU and the tiny
PV-RCNN++ in the port: two gloo processes at b2 each (tests/torch_dist_cases.py
`dist_steps_case`: DDP, one `train_step` on their halves of the batch)
against one port process at b4 (the same function at world size 1), whose
step tests/test_torch_pointpillar.py, tests/test_torch_centerpoint.py and
tests/test_torch_parta2.py and tests/test_torch_pointrcnn.py hold against
the JAX package. The BNs
(PillarVFE's over B x V x P rows, the BEV backbone's, the center head's,
UNetV2's and the RoI head's over the valid RoIs), the focal losses'
positives, the regression loss's mask sum and the RCNN losses' sampled and
foreground counts are the global batch's through parallel.comm (Part-A2's
batch has a scan with no sampled RoI on each rank; PointRCNN's point head's
positives and its PointNet++ BNs over the valid points and slots are
global too; SECONDNetIoU's IoU loss is normalised by the global batch's
valid RoIs, which differ between its ranks: torch_dist_cases'
SECONDNETIOU_TRAIN_NMS; PV-RCNN++'s sector d-fps runs on each rank's scans
and its VectorPool post_mlp BNs, which take no mask, over the global
batch's keypoints).

Tolerances, as test_torch_dist_train.py's: loss and tb terms (the ranks'
mean) atol 1e-4 * max(1, |want|), rtol 1e-4; gradients (DDP's mean) rtol
1e-3, atol 1e-4 * max|want| per tensor, not below 1e-6 * the largest |want|;
BN running statistics after the step atol and rtol 1e-5. Between the ranks:
the reduced gradients, every buffer and every parameter after the optimizer
step bit-equal.
"""
from functools import partial

import numpy as np
import pytest
import torch

from tests.torch_dist_cases import (centerpoint_batch, dist_step_case, dist_steps_case,
                                    parta2_batch, pointpillar_batch, run_ranks)

B = 4
BATCHES = {"pointpillar": pointpillar_batch, "centerpoint": centerpoint_batch,
           "parta2": parta2_batch, "pointrcnn": partial(parta2_batch, which="pointrcnn"),
           "secondnetiou": partial(parta2_batch, which="secondnetiou"),
           "pvrcnnplusplus": partial(parta2_batch, which="pvrcnnplusplus")}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """case -> (the two ranks' results, one process's at the whole batch)."""
    cases = [(c, BATCHES[c](B)) for c in BATCHES]
    ranks = run_ranks(dist_steps_case, (cases,), tmp_path_factory.mktemp("zoo_steps"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = [dist_step_case(0, 1, which, batch) for which, batch in cases]
    finally:
        torch.set_num_threads(n)
    return {c: ([r[i] for r in ranks], one[i]) for i, c in enumerate(BATCHES)}


def _close_scalar(got, want, what):
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4,
                               atol=1e-4 * max(1.0, abs(float(want))), err_msg=what)


@pytest.mark.parametrize("case", list(BATCHES))
def test_loss_and_tb_terms(results, case):
    ranks, one = results[case]
    _close_scalar(np.mean([r["loss"] for r in ranks]), one["loss"], "loss")
    assert set(ranks[0]["tb"]) == set(one["tb"]) and len(one["tb"]) >= 4
    for k, v in one["tb"].items():
        _close_scalar(np.mean([r["tb"][k] for r in ranks]), v, k)


@pytest.mark.parametrize("case", list(BATCHES))
def test_gradients(results, case):
    ranks, one = results[case]
    want = one["grads"]
    scale = max(float(np.abs(w).max()) for w in want.values())
    assert len(want) > 20 and set(ranks[0]["grads"]) == set(want)
    for k, w in want.items():
        atol = 1e-4 * max(float(np.abs(w).max()), 1e-2 * scale)
        np.testing.assert_allclose(ranks[0]["grads"][k], w, rtol=1e-3, atol=atol, err_msg=k)


@pytest.mark.parametrize("case", list(BATCHES))
def test_bn_statistics(results, case):
    ranks, one = results[case]
    want = one["buffers"]
    assert any(k.endswith("running_var") for k in want)
    assert set(ranks[0]["buffers"]) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(ranks[0]["buffers"][k], w, rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("case", list(BATCHES))
def test_ranks_bit_equal(results, case):
    ranks, _ = results[case]
    assert ranks[0]["mismatches"] == [] and ranks[1]["mismatches"] == []
    for key in ("grads", "buffers", "params"):
        for k, v in ranks[0][key].items():
            assert np.array_equal(v.view(np.uint8), ranks[1][key][k].view(np.uint8)), (key, k)
    assert ranks[0]["loss"] != ranks[1]["loss"], "each rank's loss is its own share"
