"""Data-parallel training in the port: two gloo processes at b2 each
against the JAX package's 2-device data mesh at b4 (`make_mesh(2)` on 2 of
the 8 virtual CPU devices, `shard_batch`, `replicate_state`).

The ranks (tests/torch_dist_cases.dist_steps_case) wrap the tiny model in
DDP and take one step (`runtime.train_state.train_step`) on their halves of
the batch; the JAX side runs `create_train_step` on the mesh (its metrics,
batch_stats and statistics after the step) and `jax.grad` of the
same loss on the same sharded batch (the gradients the step applies),
each jitted once a model.
Cases: the tiny TSM distillation step on the "wide" gt boxes, the same with
rank 1's two scans empty (every point masked: `safe_bn_mask` and the
normalizers must be the global batch's), the tiny teacher's step (every
parameter trains; its head's class statistics update from the global
batch's counts and feature sums) and the tiny SECOND's step.

Tolerances, as test_torch_tsm_train.py's (f32 sums run in another order:
here the ranks' partial sums too):
  * loss and tb terms (the ranks' mean, as the train loop logs them):
    atol 1e-4 * max(1, |want|), rtol 1e-4;
  * gradients (DDP's mean over the ranks): rtol 1e-3, atol 1e-4 * max|want|
    per tensor, not below 1e-6 * the largest |want| of all trained tensors;
  * BN running statistics and class statistics after the step: atol and
    rtol 1e-5.
Between the ranks: the reduced gradients, every buffer and every parameter
after the optimizer step are bit-equal (`replica_mismatches` empty).
"""
import functools

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

import __graft_entry__ as ge
from tests.test_second_e2e import META as JMETA, second_model_cfg
from tests.test_torch_teacher import _jax_teacher_cfg
from tests.torch_dist_cases import (OPTIM, TOTAL_STEPS, dist_steps_case, run_ranks,
                                    second_batch, teacher_state, tsm_batch, tsm_state)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tsm_det_pointcloud_tpu.models import build_network as jbuild
from tsm_det_pointcloud_tpu.parallel.train_state import (TrainState, create_train_step,
                                                         make_mesh, shard_batch,
                                                         wrap_student_only)
from tsm_det_pointcloud_tpu.runtime.optimization import build_optimizer as jbuild_optimizer
from tsm_det_pointcloud_tpu_torch import tiny
from tsm_det_pointcloud_tpu_torch.convert import from_flax_variables, to_flax_variables
from tsm_det_pointcloud_tpu_torch.runtime.train_state import is_student

B = 4
CASES = {"tsm": dict(model="tsm", empty=()), "tsm_empty_rank": dict(model="tsm", empty=(2, 3)),
         "teacher": dict(model="teacher", empty=()), "second": dict(model="second", empty=())}


def _batch(case):
    c = CASES[case]
    return second_batch(B) if c["model"] == "second" else tsm_batch(B, "wide", c["empty"])


def _variables(which):
    state = {"second": lambda: tiny.load_state(tiny.SECOND_STATE_PATH),
             "teacher": teacher_state, "tsm": tsm_state}[which]()
    return to_flax_variables(state)


@functools.lru_cache(maxsize=None)
def _jax_fns(which):
    """(variables, optimizer, the mesh train step, the jitted gradient) of
    the tiny model `which`."""
    model = {"second": lambda: jbuild(second_model_cfg(), num_class=1, dataset=JMETA),
             "teacher": lambda: jbuild(_jax_teacher_cfg(), num_class=3,
                                       dataset=ge._tsm_model().dataset_meta),
             "tsm": ge._tsm_model}[which]()
    variables = _variables(which)
    tx, _ = jbuild_optimizer(OPTIM, TOTAL_STEPS)
    if which == "tsm":
        tx = wrap_student_only(tx, variables["params"])
    mutable = ["batch_stats"] + (["statistics"] if variables.get("statistics") else [])

    @jax.jit
    def grads_of(v, b):
        def loss_fn(p):
            out, _ = model.apply(dict(v, params=p), b, training=True, mutable=mutable)
            return out["loss"]

        return jax.grad(loss_fn)(v["params"])

    return variables, tx, create_train_step(model, tx, mesh=make_mesh(2), donate=False), grads_of


def _jax_mesh_step(which, batch):
    """(metrics, new batch_stats, new statistics, gradients) of the JAX step
    on a 2-device data mesh, numpy leaves."""
    variables, tx, step, grads_of = _jax_fns(which)
    mesh = make_mesh(2)
    repl = NamedSharding(mesh, P())
    sharded = shard_batch(dict(batch), mesh)
    params = variables["params"]
    state = jax.device_put(TrainState(
        params=params, batch_stats=variables.get("batch_stats", {}),
        opt_state=tx.init(params), step=0, statistics=variables.get("statistics", {})), repl)
    new_state, metrics = step(state, sharded)
    dev_batch = {k: v for k, v in sharded.items() if k != "batch_size"}
    dev_batch["batch_size"] = B
    grads = grads_of(jax.device_put(variables, repl), dev_batch)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return (to_np(metrics), to_np(new_state.batch_stats), to_np(new_state.statistics),
            to_np(grads))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """case -> (the two ranks' results, the JAX step's)."""
    cases = [(c["model"], _batch(case)) for case, c in CASES.items()]
    ranks = run_ranks(dist_steps_case, (cases,), tmp_path_factory.mktemp("steps"))
    return {case: ([r[i] for r in ranks], _jax_mesh_step(model, batch))
            for i, (case, (model, batch)) in enumerate(zip(CASES, cases))}


def _close_scalar(got, want, what):
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4,
                               atol=1e-4 * max(1.0, abs(float(want))), err_msg=what)


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_tb_terms(results, case):
    ranks, (metrics, *_) = results[case]
    _close_scalar(np.mean([r["loss"] for r in ranks]), metrics["loss"], "loss")
    tb = {k: v for k, v in metrics.items() if k != "loss"}
    assert set(ranks[0]["tb"]) == set(tb)
    for k, v in tb.items():
        _close_scalar(np.mean([r["tb"][k] for r in ranks]), v, k)
    if case == "tsm":
        assert float(metrics["s_n_pos"]) > 0, "the wide boxes must give positives"


@pytest.mark.parametrize("case", list(CASES))
def test_gradients(results, case):
    ranks, (*_, grads) = results[case]
    want = from_flax_variables({"params": grads})
    trained = [k for k in want if CASES[case]["model"] != "tsm" or is_student(k)]
    scale = max(float(want[k].abs().max()) for k in trained)
    assert len(trained) > 20 and set(ranks[0]["grads"]) == set(trained)
    for k in trained:
        w = want[k].numpy()
        atol = 1e-4 * max(float(np.abs(w).max()), 1e-2 * scale)
        np.testing.assert_allclose(ranks[0]["grads"][k], w, rtol=1e-3, atol=atol, err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_bn_and_class_statistics(results, case):
    ranks, (_, batch_stats, statistics, _) = results[case]
    want = from_flax_variables({"batch_stats": batch_stats, "statistics": statistics})
    if case == "teacher":   # the update moved the statistics of some class
        before = teacher_state()
        assert any(not np.array_equal(want[k].numpy(), before[k].numpy())
                   for k in want if "object_" in k)
    assert len(want) > 20 and set(want) == set(ranks[0]["buffers"]) - _no_flax_leaf(ranks)
    for k, w in want.items():
        np.testing.assert_allclose(ranks[0]["buffers"][k], w.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def _no_flax_leaf(ranks):
    """Port buffers that no flax collection holds (SECOND's anchors and
    per-anchor thresholds, made from the config)."""
    return {k for k in ranks[0]["buffers"] if "anchor" in k or "threshold" in k}


@pytest.mark.parametrize("case", list(CASES))
def test_ranks_bit_equal(results, case):
    ranks, _ = results[case]
    assert ranks[0]["mismatches"] == [] and ranks[1]["mismatches"] == []
    for key in ("grads", "buffers", "params"):
        for k, v in ranks[0][key].items():
            assert np.array_equal(v.view(np.uint8), ranks[1][key][k].view(np.uint8)), (key, k)
    assert ranks[0]["loss"] != ranks[1]["loss"], "each rank's loss is its own share"
