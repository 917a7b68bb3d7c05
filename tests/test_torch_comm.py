"""The port's parallel/comm.py on two gloo processes against the JAX
package's parallel/comm.py.

The ranks (tests/torch_dist_cases.comm_case) run every helper; the JAX
helpers run here on the ranks' own values, their one collective
(`_allgather_arrays`, or `all_gather_object` for the merge) replaced by
the stack of what each rank gave, which is what it returns on a
two-process job. The merge takes 7 samples over 2 ranks: the JAX loader's
rank-strided shards pad them to 8 (sample 0 twice), and the merged list is
trimmed back to 7 in the sampler's order. `init_distributed` refuses a
missing environment and an unknown launcher, and reads a SLURM node list's
first host.
"""
import numpy as np
import pytest

from tests.torch_dist_cases import comm_case, run_ranks
from tsm_det_pointcloud_tpu.datasets import DataLoader as JaxLoader
from tsm_det_pointcloud_tpu.parallel import comm as jcomm
from tsm_det_pointcloud_tpu_torch.parallel import comm

N_SAMPLES = 7


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(comm_case, (N_SAMPLES,), tmp_path_factory.mktemp("comm"))


class _Sized:
    def __len__(self):
        return N_SAMPLES


def _jax_with(monkeypatch, per_rank):
    """The JAX comm module on a two-process job whose ranks gave
    `per_rank(rank)` to its array all-gather."""
    monkeypatch.setattr(jcomm, "get_world_size", lambda: 2)
    monkeypatch.setattr(jcomm, "_allgather_arrays",
                        lambda x: np.stack([np.asarray(per_rank(r)) for r in range(2)]))
    return jcomm


def test_ranks_and_world(ranks):
    assert [r["rank"] for r in ranks] == [0, 1]
    assert all(r["world"] == 2 for r in ranks)


def test_all_gather_object(ranks):
    want = [{"rank": 0, "x": [0]}, {"rank": 1, "x": [0, 1]}]
    assert all(r["gathered"] == want for r in ranks)


def test_all_reduce_mean(ranks, monkeypatch):
    j = _jax_with(monkeypatch, lambda r: [3.0 * r + 1.0])
    want = j.all_reduce_mean(3.0 * 0 + 1.0)
    assert all(r["mean"] == want for r in ranks)


@pytest.mark.parametrize("average", [True, False])
def test_reduce_dict(ranks, monkeypatch, average):
    def d(r):
        return {"b": 0.25 * r - 1.0, "a": float(r + 1), "c": 3.0}

    j = _jax_with(monkeypatch, lambda r: [float(d(r)[k]) for k in sorted(d(r))])
    want = j.reduce_dict(d(0), average=average)
    for r in ranks:
        got = r["avg" if average else "summed"]
        assert list(got) == list(want) and got == want


def test_merge_results_dist(ranks, monkeypatch):
    """7 samples over 2 ranks: the port's shards are the JAX loader's, and
    the merge gives the JAX merge of the same parts: every sample once, in
    dataset order."""
    for r in ranks:
        shard = JaxLoader(_Sized(), 2, num_shards=2, shard_id=r["rank"])._indices()
        assert [p["frame_id"] for p in r["parts"]] == shard.tolist()
    parts = [r["parts"] for r in ranks]
    monkeypatch.setattr(jcomm, "all_gather_object", lambda obj: parts)
    want = jcomm.merge_results_dist(parts[0], N_SAMPLES)
    assert [p["frame_id"] for p in want] == list(range(N_SAMPLES))
    assert all(r["merged"] == want for r in ranks)


def test_global_sum_and_its_gradient(ranks):
    """Forward: the ranks' 3 t summed. Backward: each rank's upstream
    gradient (1, 10) summed over the ranks, times 3."""
    want = 3.0 * (np.array([1.0, 2.0]) + np.array([2.0, 2.0]))
    for r in ranks:
        np.testing.assert_array_equal(r["global_sum"], want.astype(np.float32))
        np.testing.assert_array_equal(r["global_sum_grad"], np.float32([6.0, 60.0]))
        assert r["scaled"] == 3.0


def test_global_any(ranks):
    assert [r["any_empty"] for r in ranks] == [False, False]
    assert [r["any_one"] for r in ranks] == [True, True]


def test_single_process_helpers_return_their_input():
    import torch

    t = torch.tensor([1.5, -2.0], requires_grad=True)
    assert comm.get_world_size() == 1 and comm.get_rank() == 0
    assert comm.global_sum(t) is t and comm.scale_to_global(t) is t
    d = {"x": torch.tensor(2.0)}
    assert comm.reduce_dict(d) == d and comm.all_gather_object(5) == [5]
    assert comm.merge_results_dist([1, 2, 3], 2) == [1, 2]


def test_missing_environment_raises(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="RANK is not set"):
        comm.init_distributed("pytorch", "cpu")
    with pytest.raises(RuntimeError, match="SLURM_PROCID is not set"):
        comm.init_distributed("slurm", "cpu")
    with pytest.raises(ValueError, match="launcher"):
        comm.init_distributed("mpi", "cpu")


def test_launcher_on_cuda_without_a_card_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        comm.init_distributed("pytorch", "cuda")


@pytest.mark.parametrize("nodelist,host", [("gpu[03-05,07],cpu1", "gpu03"),
                                           ("node7", "node7"), ("a1,b2", "a1"),
                                           ("n[12]", "n12")])
def test_slurm_first_host(nodelist, host):
    assert comm.first_host(nodelist) == host
