"""The port's Waymo preprocessing (datasets/waymo/waymo_preprocess.py) against
the JAX package's, on the same bytes. Every comparison is exact: both sides
run the same numpy on the same input.

  * CRC32C (the port's host library against the JAX package's Python loop
    and the standard check value) and the tfrecord framing both ways,
    a corrupt length or payload raising;
  * `decode_frame` of a synthetic frame (datasets/waymo/synthetic.py: the
    TOP laser's two returns and per-pixel pose, four short-range lasers,
    labels), field for field;
  * `range_image_to_points` with and without the extrinsic's yaw and
    translation, the per-pixel pose, given and computed inclinations;
    `frame_points` with one and two returns;
  * `process_single_sequence` / `create_waymo_infos` on a synthetic root:
    the npy frames, the info pickles, the gt database files and the dbinfos.
"""
import pickle

import numpy as np
import pytest

from tests.torch_waymo_cases import preprocessed_roots
from tsm_det_pointcloud_tpu.datasets.waymo import waymo_preprocess as jwp
from tsm_det_pointcloud_tpu_torch.datasets.waymo import synthetic
from tsm_det_pointcloud_tpu_torch.datasets.waymo import waymo_preprocess as pwp

TAG = "waymo_processed_data_v0_5_0"


def assert_same(got, want, where=""):
    """Recursive equality: arrays equal in dtype, shape and value."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), where
        assert got.dtype == want.dtype and got.shape == want.shape, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert type(got) is type(want) and got == want, where


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    return preprocessed_roots(tmp_path_factory.mktemp("waymo"))


@pytest.fixture(scope="module")
def frame_bytes():
    return synthetic.sequence_frames("segment-77", 1, seed=11)[0]


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 63, 1000, 1 << 16])
def test_crc32c_equals_jax(n):
    data = np.random.RandomState(n).bytes(n)
    want = jwp.crc32c(data)
    assert pwp.crc32c(data) == want == pwp.crc32c_plain(data)
    assert pwp.crc32c(data[n // 2:], pwp.crc32c(data[:n // 2])) == want
    assert pwp.crc32c(b"123456789") == 0xE3069283   # the standard check value


def test_tfrecord_round_trip_both_ways(tmp_path):
    payloads = [b"", b"x", np.random.RandomState(0).bytes(5000)]
    pwp.write_tfrecord(tmp_path / "p.tfrecord", payloads)
    jwp.write_tfrecord(tmp_path / "j.tfrecord", payloads)
    assert (tmp_path / "p.tfrecord").read_bytes() == (tmp_path / "j.tfrecord").read_bytes()
    assert list(pwp.read_tfrecord(tmp_path / "j.tfrecord")) == payloads
    assert list(jwp.read_tfrecord(tmp_path / "p.tfrecord")) == payloads


@pytest.mark.parametrize("byte", [3, 14], ids=["length", "payload"])
def test_corrupt_record_raises(tmp_path, byte):
    p = tmp_path / "t.tfrecord"
    pwp.write_tfrecord(p, [b"payload-bytes"])
    raw = bytearray(p.read_bytes())
    raw[byte] ^= 0xFF
    p.write_bytes(bytes(raw))
    for side in (pwp, jwp):
        with pytest.raises(IOError, match="crc mismatch"):
            list(side.read_tfrecord(p))


def test_decode_frame_equals_jax(frame_bytes):
    got, want = pwp.decode_frame(frame_bytes), jwp.decode_frame(frame_bytes)
    assert_same(got, want)
    assert sorted(got["range_images"]) == [1, 2, 3, 4, 5]
    assert got["range_images"][1][0].shape == (64, 2650, 4)
    assert got["range_images"][1][1].shape == (64, 2650, 4)
    assert got["top_pose"].shape == (64, 2650, 6)
    assert len(got["camera_hw"]) == 5
    assert {lab["type"] for lab in got["labels"]} == {0, 1, 2, 3, 4}


def _pose6(rng, H, W):
    p = np.zeros((H, W, 6), np.float32)
    p[..., :3] = rng.uniform(-0.05, 0.05, (H, W, 3))
    p[..., 2] += 0.7
    p[..., 3:] = rng.uniform(-3, 3, 3)
    return p


@pytest.mark.parametrize("case", ["identity", "yaw_translation", "pixel_pose",
                                  "computed_inclinations"])
def test_range_image_to_points_equals_jax(case):
    rng = np.random.RandomState(len(case))
    H, W = 8, 40
    ri = np.zeros((H, W, 4), np.float32)
    ri[..., 0] = rng.uniform(2, 60, (H, W)) * (rng.uniform(size=(H, W)) > 0.2)
    ri[..., 1:3] = rng.uniform(0, 1, (H, W, 2))
    ri[..., 3] = np.where(rng.uniform(size=(H, W)) > 0.9, 1.0, -1.0)
    ex = np.eye(4)
    kw = dict(beam_inclinations=np.sort(rng.uniform(-0.3, 0.05, H)))
    if case != "identity":
        yaw = 0.7
        ex[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
        ex[:3, 3] = [1.4, -0.2, 2.1]
    if case == "pixel_pose":
        fp = np.eye(4)
        fp[:2, :2] = [[np.cos(0.69), -np.sin(0.69)], [np.sin(0.69), np.cos(0.69)]]
        fp[:3, 3] = [10.0, -4.0, 0.5]
        kw.update(pixel_pose=_pose6(rng, H, W), frame_pose=fp)
    if case == "computed_inclinations":
        kw = dict(beam_inclinations=None, beam_inclination_min=-0.4,
                  beam_inclination_max=0.2)
    got = pwp.range_image_to_points(ri, ex, **kw)
    want = jwp.range_image_to_points(ri, ex, **kw)
    assert got.shape == want.shape == (int((ri[..., 0] > 0).sum()), 6)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("two_returns", [True, False])
def test_frame_points_equals_jax(frame_bytes, two_returns):
    frame = jwp.decode_frame(frame_bytes)
    got, got_counts = pwp.frame_points(frame, use_two_returns=two_returns)
    want, want_counts = jwp.frame_points(frame, use_two_returns=two_returns)
    assert got_counts == want_counts
    np.testing.assert_array_equal(got, want)
    # both returns of the TOP laser take the per-pixel pose: the points of
    # the second return lie behind their first-return boxes, in the scene
    assert np.abs(got[:, :2]).max() < 61.0


def test_process_single_sequence_equals_jax(roots):
    jroot, proot = roots
    seqs = sorted(p.name for p in (jroot / TAG).iterdir())
    assert seqs == sorted(p.name for p in (proot / TAG).iterdir()) and len(seqs) == 3
    for seq in seqs:
        with open(jroot / TAG / seq / f"{seq}.pkl", "rb") as f:
            want = pickle.load(f)
        with open(proot / TAG / seq / f"{seq}.pkl", "rb") as f:
            got = pickle.load(f)
        assert_same(got, want, seq)
        assert got[0]["annos"]["name"].dtype.kind == "U"     # numpy str, as the JAX package
        assert "unknown" not in set(got[0]["annos"]["name"])
        for info in want:
            name = "%04d.npy" % info["point_cloud"]["sample_idx"]
            pts = np.load(proot / TAG / seq / name)
            np.testing.assert_array_equal(pts, np.load(jroot / TAG / seq / name))
            assert pts.dtype == np.float32 and pts.shape[1] == 6
            assert len(pts) == sum(info["num_points_of_each_lidar"]) > 163840


@pytest.mark.parametrize("name", [f"{TAG}_infos_train.pkl", f"{TAG}_infos_val.pkl",
                                  "pcdet_waymo_dbinfos_train_sampled_1.pkl"])
def test_create_waymo_infos_equals_jax(roots, name):
    jroot, proot = roots
    with open(jroot / name, "rb") as f:
        want = pickle.load(f)
    with open(proot / name, "rb") as f:
        got = pickle.load(f)
    assert_same(got, want, name)
    assert len(want) > 0


def test_gt_database_files_equal_jax(roots):
    jroot, proot = roots
    db = "pcdet_gt_database_train_sampled_1"
    want = sorted(p.name for p in (jroot / db).iterdir())
    assert want == sorted(p.name for p in (proot / db).iterdir()) and want
    for name in want:
        assert (proot / db / name).read_bytes() == (jroot / db / name).read_bytes(), name
