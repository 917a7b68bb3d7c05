"""The port's official KITTI eval and its host library against the JAX
package.

  * the host library (csrc/host_ops.cpp, built by g++ from the port's own
    source): `rotate_iou` in every criterion and `points_in_boxes` equal to
    the JAX package's library (the same arithmetic in float64), and within
    float32 round-off (atol 1e-5) of, respectively equal to, their numpy
    plain versions; a source that does not build raises;
  * `get_official_eval_result` on random detections of all three classes
    over gt annos with DontCare, Van and Person_sitting rows: the result
    string and dict equal to the JAX package's; the gt echoed as detections
    scores 100.0 on every metric.
"""
import numpy as np
import pytest

from tsm_det_pointcloud_tpu.eval import kitti_eval as jkitti_eval
from tsm_det_pointcloud_tpu.eval.rotate_iou_np import _rotate_iou_numpy as jrotate_numpy
from tsm_det_pointcloud_tpu.ops import host_native as jhost_native
from tsm_det_pointcloud_tpu_torch.eval import kitti_eval
from tsm_det_pointcloud_tpu_torch.eval.rotate_iou_np import _rotate_iou_numpy, rotate_iou_np
from tsm_det_pointcloud_tpu_torch.ops import boxes, host_native

CLASSES = ["Car", "Pedestrian", "Cyclist"]


def _boxes5(rng, n):
    b = np.zeros((n, 5))
    b[:, :2] = rng.uniform(-6, 6, (n, 2))
    b[:, 2:4] = rng.uniform(0.5, 5, (n, 2))
    b[:, 4] = rng.uniform(-np.pi, np.pi, n)
    return b


@pytest.mark.parametrize("criterion", [-1, 0, 1, None])
def test_rotate_iou_matches_jax_and_plain(criterion):
    rng = np.random.default_rng(3)
    a, b = _boxes5(rng, 40), _boxes5(rng, 30)
    b[:5] = a[:5]                                   # identical pairs too
    got = rotate_iou_np(a, b, criterion)
    assert got.dtype == np.float32 and (got > 0).any()
    np.testing.assert_array_equal(got, jhost_native.rotate_iou(a, b, criterion))
    plain = _rotate_iou_numpy(a, b, criterion)
    np.testing.assert_array_equal(plain, jrotate_numpy(a, b, criterion))
    np.testing.assert_allclose(got, plain, atol=1e-5, rtol=0)


def test_points_in_boxes_matches_jax_and_plain():
    rng = np.random.default_rng(2)
    pts = rng.uniform(-10, 10, (4096, 3))
    bx = np.zeros((12, 7))
    bx[:, :3] = rng.uniform(-8, 8, (12, 3))
    bx[:, 3:6] = rng.uniform(1, 6, (12, 3))        # large enough to overlap
    bx[:, 6] = rng.uniform(-np.pi, np.pi, 12)
    got = boxes.points_in_boxes_np(pts, bx)        # 4096 x 12 pairs: the library
    assert pts.shape[0] * bx.shape[0] >= boxes.HOST_NATIVE_MIN_PAIRS
    np.testing.assert_array_equal(got, jhost_native.points_in_boxes(pts, bx))
    np.testing.assert_array_equal(got, boxes.points_in_boxes_np_plain(pts, bx))
    assert (got >= 0).any() and (got < 0).any()


def test_host_library_build_failure_raises(tmp_path, monkeypatch):
    bad = tmp_path / "host_ops.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(host_native, "SRC", bad)
    monkeypatch.setattr(host_native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(host_native, "_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        host_native.load()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        rotate_iou_np(np.ones((1, 5)), np.ones((1, 5)))


def _gt_annos(rng, n_frames=12):
    """Frames of 3-7 objects of the three classes (some truncated or
    occluded past the easy tier), a Van, a Person_sitting and a DontCare."""
    annos = []
    for _ in range(n_frames):
        names = list(rng.choice(CLASSES, rng.integers(3, 8))) + ["Van", "Person_sitting",
                                                                   "DontCare"]
        n = len(names)
        top = rng.uniform(100, 200, n)
        loc = np.stack([rng.uniform(-15, 15, n), rng.uniform(1, 2, n),
                        rng.uniform(5, 50, n)], 1)
        dims = np.stack([rng.uniform(0.5, 4.5, n), rng.uniform(1.4, 1.9, n),
                         rng.uniform(0.5, 1.9, n)], 1)
        annos.append({
            "name": np.array(names),
            "truncated": rng.choice([0.0, 0.1, 0.4], n),
            "occluded": rng.choice([0, 0, 1, 2], n),
            "alpha": rng.uniform(-np.pi, np.pi, n),
            "bbox": np.stack([rng.uniform(0, 900, n), top, rng.uniform(950, 1200, n),
                              top + rng.uniform(20, 150, n)], 1),
            "dimensions": dims, "location": loc,
            "rotation_y": rng.uniform(-np.pi, np.pi, n),
        })
    return annos


def _det_annos(rng, gt_annos):
    """Per frame: perturbed copies of most gt objects (names kept, DontCare
    dropped) and random false positives of the three classes, with scores."""
    dets = []
    for gt in gt_annos:
        keep = np.flatnonzero((gt["name"] != "DontCare") & (rng.uniform(size=len(gt["name"]))
                                                            < 0.8))
        n_fp = int(rng.integers(0, 4))
        k = len(keep) + n_fp
        name = np.concatenate([gt["name"][keep], rng.choice(CLASSES, n_fp)])
        name = np.where(np.isin(name, CLASSES), name, "Car")
        loc = np.concatenate([gt["location"][keep] + rng.normal(0, 0.2, (len(keep), 3)),
                              np.stack([rng.uniform(-15, 15, n_fp), np.full(n_fp, 1.6),
                                        rng.uniform(5, 50, n_fp)], 1)])
        dims = np.concatenate([gt["dimensions"][keep] * rng.uniform(0.9, 1.1, (len(keep), 3)),
                               np.tile([[3.9, 1.6, 1.6]], (n_fp, 1))])
        bbox = np.concatenate([gt["bbox"][keep] + rng.normal(0, 5, (len(keep), 4)),
                               np.tile([[300.0, 150, 400, 250]], (n_fp, 1))])
        dets.append({
            "name": name, "truncated": np.zeros(k), "occluded": np.zeros(k),
            "alpha": np.concatenate([gt["alpha"][keep], rng.uniform(-np.pi, np.pi, n_fp)]),
            "bbox": bbox, "dimensions": dims, "location": loc,
            "rotation_y": np.concatenate([gt["rotation_y"][keep] + rng.normal(0, 0.1, len(keep)),
                                          rng.uniform(-np.pi, np.pi, n_fp)]),
            "score": rng.uniform(0.05, 1.0, k),
        })
    return dets


def test_official_eval_matches_jax():
    rng = np.random.default_rng(11)
    gt = _gt_annos(rng)
    dt = _det_annos(rng, gt)
    got_str, got = kitti_eval.get_official_eval_result(gt, dt, CLASSES)
    want_str, want = jkitti_eval.get_official_eval_result(gt, dt, CLASSES)
    assert got_str == want_str
    assert got.keys() == want.keys() and len(got) == 72
    for k in want:
        assert got[k] == want[k], k
    # the random detections score some, not all
    assert 0 < got["Car_3d/moderate_R40"] < 100


def test_official_eval_of_echoed_gt_is_100():
    """25 frames of two objects of each class, every one easy (50-150 px
    tall, untruncated, unoccluded; apart in the image and in 3D) plus a Van,
    a Person_sitting and a DontCare, each detected by its own gt at distinct
    scores: every AP of the result dict is 100. (The 41-point sweep steps
    through the true positives' scores: under 41 gt boxes of a class it
    cannot reach every recall point, and the AP stays under 100.)"""
    rng = np.random.default_rng(5)
    gt = _gt_annos(rng, 25)
    for a in gt:
        a["name"] = np.array(CLASSES * 2 + ["Van", "Person_sitting", "DontCare"])
        n = len(a["name"])
        for k in ("alpha", "dimensions", "location", "rotation_y", "bbox"):
            a[k] = a[k][:n] if len(a[k]) >= n else np.resize(a[k], (n,) + a[k].shape[1:])
        a["truncated"] = np.zeros(n)
        a["occluded"] = np.zeros(n, int)
        a["bbox"][:, 0] = 130.0 * np.arange(n)
        a["bbox"][:, 2] = a["bbox"][:, 0] + 100
        a["bbox"][:, 3] = a["bbox"][:, 1] + rng.uniform(50, 150, n)
        a["location"][:, 0] = 6.0 * np.arange(n) - 20
    dt = []
    for a in gt:
        keep = np.isin(a["name"], CLASSES)
        dt.append({k: v[keep] for k, v in a.items()}
                  | {"score": rng.uniform(0.5, 1.0, keep.sum())})
    _, res = kitti_eval.get_official_eval_result(gt, dt, CLASSES)
    assert len(res) == 72    # 3 classes x (3d, bev, image, aos) x 3 tiers x (R11, R40)
    for k, v in res.items():
        assert v == pytest.approx(100.0), k
