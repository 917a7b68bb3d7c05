"""The port's Waymo metric (eval/waymo_eval.py) against the JAX package's
`waymo_evaluation` on the hand-computed cases of tests/test_waymo_golden.py
and on seeded random gt / detection sets (with difficulty-2 and few-point
gts, heading errors, near misses and the range breakdown). The result dicts
must hold the same keys, each value within 1e-6 (both sides run the same
numpy and scipy calls: the dicts come out equal)."""
import numpy as np
import pytest

from tests.test_waymo_golden import box, dt_anno, gt_anno
from tsm_det_pointcloud_tpu.eval import waymo_eval as jwe
from tsm_det_pointcloud_tpu_torch.eval import waymo_eval as pwe

SQ = dict(l=2.0, w=2.0)
# (gt annos, dt annos, classes, breakdown_range) of each golden case
GOLDEN = {
    "one_tp_one_fp_one_miss": ([gt_anno([box(0.0), box(20.0)])],
                               [dt_anno([box(0.0), box(40.0)], [0.9, 0.8])], ("Vehicle",), False),
    "aph_heading_error": ([gt_anno([box(0.0, **SQ)], names=["Cyclist"])],
                          [dt_anno([box(0.0, ry=np.pi / 4, **SQ)], [0.9], names=["Cyclist"])],
                          ("Cyclist",), False),
    "pi_flip": ([gt_anno([box(0.0, ry=0.0)])], [dt_anno([box(0.0, ry=np.pi)], [0.9])],
                ("Vehicle",), False),
    "mixed_fp_curve": ([gt_anno([box(0.0, **SQ), box(20.0, **SQ)], names=["Cyclist"] * 2)],
                       [dt_anno([box(0.0, ry=np.pi / 4, **SQ), box(40.0, **SQ)], [0.9, 0.8],
                                names=["Cyclist"] * 2)], ("Cyclist",), False),
    "level_split": ([gt_anno([box(0.0), box(20.0)], npts=[99, 3])],
                    [dt_anno([box(20.0)], [0.9])], ("Vehicle",), False),
    "difficulty_2": ([gt_anno([box(0.0)], npts=[99], difficulty=[2])],
                     [dt_anno([box(0.0)], [0.9])], ("Vehicle",), False),
    "hungarian_beats_greedy": ([gt_anno([box(0.0), box(2.2)], names=["Cyclist"] * 2)],
                               [dt_anno([box(0.9), box(-1.0)], [0.9, 0.8],
                                        names=["Cyclist"] * 2)], ("Cyclist",), False),
    "rematch_at_cutoff": ([gt_anno([box(0.0), box(20.0)])],
                          [dt_anno([box(0.0), box(20.0), box(40.0)], [0.9, 0.8, 0.7])],
                          ("Vehicle",), False),
    "range_breakdown": ([gt_anno([box(10.0), box(40.0)])],
                        [dt_anno([box(10.0), box(40.0), box(60.0)], [0.9, 0.8, 0.7])],
                        ("Vehicle",), True),
    "score_quantisation": ([gt_anno([box(0.0)])], [dt_anno([box(0.0)], [0.849])],
                           ("Vehicle",), False),
    "strict_threshold": ([gt_anno([box(0.0)])], [dt_anno([box(1.0)], [0.9])],
                         ("Vehicle",), False),
}


def assert_dicts_close(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])


@pytest.mark.parametrize("case", sorted(GOLDEN))
def test_golden_cases_equal_jax(case):
    gts, dts, classes, breakdown = GOLDEN[case]
    _, want = jwe.waymo_evaluation(gts, dts, classes, breakdown_range=breakdown)
    text, got = pwe.waymo_evaluation(gts, dts, classes, breakdown_range=breakdown)
    assert_dicts_close(got, want)
    assert text.splitlines()[0].split(":")[0] in got


def _random_sets(seed, n_frames=6):
    """Per frame: gts of the three classes (some few-point or difficulty 2)
    and detections: jittered copies of most gts (some with the heading
    flipped or off), a few false positives, all at random scores."""
    rng = np.random.RandomState(seed)
    sizes = {"Vehicle": (4.5, 2.0, 1.6), "Pedestrian": (0.8, 0.8, 1.7),
             "Cyclist": (1.8, 0.8, 1.7)}
    gts, dts = [], []
    for _ in range(n_frames):
        names, boxes = [], []
        for cls, (l, w, h) in sizes.items():
            for _ in range(rng.randint(1, 6)):
                r, a = rng.uniform(3, 70), rng.uniform(-np.pi, np.pi)
                boxes.append([r * np.cos(a), r * np.sin(a), h / 2, l, w, h,
                              rng.uniform(-np.pi, np.pi)])
                names.append(cls)
        g = np.asarray(boxes, np.float32)
        gts.append({"name": np.asarray(names), "gt_boxes_lidar": g,
                    "num_points_in_gt": rng.choice([2, 5, 40, 300], len(g)),
                    "difficulty": rng.choice([0, 1, 2], len(g), p=[0.6, 0.2, 0.2])})
        keep = rng.uniform(size=len(g)) < 0.8
        d = g[keep].copy()
        d[:, :2] += rng.normal(0, 0.15, (len(d), 2))
        d[:, 3:6] *= rng.uniform(0.9, 1.1, (len(d), 3))
        d[:, 6] += rng.choice([0.0, 0.3, np.pi], len(d), p=[0.7, 0.2, 0.1])
        fp = g[rng.randint(0, len(g), 3)].copy()
        fp[:, :2] += rng.uniform(5, 10, (3, 2))
        dnames = np.concatenate([np.asarray(names)[keep], np.asarray(names)[:3]])
        dts.append({"name": dnames.astype(object), "boxes_lidar": np.concatenate([d, fp]),
                    "score": rng.uniform(0, 1, len(d) + 3).astype(np.float32)})
    return gts, dts


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("breakdown", [False, True], ids=["overall", "by_range"])
def test_random_sets_equal_jax(seed, breakdown):
    gts, dts = _random_sets(seed)
    classes = ("Vehicle", "Pedestrian", "Cyclist")
    _, want = jwe.waymo_evaluation(gts, dts, classes, breakdown_range=breakdown)
    _, got = pwe.waymo_evaluation(gts, dts, classes, breakdown_range=breakdown)
    assert_dicts_close(got, want)
    assert len(got) == 12 * (4 if breakdown else 1)
    assert 0 < got["Vehicle/AP_L2"] < 100


def test_echoed_gt_scores_100():
    gts, _ = _random_sets(5)
    dts = [{"name": g["name"].astype(object), "boxes_lidar": g["gt_boxes_lidar"],
            "score": np.linspace(0.9, 0.5, len(g["name"]))} for g in gts]
    _, res = pwe.waymo_evaluation(gts, dts)
    assert all(abs(v - 100.0) < 1e-6 for v in res.values()), res


def test_iou_and_matcher_equal_jax():
    gts, dts = _random_sets(7, n_frames=1)
    a, b = dts[0]["boxes_lidar"], gts[0]["gt_boxes_lidar"]
    np.testing.assert_array_equal(pwe.iou3d_np(a, b), jwe.iou3d_np(a, b))
    iou = pwe.iou3d_np(a, b)
    np.testing.assert_array_equal(pwe.hungarian_match(iou, 0.5), jwe.hungarian_match(iou, 0.5))
    th = np.linspace(-2 * np.pi, 2 * np.pi, 17)
    np.testing.assert_array_equal(pwe._heading_accuracy(th, th[::-1]),
                                  jwe._heading_accuracy(th, th[::-1]))
