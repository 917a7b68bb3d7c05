"""The port's reference-checkpoint converter (`convert_torch_ckpt`) against
the JAX package's tools/convert_torch_ckpt.py on the CPU. Every comparison
is exact: both sides run the same numpy on the same arrays.

  * the layout rules (`convert_weight`, `convert_state_dict`) on the cases of
    tests/test_ckpt_converter.py (a `slow` file: not in tier-1) and on a
    3-tap sparse kernel, which both reject alike;
  * the graft on the tiny student, teacher and SECOND: a synthetic
    OpenPCDet-layout state dict (`reference_state_dict`, numpy-seeded
    values on each JAX tiny training init's structure, BN
    `num_batches_tracked` entries that no rule maps) through the JAX
    `convert_state_dict` and `graft_into_tree` into a tree of that
    structure (other numpy-seeded values, so that a leaf left as it was
    shows), then `convert.from_flax_variables`, equals the port's
    `convert_checkpoint` onto the converted tree key for key and bit for
    bit, with the same unmatched and unplaced lists;
  * where each tensor lands against the leaf it came from (the faults of
    the JAX tool this shows are in ROADMAP §C);
  * the entry point on a full-width fast_cpc.yaml checkpoint.
"""
import importlib.util

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from tests.test_second_e2e import META as SECOND_JMETA, second_model_cfg, synthetic_batch
from tests.test_torch_teacher import _JMODEL as _JTEACHER, _jax_batch
from tsm_det_pointcloud_tpu.models import build_network as jbuild
from tsm_det_pointcloud_tpu_torch import convert_torch_ckpt as port, tiny
from tsm_det_pointcloud_tpu_torch.convert import from_flax_variables
from tsm_det_pointcloud_tpu_torch.infer import ROOT, dataset_meta, load_cfg
from tsm_det_pointcloud_tpu_torch.models import build_network


def _load_tool(name):
    path = ROOT / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jtool = _load_tool("convert_torch_ckpt")

LAYOUTS = {
    "linear": (8, 4),
    "conv1d_1x1": (8, 4, 1),
    "conv2d_1x1": (8, 4, 1, 1),
    "conv2d_3x3": (8, 4, 3, 3),
    "spconv_native": (8, 3, 3, 3, 4),
    "spconv_implicit_gemm": (3, 3, 3, 4, 8),
    "bias": (8,),
}


@pytest.mark.parametrize("case", sorted(LAYOUTS))
def test_weight_layout_rules_equal_jax(case):
    arr = np.random.RandomState(0).randn(*LAYOUTS[case]).astype(np.float32)
    name = "x.bias" if case == "bias" else "x.weight"
    want = jtool.convert_weight(name, arr)
    got = port.convert_weight(name, arr)
    assert got.shape == want.shape and np.array_equal(got, want)


def test_three_tap_spconv_kernel_raises_like_jax():
    """SECOND's conv_out has a (3, 1, 1) kernel: neither spconv layout of
    it is a cube, and both converters fail on it alike (ROADMAP §C)."""
    for shape in ((128, 3, 1, 1, 64), (3, 1, 1, 64, 128)):
        arr = np.zeros(shape, np.float32)
        with pytest.raises(ValueError) as want:
            jtool.convert_weight("conv_out.weight", arr)
        with pytest.raises(ValueError) as got:
            port.convert_weight("conv_out.weight", arr)
        assert str(got.value) == str(want.value)


def test_convert_state_dict_collections_equal_jax():
    rng = np.random.RandomState(1)
    sd = {
        "backbone_3d.SA_modules.0.point_mlps.0.0.weight": torch.from_numpy(
            rng.randn(16, 7, 1, 1).astype(np.float32)),
        "backbone_3d.SA_modules.0.point_mlps.0.1.bn.weight": torch.ones(16),
        "backbone_3d.SA_modules.0.point_mlps.0.1.bn.running_mean": torch.zeros(16),
        "point_head.object_statistic_features": torch.zeros(3, 256),
        "point_head.cls_block.0.3.bias": torch.zeros(1),
        "backbone_3d.SA_modules.0.point_mlps.0.1.bn.num_batches_tracked": torch.tensor(3),
    }
    want, want_unmatched = jtool.convert_state_dict(sd)
    got, got_unmatched = port.convert_state_dict(sd)
    assert got_unmatched == want_unmatched == [
        "backbone_3d.SA_modules.0.point_mlps.0.1.bn.num_batches_tracked"]
    for coll in want:
        assert list(got[coll]) == list(want[coll])
        for k in want[coll]:
            assert np.array_equal(got[coll][k], want[coll][k]), k


def _tsm(cfg, jmodel):
    return cfg, jax.eval_shape(
        lambda b: jmodel.init(jax.random.PRNGKey(0), b, training=True), _jax_batch("sparse"))


def _second():
    jmodel = jbuild(second_model_cfg(), num_class=1, dataset=SECOND_JMETA)
    return tiny.second_model_cfg(), jax.eval_shape(
        lambda b: jmodel.init(jax.random.PRNGKey(0), b, training=True), dict(synthetic_batch()))


MODELS = {
    "student": lambda: _tsm(tiny.tiny_model_cfg(), ge._tsm_model()),
    "teacher": lambda: _tsm(tiny.tiny_teacher_model_cfg(), _JTEACHER),
    "second": _second,
}


def _fill(shapes, rng):
    def fill(path, a):
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return rng.randn(*a.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


@pytest.fixture(scope="module", params=sorted(MODELS))
def case(request):
    """(name, port model cfg, the target: a JAX tiny training init's tree
    with numpy-seeded values, a synthetic reference state dict of other
    numpy-seeded values on the same structure, the port key each reference
    tensor came from, and those values as a port state dict)."""
    cfg, shapes = MODELS[request.param]()
    rng = np.random.RandomState(sorted(MODELS).index(request.param))
    init = _fill(shapes, rng)
    src = from_flax_variables(_fill(shapes, rng))
    ref, source = port.reference_state_dict(src, cfg)
    return request.param, cfg, init, ref, source, src


def _jax_side(init, ref):
    converted, unmatched = jtool.convert_state_dict(ref)
    trees, unplaced = {}, []
    for coll in ("params", "batch_stats", "statistics"):
        trees[coll], skipped = jtool.graft_into_tree(init.get(coll, {}), converted[coll],
                                                     logger=lambda *a: None)
        unplaced += skipped
    trees = jax.tree_util.tree_map(np.asarray, trees)
    return from_flax_variables(trees), unmatched, unplaced


def _without_three_tap_kernels(name, ref):
    """SECOND's state dict without conv_out's kernel, which neither side
    converts (test_three_tap_spconv_kernel_raises_like_jax)."""
    if name != "second":
        return ref
    with pytest.raises(ValueError):
        jtool.convert_state_dict(ref)
    with pytest.raises(ValueError):
        port.convert_state_dict(ref)
    return {k: v for k, v in ref.items() if k != "backbone_3d.conv_out.weight"}


def test_graft_equals_jax(case):
    name, _, init, ref, _, _ = case
    ref = _without_three_tap_kernels(name, ref)
    want, want_unmatched, want_unplaced = _jax_side(init, ref)
    got, report = port.convert_checkpoint(ref, from_flax_variables(init))
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    assert report["unmatched"] == want_unmatched
    assert report["unplaced"] == want_unplaced
    assert report["converted"] == len(ref) - len(want_unmatched)
    # far more tensors have candidates of their leaf name and shape than one
    assert len(report["tied"]) > report["converted"] // 2


# where the reference tensors land against the leaf each came from: the
# teacher head's reg_weight has no rule; SECOND's 1x1 head convs and 1x1
# deblock become 2D kernels no 4D leaf takes, and the 2x2 deblock's
# ConvTranspose2d weight goes to (kh, kw, Cout, Cin), which no leaf has
EXPECTED = {
    "student": dict(unmatched=["point_head.head.reg_weight"], unplaced=[], misplaced=[]),
    "teacher": dict(unmatched=["point_head.head.reg_weight"], unplaced=[], misplaced=[]),
    "second": dict(unmatched=[], misplaced=[], unplaced=[
        "backbone_2d/deblock0/kernel", "backbone_2d/deblock1/kernel",
        "dense_head/conv_box/kernel", "dense_head/conv_cls/kernel",
        "dense_head/conv_dir_cls/kernel"]),
}


def test_round_trip_placements(case):
    """Every converted tensor that a leaf takes lands on the leaf it came
    from, and keeps its value there; what does not is listed in EXPECTED
    (ROADMAP §C: faults of the JAX tool, which the port keeps)."""
    name, _, init, ref, source, src = case
    ref = _without_three_tap_kernels(name, ref)
    template = from_flax_variables(init)
    got, report = port.convert_checkpoint(ref, template)
    misplaced, lost = [], set()
    for ref_name, key in source.items():
        coll, path = port.map_name(ref_name)
        if ref_name not in ref or coll is None or path in report["unplaced"]:
            lost.add(key)
        elif report["placements"][coll][path] != key:
            misplaced.append(ref_name)
    unmatched = [n for n in report["unmatched"] if not n.endswith(".num_batches_tracked")]
    assert unmatched == EXPECTED[name]["unmatched"]
    assert report["unplaced"] == EXPECTED[name]["unplaced"]
    assert misplaced == EXPECTED[name]["misplaced"]
    for key, t in got.items():
        assert torch.equal(t, template[key] if key in lost else src[key]), key


def test_entry_point_on_full_width_fast_cpc(tmp_path):
    """`convert_torch_ckpt --ckpt --cfg_file --out` on a synthetic reference
    checkpoint of a seeded full-width fast_cpc.yaml detector: every converted
    tensor placed on the leaf it came from, the teacher head's reg_weight
    unmatched, epoch and it carried, and the output loads strictly."""
    cfg_file = ROOT / "tools/cfgs/kitti_models/fast_cpc.yaml"
    cfg = load_cfg(cfg_file)
    meta = dataset_meta(cfg, 16384, "train")
    src = build_network(cfg.MODEL, 3, meta, device="cpu", seed=3).state_dict()
    ref, source = port.reference_state_dict(src, cfg.MODEL)
    torch.save({"model_state": ref, "epoch": 80, "it": 1234}, tmp_path / "ref.pth")
    report = port.main(["--ckpt", str(tmp_path / "ref.pth"), "--cfg_file", str(cfg_file),
                        "--out", str(tmp_path / "out.pth")])
    assert report["unplaced"] == []
    assert [n for n in report["unmatched"] if not n.endswith(".num_batches_tracked")] == [
        "point_head.head.reg_weight"]
    out = torch.load(tmp_path / "out.pth", weights_only=True)
    assert (out["epoch"], out["it"]) == (80, 1234)
    model = build_network(cfg.MODEL, 3, meta, device="cpu")
    model.load_state_dict(out["model_state"], strict=True)
    for ref_name, key in source.items():
        if ref_name != "point_head.head.reg_weight":
            assert torch.equal(out["model_state"][key], src[key]), key
