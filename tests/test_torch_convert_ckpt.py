"""The port's reference-checkpoint converter (`convert_torch_ckpt`) against
the JAX package's tools/convert_torch_ckpt.py on the CPU. Every comparison
is exact: both sides run the same numpy on the same arrays.

  * the layout rules (`convert_weight`, `convert_state_dict`) on the cases of
    tests/test_ckpt_converter.py (a `slow` file: not in tier-1) and on a
    3-tap sparse kernel, which both reject alike;
  * the graft on the tiny student, teacher, SECOND, PointPillars,
    CenterPoint, the Lyft CenterPoint (five head groups, 5 point features),
    Part-A2, PV-RCNN, PointRCNN and CaDDN (the DDNDeepLabV3 plan): a synthetic
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
import dataclasses
import importlib.util
import re

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from tests.test_second_e2e import synthetic_batch
from tests.test_torch_teacher import _JMODEL as _JTEACHER, _jax_batch
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tsm_det_pointcloud_tpu.models import build_network as jbuild
from tsm_det_pointcloud_tpu.models.detectors.detector3d_template import (
    DatasetMeta as JDatasetMeta,
)
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


def _voxel(cfg, meta, batch=None):
    """A voxel detector of the JAX package built on the port's tiny config
    and geometry; its init's shapes on `batch`, by default the tiny SECOND's."""
    jmodel = jbuild(cfg, num_class=len(meta.class_names),
                    dataset=JDatasetMeta(**dataclasses.asdict(meta)))
    return cfg, jax.eval_shape(
        lambda b: jmodel.init(jax.random.PRNGKey(0), b, training=True),
        dict(synthetic_batch()) if batch is None else batch)


def _lyft_batch():
    """The tiny Lyft CenterPoint's training batch: 5 point features, one car
    a scan."""
    gt = np.zeros((2, 1, 8), np.float32)
    gt[:, 0] = [2, 1, -1, 4.76, 1.93, 1.72, 0.3, 1]
    return {"points": tiny.nusc_points(2), "points_mask": np.ones((2, 512), bool),
            "batch_size": 2, "gt_boxes": gt, "gt_boxes_mask": np.ones((2, 1), bool)}


def _pvssda_batch():
    """The tiny PVSSDA's training batch (PointNet2FSMSG's 512 points a scan)."""
    gt, mask = tiny.pvssda_gt()
    return {"points": tiny.pvssda_points(2), "points_mask": np.ones((2, 512), bool),
            "batch_size": 2, "gt_boxes": gt, "gt_boxes_mask": mask}


def _dsasnet_batch():
    """The tiny DSASNet's training batch (256 points a scan, a car box)."""
    gt, mask = tiny.pvssda_gt()
    return {"points": tiny.second_points(2, 256), "points_mask": np.ones((2, 256), bool),
            "batch_size": 2, "gt_boxes": gt, "gt_boxes_mask": mask}


def _pp_multihead_cfg():
    """The tiny cbgs_pp_multihead model with a deblock_final added (an
    UPSAMPLE_STRIDES one longer), so that its BEV backbone has a strided
    plain conv (deblock0), 1 x 1 and 2 x 2 transposed ones and a transposed
    deblock_final over the concatenation (the anchors then at stride 2)."""
    cfg = tiny.pp_multihead_model_cfg()
    cfg.BACKBONE_2D.UPSAMPLE_STRIDES = [0.5, 1, 2, 2]
    for a in cfg.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG:
        a["feature_map_stride"] = 2
    return cfg


def _pp_multihead_batch():
    gt, mask = tiny.pp_multihead_gt(2)
    return {"points": tiny.nusc_points(2), "points_mask": np.ones((2, 512), bool),
            "batch_size": 2, "gt_boxes": gt, "gt_boxes_mask": mask}


MODELS = {
    "student": lambda: _tsm(tiny.tiny_model_cfg(), ge._tsm_model()),
    "teacher": lambda: _tsm(tiny.tiny_teacher_model_cfg(), _JTEACHER),
    "second": lambda: _voxel(tiny.second_model_cfg(), tiny.SECOND_META),
    "pointpillar": lambda: _voxel(tiny.pointpillar_model_cfg(), tiny.POINTPILLAR_META),
    "centerpoint": lambda: _voxel(tiny.centerpoint_model_cfg(), tiny.CENTERPOINT_META),
    "centerpoint_lyft": lambda: _voxel(tiny.centerpoint_lyft_model_cfg(),
                                       tiny.CENTERPOINT_LYFT_META, _lyft_batch()),
    "parta2": lambda: _voxel(*tiny.two_stage_model("parta2")),
    "pvrcnn": lambda: _voxel(*tiny.two_stage_model("pvrcnn")),
    "pointrcnn": lambda: _voxel(*tiny.two_stage_model("pointrcnn")),
    "voxelrcnn": lambda: _voxel(*tiny.two_stage_model("voxelrcnn")),
    "secondnetiou": lambda: _voxel(*tiny.two_stage_model("secondnetiou")),
    "pvrcnnplusplus": lambda: _voxel(*tiny.two_stage_model("pvrcnnplusplus")),
    "caddn": lambda: _voxel(tiny.caddn_model_cfg("deeplab"), tiny.CADDN_META,
                            dict(tiny.caddn_batch(), batch_size=2)),
    "pvssda": lambda: _voxel(tiny.pvssda_model_cfg("fsmsg"), tiny.PVSSDA_META,
                             _pvssda_batch()),
    "dsasnet": lambda: _voxel(*tiny.two_stage_model("dsasnet"), _dsasnet_batch()),
    "cbgs_pp_multihead": lambda: _voxel(_pp_multihead_cfg(), tiny.PP_MULTIHEAD_META,
                                        _pp_multihead_batch()),
}
# the cases whose 4-D kernels need the port model to tell a strided plain
# conv from a transposed one (`convert.transposed_convs`)
PORT_MODELS = {"cbgs_pp_multihead": lambda cfg: build_network(cfg, 10, tiny.PP_MULTIHEAD_META,
                                                              device="cpu")}


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
    tensor came from, those values as a port state dict, and the port model
    where the layouts need it, else None)."""
    cfg, shapes = MODELS[request.param]()
    model = PORT_MODELS[request.param](cfg) if request.param in PORT_MODELS else None
    rng = np.random.RandomState(sorted(MODELS).index(request.param))
    init = _fill(shapes, rng)
    src = from_flax_variables(_fill(shapes, rng), model)
    ref, source = port.reference_state_dict(src, cfg, model)
    return request.param, cfg, init, ref, source, src, model


def _jax_side(init, ref, model=None):
    converted, unmatched = jtool.convert_state_dict(ref)
    trees, unplaced = {}, []
    for coll in ("params", "batch_stats", "statistics"):
        trees[coll], skipped = jtool.graft_into_tree(init.get(coll, {}), converted[coll],
                                                     logger=lambda *a: None)
        unplaced += skipped
    trees = jax.tree_util.tree_map(np.asarray, trees)
    return from_flax_variables(trees, model), unmatched, unplaced


def _without_three_tap_kernels(name, ref):
    """SECOND's and CenterPoint's state dicts without conv_out's kernel,
    which neither side converts (test_three_tap_spconv_kernel_raises_like_jax)."""
    if name not in ("second", "centerpoint", "centerpoint_lyft", "parta2", "pvrcnn",
                    "voxelrcnn", "secondnetiou", "pvrcnnplusplus", "dsasnet"):
        return ref
    with pytest.raises(ValueError):
        jtool.convert_state_dict(ref)
    with pytest.raises(ValueError):
        port.convert_state_dict(ref)
    return {k: v for k, v in ref.items() if k != "backbone_3d.conv_out.weight"}


def test_graft_equals_jax(case):
    name, _, init, ref, _, _, model = case
    ref = _without_three_tap_kernels(name, ref)
    want, want_unmatched, want_unplaced = _jax_side(init, ref, model)
    got, report = port.convert_checkpoint(ref, from_flax_variables(init, model), model)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    assert report["unmatched"] == want_unmatched
    assert report["unplaced"] == want_unplaced
    assert report["converted"] == len(ref) - len(want_unmatched)
    # far more tensors have candidates of their leaf name and shape than one
    assert len(report["tied"]) > report["converted"] // 2


# where the reference tensors land against the leaf each came from: the
# teacher head's reg_weight has no rule; SECOND's and PointPillars' 1x1 head
# convs and 1x1 deblock become 2D kernels no 4D leaf takes, and the 2x2
# deblock's ConvTranspose2d weight goes to (kh, kw, Cout, Cin), which no
# leaf has (CenterPoint's deblocks alike)
ANCHOR_HEAD_UNPLACED = ["backbone_2d/deblock0/kernel", "backbone_2d/deblock1/kernel",
                        "dense_head/conv_box/kernel", "dense_head/conv_cls/kernel",
                        "dense_head/conv_dir_cls/kernel"]
EXPECTED = {
    "student": dict(unmatched=["point_head.head.reg_weight"], unplaced=[], misplaced=[]),
    "teacher": dict(unmatched=["point_head.head.reg_weight"], unplaced=[], misplaced=[]),
    "second": dict(unmatched=[], misplaced=[], unplaced=ANCHOR_HEAD_UNPLACED),
    "pointpillar": dict(unmatched=[], misplaced=[], unplaced=ANCHOR_HEAD_UNPLACED),
    "centerpoint": dict(unmatched=[], misplaced=[], unplaced=[
        "backbone_2d/deblock0/kernel", "backbone_2d/deblock1/kernel"]),
    # the tiny Lyft CenterPoint's five-group head (the port's names, not
    # OpenPCDet's): each group's branches land on the group's own leaves
    "centerpoint_lyft": dict(unmatched=[], misplaced=[], unplaced=[
        "backbone_2d/deblock0/kernel", "backbone_2d/deblock1/kernel"]),
    # the two-stage tiny models: the anchor head's 1x1 convs as SECOND's; the
    # RoI head's cls_fc / cls_out tie in leaf name and shape with the point
    # head's (Part-A2: a (16, 16) fc, its BN and a (16, 1) output; PV-RCNN:
    # cls_out) and go to the point head's, the first in flax order; PV-RCNN's
    # 1x1 deblock0 goes to another (32, 32) 2D leaf
    "parta2": dict(unmatched=[], unplaced=["backbone_2d/deblock0/kernel"]
                   + ANCHOR_HEAD_UNPLACED[2:],
                   misplaced=[f"roi_head.cls_fc.bn0.{k}" for k in (
                       "running_mean", "running_var", "bias", "weight")]
                   + ["roi_head.cls_out.bias", "roi_head.cls_out.weight"]),
    "pvrcnn": dict(unmatched=[], unplaced=ANCHOR_HEAD_UNPLACED[2:],
                   misplaced=["backbone_2d.deblock0.weight", "roi_head.cls_out.bias",
                              "roi_head.cls_out.weight"]),
    # PV-RCNN++: PV-RCNN's; every VectorPool tensor lands home
    "pvrcnnplusplus": dict(unmatched=[], unplaced=ANCHOR_HEAD_UNPLACED[2:],
                           misplaced=["backbone_2d.deblock0.weight", "roi_head.cls_out.bias",
                                      "roi_head.cls_out.weight"]),
    # Voxel R-CNN and SECONDNetIoU: the anchor head's 1x1 convs and the 1x1
    # deblock0 as Part-A2's; no other leaf shares a leaf name and shape with
    # their RoI heads' (no point head), so every other tensor lands home
    "voxelrcnn": dict(unmatched=[], unplaced=["backbone_2d/deblock0/kernel"]
                      + ANCHOR_HEAD_UNPLACED[2:], misplaced=[]),
    "secondnetiou": dict(unmatched=[], unplaced=["backbone_2d/deblock0/kernel"]
                         + ANCHOR_HEAD_UNPLACED[2:], misplaced=[]),
    # PointRCNN: every tensor placed, but the RoI head's cls_fc BN and
    # cls_out, which tie with the point head's (a 16-wide BN, a (16, 1)
    # output) and go to the point head's, as Part-A2's
    "pointrcnn": dict(unmatched=[], unplaced=[],
                      misplaced=[f"roi_head.cls_fc.bn0.{k}" for k in (
                          "running_mean", "running_var", "bias", "weight")]
                      + ["roi_head.cls_out.bias", "roi_head.cls_out.weight"]),
}


# the tiny PVSSDA on PointNet2FSMSG: no leaf name and shape ties across its
# modules, so every tensor lands home
EXPECTED["pvssda"] = dict(unmatched=[], unplaced=[], misplaced=[])
# the tiny DSASNet on SparsePointBackbone: the RoI head's cls_out ties in
# leaf name and shape with the point head's (a (16, 1) output) and goes there,
# as PV-RCNN's; every other tensor, the hybrid's statistics buffer and its
# window-pool MLPs included, lands home
EXPECTED["dsasnet"] = dict(unmatched=[], unplaced=[],
                           misplaced=["roi_head.cls_out.bias", "roi_head.cls_out.weight"])


# the tiny multi-head with a deblock_final: its 1x1 head convs and 1x1
# deblock1 and its 2x2 deblock2 (ConvTranspose2d (8, 8) -> (32, 8): read as a
# Conv2d it becomes (2, 2, 8, 32), which no leaf has) as PointPillars'; the
# strided plain conv deblock0 is a Conv2d in both layouts and lands home
# unflipped; deblock_final's square (24, 24) ConvTranspose2d weight, read as
# a Conv2d, fits its own leaf: it lands home with its two channel axes
# swapped and unflipped (ROADMAP §C)
EXPECTED["cbgs_pp_multihead"] = dict(
    unmatched=[], misplaced=[],
    unplaced=["backbone_2d/deblock1/kernel", "backbone_2d/deblock2/kernel",
              "dense_head/conv_box/kernel", "dense_head/conv_cls/kernel"],
    mislaid=["module_list.2.deblock_final.weight"])


def _caddn_unplaced():
    """The tiny CaDDN's leaves no reference tensor lands on (ROADMAP §C, the
    JAX tool's name rules): every _ConvBN's BN scale, whose `.weight` the
    tool names a conv kernel, every 1x1 conv of the depth network (the
    classifier's too), the collapse's, and the anchor head's and 1x1
    deblock's, in flax order."""
    ddn = []
    one_by_one = {"ASPP_0": (0, 4, 5), **{f"Bottleneck_{k}": (0, 2, 3) for k in range(4)},
                  "": (2,)}
    for scope, n in (("ASPP_0", 6), *((f"Bottleneck_{k}", 4) for k in range(4)), ("", 3)):
        for i in range(n):
            path = f"vfe/ddn/{scope + '/' if scope else ''}_ConvBN_{i}"
            ddn.append(f"{path}/BatchNorm_0/kernel")
            if i in one_by_one[scope]:
                ddn.append(f"{path}/Conv_0/kernel")
    return ddn + ["vfe/ddn/classifier/kernel", "map_to_bev_module/collapse/kernel",
                  "backbone_2d/deblock0/kernel"] + ANCHOR_HEAD_UNPLACED[2:]


# the tiny CaDDN: every reference tensor is matched by name; the stem's and
# the logits' _ConvBN (8 and 256 channels) tie in leaf name and shape with
# earlier leaves in flax order (a bottleneck's BN, an ASPP conv) and go there
EXPECTED["caddn"] = dict(
    unmatched=[], unplaced=_caddn_unplaced(),
    misplaced=[f"vfe.ddn._ConvBN_{i}.BatchNorm_0.running_{k}" for i in (0, 1)
               for k in ("mean", "var")]
    + ["vfe.ddn._ConvBN_0.BatchNorm_0.bias", "vfe.ddn._ConvBN_1.BatchNorm_0.bias",
       "vfe.ddn._ConvBN_1.Conv_0.weight"])


def test_round_trip_placements(case):
    """Every converted tensor that a leaf takes lands on the leaf it came
    from, and keeps its value there; what does not is listed in EXPECTED
    (ROADMAP §C: faults of the JAX tool, which the port keeps): a leaf no
    tensor lands on keeps the template's value, and a leaf a misplaced tensor
    lands on is not held."""
    name, _, init, ref, source, src, model = case
    ref = _without_three_tap_kernels(name, ref)
    template = from_flax_variables(init, model)
    got, report = port.convert_checkpoint(ref, template, model)
    misplaced, lost, taken = [], set(), set()
    for ref_name, key in source.items():
        coll, path = port.map_name(ref_name)
        if ref_name not in ref or coll is None or path in report["unplaced"]:
            lost.add(key)
        elif report["placements"][coll][path] != key:
            misplaced.append(ref_name)
            lost.add(key)
            taken.add(report["placements"][coll][path])
    unmatched = [n for n in report["unmatched"] if not n.endswith(".num_batches_tracked")]
    assert unmatched == EXPECTED[name]["unmatched"]
    assert report["unplaced"] == EXPECTED[name]["unplaced"]
    assert misplaced == EXPECTED[name]["misplaced"]
    mislaid = EXPECTED[name].get("mislaid", [])
    for key, t in got.items():
        if key in taken:      # a misplaced tensor went here too (ROADMAP §C)
            continue
        if key in mislaid:    # its own leaf in the JAX tool's layout (ROADMAP §C)
            assert torch.equal(t, src[key].transpose(0, 1).flip(2, 3)), key
            continue
        assert torch.equal(t, template[key] if key in lost else src[key]), key
    if name == "cbgs_pp_multihead":
        # a plain strided conv: the reference's Conv2d weight is the port's
        # own layout and lands unflipped; the transposed convs' port weights
        # are the kernels flax keeps flipped in both spatial axes
        deblock0 = "module_list.2.deblock0.weight"
        assert torch.equal(ref["backbone_2d.deblock0.weight"], src[deblock0])
        assert torch.equal(got[deblock0], src[deblock0])
        flax = {k: a for _, _, k, a in port.flax_view(src, model)}
        for k in (deblock0, "module_list.2.deblock_final.weight"):
            plain = np.ascontiguousarray(flax[k].transpose(3, 2, 0, 1))
            assert np.array_equal(src[k].numpy(), plain) == (k == deblock0), k


# OpenPCDet's own module names where the port's (the flax ones) differ:
# PillarVFE's PFNLayer and CenterHead's shared conv and SeparateHead
OPENPCDET_NAMES = [
    (r"^vfe\.pfn_(\d+)\.", r"vfe.pfn_layers.\1.linear."),
    (r"^vfe\.pfn_bn_(\d+)\.", r"vfe.pfn_layers.\1.norm."),
    (r"^dense_head\.shared_conv\.", "dense_head.shared_conv.0."),
    (r"^dense_head\.shared_bn\.", "dense_head.shared_conv.1."),
    (r"^dense_head\.head_(\d+)\.(\w+?)_conv(\d+)\.", r"dense_head.heads_list.\1.\2.\3.0."),
    (r"^dense_head\.head_(\d+)\.(\w+?)_bn(\d+)\.", r"dense_head.heads_list.\1.\2.\3.1."),
    (r"^dense_head\.head_(\d+)\.(\w+?)_out\.", r"dense_head.heads_list.\1.\2.1."),
]


def _openpcdet_name(name):
    for pat, rep in OPENPCDET_NAMES:
        if re.match(pat, name):
            return re.sub(pat, rep, name)
    return name


@pytest.mark.parametrize("name", ["pointpillar", "centerpoint"])
def test_openpcdet_zoo_names_place_like_jax(name):
    """A reference checkpoint under OpenPCDet's names of the PFN layer
    (`vfe.pfn_layers.0.linear` / `.norm`) and of the center head
    (`dense_head.shared_conv.{0,1}`, `dense_head.heads_list.*`): both
    converters place it alike, bit for bit. No rule maps a BN named `norm`
    or `<i>.1` to a scale: its weight becomes a 1-D `kernel` that no leaf
    takes (unplaced). PointPillars' PFN is then placed right but for that
    scale (its bias and statistics go to the only PFN BN, the first such
    leaf in flax order). CenterPoint's head shares no path component with
    its flax leaves but the leaf name: each of its BN biases and statistics,
    hidden convs and output convs goes to the first leaf of its shape in
    flax order (the sparse stem's conv2_down BN, the BEV backbone's
    block0_conv0, head_0's first output conv of that width): 67 tensors
    misplaced on the tiny model (ROADMAP §C)."""
    cfg, shapes = MODELS[name]()
    rng = np.random.RandomState(sorted(MODELS).index(name))
    init = _fill(shapes, rng)
    src = from_flax_variables(_fill(shapes, rng))
    ref, source = port.reference_state_dict(src, cfg)
    ref = {_openpcdet_name(k): v for k, v in _without_three_tap_kernels(name, ref).items()}
    source = {_openpcdet_name(k): v for k, v in source.items()}
    want, want_unmatched, want_unplaced = _jax_side(init, ref)
    got, report = port.convert_checkpoint(ref, from_flax_variables(init))
    assert list(got) == list(want) and all(torch.equal(got[k], want[k]) for k in want)
    assert report["unmatched"] == want_unmatched and report["unplaced"] == want_unplaced
    misplaced = {}
    for ref_name, key in source.items():
        coll, path = port.map_name(ref_name)
        if ref_name in ref and coll is not None and path not in report["unplaced"] \
                and report["placements"][coll][path] != key:
            misplaced[ref_name] = report["placements"][coll][path]
    scales = [p for p in report["unplaced"] if p.endswith("/kernel") and "deblock" not in p
              and not p.startswith("dense_head/conv_")]
    if name == "pointpillar":
        assert scales == ["vfe/pfn_layers/0/norm/kernel"] and misplaced == {}
    else:
        assert len(scales) == 11 and all("/1/kernel" in p for p in scales)
        assert len(misplaced) == 67 and all(n.startswith("dense_head.") for n in misplaced)
        assert misplaced["dense_head.heads_list.0.hm.0.0.weight"] == (
            "module_list.3.block0_conv0.weight")
        assert misplaced["dense_head.shared_conv.1.running_mean"] == (
            "module_list.1.conv2_down.bn.running_mean")


# OpenPCDet's names of the two-stage modules where the port's (the flax
# ones) differ: the VSA's SA layers and fusion, PV-RCNN++'s VectorPool
# groups (`layer_<k>.post_mlps`) and their `msg_post_mlps`, the point heads'
# cls / part layers, the RoI heads' grid-pool MLPs and FC stacks (a Conv1d,
# BN, ReLU, Dropout each; the output conv after them), UNetV2's decoder convs
def _seq(prefix, first, step, offset=0):
    return lambda m: f"{prefix}.{int(m.group(first)) * step + offset}."


def _two_stage_openpcdet_names(cfg):
    conv_src = [s for s in cfg.get("PFE", {}).get("FEATURES_SOURCE", []) if s.startswith("x_")]
    n = {k: len(cfg.ROI_HEAD.get(f"{k.upper()}_FC", [])) for k in ("cls", "reg")}
    n_point = {k: len(cfg.POINT_HEAD.get(f"{k.upper()}_FC", [])) for k in ("cls", "part")}
    rules = [
        (r"^pfe\.sa_(x_conv\d)\.scale(\d)\.post_mlp\.(fc|bn)(\d)\.",
         lambda m: f"pfe.SA_layers.{conv_src.index(m.group(1))}.layer_{m.group(2)}.post_mlps."
                   f"{3 * int(m.group(4)) + (m.group(3) == 'bn')}."),
        (r"^pfe\.sa_rawpoints\.scale(\d)\.post_mlp\.(fc|bn)(\d)\.",
         lambda m: f"pfe.SA_rawpoints.layer_{m.group(1)}.post_mlps."
                   f"{3 * int(m.group(3)) + (m.group(2) == 'bn')}."),
        (r"^pfe\.sa_(x_conv\d)\.agg\.(fc|bn)(\d)\.",
         lambda m: f"pfe.SA_layers.{conv_src.index(m.group(1))}.msg_post_mlps."
                   f"{3 * int(m.group(3)) + (m.group(2) == 'bn')}."),
        (r"^pfe\.sa_rawpoints\.agg\.(fc|bn)(\d)\.",
         lambda m: f"pfe.SA_rawpoints.msg_post_mlps.{3 * int(m.group(2)) + (m.group(1) == 'bn')}."),
        (r"^pfe\.sa_(x_conv\d)\.mlp(\d)\.(fc|bn)(\d)\.",
         lambda m: f"pfe.SA_layers.{conv_src.index(m.group(1))}.mlps.{m.group(2)}."
                   f"{3 * int(m.group(4)) + (m.group(3) == 'bn')}."),
        (r"^pfe\.sa_rawpoints\.mlp(\d)\.(fc|bn)(\d)\.",
         lambda m: f"pfe.SA_rawpoints.mlps.{m.group(1)}."
                   f"{3 * int(m.group(3)) + (m.group(2) == 'bn')}."),
        (r"^pfe\.vsa_point_feature_fusion\.", lambda m: "pfe.vsa_point_feature_fusion.0."),
        (r"^pfe\.fusion_bn\.", lambda m: "pfe.vsa_point_feature_fusion.1."),
        (r"^point_head\.(cls|part)_fc\.(fc|bn)(\d)\.",
         lambda m: f"point_head.{'cls_layers' if m.group(1) == 'cls' else 'part_reg_layers'}."
                   f"{3 * int(m.group(3)) + (m.group(2) == 'bn')}."),
        (r"^point_head\.(cls|part)_out\.",
         lambda m: f"point_head.{'cls_layers' if m.group(1) == 'cls' else 'part_reg_layers'}."
                   f"{3 * n_point[m.group(1)]}."),
        (r"^roi_head\.pool_mlp(\d)\.(fc|bn)(\d)\.",
         lambda m: f"roi_head.roi_grid_pool_layer.mlps.{m.group(1)}."
                   f"{3 * int(m.group(3)) + (m.group(2) == 'bn')}."),
        (r"^roi_head\.(shared|cls|reg)_(fc|bn)(\d)\.",
         lambda m: f"roi_head.{m.group(1)}{'_fc_layer' if m.group(1) == 'shared' else '_layers'}."
                   f"{4 * int(m.group(3)) + (m.group(2) == 'bn')}."),
        (r"^roi_head\.(cls|reg)_fc\.(fc|bn)(\d)\.",
         lambda m: f"roi_head.{m.group(1)}_layers."
                   f"{4 * int(m.group(3)) + (m.group(2) == 'bn')}."),
        (r"^roi_head\.(cls|reg)_out\.", lambda m: f"roi_head.{m.group(1)}_layers."
                                               f"{4 * n[m.group(1)]}."),
        (r"^backbone_3d\.up(\d)to\d_(lateral|inv|fuse)\.(bn\.)?",
         lambda m: f"backbone_3d."
                   f"{dict(lateral='conv_up_t', inv='inv_conv', fuse='conv_up_m')[m.group(2)]}"
                   f"{m.group(1)}.{1 if m.group(3) else 0}."),
    ]

    def rename(name):
        for pat, rep in rules:
            if re.match(pat, name):
                return re.sub(pat, rep, name)
        return name

    return rename


@pytest.mark.parametrize("name", ["parta2", "pvrcnn", "pvrcnnplusplus"])
def test_openpcdet_two_stage_names_place_like_jax(name):
    """A reference checkpoint of the tiny two-stage detector under OpenPCDet's
    module names (`_two_stage_openpcdet_names`): both converters place it
    alike, bit for bit, with the same unmatched and unplaced lists; what the
    JAX rules make of it is in ROADMAP §C (no rule maps a BN named `<i>` to
    a scale, and a tensor whose path shares nothing with its leaf's but the
    leaf name goes to the first leaf of its shape in flax order). Under
    PV-RCNN++'s VectorPool names every BN scale of a group is unplaced, each
    group's first post_mlp layer, whose width of cells x (3 + C) inputs no
    other leaf has, lands home, and x_conv3's msg_post_mlps BN lands on the
    sparse stem's conv1 BN, the first 16-wide BN in flax order."""
    cfg, shapes = MODELS[name]()
    rng = np.random.RandomState(sorted(MODELS).index(name))
    init = _fill(shapes, rng)
    src = from_flax_variables(_fill(shapes, rng))
    ref, source = port.reference_state_dict(src, cfg)
    rename = _two_stage_openpcdet_names(cfg)
    ref = _without_three_tap_kernels(name, ref)
    renamed = [k for k in ref if rename(k) != k]
    ref = {rename(k): v for k, v in ref.items()}
    source = {rename(k): v for k, v in source.items()}
    assert len(renamed) > 20
    want, want_unmatched, want_unplaced = _jax_side(init, ref)
    got, report = port.convert_checkpoint(ref, from_flax_variables(init))
    assert list(got) == list(want) and all(torch.equal(got[k], want[k]) for k in want)
    assert report["unmatched"] == want_unmatched and report["unplaced"] == want_unplaced
    placed = sum(torch.equal(got[key], src[key]) for n, key in source.items() if n in ref)
    print(f"{name}: {len(ref)} tensors, {len(renamed)} renamed, "
          f"{len(report['unplaced'])} unplaced, {placed} on the leaf they came from")
    if name == "pvrcnnplusplus":
        pool = [p for p in report["unplaced"] if "/layer_" in p or "/msg_post_mlps/" in p]
        assert len(pool) == 10 and all(p.endswith(("/1/kernel", "/4/kernel")) for p in pool)
        home = {"pfe/SA_rawpoints/layer_0/post_mlps/0/kernel":
                "module_list.3.sa_rawpoints.scale0.post_mlp.fc0.weight",
                "pfe/SA_rawpoints/layer_1/post_mlps/0/kernel":
                "module_list.3.sa_rawpoints.scale1.post_mlp.fc0.weight",
                "pfe/SA_layers/0/layer_0/post_mlps/0/kernel":
                "module_list.3.sa_x_conv3.scale0.post_mlp.fc0.weight",
                "pfe/SA_layers/0/msg_post_mlps/1/bias": "module_list.1.conv1.bn.bias"}
        for path, key in home.items():
            assert report["placements"]["params"][path] == key, path


def _voxel_roi_openpcdet_names(cfg):
    """OpenPCDet's names of Voxel R-CNN's and SECONDNetIoU's RoI heads where
    the port's (the flax ones) differ: the grid-pool layers
    (`roi_head.roi_grid_pool_layers.<source>.mlps.<scale>.<k>`, a conv, BN
    and ReLU a layer), `roi_head.shared_fc_layer`, `roi_head.cls_layers` /
    `reg_layers` / `iou_layers` (a linear or conv, BN, ReLU and Dropout a
    layer; the output after them)."""
    sources = list(cfg.ROI_HEAD.get("ROI_GRID_POOL", {}).get("POOL_LAYERS", {}))
    n = {k: len(cfg.ROI_HEAD.get(f"{k.upper()}_FC", [])) for k in ("cls", "reg", "iou")}
    rules = [
        (r"^roi_head\.pool_(x_conv\d)_(\d)\.(fc|bn)(\d)\.",
         lambda m: f"roi_head.roi_grid_pool_layers.{sources.index(m.group(1))}.mlps."
                   f"{m.group(2)}.{3 * int(m.group(4)) + (m.group(3) == 'bn')}."),
        (r"^roi_head\.shared_(fc|bn)(\d)\.",
         lambda m: f"roi_head.shared_fc_layer.{4 * int(m.group(2)) + (m.group(1) == 'bn')}."),
        (r"^roi_head\.(cls|reg|iou)_fc\.(fc|bn)(\d)\.",
         lambda m: f"roi_head.{m.group(1)}_layers."
                   f"{4 * int(m.group(3)) + (m.group(2) == 'bn')}."),
        (r"^roi_head\.(cls|reg|iou)_out\.",
         lambda m: f"roi_head.{m.group(1)}_layers.{4 * n[m.group(1)]}."),
    ]

    def rename(name):
        for pat, rep in rules:
            if re.match(pat, name):
                return re.sub(pat, rep, name)
        return name

    return rename


@pytest.mark.parametrize("name", ["voxelrcnn", "secondnetiou"])
def test_openpcdet_voxel_roi_names_place_like_jax(name):
    """A reference checkpoint of the tiny Voxel R-CNN or SECONDNetIoU under
    OpenPCDet's RoI-head names (`_voxel_roi_openpcdet_names`): both
    converters place it alike, bit for bit, with the same unmatched and
    unplaced lists. No rule maps a BN named `<k>` to a scale: each RoI-head
    BN weight becomes a 1-D kernel no leaf takes, and the other renamed
    tensors, which share no path component with their leaves but the leaf
    name, go to the first leaf of their shape in flax order (ROADMAP §C)."""
    cfg, shapes = MODELS[name]()
    rng = np.random.RandomState(sorted(MODELS).index(name))
    init = _fill(shapes, rng)
    src = from_flax_variables(_fill(shapes, rng))
    ref, source = port.reference_state_dict(src, cfg)
    rename = _voxel_roi_openpcdet_names(cfg)
    ref = _without_three_tap_kernels(name, ref)
    renamed = [k for k in ref if rename(k) != k]
    ref = {rename(k): v for k, v in ref.items()}
    source = {rename(k): v for k, v in source.items()}
    assert len(renamed) == len([k for k in ref if k.startswith("roi_head.")]) > 10
    head_names = {"voxelrcnn": ("roi_head.roi_grid_pool_layers.1.mlps.0.3.weight",
                                "roi_head.shared_fc_layer.1.running_var",
                                "roi_head.cls_layers.4.bias", "roi_head.reg_layers.0.weight"),
                  "secondnetiou": ("roi_head.shared_fc_layer.0.weight",
                                   "roi_head.iou_layers.1.weight", "roi_head.iou_layers.4.bias")}
    for n_ in head_names[name]:
        assert n_ in ref, n_
    want, want_unmatched, want_unplaced = _jax_side(init, ref)
    got, report = port.convert_checkpoint(ref, from_flax_variables(init))
    assert list(got) == list(want) and all(torch.equal(got[k], want[k]) for k in want)
    assert report["unmatched"] == want_unmatched and report["unplaced"] == want_unplaced
    bn_scales = [p for p in report["unplaced"] if p.startswith("roi_head/")]
    assert bn_scales and all(p.endswith("/kernel") for p in bn_scales)
    placed = sum(torch.equal(got[key], src[key]) for n_, key in source.items() if n_ in ref)
    print(f"{name}: {len(ref)} tensors, {len(renamed)} renamed, "
          f"{len(report['unplaced'])} unplaced, {placed} on the leaf they came from")


@pytest.mark.parametrize("name,unplaced", [
    ("pointpillar", ["backbone_2d/deblock0/kernel", "backbone_2d/deblock2/kernel",
                     "dense_head/conv_box/kernel", "dense_head/conv_cls/kernel",
                     "dense_head/conv_dir_cls/kernel"]),
    ("centerpoint", ["backbone_2d/deblock0/kernel"])])
def test_full_width_square_deblock_lands_unread(name, unplaced):
    """At full width pointpillar.yaml's deblock1 (128 -> 128) and
    centerpoint.yaml's (256 -> 256) are 2 x 2 ConvTranspose2d's with as
    many inputs as outputs: read as a Conv2d's (kh, kw, Cin, Cout) their
    weight has the leaf's shape, so the graft puts it on its own leaf,
    unflipped and with inputs and outputs swapped, without a word; every
    other placed tensor equals its source (ROADMAP §C)."""
    cfg = load_cfg(ROOT / f"tools/cfgs/kitti_models/{name}.yaml")
    meta = dataset_meta(cfg, 16384, "train")
    src = build_network(cfg.MODEL, 3, meta, device="cpu", seed=3).state_dict()
    template = build_network(cfg.MODEL, 3, meta, device="cpu", seed=4).state_dict()
    ref, source = port.reference_state_dict(src, cfg.MODEL)
    ref = {k: v for k, v in ref.items() if k != "backbone_3d.conv_out.weight"}
    got, report = port.convert_checkpoint(ref, template)
    assert report["unplaced"] == unplaced and report["unmatched"] == [
        n for n in ref if n.endswith(".num_batches_tracked")]
    differ = [key for n, key in source.items() if n in ref
              and port.map_name(n)[1] not in unplaced and not torch.equal(got[key], src[key])]
    key = f"module_list.{3 if name == 'centerpoint' else 2}.deblock1.weight"
    assert differ == [key]
    w = ref[f"backbone_2d.deblock1.weight"].numpy()             # (Cin, Cout, 2, 2)
    assert np.array_equal(got[key].numpy(), w.transpose(1, 0, 2, 3)[:, :, ::-1, ::-1])


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


def _pointrcnn_openpcdet_names(cfg):
    """OpenPCDet's PointRCNN names of the port's (the flax) modules: the SA
    and FP modules' SharedMLPs (Conv2d, BN, ReLU a layer), the point head's
    cls / box layers (Linear, BN, ReLU a layer, the output Linear after
    them), the RoI head's `xyz_up_layer` (as built with BN), in-RoI
    `SA_modules` and FC stacks (Conv1d, BN, ReLU a layer, a Dropout after
    the first: DP_RATIO 0.0 >= 0)."""
    n_point = {k: len(cfg.POINT_HEAD[f"{k.upper()}_FC"]) for k in ("cls", "reg")}
    n_roi = {k: len(cfg.ROI_HEAD[f"{k.upper()}_FC"]) for k in ("cls", "reg")}

    def fc(k):
        return 3 * k + (k > 0)

    rules = [
        (r"^backbone_3d\.sa(\d)\.mlp(\d)\.(fc|bn)(\d)\.",
         lambda m: f"backbone_3d.SA_modules.{m.group(1)}.mlps.{m.group(2)}."
                   f"{3 * int(m.group(4)) + (m.group(3) == 'bn')}."),
        (r"^backbone_3d\.fp(\d)\.mlp\.(fc|bn)(\d)\.",
         lambda m: f"backbone_3d.FP_modules.{m.group(1)}.mlp."
                   f"{3 * int(m.group(3)) + (m.group(2) == 'bn')}."),
        (r"^point_head\.(cls|box)_fc\.(fc|bn)(\d)\.",
         lambda m: f"point_head.{m.group(1)}_layers.{3 * int(m.group(3)) + (m.group(2) == 'bn')}."),
        (r"^point_head\.(cls|box)_out\.",
         lambda m: f"point_head.{m.group(1)}_layers."
                   f"{3 * n_point['cls' if m.group(1) == 'cls' else 'reg']}."),
        (r"^roi_head\.xyz_up\.(fc|bn)(\d)\.",
         lambda m: f"roi_head.xyz_up_layer.{3 * int(m.group(2)) + (m.group(1) == 'bn')}."),
        (r"^roi_head\.roi_sa(\d)\.(mlp0\.)?(fc|bn)(\d)\.",
         lambda m: f"roi_head.SA_modules.{m.group(1)}.mlps.0."
                   f"{3 * int(m.group(4)) + (m.group(3) == 'bn')}."),
        (r"^roi_head\.shared_(fc|bn)(\d)\.",
         lambda m: f"roi_head.shared_fc_layer.{fc(int(m.group(2))) + (m.group(1) == 'bn')}."),
        (r"^roi_head\.(cls|reg)_fc\.(fc|bn)(\d)\.",
         lambda m: f"roi_head.{m.group(1)}_layers.{fc(int(m.group(3))) + (m.group(2) == 'bn')}."),
        (r"^roi_head\.(cls|reg)_out\.",
         lambda m: f"roi_head.{m.group(1)}_layers.{fc(n_roi[m.group(1)])}."),
    ]

    def rename(name):
        for pat, rep in rules:
            if re.match(pat, name):
                return re.sub(pat, rep, name)
        return name

    return rename


def test_openpcdet_pointrcnn_names_place_like_jax():
    """A reference checkpoint of the tiny PointRCNN under OpenPCDet's module
    names (`backbone_3d.SA_modules.<i>.mlps.<j>.<k>`, `FP_modules`,
    `point_head.cls_layers`, `roi_head.SA_modules`, `roi_head.xyz_up_layer`,
    ...): both converters place it alike, bit for bit, with the same
    unmatched and unplaced lists. No rule maps a BN named `<k>` to a scale
    (its weight becomes an unplaced 1-D kernel), and a tensor whose path
    shares nothing with its leaf's but the leaf name goes to the first leaf
    of its shape in flax order (ROADMAP §C)."""
    cfg, shapes = MODELS["pointrcnn"]()
    rng = np.random.RandomState(sorted(MODELS).index("pointrcnn"))
    init = _fill(shapes, rng)
    src = from_flax_variables(_fill(shapes, rng))
    ref, source = port.reference_state_dict(src, cfg)
    rename = _pointrcnn_openpcdet_names(cfg)
    renamed = [k for k in ref if rename(k) != k]
    assert len(renamed) == len(ref)
    ref = {rename(k): v for k, v in ref.items()}
    source = {rename(k): v for k, v in source.items()}
    for name in ("backbone_3d.SA_modules.1.mlps.0.3.weight", "backbone_3d.FP_modules.0.mlp.0.weight",
                 "point_head.cls_layers.0.weight", "point_head.cls_layers.3.bias",
                 "roi_head.SA_modules.1.mlps.0.3.weight", "roi_head.xyz_up_layer.4.weight",
                 "roi_head.cls_layers.4.bias"):
        assert name in ref, name
    want, want_unmatched, want_unplaced = _jax_side(init, ref)
    got, report = port.convert_checkpoint(ref, from_flax_variables(init))
    assert list(got) == list(want) and all(torch.equal(got[k], want[k]) for k in want)
    assert report["unmatched"] == want_unmatched and report["unplaced"] == want_unplaced
    placed = sum(torch.equal(got[key], src[key]) for n, key in source.items() if n in ref)
    print(f"pointrcnn: {len(ref)} tensors, {len(renamed)} renamed, "
          f"{len(report['unplaced'])} unplaced, {placed} on the leaf they came from")


def test_openpcdet_nuscenes_centerpoint_names_place_like_jax():
    """A synthetic reference checkpoint of the full-width
    cbgs_voxel01_res3d_centerpoint.yaml detector (six CenterHead groups,
    each with a vel branch) under OpenPCDet's names
    (`dense_head.heads_list.<g>.<branch>.*`): both converters place it
    alike, bit for bit, with the same unmatched and unplaced lists. The
    groups' branches share their shapes (every hidden conv is (3, 3, 64,
    64), the center / rot / vel outputs (3, 3, 64, 2)), so each such tensor,
    whose path shares nothing with its leaf's but the leaf name, goes to the
    first leaf of its shape in flax order, whatever its group: each hidden
    conv on head_0's center_conv0, each output on head_0's first output of
    its width (every vel and 2-class hm output on center_out, every 1-class
    hm on center_z_out), the BN biases and statistics on the sparse stem's
    conv3_down BN (the first 64-wide BN in flax order); each BN scale,
    a 1-D kernel, is unplaced. 248 of the 257 placed dense-head tensors
    land away from home (ROADMAP §C)."""
    cfg = load_cfg(ROOT / "tools/cfgs/nuscenes_models/cbgs_voxel01_res3d_centerpoint.yaml")
    meta = dataset_meta(cfg, 4096, "train")
    jmodel = jbuild(cfg.MODEL, num_class=10, dataset=JDatasetMeta(**dataclasses.asdict(meta)))
    batch = {"points": np.zeros((1, 4096, 5), np.float32),
             "points_mask": np.ones((1, 4096), bool), "batch_size": 1}
    shapes = jax.eval_shape(lambda b: jmodel.init(jax.random.PRNGKey(0), b, training=False),
                            batch)
    rng = np.random.RandomState(11)
    init = _fill(shapes, rng)
    src = from_flax_variables(_fill(shapes, rng))
    ref, source = port.reference_state_dict(src, cfg.MODEL)
    ref = {_openpcdet_name(k): v for k, v in ref.items() if k != "backbone_3d.conv_out.weight"}
    source = {_openpcdet_name(k): v for k, v in source.items()}
    vel = [k for k in ref if re.match(r"dense_head\.heads_list\.\d\.vel\.", k)]
    assert len(vel) == 6 * 9 and "dense_head.heads_list.5.vel.1.weight" in ref
    want, want_unmatched, want_unplaced = _jax_side(init, ref)
    got, report = port.convert_checkpoint(ref, from_flax_variables(init))
    assert list(got) == list(want) and all(torch.equal(got[k], want[k]) for k in want)
    assert report["unmatched"] == want_unmatched and report["unplaced"] == want_unplaced
    misplaced, home = {}, 0
    for ref_name, key in source.items():
        coll, path = port.map_name(ref_name)
        if ref_name not in ref or coll is None or path in report["unplaced"]:
            continue
        if report["placements"][coll][path] != key:
            misplaced[ref_name] = report["placements"][coll][path]
        else:
            home += 1
    head = [n for n in ref if n.startswith("dense_head.") and port.map_name(n)[0] is not None
            and port.map_name(n)[1] not in report["unplaced"]]
    print(f"nuScenes CenterPoint: {len(ref)} tensors, {len(report['unplaced'])} unplaced, "
          f"{home} home, {len(misplaced)} misplaced ({len(head)} placed dense-head tensors)")
    assert all(n.startswith("dense_head.") for n in misplaced)
    assert all(misplaced[n] == "module_list.4.head_0.center_out.weight"
               for n in vel if re.search(r"\.vel\.1\.weight$", n))
    assert misplaced["dense_head.heads_list.3.hm.0.0.weight"] == (
        "module_list.4.head_0.center_conv0.weight")
    assert misplaced["dense_head.shared_conv.1.running_mean"] == (
        "module_list.1.conv3_down.bn.running_mean")
    assert (len(report["unplaced"]), home, len(misplaced), len(head)) == NUSC_PLACEMENTS


# (unplaced, placed home, misplaced, placed dense-head tensors) of the full-width
# nuScenes CenterPoint's OpenPCDet-named checkpoint (ROADMAP §C)
NUSC_PLACEMENTS = (38, 182, 248, 257)
