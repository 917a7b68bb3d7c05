"""The port stands alone: it imports neither JAX, flax nor the JAX package;
its entry points refuse CUDA on a host without a card unless device="cpu"
is given; the weight converter consumes every leaf of the eval path."""
import pathlib
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "tsm_det_pointcloud_tpu_torch"
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|flax|tsm_det_pointcloud_tpu)\b",
                       re.MULTILINE)


def _port_modules():
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        mods.append(".".join(rel.parts).removesuffix(".__init__"))
    return mods


def test_imports_without_jax():
    code = (
        "import sys, importlib\n"
        "for name in ('jax', 'flax', 'tsm_det_pointcloud_tpu'):\n"
        "    sys.modules[name] = None\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in list(PORT.rglob("*.py"))
    + list(PORT.rglob("*.cu")) + [ROOT / "chip_smoke.py"]))
def test_no_jax_import_in_source(path):
    text = (ROOT / path).read_text()
    assert not FORBIDDEN.search(text), path


def test_entry_points_refuse_cuda_without_card(monkeypatch):
    from tsm_det_pointcloud_tpu_torch import infer, tiny
    from tsm_det_pointcloud_tpu_torch.models import build_network
    from tsm_det_pointcloud_tpu_torch.utils.common_utils import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_network(tiny.tiny_model_cfg(), 3, tiny.META)
    with pytest.raises(RuntimeError, match="CUDA"):
        infer.main(["--batch", "1", "--points", "64", "--iters", "1"])
    model = build_network(tiny.tiny_model_cfg(), 3, tiny.META, device="cpu")
    assert next(model.parameters()).device.type == "cpu"


def test_other_models_raise():
    from tsm_det_pointcloud_tpu_torch import tiny
    from tsm_det_pointcloud_tpu_torch.models import build_network

    cfg = tiny.tiny_model_cfg()
    cfg["NAME"] = "PointPillar"
    with pytest.raises(NotImplementedError):
        build_network(cfg, 3, tiny.META, device="cpu")
    model = build_network(tiny.tiny_model_cfg(), 3, tiny.META, device="cpu")
    model.train()
    with pytest.raises(NotImplementedError):
        model({"points": torch.zeros(1, 256, 4),
               "points_mask": torch.ones(1, 256, dtype=torch.bool)})


def test_converter_consumes_every_eval_leaf():
    import __graft_entry__ as ge
    from tsm_det_pointcloud_tpu_torch import tiny
    from tsm_det_pointcloud_tpu_torch.convert import from_flax_variables
    from tsm_det_pointcloud_tpu_torch.models import build_network

    model = ge._tsm_model()
    batch = ge._synth_batch(2, with_gt=True, seed=0)
    shapes = jax.eval_shape(
        lambda b: model.init(jax.random.PRNGKey(0), b, training=True), dict(batch))
    variables = jax.tree_util.tree_map(
        lambda s: np.full(s.shape, 0.5, np.float32), shapes)
    state, unused = from_flax_variables(variables, return_unused=True)
    port = build_network(tiny.tiny_model_cfg(), 3, tiny.META, device="cpu")
    # strict: every port tensor is given and every converted leaf is used
    port.load_state_dict(state, strict=True)
    assert unused and all(
        re.match(r"^(params|batch_stats)/module_list_(1/head|0/sa1)/", u)
        for u in unused), unused
    with pytest.raises(ValueError):
        from_flax_variables({"params": {"module_list_0": {"sa0": {"odd": {
            "leaf": np.zeros((2, 2, 2, 2), np.float32)}}}}})
