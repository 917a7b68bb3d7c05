"""YAML config system (the port's own copy of tsm_det_pointcloud_tpu/config.py).

  * ``cfg_from_yaml_file(path, config)`` with ``_BASE_CONFIG_`` inheritance,
    resolved against the repository's ``tools/`` directory, the repository
    root, then the working directory
  * ``merge_new_config`` recursive merge
  * ``cfg_from_list(['K.E.Y', 'val', ...], config)`` dotted overrides
"""
from __future__ import annotations

from ast import literal_eval
from pathlib import Path

import yaml

from .utils.edict import EDict

cfg = EDict()
cfg.ROOT_DIR = (Path(__file__).resolve().parent / "../").resolve()
cfg.LOCAL_RANK = 0


def merge_new_config(config, new_config):
    """Recursively merge ``new_config`` into ``config``, loading a
    ``_BASE_CONFIG_`` yaml into ``config`` first."""
    if "_BASE_CONFIG_" in new_config:
        base_path = Path(new_config["_BASE_CONFIG_"])
        if not base_path.exists():
            for root in (cfg.ROOT_DIR / "tools", cfg.ROOT_DIR, Path.cwd()):
                cand = root / new_config["_BASE_CONFIG_"]
                if cand.exists():
                    base_path = cand
                    break
        with open(base_path, "r") as f:
            yaml_config = yaml.safe_load(f)
        config.update(EDict(yaml_config))

    for key, val in new_config.items():
        if key == "_BASE_CONFIG_":
            continue
        if isinstance(val, dict):
            if key not in config or not isinstance(config[key], dict):
                config[key] = EDict()
            merge_new_config(config[key], val)
        else:
            config[key] = val
    return config


def cfg_from_yaml_file(cfg_file, config=None):
    if config is None:
        config = cfg
    with open(cfg_file, "r") as f:
        new_config = yaml.safe_load(f)
    merge_new_config(config=config, new_config=new_config)
    config.TAG = Path(cfg_file).stem
    config.EXP_GROUP_PATH = "/".join(str(cfg_file).split("/")[1:-1])
    return config


def cfg_from_list(cfg_list, config=None):
    """Set config keys via list: ['MODEL.NAME', 'PointPillar', ...]."""
    if config is None:
        config = cfg
    assert len(cfg_list) % 2 == 0, "override list must be key/value pairs"
    for full_key, v in zip(cfg_list[0::2], cfg_list[1::2]):
        key_list = full_key.split(".")
        d = config
        for subkey in key_list[:-1]:
            assert subkey in d, "Not a valid config key: %s" % full_key
            d = d[subkey]
        subkey = key_list[-1]
        assert subkey in d, "Not a valid config key: %s" % full_key
        try:
            value = literal_eval(v)
        except (ValueError, SyntaxError):
            value = v
        if isinstance(value, dict):
            for k2, v2 in value.items():
                d[subkey][k2] = v2
        else:
            if (d[subkey] is not None and type(value) != type(d[subkey])
                    and not isinstance(d[subkey], EDict)):
                assert (isinstance(value, type(d[subkey]))
                        or isinstance(d[subkey], type(value))), (
                    "type mismatch for config key: %s" % full_key)
            d[subkey] = value
    return config
