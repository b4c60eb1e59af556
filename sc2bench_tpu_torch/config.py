"""YAML experiment-config loader (counterpart of `sc2bench_tpu/config.py`).

Top-level keys `dependencies` / `models` / `train` / `test`, multi-stage
`train.stage1..N`. The tag `!join` concatenates scalars into a string. (The
JAX loader's `!getattr` is used by no config and is not carried over.)
"""
from __future__ import annotations

import json

import yaml

from .common.config_util import overwrite_config


class _Loader(yaml.SafeLoader):
    pass


def _join(loader, node):
    return ''.join(str(s) for s in loader.construct_sequence(node))


_Loader.add_constructor('!join', _join)


def load_config(path, json_overwrite: str | dict | None = None) -> dict:
    """Load a YAML config; optionally deep-merge a JSON override (a string
    or a dict; the CLI's `--json`)."""
    with open(path) as f:
        config = yaml.load(f, Loader=_Loader)
    if json_overwrite:
        if isinstance(json_overwrite, str):
            json_overwrite = json.loads(json_overwrite)
        overwrite_config(config, json_overwrite)
    return config


def train_stage_configs(train_config: dict) -> list[dict]:
    """Ordered stage configs: the explicit stage1..N keys, else the flat
    train config as one stage."""
    stages = sorted(k for k in train_config if k.startswith('stage'))
    if stages:
        out = []
        for k in stages:
            cfg = dict(train_config[k])
            cfg.setdefault('name', k)
            out.append(cfg)
        return out
    cfg = dict(train_config)
    cfg.setdefault('name', 'train')
    return [cfg]
