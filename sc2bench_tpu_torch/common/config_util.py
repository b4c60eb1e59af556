"""Config dict utilities (counterpart of
`sc2bench_tpu/common/config_util.py`)."""
from __future__ import annotations


def overwrite_config(config: dict, overwrite_dict: dict) -> dict:
    """Recursively deep-merge `overwrite_dict` into `config`, in place:
    nested dicts merge, every other value replaces. This backs the `--json`
    CLI override."""
    for key, value in overwrite_dict.items():
        if key in config and isinstance(value, dict) \
                and isinstance(config[key], dict):
            overwrite_config(config[key], value)
        else:
            config[key] = value
    return config
