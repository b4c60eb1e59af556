"""Detection model resolution (counterpart of
`sc2bench_tpu/models/detection/registry.py`)."""
from __future__ import annotations

import logging

from ...registry import get as registry_get
from ...utils.ckpt import load_ckpt

logger = logging.getLogger(__name__)


def load_detection_model(model_config, device=None):
    """The detection model of `model_config` (`key`, `kwargs`) built by the
    'model' registry on `device` (CUDA unless asked otherwise), with the
    weights of its `ckpt` (the port's format or the JAX package's) when it
    names one; a missing ckpt logs a warning and keeps the fresh weights,
    as in the JAX package."""
    module = registry_get('model', model_config['key'])(
        device=device, **model_config.get('kwargs', {}))
    ckpt = model_config.get('ckpt')
    if ckpt:
        try:
            state_dict, _, _ = load_ckpt(ckpt, module)
        except FileNotFoundError:
            logger.warning('detection ckpt %s missing; random init', ckpt)
        else:
            module.load_state_dict(state_dict)
            logger.info('loaded detection ckpt %s', ckpt)
    return module
