"""Compressed-size and model-size analysis (counterpart of
`sc2bench_tpu/analysis.py`).

Data size is the pickled size of the compressed object, so the numbers are
equal to the JAX package's when the object pickled is the same. Encoder
size is dtype bits x parameter count, split by parameter-name prefix.
"""
from __future__ import annotations

import logging
import pickle
import sys

import numpy as np

from .registry import lookup, register_analyzer

logger = logging.getLogger(__name__)


def get_binary_object_size(obj, unit_size: int = 1024) -> float:
    """Pickled size of an arbitrary object."""
    return sys.getsizeof(pickle.dumps(obj)) / unit_size


class BaseAnalyzer:
    """The analyzers' interface: `analyze` one sample, `summarize` what was
    seen, `clear` it."""

    def analyze(self, *args, **kwargs):
        raise NotImplementedError()

    def summarize(self):
        raise NotImplementedError()

    def clear(self):
        raise NotImplementedError()


@register_analyzer
class FileSizeAnalyzer(BaseAnalyzer):
    """Compressed-object size per sample; summarize() reports mean/std."""

    UNIT_DICT = {'B': 1, 'KB': 1024, 'MB': 1024 * 1024}

    def __init__(self, unit='KB', **kwargs):
        self.unit = unit
        self.unit_size = self.UNIT_DICT[unit]
        self.kwargs = kwargs
        self.file_size_list = []

    def analyze(self, compressed_obj):
        self.file_size_list.append(
            get_binary_object_size(compressed_obj, unit_size=self.unit_size))

    def summarize(self):
        file_sizes = np.array(self.file_size_list)
        logger.info('Bottleneck size [%s]: mean %s std %s for %s samples',
                    self.unit, file_sizes.mean() if len(file_sizes) else 0.0,
                    file_sizes.std() if len(file_sizes) else 0.0,
                    len(file_sizes))
        return {'mean': float(file_sizes.mean()) if len(file_sizes) else 0.0,
                'std': float(file_sizes.std()) if len(file_sizes) else 0.0,
                'num_samples': len(file_sizes), 'unit': self.unit}

    def clear(self):
        self.file_size_list.clear()


@register_analyzer
class FileSizeAccumulator(FileSizeAnalyzer):
    """Accumulates sizes already counted in bytes (a codec transform's
    file size) instead of pickling an object."""

    def analyze(self, file_size):
        self.file_size_list.append(file_size / self.unit_size)


def get_analyzer(cls_name, **kwargs):
    cls = lookup('analyzer', cls_name)
    return None if cls is None else cls(**kwargs)


class AnalyzerHolder:
    """State holder giving model runtimes the analyzable surface:
    activate_analysis / deactivate_analysis / analyze / summarize /
    clear_analysis."""

    def __init__(self, analyzer_configs=None):
        analyzer_configs = analyzer_configs or []
        self.analyzers = [
            get_analyzer(cfg['key'], **cfg.get('kwargs', {}))
            for cfg in analyzer_configs]
        self.activated_analysis = False

    def activate_analysis(self):
        self.activated_analysis = True

    def deactivate_analysis(self):
        self.activated_analysis = False

    def analyze(self, compressed_obj):
        if not self.activated_analysis:
            return
        for analyzer in self.analyzers:
            analyzer.analyze(compressed_obj)

    def summarize(self):
        return [analyzer.summarize() for analyzer in self.analyzers]

    def clear_analysis(self):
        for analyzer in self.analyzers:
            analyzer.clear()


def check_if_analyzable(module) -> bool:
    return isinstance(module, AnalyzerHolder) or (
        hasattr(module, 'activate_analysis') and hasattr(module, 'analyze'))


_DTYPE_BITS = {
    'int64': 64, 'float64': 64,
    'int32': 32, 'float32': 32, 'uint32': 32,
    'int16': 16, 'float16': 16, 'bfloat16': 16, 'uint16': 16,
    'int8': 8, 'uint8': 8,
    'bool': 2,
}


def analyze_model_size(params, encoder_paths=None, additional_rest_paths=None,
                       ignores_dtype_error=True):
    """Bits of the parameters of the whole model / the encoder / the rest,
    split by dotted-name prefix. `params` maps names to tensors or arrays:
    `dict(model.named_parameters())` counts what the JAX package counts
    over Flax `params` (no BatchNorm statistics); a `state_dict()` adds the
    buffers."""
    encoder_path_set = set(encoder_paths or [])
    additional_rest_path_set = set(additional_rest_paths or [])
    model_size = encoder_size = rest_size = 0
    for path, v in params.items():
        param_count = int(np.prod(tuple(v.shape)))
        dtype_name = str(v.dtype).removeprefix('torch.')
        if dtype_name not in _DTYPE_BITS:
            msg = f'For {path}, dtype `{dtype_name}` is not expected'
            if ignores_dtype_error:
                logger.warning(msg)
                continue
            raise TypeError(msg)
        param_size = _DTYPE_BITS[dtype_name] * param_count
        model_size += param_size
        matched = False
        for encoder_path in encoder_path_set:
            if path.startswith(encoder_path):
                encoder_size += param_size
                if path in additional_rest_path_set:
                    rest_size += param_size
                matched = True
                break
        if not matched:
            rest_size += param_size
    return {'model': model_size, 'encoder': encoder_size, 'rest': rest_size}
