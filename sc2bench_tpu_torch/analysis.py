"""Compressed-size analysis (counterpart of `sc2bench_tpu/analysis.py`).

Data size is the pickled size of the compressed object, so the numbers are
equal to the JAX package's when the object pickled is the same.
"""
from __future__ import annotations

import logging
import pickle
import sys

import numpy as np

logger = logging.getLogger(__name__)


def get_binary_object_size(obj, unit_size: int = 1024) -> float:
    """Pickled size of an arbitrary object."""
    return sys.getsizeof(pickle.dumps(obj)) / unit_size


class FileSizeAnalyzer:
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


ANALYZERS = {'FileSizeAnalyzer': FileSizeAnalyzer}


def get_analyzer(cls_name, **kwargs):
    cls = ANALYZERS.get(cls_name)
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
