"""Global string -> object registries (counterpart of
`sc2bench_tpu/registry.py`).

Layers, models, wrappers, transforms, analyzers, datasets, collate
functions and losses register under a namespace with the `register_*` decorators; configs name
them as `{key, kwargs}` and the builders look them up here.

Configs list the JAX package's modules under `dependencies`
(`sc2bench_tpu.models`, ...). `import_dependencies` imports this package's
counterpart of each one instead, and never the JAX package: a dependency
that has no counterpart here yet is logged and skipped, and a lookup of a
name it would have registered raises `KeyError`.
"""
from __future__ import annotations

import importlib
import importlib.util
import logging
from typing import Any, Callable, Dict

logger = logging.getLogger(__name__)

_REGISTRIES: Dict[str, Dict[str, Any]] = {}
_JAX_PACKAGE, _PORT_PACKAGE = 'sc2bench_tpu', 'sc2bench_tpu_torch'


def _registry(namespace: str) -> Dict[str, Any]:
    return _REGISTRIES.setdefault(namespace, {})


def register(namespace: str, name: str | None = None) -> Callable:
    """Decorator registering a class or function under `namespace`."""

    def deco(obj):
        _registry(namespace)[name or obj.__name__] = obj
        return obj

    return deco


def lookup(namespace: str, name: str, default=None):
    return _registry(namespace).get(name, default)


def get(namespace: str, name: str):
    reg = _registry(namespace)
    if name not in reg:
        raise KeyError(
            f'`{name}` is not registered in namespace `{namespace}`. '
            f'Known: {sorted(reg)}')
    return reg[name]


def build(namespace: str, name: str, **kwargs):
    """Instantiate (or call) a registered entry with kwargs."""
    return get(namespace, name)(**kwargs)


def names(namespace: str):
    return sorted(_registry(namespace))


def port_module_name(name: str) -> str:
    """This package's counterpart of a JAX-package module name; other
    names are returned unchanged."""
    if name == _JAX_PACKAGE or name.startswith(_JAX_PACKAGE + '.'):
        return _PORT_PACKAGE + name[len(_JAX_PACKAGE):]
    return name


def import_dependencies(dependencies):
    """Import the modules a config lists under `dependencies` so their
    registration decorators run; JAX-package names map to this package."""
    for dep in dependencies or ():
        name = dep['name'] if isinstance(dep, dict) else dep
        ported = port_module_name(name)
        try:
            found = importlib.util.find_spec(ported) is not None
        except ModuleNotFoundError:         # a parent package is missing
            found = False
        if ported != name and not found:
            logger.warning('dependency %s has no counterpart in %s yet '
                           '(%s); skipped', name, _PORT_PACKAGE, ported)
            continue
        importlib.import_module(ported)


def _shorthand(namespace: str):
    def register_in(obj=None, *, name=None):
        if obj is None:
            return register(namespace, name)
        return register(namespace)(obj)
    register_in.__doc__ = f'Register in the `{namespace}` namespace.'
    return register_in


register_layer = _shorthand('layer')
register_model = _shorthand('model')
register_analyzer = _shorthand('analyzer')
register_dataset = _shorthand('dataset')
register_loss = _shorthand('loss')
register_transform = _shorthand('transform')
register_wrapper = _shorthand('wrapper')
register_collate = _shorthand('collate')
