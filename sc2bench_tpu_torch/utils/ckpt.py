"""Checkpoint save/load (counterpart of `sc2bench_tpu/utils/ckpt.py`).

The port's own format is `torch.save` of a state dict. Beside the file,
as in the JAX package, `<path>.tables.pkl` holds the coding tables and
`<path>.meta.pkl` any metadata (both optional; `update()` rebuilds the
tables from the parameters anyway).

`load_ckpt` also reads a checkpoint that the JAX package's `save_ckpt`
wrote (Flax msgpack of the variables) and converts it with
`state_dict_from_flax`. It tells the two formats apart by the file's first
bytes: a `torch.save` file is a zip archive, a Flax one a msgpack map.

`save_train_state`/`load_train_state` keep the state to resume training
from, at `<path>.train_state` in the port's own format (`torch.save` of
the student's state dict, the stage's optimizer and schedule state, the
epoch, the stage name and the best metric).

In a data-parallel group (the counterpart of the JAX package's Orbax
backend, `save_ckpt_orbax`/`load_ckpt_orbax`) rank 0 writes and the other
ranks wait at a barrier; the ranks hold the same state, since their
gradients are averaged. Each file is written to a temp sibling and renamed
over its target, and the sidecars only after the variables, so that an
interrupted save leaves the previous checkpoint whole and never pairs new
metadata with old variables. Every rank loads onto its own device.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
from pathlib import Path

import numpy as np
import torch

from ..parallel.dist import barrier, rank
from .convert import state_dict_from_flax

_TABLES_SUFFIX = '.tables.pkl'
_META_SUFFIX = '.meta.pkl'
_TRAIN_SUFFIX = '.train_state'
_ZIP_MAGIC = b'PK\x03\x04'
_MSGPACK_NDARRAY = 1          # Flax's msgpack ext type of an ndarray


def _replace(target: Path, write) -> None:
    """`write(tmp)` into a temp sibling of `target`, then rename it over
    `target`."""
    tmp = target.with_name(target.name + '.tmp')
    write(tmp)
    os.replace(tmp, target)


def save_ckpt(path, state_dict, tables=None, meta=None):
    """Write `state_dict` (tensors moved to the CPU) and the optional
    sidecars; `tables` is a `CodingTables`. Rank 0 of a data-parallel
    group writes; every rank returns once the files are in place."""
    path = Path(path)
    if rank() == 0:
        path.parent.mkdir(parents=True, exist_ok=True)
        cpu = {k: v.detach().cpu() for k, v in state_dict.items()}
        _replace(path, lambda tmp: torch.save(cpu, tmp))
        if tables is not None:
            payload = pickle.dumps(
                {k: v for k, v in dataclasses.asdict(tables).items()
                 if v is not None})
            _replace(Path(str(path) + _TABLES_SUFFIX),
                     lambda tmp: tmp.write_bytes(payload))
        if meta is not None:
            _replace(Path(str(path) + _META_SUFFIX),
                     lambda tmp: tmp.write_bytes(pickle.dumps(meta)))
    barrier()


def _msgpack_ext(code, data):
    import msgpack
    if code != _MSGPACK_NDARRAY:
        return msgpack.ExtType(code, data)
    shape, dtype, buffer = msgpack.unpackb(data, raw=True)
    return np.frombuffer(buffer, dtype=np.dtype(dtype.decode())).reshape(
        shape)


def load_flax_ckpt(path, model=None) -> dict:
    """State dict of a checkpoint written by the JAX package's `save_ckpt`
    (`flax.serialization.to_bytes` of `{'params', 'batch_stats'}`: msgpack
    maps, arrays as ext type 1 holding (shape, dtype name, bytes)); `model`
    as `state_dict_from_flax` takes it."""
    try:
        import msgpack
    except ImportError as e:
        raise ImportError(
            f'{path} is a Flax (msgpack) checkpoint; reading it needs the '
            '`msgpack` package, which is not installed') from e
    variables = msgpack.unpackb(Path(path).read_bytes(),
                                ext_hook=_msgpack_ext, raw=False)
    return state_dict_from_flax(variables, model)


def _is_msgpack_map(head: bytes) -> bool:
    return bool(head) and (0x80 <= head[0] <= 0x8f or head[0] in (0xde, 0xdf))


def load_ckpt(path, model=None):
    """(state_dict, tables state or None, meta or None) of a checkpoint in
    the port's format or the JAX package's, chosen by the file's first
    bytes; `model`, the module the state is for, is needed to convert a
    JAX one with a `SimpleBottleneck`. A missing file raises
    `FileNotFoundError`."""
    path = Path(path)
    with open(path, 'rb') as f:
        head = f.read(4)
    if head == _ZIP_MAGIC:
        state_dict = torch.load(path, map_location='cpu', weights_only=True)
    elif _is_msgpack_map(head):
        state_dict = load_flax_ckpt(path, model)
    else:
        raise ValueError(f'{path} is neither a torch.save checkpoint nor a '
                         'Flax msgpack one')
    sidecars = []
    for suffix in (_TABLES_SUFFIX, _META_SUFFIX):
        side = Path(str(path) + suffix)
        sidecars.append(pickle.loads(side.read_bytes())
                        if side.exists() else None)
    return (state_dict, *sidecars)


def save_train_state(path, state_dict, optimizer_state, epoch: int,
                     stage: str, best_metric: float) -> None:
    """Write the state to resume training from beside `path` (rank 0 of
    a group, the others wait)."""
    target = Path(str(path) + _TRAIN_SUFFIX)
    if rank() == 0:
        target.parent.mkdir(parents=True, exist_ok=True)
        payload = {'model': {k: v.detach().cpu()
                             for k, v in state_dict.items()},
                   'optimizer': optimizer_state, 'epoch': int(epoch),
                   'stage': stage, 'best_metric': float(best_metric)}
        _replace(target, lambda tmp: torch.save(payload, tmp))
    barrier()


def load_train_state(path, map_location='cpu'):
    """The payload `save_train_state` wrote beside `path` ({'model',
    'optimizer', 'epoch', 'stage', 'best_metric'}), or None."""
    target = Path(str(path) + _TRAIN_SUFFIX)
    if not target.exists():
        return None
    return torch.load(target, map_location=map_location, weights_only=True)
