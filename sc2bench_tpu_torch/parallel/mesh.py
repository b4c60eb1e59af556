"""The ('data',) and ('data', 'model') meshes over the process group, and
the spatially sharded encoder (counterpart of
`sc2bench_tpu/parallel/mesh.py`).

JAX lays its devices out as a `Mesh` and places arrays on it with
`NamedSharding`s; XLA then inserts the collectives. Here one process
drives one device (`parallel/dist.py`), so a mesh is a layout of the
group's ranks, with one sub-group along each axis of more than one rank,
and the placements are explicit:

- `get_mesh` has JAX's shape rule: a 1-D ('data',) mesh of all ranks, or
  a 2-D ('data', 'model') mesh whose 'model' axis is the largest of 2
  and 4 that divides the rank count (8 ranks as (2, 4), 4 as (1, 4), 2
  as (1, 2), an odd count as (n, 1)); rank r sits at row r // model,
  column r % model, as `reshape(n // model, model)` puts JAX's devices;
- `data_sharding` is this rank's block of a batch along 'data' (JAX's
  `P('data')`), `shard_batch` cuts it, and `replicate` broadcasts a module
  or a tensor from the mesh's first rank (JAX's `P()`);
- `shard_spatial` also cuts the image rows (NCHW H) along 'model' (JAX's
  `P('data', 'model', None, None)`), and `sharded_encode` runs a
  bottleneck's convolutional encoder on them. GSPMD inserts the
  convolutions' halo exchanges; here each convolution first trades its
  boundary rows with the neighbouring ranks of the 'model' group (both
  neighbours at once, `batch_isend_irecv`), and GDN, which mixes channels
  a pixel at a time, needs none.

In one process (no group, or a group of one) `get_mesh` returns a mesh of
one rank and every helper is the identity; `sharded_encode` is then the
plain encoder.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.distributed as tdist
import torch.nn.functional as F
from torch import nn

from ..models.precision import compute
from ..ops.gdn import GDN1
from . import dist

def mesh_shape(n: int, axes=('data',)) -> tuple:
    """The mesh's shape for `n` ranks: (n,) for one axis; for two, 'model'
    the largest of 2 and 4 that divides n (JAX's `get_mesh` rule)."""
    if len(axes) == 1:
        return (n,)
    if len(axes) != 2:
        raise ValueError(f'a mesh has one or two axes, not {axes}')
    model = 1
    for cand in (2, 4):
        if n % cand == 0:
            model = cand
    return (n // model, model)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A layout of ranks. `ranks` holds the group's ranks in the mesh's
    shape; `rank` is this process's; `groups` maps each axis to the
    process group of this rank's line along it (None where the line is
    this rank alone)."""

    axis_names: tuple
    ranks: np.ndarray
    rank: int
    groups: dict

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.ranks.shape))

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def coord(self, axis: str) -> int:
        """This rank's index along `axis`."""
        where = np.argwhere(self.ranks == self.rank)[0]
        return int(where[self.axis_names.index(axis)])

    def line(self, axis: str) -> list:
        """The ranks of this rank's line along `axis`, in order."""
        if axis not in self.axis_names:
            return [self.rank]
        where = list(np.argwhere(self.ranks == self.rank)[0])
        where[self.axis_names.index(axis)] = slice(None)
        return [int(r) for r in self.ranks[tuple(where)]]

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)


def get_mesh(n_devices: int | None = None, axes=('data',),
             local: bool = False) -> Mesh:
    """The mesh over the process group (`parallel/dist.py`): all its
    ranks, laid out by `mesh_shape`. `n_devices`, when given, must equal
    the group's size (a rank outside the mesh would have no place in
    its collectives). `local=True` is this rank alone, the mesh of a
    process that scores its own shard (JAX's process-local mesh: one
    device a process here). Every rank of the group must call it with
    the same arguments: it creates the axes' sub-groups together."""
    axes = tuple(axes)
    world = 1 if local else dist.world_size()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(f'n_devices={n_devices}, but the group has {world} '
                         f'rank(s): start {n_devices} processes')
    me = 0 if world == 1 else dist.rank()
    shape = mesh_shape(world, axes)
    ranks = np.arange(world).reshape(shape) if world > 1 \
        else np.asarray([me]).reshape(shape)
    return Mesh(axes, ranks, me, _axis_groups(ranks, axes, me))


def _axis_groups(ranks: np.ndarray, axes: tuple, me: int) -> dict:
    """The process group of each axis's line through `me`. Every rank
    creates every line's group, in one order (`new_group` is collective);
    the groups are kept for the next mesh of that layout until the
    process group is destroyed (`dist.subgroups`)."""
    if ranks.size == 1:
        return {axis: None for axis in axes}

    def make():
        made = {}
        for i, axis in enumerate(axes):
            lines = np.moveaxis(ranks, i, -1).reshape(-1, ranks.shape[i])
            for line in lines:
                line = [int(r) for r in line]
                g = tdist.new_group(line) if len(line) > 1 else None
                if me in line:
                    made[axis] = g
        return made
    return dist.subgroups((tuple(ranks.reshape(-1).tolist()), ranks.shape,
                           axes), make)


@dataclasses.dataclass(frozen=True)
class DataSharding:
    """This rank's block of a batch along 'data': block `index` of
    `count` contiguous, equal blocks (JAX's `P('data')`: device i of the
    axis holds rows [i*b, (i+1)*b), the rows `dist.global_rows` keeps)."""

    index: int
    count: int

    def rows(self, n: int) -> slice:
        if n % self.count:
            raise ValueError(f'a batch of {n} does not split into '
                             f'{self.count} equal blocks along data')
        b = n // self.count
        return slice(self.index * b, (self.index + 1) * b)


def data_sharding(mesh: Mesh) -> DataSharding:
    """The batch sharding that `shard_batch` follows."""
    return DataSharding(mesh.coord('data'), mesh.axis_size('data'))


def shard_batch(mesh: Mesh, batch):
    """This rank's block of every leading-batch tensor or array in
    `batch` (a tensor, an array, or a dict, list or tuple of them);
    ranks of one 'data' block (a 'model' line) get the same rows."""
    sharding = data_sharding(mesh)

    def cut(x):
        if isinstance(x, dict):
            return {k: cut(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(cut(v) for v in x)
        if isinstance(x, (torch.Tensor, np.ndarray)):
            return x[sharding.rows(x.shape[0])]
        return x
    return cut(batch)


def replicate(mesh: Mesh, obj):
    """`obj` (a module or a tensor) made equal on every rank of the mesh:
    broadcast from its first rank, in place. Returns `obj`."""
    if mesh.size == 1:
        return obj
    src = int(mesh.ranks.reshape(-1)[0])
    if isinstance(obj, nn.Module):
        dist.broadcast_module(obj, src)
        return obj
    staged = obj.cpu() if obj.is_cuda and dist.backend() == 'gloo' else obj
    tdist.broadcast(staged, src)
    if staged is not obj:
        obj.copy_(staged)
    return obj


def shard_spatial(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's part of an NCHW batch: its block of images along
    'data' and its block of rows (H) along 'model'."""
    x = shard_batch(mesh, x)
    m = mesh.axis_size('model')
    i = mesh.coord('model') if m > 1 else 0
    if x.shape[2] % m:
        raise ValueError(f'H={x.shape[2]} does not split into {m} equal '
                         'row blocks along model')
    rows = x.shape[2] // m
    return x[:, :, i * rows:(i + 1) * rows]


def _conv_rows(conv: nn.Conv2d) -> tuple:
    """(rows above, rows below) of neighbouring shards a row-sharded conv
    needs: `padding` above, kernel - stride - padding below."""
    (k, _), (s, _), (p, _) = conv.kernel_size, conv.stride, conv.padding
    if conv.dilation != (1, 1) or conv.padding_mode != 'zeros' \
            or k - s - p < 0:
        raise ValueError(f'{conv} cannot be sharded over rows here')
    return p, k - s - p


def _row_multiple(encoder: nn.Sequential) -> int:
    """The product of the encoder convolutions' H strides: a shard's rows
    must be a multiple of it."""
    return math.prod(m.stride[0] for m in encoder
                     if isinstance(m, nn.Conv2d))


def _out_rows(encoder: nn.Sequential, rows: int) -> int:
    """The unsharded encoder's output rows for `rows` input rows."""
    for m in encoder:
        if isinstance(m, nn.Conv2d):
            (k, _), (s, _), (p, _) = m.kernel_size, m.stride, m.padding
            rows = (rows + 2 * p - k) // s + 1
    return rows


def _exchange(x: torch.Tensor, above: int, below: int, line: list, i: int,
              group) -> tuple:
    """Trade boundary rows with the line's neighbours: rank i sends its
    first `below` rows to rank i-1 and its last `above` rows to rank i+1,
    and receives `above` rows from i-1 and `below` from i+1, both at
    once. The line's ends get nothing from outside it (None). Under gloo
    a CUDA tensor's rows travel through the CPU."""
    stage = x.is_cuda and dist.backend() == 'gloo'
    n, c, _, w = x.shape
    ops, recv = [], {}

    def buf(rows):
        return torch.empty((n, c, rows, w), dtype=x.dtype,
                           device='cpu' if stage else x.device)

    def out(t):
        t = t.contiguous()
        return t.cpu() if stage else t

    if i > 0:
        if above:
            recv['above'] = buf(above)
            ops.append(tdist.P2POp(tdist.irecv, recv['above'], line[i - 1],
                                   group))
        if below:
            ops.append(tdist.P2POp(tdist.isend, out(x[:, :, :below]),
                                   line[i - 1], group))
    if i < len(line) - 1:
        if above:
            ops.append(tdist.P2POp(tdist.isend, out(x[:, :, -above:]),
                                   line[i + 1], group))
        if below:
            recv['below'] = buf(below)
            ops.append(tdist.P2POp(tdist.irecv, recv['below'], line[i + 1],
                                   group))
    if ops:
        for req in tdist.batch_isend_irecv(ops):
            req.wait()
    return tuple(recv[k].to(x.device) if k in recv else None
                 for k in ('above', 'below'))


def _sharded_conv(conv: nn.Conv2d, x: torch.Tensor, line: list, i: int,
                  group) -> torch.Tensor:
    above, below = _conv_rows(conv)
    if x.shape[2] < max(above, below):
        raise ValueError(f'a shard of {x.shape[2]} rows is too small for '
                         f'{conv}')
    top, bottom = _exchange(x, above, below, line, i, group)
    n, c, _, w = x.shape
    # the global edges get the convolution's own zero padding
    if top is None:
        top = x.new_zeros((n, c, conv.padding[0], w))
    if bottom is None:
        bottom = x.new_zeros((n, c, conv.padding[0], w))
    xp = torch.cat([top, x, bottom], dim=2)
    return F.conv2d(xp, conv.weight, conv.bias, conv.stride,
                    (0, conv.padding[1]), conv.dilation, conv.groups)


@torch.no_grad()
def sharded_encode(bottleneck: nn.Module, x: torch.Tensor,
                   mesh: Mesh) -> torch.Tensor:
    """The latent of `bottleneck.encoder` (the FP bottleneck's
    conv 5x5/2, GDN, conv 5x5/2, GDN, conv 2x2/1) from `x`, this rank's
    rows of the images (`shard_spatial`), with the image rows sharded
    over the mesh's 'model' axis; float32, as `encode_ops` computes it.
    Every rank of the 'model' line must call it: it trades rows and
    gathers over the line.

    Accepted: H a multiple of 4m (m the 'model' size, 4 the encoder's
    stride) with at least two latent rows a rank, so every shard of
    every convolution holds whole output rows and the rows its
    neighbours need; any other H raises. Each 5x5/2 convolution takes 2
    rows from the rank above and 1 from the rank below, the 2x2/1 one 1
    from below; the first and last rank pad with zeros, as the
    unsharded convolution does. The 2x2 convolution has no padding, so
    the last rank's latent has one row fewer than the others'.

    Returns the whole latent (n, C, H/4 - 1, W/4 - 1) on every rank of
    the 'model' line (all-gathered). Without a 'model' axis of more than
    one rank it is the plain encoder (`bottleneck._encode`)."""
    if mesh.axis_size('model') == 1:
        return bottleneck._encode(x)
    y, _ = _encode_rows(bottleneck, x, mesh)
    enc, rows = bottleneck.encoder, x.shape[2]
    return _gather_rows(y, rows // _row_multiple(enc),
                        _out_rows(enc, rows * mesh.axis_size('model')),
                        mesh.line('model'), mesh.groups['model'])


@torch.no_grad()
def _encode_rows(bottleneck: nn.Module, x: torch.Tensor, mesh: Mesh) -> tuple:
    """This rank's latent rows of the row-sharded encoder (`m` > 1), and
    the global index of their first row."""
    m = mesh.axis_size('model')
    enc = bottleneck.encoder
    rows = x.shape[2]
    stride = _row_multiple(enc)
    if rows % stride or rows // stride < 2:
        raise ValueError(f'a shard of {rows} rows: the sharded encoder needs '
                         f'H a multiple of {stride * m} ({stride} x model '
                         f'{m}) with at least {2 * stride} rows a rank')
    line, i = mesh.line('model'), mesh.coord('model')
    group = mesh.groups['model']
    with compute(bottleneck.dtype, x):
        y = x
        for layer in enc:
            if isinstance(layer, nn.Conv2d):
                y = _sharded_conv(layer, y, line, i, group)
            elif isinstance(layer, GDN1):
                y = layer(y)
            else:
                raise ValueError(f'{type(layer).__name__} in the encoder '
                                 'cannot be sharded over rows')
        y = y.to(torch.float32)
    return y, i * (rows // stride)


def _gather_rows(y: torch.Tensor, full_rows: int, total: int, line: list,
                 group) -> torch.Tensor:
    """The line's latent shards, each padded to `full_rows` rows for the
    all-gather, stacked in order and cut to the latent's `total` rows."""
    short = full_rows - y.shape[2]
    padded = F.pad(y, (0, 0, 0, short)) if short else y.contiguous()
    stage = padded.is_cuda and dist.backend() == 'gloo'
    src = padded.cpu() if stage else padded
    parts = [torch.empty_like(src) for _ in line]
    tdist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=2)[:, :, :total].to(y.device)

