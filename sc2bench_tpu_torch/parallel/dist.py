"""Data parallelism over `torch.distributed` (counterpart of
`sc2bench_tpu/parallel/mesh.py`).

The JAX package puts a global batch on a 1-D ('data',) mesh and lets XLA
insert the gradient all-reduce. Here one process drives one device, a
launcher (`torchrun`) starts the processes, and the collectives are
explicit:

- `init_from_env` joins the group that `torchrun`'s environment describes
  (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `LOCAL_WORLD_SIZE`,
  `MASTER_ADDR`/`MASTER_PORT`): NCCL with a card a process, gloo on the
  CPU or with more processes on a host than cards (under gloo a CUDA
  tensor's collective is staged through the CPU);
- the training box broadcasts the student from rank 0 at the start of a
  stage (`broadcast_module`) and averages every trainable gradient after
  backward in one coalesced all-reduce (`average_gradients`);
- `global_rows` draws a random tensor for the global batch and keeps this
  process's block of rows, as JAX draws one key's noise for the global
  array and hands process p the rows [p*b, (p+1)*b);
- BatchNorm takes its statistics over the group (`models/resnet.py`),
  the losses normalize by global counts (`loss.py`), and the metrics,
  confusion matrices and COCO results are summed or gathered over it
  (`utils/`).

The group's two per-step collectives are program spans
(`utils/profiling.py`) named `dist.average_gradients` (the gradient
all-reduce) and `dist.group_sum` (BatchNorm's statistics, forward and
backward), so a trace gives their share of a step; `dist.allreduce`, a
device-timed span (a CUDA event pair) inside the first, times the
coalesced all-reduce itself on the device.

Every rank holds an equal share of the global batch: the loaders shard
the dataset into equal shards (`datasets/image.py`), so a process's final
partial batch is as long as every other's. That is JAX's `shard_batch`
rule (`train/box.py:206-250`) with one device a process: a partial batch
is padded to a multiple of the per-process device count, here 1, so
nothing is padded. One process (no group, or a group of one) runs
exactly as before: every helper is then the identity.

JAX's mesh helpers and its 2-D ('data', 'model') mesh, with the encoder
sharded over image rows, are in `parallel/mesh.py`.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..utils.profiling import span


def is_multi() -> bool:
    """Whether this process is in a group of more than one process."""
    return dist.is_available() and dist.is_initialized() \
        and dist.get_world_size() > 1


def world_size() -> int:
    return dist.get_world_size() if is_multi() else 1


def rank() -> int:
    return dist.get_rank() if is_multi() else 0


def barrier() -> None:
    if is_multi():
        dist.barrier()


def backend() -> str | None:
    return dist.get_backend() if is_multi() else None


def init_from_env(world_size: int = 1, device='cuda') -> torch.device:
    """Join the process group that `torchrun` describes in the
    environment and return this process's device.

    `world_size` is the CLI's `--world_size`; it must equal the
    environment's `WORLD_SIZE`. With one process nothing is initialized
    and `device` comes back as it is. With more, a CUDA `device` becomes
    `cuda:<LOCAL_RANK mod the visible cards>` (set as the current device
    before the group starts). The backend is gloo for a CPU device or
    when the host runs more processes (`LOCAL_WORLD_SIZE`) than it has
    cards, since NCCL refuses two ranks on one card; else NCCL."""
    env_world = int(os.environ.get('WORLD_SIZE', '1'))
    if int(world_size) != env_world:
        raise ValueError(
            f'--world_size {world_size} disagrees with the launcher\'s '
            f'WORLD_SIZE={env_world}: start the processes with '
            f'`torchrun --nproc_per_node {world_size}`')
    device = torch.device(device)
    if env_world <= 1:
        return device
    if device.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError('no CUDA device is available; pass '
                               '--device cpu to run over gloo on the CPU')
        local = int(os.environ.get('LOCAL_RANK', '0'))
        device = torch.device('cuda', local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        local_world = int(os.environ.get('LOCAL_WORLD_SIZE', env_world))
        backend = 'nccl' if device.type == 'cuda' and \
            local_world <= torch.cuda.device_count() else 'gloo'
        dist.init_process_group(
            backend, init_method='env://', world_size=env_world,
            rank=int(os.environ['RANK']))
    return device


_SUBGROUPS: dict = {}


def subgroups(key, make):
    """`make()`, the sub-groups of the group that `key` names (a mesh's
    lines), made once and kept until `destroy` ends the group."""
    if key not in _SUBGROUPS:
        _SUBGROUPS[key] = make()
    return _SUBGROUPS[key]


def destroy() -> None:
    """Ends the group and forgets its sub-groups."""
    _SUBGROUPS.clear()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the group, in place (no gradient). Under
    gloo a CUDA tensor is staged through the CPU; NCCL takes it as it
    is."""
    if not is_multi():
        return t
    if t.is_cuda and backend() == 'gloo':
        staged = t.cpu()
        dist.all_reduce(staged, op=dist.ReduceOp.SUM)
        t.copy_(staged)
    else:
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


def sync_metric(x) -> torch.Tensor:
    """The group's sum of a metric (the reference's `dist.all_reduce`;
    JAX's `sync_metric` psums over the mesh), as a float64 tensor on the
    CPU (reduced on this process's card under NCCL)."""
    t = torch.as_tensor(x, dtype=torch.float64).clone()
    if backend() == 'nccl':
        t = t.cuda()
    return all_reduce_sum(t).cpu()


def global_count(t: torch.Tensor) -> torch.Tensor:
    """A data-dependent count (a loss's denominator) summed over the
    group, with no gradient; `t` itself in one process."""
    if not is_multi():
        return t
    t = t.detach().clone()
    return all_reduce_sum(t)


class _GroupSum(torch.autograd.Function):
    """Forward: the group's sum. Backward: the group's sum of the output
    gradients, since every rank's loss depends on the sum."""

    @staticmethod
    def forward(ctx, t):
        with span('dist.group_sum'):
            return all_reduce_sum(t.clone())

    @staticmethod
    def backward(ctx, g):
        with span('dist.group_sum'):
            return all_reduce_sum(g.clone())


def group_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the group, differentiable; `t` itself in one
    process."""
    if not is_multi():
        return t
    return _GroupSum.apply(t)


def global_rows(draw, n: int) -> torch.Tensor:
    """`draw(rows)` for the global batch, this rank's block of `n` rows.
    Every rank calls `draw` with the same generator state, so the ranks
    together hold exactly what one process drawing `n * world` rows
    holds."""
    w = world_size()
    if w == 1:
        return draw(n)
    r = rank()
    return draw(n * w)[r * n:(r + 1) * n]


def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Every parameter and buffer of `module` from rank `src`, one
    coalesced broadcast per dtype."""
    if not is_multi():
        return
    tensors = list(module.parameters()) + list(module.buffers())
    for group in _by_dtype(tensors):
        flat = torch.cat([t.detach().reshape(-1) for t in group])
        staged = flat.cpu() if flat.is_cuda and backend() == 'gloo' \
            else flat
        dist.broadcast(staged, src)
        if staged is not flat:
            flat.copy_(staged)
        _scatter_back(flat, group, lambda t: t.data)


def average_gradients(params) -> None:
    """Average the gradients of `params` (those that have one) over the
    group in one coalesced all-reduce per dtype. Ranks run one graph, so
    they agree on which parameters have a gradient."""
    if not is_multi():
        return
    grads = [p.grad for p in params if p.grad is not None]
    w = world_size()
    with span('dist.average_gradients'):
        for group in _by_dtype(grads):
            flat = torch.cat([g.reshape(-1) for g in group])
            with span('dist.allreduce', device=True):
                all_reduce_sum(flat)
            flat.div_(w)
            _scatter_back(flat, group, lambda t: t)


def all_gather_object(obj) -> list:
    """Every rank's `obj`, in rank order (pickled through the CPU under
    gloo; under NCCL torch stages it through this process's card)."""
    if not is_multi():
        return [obj]
    out = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


def _by_dtype(tensors):
    groups: dict = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    return list(groups.values())


def _scatter_back(flat, tensors, target) -> None:
    offset = 0
    with torch.no_grad():
        for t in tensors:
            n = t.numel()
            target(t).copy_(flat[offset:offset + n].view_as(t))
            offset += n
