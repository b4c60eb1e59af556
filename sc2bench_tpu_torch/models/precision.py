"""Compute dtypes of the port's models (counterpart of the Flax modules'
`dtype` field in the JAX package).

A module that takes `dtype` keeps its parameters in float32 and runs its
convolutions and products in that dtype: with bfloat16, its forward
methods run under `torch.autocast(dtype=torch.bfloat16)`, which casts
each weight and input at the call and keeps BatchNorm's statistics and
running buffers in float32. Submodules without a `dtype` of their own
(stages, blocks, heads) run in their parent's. A module with a float32
`dtype` disables autocast for its own methods, so a bottleneck keeps its
dtype inside a bfloat16 model, as the Flax modules' fields do. Outputs
that feed a softmax, box decoding or the entropy model are cast back to
float32 by the module that makes them. With float32 everywhere (the
default) no cast happens and the outputs are exactly those of a model
without `dtype`.
"""
from __future__ import annotations

import copy
import itertools

import torch
from torch import nn

_NAMES = {'bfloat16': torch.bfloat16, 'bf16': torch.bfloat16,
          'float32': torch.float32, 'f32': torch.float32}


def resolve_dtype(dtype=None) -> torch.dtype:
    """A config's dtype (None, 'float32', 'bfloat16', or a torch dtype) as
    a torch dtype; float32 for None."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        out = dtype
    else:
        out = _NAMES.get(str(dtype).removeprefix('torch.'))
    if out not in (torch.float32, torch.bfloat16):
        raise ValueError(f'compute dtype {dtype!r}: float32 or bfloat16')
    return out


def compute(dtype: torch.dtype, x: torch.Tensor):
    """The context in which a module of compute dtype `dtype` runs on
    `x`'s device: autocast to bfloat16, or autocast disabled."""
    return torch.autocast(x.device.type, dtype=torch.bfloat16,
                          enabled=dtype == torch.bfloat16)


def linear_head(fc: nn.Linear, z: torch.Tensor) -> torch.Tensor:
    """A classifier's fc in its weights' dtype, outside autocast (the
    Flax `nn.Dense` without a dtype: float32 weights compute in float32),
    returning float32 logits."""
    with torch.autocast(z.device.type, enabled=False):
        return fc(z.to(fc.weight.dtype)).to(torch.float32)


def with_compute_dtype(module: nn.Module, dtype) -> nn.Module:
    """A copy of `module` whose every submodule with a `dtype` attribute
    computes in `dtype`, sharing `module`'s parameters and buffers (the
    Flax `module.clone(dtype=...)` over the same variables): weight updates
    reach both."""
    memo = {id(t): t for t in itertools.chain(module.parameters(),
                                              module.buffers())}
    clone = copy.deepcopy(module, memo)
    dtype = resolve_dtype(dtype)
    for m in clone.modules():
        if isinstance(getattr(m, 'dtype', None), torch.dtype):
            m.dtype = dtype
    return clone
