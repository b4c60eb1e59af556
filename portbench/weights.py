"""Seeded weights, drawn on the device in a few large calls.

A reference lists each tensor of its model as (name, shape, init)
(`reference/resnet_fp.py`, `reference/frcnn.py`); `make_state` draws all
normal tensors from one `randn` and all uniform ones from one `rand` of a
generator on the device seeded with the run's seed, in the dtype they are
served in (float32), and fills the constants. The program and the
reference get the same tensors.
"""
from __future__ import annotations

import math

import torch


def make_state(specs, seed, device, dtype=torch.float32):
    """{name: tensor} for `specs`; the same seed gives the same tensors."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    out = {}
    normal = [s for s in specs if s[2][0] == 'normal']
    uniform = [s for s in specs if s[2][0] == 'uniform']
    for group, draw in ((normal, torch.randn), (uniform, torch.rand)):
        sizes = [math.prod(shape) for _, shape, _ in group]
        if not sizes:
            continue
        flat = draw(sum(sizes), generator=gen, device=device, dtype=dtype)
        for (name, shape, init), part in zip(group, flat.split(sizes)):
            t = part.view(shape)
            if init[0] == 'normal':
                out[name] = t.mul_(init[1])
            else:
                out[name] = t.mul_(init[2] - init[1]).add_(init[1])
    for name, shape, init in specs:
        kind = init[0]
        if kind == 'const':
            out[name] = torch.full(shape, init[1], dtype=dtype, device=device)
        elif kind == 'eye':
            t = torch.full(shape, init[2], dtype=dtype, device=device)
            out[name] = t.fill_diagonal_(init[1])
        elif kind == 'quantiles':
            s = init[1]
            out[name] = torch.tensor([-s, 0.0, s], dtype=dtype,
                                     device=device).expand(shape).clone()
        elif kind == 'count':
            out[name] = torch.zeros(shape, dtype=torch.int64, device=device)
        elif kind not in ('normal', 'uniform'):
            raise ValueError(f'{name}: unknown init {init}')
    return {name: out[name] for name, _, _ in specs}


def load_into(module, state):
    """Copy `state` into `module`, which must have exactly these tensors
    at these shapes."""
    own = module.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    wrong = [k for k in own if k in state
             and tuple(own[k].shape) != tuple(state[k].shape)]
    if missing or extra or wrong:
        raise ValueError(f'state does not fit the model: missing {missing[:5]}'
                         f', extra {extra[:5]}, shapes differ {wrong[:5]}')
    module.load_state_dict(state)
    return module
