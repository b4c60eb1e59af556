"""Flax variables -> this package's `state_dict`.

Carries the JAX package's weights across: `state_dict_from_flax` takes
`{'params': ..., 'batch_stats': ...}` as nested dicts of numpy arrays (no
JAX needed) and returns the torch key space of `SplittableResNet` and
`ResNet` (torchvision ResNet names, CompressAI bottleneck names):

  Conv kernel (kH, kW, I, O)       -> Conv2d.weight (O, I, kH, kW)
  Dense kernel (I, O)              -> Linear.weight (O, I)
  BatchNorm scale/bias, mean/var   -> weight/bias, running_mean/running_var
  GDN beta/gamma (stored values)   -> beta/gamma, unchanged
  EntropyBottleneck matrix_i/bias_i/factor_i/quantiles
                                   -> _matrix{i}/_bias{i}/_factor{i}/quantiles
                                      (same (C, r, d)/(C, 1, 3) shapes)
  ConvTranspose kernel (kH, kW, I, O) of the hyperprior's h_s
                                   -> ConvTranspose2d.weight (I, O, kH, kW),
                                      spatially flipped: Flax runs an
                                      input-dilated convolution with the
                                      kernel as it is, torch the gradient of
                                      a convolution (an implicit flip)

The bottleneck's scopes are the FP bottleneck's (`enc_conv0` ...) or the
SHP/MSHP bottleneck's (`g_a_conv0`, `h_a_conv0`, `h_s_deconv0` ...).

`flax_param_path` is the inverse on names: a torch parameter name ->
its Flax path, dotted (`bottleneck_layer.encoder.0.weight` ->
`bottleneck_layer.enc_conv0.kernel`), the space in which configs name
frozen and module-wise parameter groups.
"""
from __future__ import annotations

import re

import numpy as np
import torch

# flax scope path ('/'-joined) -> torch module path
_FP_SCOPES = {
    'enc_conv0': 'encoder.0', 'enc_gdn0': 'encoder.1',
    'enc_conv1': 'encoder.2', 'enc_gdn1': 'encoder.3',
    'enc_conv2': 'encoder.4',
    'dec_conv0': 'decoder.0', 'dec_igdn0': 'decoder.1',
    'dec_conv1': 'decoder.2', 'dec_igdn1': 'decoder.3',
    'dec_conv2': 'decoder.4',
    'entropy_bottleneck': 'entropy_bottleneck',
}

_SHP_SCOPES = {
    'g_a_conv0': 'g_a.0', 'g_a_gdn0': 'g_a.1', 'g_a_conv1': 'g_a.2',
    'g_a_gdn1': 'g_a.3', 'g_a_conv2': 'g_a.4',
    'g_s_conv0': 'g_s.0', 'g_s_igdn0': 'g_s.1', 'g_s_conv1': 'g_s.2',
    'g_s_igdn1': 'g_s.3', 'g_s_conv2': 'g_s.4',
    'h_a_conv0': 'h_a.0', 'h_a_conv1': 'h_a.2',
    'h_s_deconv0': 'h_s.0', 'h_s_deconv1': 'h_s.2', 'h_s_conv2': 'h_s.4',
}
# flax scopes holding a ConvTranspose kernel
_DECONV_SCOPES = {f'bottleneck_layer/{k}' for k in _SHP_SCOPES
                  if '_deconv' in k}
_BOTTLENECK_SCOPES = {**_FP_SCOPES, **_SHP_SCOPES}

_RULES = [(rf'^bottleneck_layer/{k}$', f'bottleneck_layer.{v}')
          for k, v in _BOTTLENECK_SCOPES.items()] + [
    (r'^stem/(conv1|bn1)$', r'\1'),
    (r'^layer(\d)/block(\d+)/(conv\d|bn\d)$', r'layer\1.\2.\3'),
    (r'^layer(\d)/block(\d+)/downsample_conv$', r'layer\1.\2.downsample.0'),
    (r'^layer(\d)/block(\d+)/downsample_bn$', r'layer\1.\2.downsample.1'),
    (r'^fc$', 'fc'),
]


def _torch_scope(scope: str) -> str:
    for pattern, repl in _RULES:
        m = re.fullmatch(pattern, scope)
        if m:
            return m.expand(repl)
    raise KeyError(f'no torch counterpart for flax scope {scope!r}')


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix, k, np.asarray(v)


def _param_leaf(leaf: str, value: np.ndarray, deconv: bool = False):
    """(torch leaf name, converted array) for one flax param leaf;
    `deconv` marks a ConvTranspose kernel."""
    if leaf == 'kernel':
        if deconv:                                # flipped HWIO -> IOHW
            return 'weight', np.transpose(value[::-1, ::-1], (2, 3, 0, 1))
        if value.ndim == 4:                       # HWIO -> OIHW
            return 'weight', np.transpose(value, (3, 2, 0, 1))
        return 'weight', value.T                  # Dense (I, O) -> (O, I)
    if leaf == 'scale':
        return 'weight', value
    m = re.fullmatch(r'(matrix|bias|factor)_(\d+)', leaf)
    if m:
        return f'_{m.group(1)}{m.group(2)}', value
    return leaf, value                            # bias, beta, gamma, quantiles


def state_dict_from_flax(variables: dict) -> dict:
    """Flax `{'params', 'batch_stats'}` of the JAX `SplittableResNet` (FP,
    SHP or MSHP bottleneck) or `ResNet` -> a state_dict that
    `load_state_dict` takes strictly."""
    out = {}
    for scope, leaf, value in _leaves(variables['params']):
        name, arr = _param_leaf(leaf, value,
                                deconv='/'.join(scope) in _DECONV_SCOPES)
        out[f"{_torch_scope('/'.join(scope))}.{name}"] = arr
    for scope, leaf, value in _leaves(variables.get('batch_stats', {})):
        path = _torch_scope('/'.join(scope))
        out[f'{path}.running_{leaf}'] = value
        out[f'{path}.num_batches_tracked'] = np.asarray(0, np.int64)
    return {k: torch.from_numpy(np.array(v, order='C', copy=True))
            for k, v in out.items()}


_INVERSE_RULES = [(rf'^bottleneck_layer\.{re.escape(v)}$',
                   f'bottleneck_layer.{k}')
                  for k, v in _BOTTLENECK_SCOPES.items()] + [
    (r'^(conv1|bn1)$', r'stem.\1'),
    (r'^layer(\d)\.(\d+)\.(conv\d|bn\d)$', r'layer\1.block\2.\3'),
    (r'^layer(\d)\.(\d+)\.downsample\.0$', r'layer\1.block\2.downsample_conv'),
    (r'^layer(\d)\.(\d+)\.downsample\.1$', r'layer\1.block\2.downsample_bn'),
    (r'^fc$', 'fc'),
]


def flax_param_path(name: str) -> str:
    """Dotted Flax path of the parameter `name` of the port's
    `SplittableResNet` (FP, SHP or MSHP bottleneck) or `ResNet`."""
    module, leaf = name.rsplit('.', 1)
    for pattern, repl in _INVERSE_RULES:
        m = re.fullmatch(pattern, module)
        if m:
            scope = m.expand(repl)
            break
    else:
        raise KeyError(f'no flax counterpart for torch module {module!r}')
    if leaf == 'weight':
        last = scope.rsplit('.', 1)[-1]
        leaf = 'scale' if re.fullmatch(r'bn\d|downsample_bn', last) \
            else 'kernel'
    else:
        m = re.fullmatch(r'_(matrix|bias|factor)(\d+)', leaf)
        if m:
            leaf = f'{m.group(1)}_{m.group(2)}'
    return f'{scope}.{leaf}'
