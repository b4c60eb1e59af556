"""Flax variables -> this package's `state_dict`.

Carries the JAX package's weights across: `state_dict_from_flax` takes
`{'params': ..., 'batch_stats': ...}` as nested dicts of numpy arrays (no
JAX needed) and returns the torch key space of `SplittableResNet`,
`ResNet`, `EntropicClassifierModule` and the zoo's image codecs
(torchvision ResNet names, CompressAI bottleneck and codec names):

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

The image codecs (`models/zoo.py`, `models/zoo_jahp.py`) keep their
Sequential children at the top of the Flax tree: `g_a{i}`/`g_a_gdn{i}` ->
`g_a.{2i}`/`g_a.{2i+1}`, `g_s{i}`/`g_s_igdn{i}` likewise (every `g_s{i}`
and `h_s0`/`h_s1` a ConvTranspose, flipped), `h_a{i}`/`h_s{i}` ->
`h_a.{2i}`/`h_s.{2i}`, `ep{i}` -> `entropy_parameters.{2i}`, and
`context_prediction`, whose kernel gets the 'A' mask applied and whose
mask is written as the module's `mask` buffer.

The bottleneck's scopes are the FP bottleneck's (`enc_conv0` ...), the
SHP/MSHP bottleneck's (`g_a_conv0`, `h_a_conv0`, `h_s_deconv0` ...) or the
`SimpleBottleneck`'s `LayerSeq` stacks (`encoder/layer{i}` ->
`encoder.{i}`). A `LayerSeq` scope does not say whether its kernel is a
convolution's or a transposed one's (the CR+BQ decoder's 2x2/2
upsampling), so converting one needs the torch `model`, whose module
there tells. An `EntropicClassifierModule` keeps the ResNet under `base/`
and its `entropy_bottleneck` at the top.

`flax_param_path` is the inverse on names: a torch parameter name ->
its Flax path, dotted (`bottleneck_layer.encoder.0.weight` ->
`bottleneck_layer.enc_conv0.kernel`), the space in which configs name
frozen and module-wise parameter groups. A `SimpleBottleneck` shares the
FP bottleneck's torch names (`encoder.{i}`), so its paths need the
`model` too.
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
# the image codecs of the zoo (CompressAI names): Sequential children at
# the top level of the Flax tree, `g_a{i}`/`g_a_gdn{i}` -> g_a.{2i}/.{2i+1}
_ZOO_SCOPES = {**{f'g_a{i}': f'g_a.{2 * i}' for i in range(4)},
               **{f'g_a_gdn{i}': f'g_a.{2 * i + 1}' for i in range(3)},
               **{f'g_s{i}': f'g_s.{2 * i}' for i in range(4)},
               **{f'g_s_igdn{i}': f'g_s.{2 * i + 1}' for i in range(3)},
               **{f'h_a{i}': f'h_a.{2 * i}' for i in range(3)},
               **{f'h_s{i}': f'h_s.{2 * i}' for i in range(3)},
               **{f'ep{i}': f'entropy_parameters.{2 * i}' for i in range(3)},
               'context_prediction': 'context_prediction'}
# flax scopes holding a ConvTranspose kernel
_DECONV_SCOPES = {f'bottleneck_layer/{k}' for k in _SHP_SCOPES
                  if '_deconv' in k} | {'g_s0', 'g_s1', 'g_s2', 'g_s3',
                                        'h_s0', 'h_s1'}
_BOTTLENECK_SCOPES = {**_FP_SCOPES, **_SHP_SCOPES}

# the SimpleBottleneck's LayerSeq stacks
_LAYER_SEQ = r'^bottleneck_layer/(encoder|decoder)/layer(\d+)$'
_RULES = [(rf'^bottleneck_layer/{k}$', f'bottleneck_layer.{v}')
          for k, v in _BOTTLENECK_SCOPES.items()] + [
    (_LAYER_SEQ, r'bottleneck_layer.\1.\2'),
    (r'^entropy_bottleneck$', 'entropy_bottleneck'),
    (r'^(base/)?stem/(conv1|bn1)$', r'\1\2'),
    (r'^(base/)?layer(\d)/block(\d+)/(conv\d|bn\d)$', r'\1layer\2.\3.\4'),
    (r'^(base/)?layer(\d)/block(\d+)/downsample_conv$',
     r'\1layer\2.\3.downsample.0'),
    (r'^(base/)?layer(\d)/block(\d+)/downsample_bn$',
     r'\1layer\2.\3.downsample.1'),
    (r'^(base/)?fc$', r'\1fc'),
] + [(rf'^{k}$', v) for k, v in _ZOO_SCOPES.items()]


def _torch_scope(scope: str) -> str:
    for pattern, repl in _RULES:
        m = re.fullmatch(pattern, scope)
        if m:
            return m.expand(repl).replace('base/', 'base.')
    raise KeyError(f'no torch counterpart for flax scope {scope!r}')


def _is_deconv(scope: str, model) -> bool:
    """Whether the kernel at flax `scope` is a ConvTranspose's."""
    if scope in _DECONV_SCOPES:
        return True
    if not re.fullmatch(_LAYER_SEQ, scope):
        return False
    if model is None:
        raise ValueError(f'{scope} is a LayerSeq kernel: converting it needs '
                         'the torch model (state_dict_from_flax(variables, '
                         'model))')
    return isinstance(model.get_submodule(_torch_scope(scope)),
                      torch.nn.ConvTranspose2d)


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


def state_dict_from_flax(variables: dict, model=None) -> dict:
    """Flax `{'params', 'batch_stats'}` of the JAX `SplittableResNet` (FP,
    SHP, MSHP or `SimpleBottleneck`), `ResNet` or
    `EntropicClassifierModule` -> a state_dict that `load_state_dict`
    takes strictly. `model`, the port's counterpart, is needed for a
    `SimpleBottleneck` (see the module doc)."""
    out = {}
    for scope, leaf, value in _leaves(variables['params']):
        path = '/'.join(scope)
        name, arr = _param_leaf(leaf, value, deconv=leaf == 'kernel'
                                and _is_deconv(path, model))
        if path == 'context_prediction' and name == 'weight':
            # the 'A' mask applied, and kept as the module's buffer
            from ..models.zoo_jahp import causal_mask
            mask = np.broadcast_to(causal_mask(arr.shape[-1]), arr.shape)
            arr = arr * mask
            out['context_prediction.mask'] = mask
        out[f'{_torch_scope(path)}.{name}'] = arr
    for scope, leaf, value in _leaves(variables.get('batch_stats', {})):
        path = _torch_scope('/'.join(scope))
        out[f'{path}.running_{leaf}'] = value
        out[f'{path}.num_batches_tracked'] = np.asarray(0, np.int64)
    return {k: torch.from_numpy(np.array(v, order='C', copy=True))
            for k, v in out.items()}


_INVERSE_RULES = [(rf'^bottleneck_layer\.{re.escape(v)}$',
                   f'bottleneck_layer.{k}')
                  for k, v in _BOTTLENECK_SCOPES.items()] + [
    (r'^entropy_bottleneck$', 'entropy_bottleneck'),
    (r'^(base\.)?(conv1|bn1)$', r'\1stem.\2'),
    (r'^(base\.)?layer(\d)\.(\d+)\.(conv\d|bn\d)$', r'\1layer\2.block\3.\4'),
    (r'^(base\.)?layer(\d)\.(\d+)\.downsample\.0$',
     r'\1layer\2.block\3.downsample_conv'),
    (r'^(base\.)?layer(\d)\.(\d+)\.downsample\.1$',
     r'\1layer\2.block\3.downsample_bn'),
    (r'^(base\.)?fc$', r'\1fc'),
]


def _layer_seq_entry(model, module: str):
    """The module at `module` when its parent is a `LayerSeq`, else None."""
    from ..models.layer import LayerSeq
    parent, _, index = module.rpartition('.')
    if model is None or not index.isdigit():
        return None
    try:
        seq = model.get_submodule(parent)
    except AttributeError:
        return None
    return seq[int(index)] if isinstance(seq, LayerSeq) else None


def flax_param_path(name: str, model=None) -> str:
    """Dotted Flax path of the parameter `name` of the port's
    `SplittableResNet`, `ResNet` or `EntropicClassifierModule`; a
    `SimpleBottleneck`'s (`LayerSeq` entry `{i}` -> `layer{i}`) only when
    `model` is given."""
    module, leaf = name.rsplit('.', 1)
    entry = _layer_seq_entry(model, module)
    if entry is not None:
        prefix, _, index = module.rpartition('.')
        if leaf == 'weight':
            leaf = 'scale' if isinstance(entry, torch.nn.BatchNorm2d) \
                else 'kernel'
        return f'{prefix}.layer{index}.{leaf}'
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
