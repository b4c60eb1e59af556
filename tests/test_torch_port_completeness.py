"""The port does all that the JAX package does, name by name.

Both packages are parsed with `ast`; neither is imported. Every public
function and class of `sc2bench_tpu/` (a name without a leading
underscore, at a module's top level) and every public method of a public
class must have a counterpart in `sc2bench_tpu_torch/`: the same name in
the same module (a function, a class, or a name assigned there), or for a
method, the same name on the port's class of that name or on one of its
port base classes. A JAX name without one must be in `MOVED`, which
names its counterpart (checked to exist), or in `NO_COUNTERPART`, which
says why the port has none: JAX idioms (Flax `setup`, train states,
optax and orbax, the XLA cache, the Pallas plan pickers) whose
counterparts the port has under other shapes. A stale entry (one whose
name now has a same-named counterpart, or that names nothing of the JAX
package) fails too, so the lists stay the audit of what differs."""
import torch_port_threads  # noqa: F401  (pins torch threads)
import ast
import fnmatch
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX, PORT = REPO / 'sc2bench_tpu', REPO / 'sc2bench_tpu_torch'

# JAX name -> its counterpart in the port, 'module.py Name' or
# 'module.py Class.member'
MOVED = {
    'models/registry.py get_backbone': 'models/backbone.py get_backbone',
    'parallel/mesh.py sync_metric': 'parallel/dist.py sync_metric',
    'models/resnet.py FrozenBatchNorm': 'models/resnet.py FrozenBatchNorm2d',
    'models/resnet.py ResNetStem': 'models/resnet.py ResNet.stem',
    'models/segmentation/base.py SegmentationBackboneFeatures':
        'models/segmentation/base.py SegmentationBackbone',
    'models/segmentation/base.py SegmentationBackboneFeatures.forward_tail':
        'models/segmentation/base.py SegmentationBackbone.forward_tail',
    'models/detection/rcnn.py optax_sigmoid_ce':
        'models/detection/rcnn.py sigmoid_ce',
    'models/detection/rcnn.py FasterRCNN.extract_features':
        'models/detection/base.py BackboneWithFPN.forward',
    'train/optim.py build_optimizer': 'train/optim.py StageOptimizer',
    'train/optim.py build_multi_optimizer': 'train/optim.py StageOptimizer',
    'utils/ckpt.py save_ckpt_orbax': 'utils/ckpt.py save_ckpt',
    'utils/ckpt.py load_ckpt_orbax': 'utils/ckpt.py load_ckpt',
    'train/box.py DistillationBox.shard_batch': 'parallel/mesh.py shard_batch',
    'models/runtime.py pipeline_stream':
        'models/runtime.py SplitClassifierRuntime.stream_deploy',
    'models/runtime.py to_wire':
        'models/runtime.py SplitClassifierRuntime.encode_device',
    'models/runtime.py copy_async':
        'models/runtime.py SplitClassifierRuntime._encode_to_host',
    'models/runtime.py add_timing': 'utils/profiling.py span',
    'ops/rans/pallas_kernel.py pallas_cyclic_encode':
        'ops/rans/kernels.py cyclic_encode',
    'ops/rans/pallas_kernel.py pallas_cyclic_decode':
        'ops/rans/kernels.py cyclic_decode',
    'ops/rans/pallas_kernel.py pallas_cyclic_encode_aligned':
        'ops/rans/kernels.py cyclic_encode_aligned',
    'ops/rans/pallas_kernel.py pallas_cyclic_decode_aligned':
        'ops/rans/kernels.py cyclic_decode_aligned',
}

# JAX names (a glob over 'module.py Name', or over 'module.py *' for a
# whole module) the port has no counterpart for, and why
NO_COUNTERPART = {
    '* *.setup': 'Flax builds its submodules in `setup`; a torch module '
                 'builds them in `__init__`',
    'train/box.py TrainState': 'the optimizer state lives in '
                               '`StageOptimizer` and the weights in the '
                               'student module',
    'train/box.py flatten_io': 'Flax `sow`s intermediates into a nested '
                               'tree; the port\'s modules fill the flat '
                               '`io` dict as they run',
    'train/box.py DistillationBox.student_variables': 'the student is the '
                                                      'module itself '
                                                      '(`DistillationBox.'
                                                      'student`)',
    'train/engine.py init_model': 'a jitted Flax `init`; the port\'s '
                                  'builders make their parameters on '
                                  '`device` from the torch seed',
    'train/engine.py localized': 'a multi-process JAX array\'s host copy; '
                                 'each port process holds its own tensors',
    'models/runtime.py FactorizedCodec.eb_params': 'a Flax parameter '
                                                   'subtree; the port\'s '
                                                   'codec reads the '
                                                   '`entropy_bottleneck` '
                                                   'module',
    'models/runtime.py SplitClassifierRuntime.variables': 'Flax variables; '
                                                          'the port\'s '
                                                          'runtime holds '
                                                          'the module',
    'models/entropic.py EntropicClassifierModule.eb_param_path':
        'a path into the Flax parameter tree; the port names the module',
    'models/device_wire.py *': 'the JAX device-wire mixin; the port\'s '
                               'segmentation and detection runtimes inherit '
                               '`stream_deploy_device` from '
                               '`SplitClassifierRuntime`',
    'ops/rans/pallas_kernel.py pick_*': 'the Pallas VMEM plan pickers: the '
                                        'CUDA kernels pick their plans in '
                                        '`csrc/rans_cyclic.cu`',
    'ops/rans/pallas_kernel.py vmem_bytes_estimate': 'the Pallas VMEM '
                                                     'budget (the same)',
    'utils/cache.py *': 'the XLA persistent compile cache',
    'utils/torch_*.py *': 'the JAX tests\' torch replicas of the reference',
}


def _scan(root: Path) -> dict:
    """{module path: (top-level names, {class: (members, base names)})}
    of every module under `root`."""
    out = {}
    for path in sorted(root.rglob('*.py')):
        top, classes = set(), {}
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                top.add(node.name)
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                top |= {t.id for t in targets if isinstance(t, ast.Name)}
            if isinstance(node, ast.ClassDef):
                members = set()
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        members.add(sub.name)
                    elif isinstance(sub, ast.Assign):
                        members |= {t.id for t in sub.targets
                                    if isinstance(t, ast.Name)}
                classes[node.name] = (
                    members, [ast.unparse(b).split('.')[-1]
                              for b in node.bases])
        out[path.relative_to(root).as_posix()] = (top, classes)
    return out


def _jax_names(jax: dict) -> list:
    """'module.py Name' and 'module.py Class.method' of every public
    function, class and method of the JAX package."""
    names = []
    for module, (_, classes) in jax.items():
        tree = ast.parse((JAX / module).read_text())
        for node in tree.body:
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef)) \
                    or node.name.startswith('_'):
                continue
            names.append(f'{module} {node.name}')
            if isinstance(node, ast.ClassDef):
                names += [f'{module} {node.name}.{m}'
                          for m in sorted(classes[node.name][0])
                          if not m.startswith('_')
                          and isinstance(_member(node, m),
                                         (ast.FunctionDef,
                                          ast.AsyncFunctionDef))]
    return names


def _member(cls: ast.ClassDef, name: str):
    return next((s for s in cls.body if getattr(s, 'name', None) == name),
                None)


@pytest.fixture(scope='module')
def audit():
    return _scan(JAX), _scan(PORT)


def _port_members(port: dict, cls: str, seen=()) -> set:
    """A port class's members with those of its port base classes."""
    out = set()
    for _, classes in port.values():
        if cls in classes and cls not in seen:
            members, bases = classes[cls]
            out |= members
            for base in bases:
                out |= _port_members(port, base, seen + (cls,))
    return out


def _has(port: dict, where: str) -> bool:
    """Whether 'module.py Name' or 'module.py Class.member' is in the
    port (a member also through the class's port bases)."""
    module, name = where.split(' ')
    if module not in port:
        return False
    top, classes = port[module]
    if '.' not in name:
        return name in top
    cls, member = name.split('.', 1)
    return cls in classes and member in _port_members(port, cls)


def _excused(name: str) -> bool:
    return any(fnmatch.fnmatchcase(name, pattern)
               for pattern in NO_COUNTERPART)


def test_every_public_jax_name_has_a_counterpart(audit):
    jax, port = audit
    missing = [n for n in _jax_names(jax)
               if not _has(port, n) and n not in MOVED and not _excused(n)]
    assert not missing, ('JAX names without a counterpart in the port: '
                         + ', '.join(missing))


def test_moved_names_exist_in_the_port(audit):
    jax, port = audit
    names = set(_jax_names(jax))
    for name, target in MOVED.items():
        assert name in names, f'{name} is not a public JAX name'
        assert not _has(port, name), f'{name} is ported under its own name'
        assert _has(port, target), f'{name}: {target} is not in the port'


def test_no_counterpart_entries_are_needed(audit):
    """Each entry covers a JAX name that has no counterpart; none covers
    a name the port has."""
    jax, port = audit
    names = _jax_names(jax)
    for pattern in NO_COUNTERPART:
        covered = [n for n in names if fnmatch.fnmatchcase(n, pattern)]
        assert covered, f'{pattern} covers no public JAX name'
        ported = [n for n in covered if _has(port, n)]
        assert not ported, f'{pattern} covers ported names: {ported}'


@pytest.mark.parametrize('name', [
    'parallel/mesh.py get_mesh', 'parallel/mesh.py data_sharding',
    'parallel/mesh.py replicate', 'parallel/mesh.py shard_batch',
    'ops/rans/coder.py RansCoder.encode_interleaved',
    'ops/rans/coder.py RansCoder.decode_interleaved',
    'ops/boxes.py fast_nms_mask', 'datasets/sampler.py GroupedBatchSampler',
    'datasets/sampler.py create_aspect_ratio_groups',
    'datasets/sampler.py compute_aspect_ratios',
    'transforms/misc.py ClearTargetTransform',
    'datasets/image.py DataLoader.close',
    'models/detection/base.py check_if_updatable_detection_model',
    'models/segmentation/base.py check_if_updatable_segmentation_model',
    'models/regnet.py generate_regnet_params',
    'utils/metrics.py MetricLogger.log_every', 'analysis.py BaseAnalyzer',
    'ops/rans/device.py split_wire',
    'ops/entropy/tables.py CodingTables.state_dict',
    'ops/entropy/tables.py CodingTables.from_state_dict'])
def test_the_last_slice_is_ported_under_jax_names(audit, name):
    """The names this slice ports are the port's own, in JAX's modules."""
    jax, port = audit
    assert name in _jax_names(jax)
    assert _has(port, name)
