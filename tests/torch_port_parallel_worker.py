"""One rank of the port's data-parallel checks, run by
`tests/test_torch_port_parallel.py` under

    torchrun --standalone --nproc_per_node 2 \\
        tests/torch_port_parallel_worker.py SPEC.pt OUT_DIR

on the CPU over gloo. Each rank reads the spec the test wrote, runs the
box steps and the detection step on its block of the batch, the segm and
keypoint evaluators on its share of the images, the FP encoder with the
image rows sharded over a ('data', 'model') mesh, and the three CLIs over
the group, and writes what it saw to `OUT_DIR/rank<r>.pt`; the
test compares those with one process and with JAX. `box_steps` and
`det_step` are also the one-process reference (`block` the identity)."""
from __future__ import annotations

import logging
import sys
from pathlib import Path

import torch

torch.set_num_threads(1)


def box_steps(spec: dict, block=lambda t: t) -> list:
    """One `DistillationBox` step a stage from the spec's student and
    teacher, each stage with a fresh generator from its seed and its own
    batch (`block` picks this rank's rows); per stage the losses, the aux
    loss and the student's state after the step."""
    from sc2bench_tpu_torch.models.registry import load_classification_model
    from sc2bench_tpu_torch.train.box import DistillationBox
    teacher = load_classification_model(spec['teacher_cfg'], device='cpu')
    teacher.load_state_dict(spec['teacher'])
    student = load_classification_model(spec['student_cfg'], device='cpu')
    student.load_state_dict(spec['student'])
    out = []
    for stage_cfg, seed, x, y in zip(spec['stages'], spec['seeds'],
                                     spec['x'], spec['y']):
        box = DistillationBox(student, stage_cfg, teacher=teacher,
                              steps_per_epoch=1, student_mode='train',
                              generator=torch.Generator().manual_seed(seed))
        metrics = box.train_step(block(x), block(y))
        out.append({'loss': {k: float(v) for k, v in
                             metrics['loss'].items()},
                    'aux_loss': float(metrics['aux_loss']),
                    'state': {k: v.detach().clone()
                              for k, v in student.state_dict().items()}})
    return out


def det_step(spec: dict, block=lambda t: t) -> dict:
    """One `DetectionBox` step of the end-to-end COCO recipe (the 'train'
    forward's noise, bpp, the RPN and RoI losses with both samplers, SGD,
    BatchNorm training) on the spec's small Faster R-CNN, its generator
    seeded from the spec, on this rank's block of the canvases and
    targets; the losses, the aux loss and the student's state after."""
    from sc2bench_tpu_torch.models.detection.base import \
        SplittableDetectionBackbone
    from sc2bench_tpu_torch.models.detection.rcnn import FasterRCNN
    from sc2bench_tpu_torch.models.layer import get_layer
    from sc2bench_tpu_torch.train.det_engine import DetectionBox
    bneck = spec['bottleneck']
    student = FasterRCNN(SplittableDetectionBackbone(
        get_layer(bneck['key'], **bneck['kwargs']), spec['stages']),
        num_classes=spec['classes'])
    student.load_state_dict(spec['state'])
    student.eval()
    box = DetectionBox(student, spec['stage'], detection_loss_weight=1.0,
                       steps_per_epoch=1, student_mode='train',
                       generator=torch.Generator().manual_seed(spec['seed']))
    metrics = box.train_step(block(spec['x']), {
        k: block(v) for k, v in spec['targets'].items()})
    return {'loss': {k: float(v) for k, v in metrics['loss'].items()},
            'aux_loss': float(metrics['aux_loss']),
            'state': {k: v.detach().clone()
                      for k, v in student.state_dict().items()}}


def seg_loss(spec: dict, block=lambda t: t) -> dict:
    """`SegCrossEntropyLoss` (its denominator the valid pixels of the
    global batch) on this rank's block: the value and the gradient of the
    logits."""
    from sc2bench_tpu_torch.loss import SegCrossEntropyLoss
    logits = block(spec['logits']).clone().requires_grad_(True)
    loss = SegCrossEntropyLoss()({'output': logits}, None,
                                 block(spec['targets']))
    loss.backward()
    return {'loss': float(loss.detach()), 'grad': logits.grad}


def coco_sync(spec: dict, rank: int = 0, world: int = 1) -> dict:
    """The segm and keypoint COCO evaluators of the spec ({iou_type:
    (targets, predictions)}), this rank holding image i when i % world ==
    rank, synchronized over the group: each type's 12 metrics."""
    from sc2bench_tpu_torch.utils.coco_eval import CocoEvaluator
    out = {}
    for iou_type, (targets, preds) in spec.items():
        evaluator = CocoEvaluator(iou_type=iou_type)
        for i, target in enumerate(targets):
            if i % world != rank:
                continue
            evaluator.add_gt(target)
            if target['image_id'] in preds:
                evaluator.update({target['image_id']:
                                  preds[target['image_id']]})
        evaluator.synchronize_between_processes()
        evaluator.accumulate()
        out[iou_type] = evaluator.summarize()
    return out


def mesh_encode(spec: dict) -> dict:
    """The 2-D mesh over the group and the spec's FP bottleneck encoder on
    this rank's rows of the spec's images (`sharded_encode`): the mesh's
    shape and this rank's lines, the gathered latent, this rank's
    latent rows and their offset (`_encode_rows`, before the gather),
    and the message of an H the encoder refuses."""
    from sc2bench_tpu_torch.models.layer import FPBasedResNetBottleneck
    from sc2bench_tpu_torch.parallel.mesh import (_encode_rows, get_mesh,
                                                  replicate, shard_spatial,
                                                  sharded_encode)
    mesh = get_mesh(axes=('data', 'model'))
    bneck = FPBasedResNetBottleneck(
        num_bottleneck_channels=spec['channels']).eval()
    if mesh.rank == 0:
        bneck.load_state_dict(spec['state'])
    replicate(mesh, bneck)                 # rank 0's weights everywhere
    x = shard_spatial(mesh, spec['x'])
    shard, offset = _encode_rows(bneck, x, mesh)
    try:
        sharded_encode(bneck, x[:, :, :x.shape[2] - 2], mesh)
        refused = None
    except ValueError as e:
        refused = str(e)
    return {'shape': mesh.shape, 'model_line': mesh.line('model'),
            'data_line': mesh.line('data'), 'rows': x.shape[2],
            'latent': sharded_encode(bneck, x, mesh), 'shard': shard,
            'offset': offset, 'refused': refused}


class _Messages(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _cli(main, argv: list) -> dict:
    """`main(argv)` with the log messages it emitted; the student's state
    and the analyzer's per-image sizes."""
    handler = _Messages()
    logging.getLogger().addHandler(handler)
    logging.getLogger().setLevel(logging.INFO)
    try:
        out = main(argv)
    finally:
        logging.getLogger().removeHandler(handler)
    engine = out['engine']
    runtime = getattr(engine, 'runtime', None)
    sizes = [] if runtime is None else [
        s for a in runtime.analyzers for s in a.file_size_list]
    return {'result': out['result'], 'summaries': out['summaries'],
            'teacher': out['teacher'], 'best': out['best'],
            'sizes': sizes, 'messages': handler.lines,
            'state': {k: v.detach().clone()
                      for k, v in engine.student.state_dict().items()}}


def cli_runs(spec: dict, world: int) -> dict:
    """The CLI runs of the spec over the group: `(name, task, argv)`."""
    from sc2bench_tpu_torch.tasks import (image_classification,
                                          object_detection,
                                          semantic_segmentation)
    mains = {'cls': image_classification.main,
             'seg': semantic_segmentation.main,
             'det': object_detection.main}
    group = ['--world_size', str(world), '--device', 'cpu']
    return {name: _cli(mains[task], [*argv, *group])
            for name, task, argv in spec['cli']}


def main(spec_path: str, out_dir: str) -> None:
    from sc2bench_tpu_torch.parallel import dist
    spec = torch.load(spec_path, weights_only=False)
    dist.init_from_env(spec['world'], 'cpu')
    r, w = dist.rank(), dist.world_size()

    def block(t):
        n = t.shape[0] // w
        return t[r * n:(r + 1) * n]

    res = {'rank': r, 'world': w, 'backend': dist.backend(),
           'box': box_steps(spec['box'], block),
           'det': det_step(spec['det'], block),
           'seg_loss': seg_loss(spec['seg_loss'], block),
           'coco': coco_sync(spec['coco'], r, w),
           'mesh': mesh_encode(spec['mesh']),
           'cli': cli_runs(spec, w)}
    torch.save(res, Path(out_dir) / f'rank{r}.pt')
    dist.barrier()
    dist.destroy()


if __name__ == '__main__':
    main(*sys.argv[1:3])
