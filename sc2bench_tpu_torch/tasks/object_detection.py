"""Detection CLI of the port (counterpart of
`script/task/object_detection.py`).

    python -m sc2bench_tpu_torch.tasks.object_detection \\
        --config configs/coco2017/...yaml [--json '{...}'] \\
        [-test_only] [-student_only] [--device cpu] [--seed 42] \\
        [--dst_ckpt path] [-adjust_lr] [--world_size N] \
        [--iou_types bbox segm|keypoints]

YAML config (+ `--json` deep override) -> Faster R-CNN teacher and
student (or a Mask or Keypoint R-CNN) -> without `-test_only`, the
config's training stages (`--dst_ckpt` keeps the best validation mAP's
weights) -> the 12 COCO bbox metrics, `model_time` and the data-size
summary of the student at batch 1 through the real bitstream
(`deploy_wire: device` in the config selects the device-rANS wire, else
the host coder; a student without an entropy model is scored on its
plain forward, on every evaluation type) -> the teacher's metrics unless
`-student_only`. `--iou_types` sets the config's `iou_types`, the
evaluation types of the plain forward (default: bbox, plus segm for a
Mask R-CNN and keypoints for a Keypoint R-CNN); the deploy path scores
bbox only, as in JAX. A `models.wrapper` config (the input-compression
family) is test-only: its wrapper compresses each image before the
detector and accounts its size. The device is the card unless `--device
cpu`; it raises when there is none.

Over N processes (`torchrun --nproc_per_node N ... --world_size N`) each
trains on its shard and tests the whole test set; the COCO evaluator
gathers the processes' detections by image id (`CocoEvaluator`).
"""
from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

from ..config import load_config
from ..parallel.dist import destroy, init_from_env
from ..train.det_engine import DetectionEngine

logger = logging.getLogger('sc2bench_tpu_torch')


def get_argparser():
    parser = argparse.ArgumentParser(
        description='Supervised compression for split computing on the GPU: '
        'object detection')
    parser.add_argument('--config', required=True, help='yaml config path')
    parser.add_argument('--json', help='json string to overwrite config')
    parser.add_argument('--run_log', help='log file path')
    parser.add_argument('--device', default='cuda',
                        help="torch device; 'cpu' runs the plain PyTorch "
                        'path')
    parser.add_argument('--seed', type=int, default=42,
                        help="seed of the training forward's noise and the "
                        "samplers' draws")
    parser.add_argument('--dst_ckpt', help='checkpoint output path')
    parser.add_argument('--iou_types', nargs='+', default=None,
                        help='bbox/segm/keypoints; default: bbox, plus '
                        'segm for a Mask R-CNN and keypoints for a '
                        'Keypoint R-CNN')
    parser.add_argument('--world_size', type=int, default=1,
                        help='data-parallel processes; start them with '
                        '`torchrun --nproc_per_node N`')
    parser.add_argument('-test_only', action='store_true',
                        help='only test the model')
    parser.add_argument('-student_only', action='store_true',
                        help='skip the teacher-anchor eval')
    parser.add_argument('-adjust_lr', action='store_true',
                        help='multiply the learning rates by the number of '
                        'data-parallel processes')
    parser.add_argument('-no_dp_eval', action='store_true',
                        help='accepted for parity with the JAX CLI: a '
                        'process drives one device, so there is no eval '
                        'batch to shard over its devices')
    parser.add_argument('-log_config', action='store_true',
                        help='log the resolved config')
    return parser


def main(argv=None):
    """Run the CLI on `argv` (default: the process's arguments). Returns
    {'result': student metrics, 'summaries': data-size summaries,
    'teacher': teacher metrics or None, 'best': the best validation mAP of
    training or None, 'engine': the engine}."""
    args = get_argparser().parse_args(argv)
    handlers = [logging.StreamHandler()]
    if args.run_log:
        Path(args.run_log).parent.mkdir(parents=True, exist_ok=True)
        handlers.append(logging.FileHandler(args.run_log))
    logging.basicConfig(level=logging.INFO, handlers=handlers)
    device = init_from_env(args.world_size, args.device)
    config = load_config(args.config, args.json)
    if args.iou_types:
        config['iou_types'] = args.iou_types
    if args.adjust_lr:
        config['adjust_lr'] = True
    if args.log_config:
        logger.info('config: %s', config)
    engine = DetectionEngine(config, device=device, seed=args.seed)
    best = None
    if not args.test_only:
        best = engine.train(dst_ckpt=args.dst_ckpt)
        logger.info('best val mAP: %s', best)
    result, summaries = engine.test()
    logger.info('test mAP stats: %s', result)
    teacher = None
    test_cfg = config.get('test', {}).get('test_data_loader')
    if not args.student_only and engine.teacher is not None and test_cfg:
        teacher = engine.evaluate(engine.build_loader(test_cfg),
                                  use_teacher=True)
        logger.info('teacher mAP stats: %s', teacher)
    return {'result': result, 'summaries': summaries, 'teacher': teacher,
            'best': best, 'engine': engine}


if __name__ == '__main__':
    main(sys.argv[1:])
    destroy()
