"""Detection CLI of the port (counterpart of
`script/task/object_detection.py`).

    python -m sc2bench_tpu_torch.tasks.object_detection \\
        --config configs/coco2017/...yaml [--json '{...}'] \\
        [-test_only] [-student_only] [--device cpu] [--seed 42] \\
        [--dst_ckpt path] [-adjust_lr]

YAML config (+ `--json` deep override) -> Faster R-CNN teacher and
student -> without `-test_only`, the config's training stages
(`--dst_ckpt` keeps the best validation mAP's weights) -> the 12 COCO
bbox metrics, `model_time` and the data-size summary of the student at
batch 1 through the real bitstream (`deploy_wire: device` in the config
selects the device-rANS wire, else the host coder; a CR+BQ student is
scored on its plain forward) -> the teacher's metrics unless
`-student_only`. A `models.wrapper` config (the input-compression
family) is test-only: its wrapper compresses each image before the
detector and accounts its size. The device is the card unless `--device cpu`; it raises
when there is none.
"""
from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

from ..config import load_config
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
                        help="evaluation types; 'bbox' is the one ported")
    parser.add_argument('--world_size', type=int, default=1,
                        help='data-parallel processes (one in the port)')
    parser.add_argument('-test_only', action='store_true',
                        help='only test the model')
    parser.add_argument('-student_only', action='store_true',
                        help='skip the teacher-anchor eval')
    parser.add_argument('-adjust_lr', action='store_true',
                        help='multiply the learning rates by the number of '
                        'data-parallel processes (one here)')
    parser.add_argument('-no_dp_eval', action='store_true',
                        help='evaluate in one process (the port always '
                        'does)')
    parser.add_argument('-log_config', action='store_true',
                        help='log the resolved config')
    return parser


def main(argv=None):
    """Run the CLI on `argv` (default: the process's arguments). Returns
    {'result': student metrics, 'summaries': data-size summaries,
    'teacher': teacher metrics or None, 'best': the best validation mAP of
    training or None, 'engine': the engine}."""
    args = get_argparser().parse_args(argv)
    if args.world_size > 1:
        raise NotImplementedError('data-parallel training is not ported yet '
                                  '(ROADMAP Queue A item 4)')
    if args.iou_types and set(args.iou_types) != {'bbox'}:
        raise NotImplementedError('only the bbox evaluation is ported '
                                  '(segm and keypoints: ROADMAP Queue A '
                                  'item 5)')
    handlers = [logging.StreamHandler()]
    if args.run_log:
        Path(args.run_log).parent.mkdir(parents=True, exist_ok=True)
        handlers.append(logging.FileHandler(args.run_log))
    logging.basicConfig(level=logging.INFO, handlers=handlers)
    config = load_config(args.config, args.json)
    if args.adjust_lr:
        config['adjust_lr'] = True
    if args.log_config:
        logger.info('config: %s', config)
    engine = DetectionEngine(config, device=args.device, seed=args.seed)
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
