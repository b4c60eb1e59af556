"""Segmentation CLI of the port (counterpart of
`script/task/semantic_segmentation.py`).

    python -m sc2bench_tpu_torch.tasks.semantic_segmentation \\
        --config configs/pascal_voc2012/...yaml [--json '{...}'] \\
        [-test_only] [-student_only] [--device cpu] [--seed 42] \\
        [--dst_ckpt path] [-adjust_lr] [--world_size N]

YAML config (+ `--json` deep override) -> DeepLabv3 teacher and student
-> without `-test_only`, the config's training stages (`--dst_ckpt`
keeps the best validation mIoU's weights) -> tables built -> mIoU, global
accuracy, `model_time` and the data-size summary of the student at batch
1 through the real bitstream (`deploy_wire: device` in the config selects
the device-rANS wire, else the host coder) -> the teacher's mIoU unless
`-student_only`. A `models.wrapper` config (JPEG/WebP/BPG or a neural
image codec in front of DeepLabv3) is test-only. The device is the card
unless `--device cpu`; it raises when there is none.

Over N processes (`torchrun --nproc_per_node N ... --world_size N`) each
trains on its shard and tests the whole test set; the confusion matrix
is summed over the group.
"""
from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

from ..config import load_config
from ..parallel.dist import destroy, init_from_env
from ..train.seg_engine import SegmentationEngine

logger = logging.getLogger('sc2bench_tpu_torch')


def get_argparser():
    parser = argparse.ArgumentParser(
        description='Supervised compression for split computing on the GPU: '
        'semantic segmentation')
    parser.add_argument('--config', required=True, help='yaml config path')
    parser.add_argument('--json', help='json string to overwrite config')
    parser.add_argument('--run_log', help='log file path')
    parser.add_argument('--device', default='cuda',
                        help="torch device; 'cpu' runs the plain PyTorch "
                        'path')
    parser.add_argument('--seed', type=int, default=42,
                        help="seed of the training forward's noise")
    parser.add_argument('--dst_ckpt', help='checkpoint output path')
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
    'teacher': teacher metrics or None, 'best': the best validation mIoU
    of training or None, 'engine': the engine}."""
    args = get_argparser().parse_args(argv)
    handlers = [logging.StreamHandler()]
    if args.run_log:
        Path(args.run_log).parent.mkdir(parents=True, exist_ok=True)
        handlers.append(logging.FileHandler(args.run_log))
    logging.basicConfig(level=logging.INFO, handlers=handlers)
    device = init_from_env(args.world_size, args.device)
    config = load_config(args.config, args.json)
    if args.adjust_lr:
        config['adjust_lr'] = True
    if args.log_config:
        logger.info('config: %s', config)
    engine = SegmentationEngine(config, device=device, seed=args.seed)
    best = None
    if not args.test_only:
        best = engine.train(dst_ckpt=args.dst_ckpt)
        logger.info('best val mIoU: %s', best)
    result, summaries = engine.test()
    logger.info('test result: %s', result)
    for s in summaries:
        logger.info('analysis: %s', s)
    teacher = None
    test_cfg = config.get('test', {}).get('test_data_loader')
    if not args.student_only and engine.teacher is not None and test_cfg:
        teacher = engine.evaluate(engine.build_loader(test_cfg),
                                  use_teacher=True)
        logger.info('teacher result: %s', teacher)
    return {'result': result, 'summaries': summaries, 'teacher': teacher,
            'best': best, 'engine': engine}


if __name__ == '__main__':
    main(sys.argv[1:])
    destroy()
