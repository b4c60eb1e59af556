"""Classification test CLI of the port (counterpart of
`script/task/image_classification.py`, the test-only protocol).

    python -m sc2bench_tpu_torch.tasks.image_classification \\
        --config configs/ilsvrc2012/supervised_compression/...yaml \\
        [--json '{...}'] -test_only [-student_only] [--device cpu]

YAML config (+ `--json` deep override) -> teacher and student -> tables
built -> top-1/top-5 and the data-size summary of the student at batch 1
through the real bitstream (`deploy_wire: device` in the config selects
the device-rANS wire, else the host coder) -> top-1/top-5 of the teacher
unless `-student_only`. The device is the card unless `--device cpu`; it
raises when there is none. Training is not ported yet: without
`-test_only` it raises.
"""
from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

from ..config import load_config
from ..train.engine import ClassificationEngine

logger = logging.getLogger('sc2bench_tpu_torch')


def get_argparser():
    parser = argparse.ArgumentParser(
        description='Supervised compression for split computing on the GPU: '
        'image classification, test protocol')
    parser.add_argument('--config', required=True, help='yaml config path')
    parser.add_argument('--json', help='json string to overwrite config')
    parser.add_argument('--run_log', help='log file path')
    parser.add_argument('--device', default='cuda',
                        help="torch device; 'cpu' runs the plain PyTorch "
                        'path')
    parser.add_argument('-test_only', action='store_true',
                        help='only test the model (training is not ported '
                        'yet, so this is required)')
    parser.add_argument('-student_only', action='store_true',
                        help='test the student model only')
    parser.add_argument('-log_config', action='store_true',
                        help='log the resolved config')
    return parser


def main(argv=None):
    """Run the CLI on `argv` (default: the process's arguments). Returns
    {'result': student metrics, 'summaries': data-size summaries,
    'teacher': teacher metrics or None, 'engine': the engine}."""
    args = get_argparser().parse_args(argv)
    handlers = [logging.StreamHandler()]
    if args.run_log:
        Path(args.run_log).parent.mkdir(parents=True, exist_ok=True)
        handlers.append(logging.FileHandler(args.run_log))
    logging.basicConfig(level=logging.INFO, handlers=handlers)
    if not args.test_only:
        raise NotImplementedError(
            'training is not ported yet (ROADMAP Queue A item 6); run with '
            '-test_only')
    config = load_config(args.config, args.json)
    if args.log_config:
        logger.info('config: %s', config)
    engine = ClassificationEngine(config, device=args.device)
    result, summaries = engine.test()
    logger.info('test result: %s', result)
    for s in summaries:
        logger.info('analysis: %s', s)
    teacher = None
    test_cfg = config.get('test', {}).get('test_data_loader')
    if not args.student_only and engine.teacher is not None and test_cfg:
        teacher = engine.evaluate_teacher(engine.build_loader(test_cfg))
    return {'result': result, 'summaries': summaries, 'teacher': teacher,
            'engine': engine}


if __name__ == '__main__':
    main(sys.argv[1:])
