"""Classification CLI of the port (counterpart of
`script/task/image_classification.py`).

    python -m sc2bench_tpu_torch.tasks.image_classification \\
        --config configs/ilsvrc2012/supervised_compression/...yaml \\
        [--json '{...}'] [-test_only] [-student_only] [--device cpu] \\
        [--seed 42] [--dst_ckpt path] [-resume] [-adjust_lr] \\
        [--profile_dir dir]
    torchrun --nproc_per_node N -m sc2bench_tpu_torch.tasks.\\
        image_classification --world_size N --config ... [--device cpu]

YAML config (+ `--json` deep override) -> teacher and student -> without
`-test_only`, the config's training stages (`--dst_ckpt` keeps the best
checkpoint and the resume state, `-resume` continues from it) -> tables
built -> top-1/top-5 and the data-size summary of the student at batch 1
through the real bitstream (`deploy_wire: device` in the config selects
the device-rANS wire, else the host coder) -> top-1/top-5 of the teacher
unless `-student_only`. A `models.wrapper` config (the input- and
feature-compression baselines: a classifier behind JPEG/WebP/BPG/VTM or a
neural image codec, or a codec on a split feature) is test-only: top-1/
top-5 and the wrapper's data-size summary; `deploy_wire: device` codes
the images of a neural input-compression wrapper whose codec has a
device wire (the joint autoregressive codec) on that wire, the images
padded on the card, and raises for any other wrapper; its data-size
summary is then the lane format's, which carries the lanes' states and
lengths and is not comparable with the host wire's or the paper's. The device is the
card unless `--device cpu`; it raises when there is none.

Over N processes (`torchrun`, `--world_size N`: NCCL on the cards, one a
process, or gloo with `--device cpu`) each process trains on its shard
of the training data with the gradients averaged over the group, and
tests the whole test set; the metrics are summed over the group, rank 0
writes the checkpoints. `--profile_dir` writes a `torch.profiler` trace
of the test phase there, and the totals of the program's spans
(`utils/profiling.py`), one pair of files a process.
"""
from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

from ..config import load_config
from ..parallel.dist import destroy, init_from_env
from ..train.engine import ClassificationEngine
from ..utils.profiling import trace

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
    parser.add_argument('--seed', type=int, default=42,
                        help="seed of the training forward's noise")
    parser.add_argument('--dst_ckpt', help='checkpoint output path')
    parser.add_argument('-test_only', action='store_true',
                        help='only test the model')
    parser.add_argument('-resume', action='store_true',
                        help='resume training from the dst_ckpt train state')
    parser.add_argument('-adjust_lr', action='store_true',
                        help='multiply the learning rates by the number of '
                        'data-parallel processes')
    parser.add_argument('--world_size', type=int, default=1,
                        help='data-parallel processes; start them with '
                        '`torchrun --nproc_per_node N`')
    parser.add_argument('-no_dp_eval', action='store_true',
                        help='accepted for parity with the JAX CLI: a '
                        'process drives one device, so there is no eval '
                        'batch to shard over its devices')
    parser.add_argument('-student_only', action='store_true',
                        help='test the student model only')
    parser.add_argument('-log_config', action='store_true',
                        help='log the resolved config')
    parser.add_argument('--profile_dir',
                        help='write a torch.profiler trace of the test phase '
                        'into this directory')
    return parser


def main(argv=None):
    """Run the CLI on `argv` (default: the process's arguments). Returns
    {'result': student metrics, 'summaries': data-size summaries,
    'teacher': teacher metrics or None, 'best': the best validation acc1
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
    engine = ClassificationEngine(config, device=device, seed=args.seed)
    best = None
    if not args.test_only:
        best = engine.train(dst_ckpt=args.dst_ckpt, resume=args.resume)
        logger.info('best validation acc1: %s', best)
    if args.profile_dir:
        with trace(args.profile_dir):
            result, summaries = engine.test()
    else:
        result, summaries = engine.test()
    logger.info('test result: %s', result)
    for s in summaries:
        logger.info('analysis: %s', s)
    teacher = None
    test_cfg = config.get('test', {}).get('test_data_loader')
    if not args.student_only and engine.teacher is not None and test_cfg:
        teacher = engine.evaluate_teacher(engine.build_loader(test_cfg))
    return {'result': result, 'summaries': summaries, 'teacher': teacher,
            'best': best, 'engine': engine}


if __name__ == '__main__':
    main(sys.argv[1:])
    destroy()
