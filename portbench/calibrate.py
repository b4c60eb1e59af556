#!/usr/bin/env python3
"""Readings that set the limits of `correct` (`limits/<cell>.json`).

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --seconds 4 [--stand-ins tf32,reorder] [--fault <name>]

For each seed, in one process: the cell's system is built, driven through
a window of `--seconds` at the cell's own size and load, and checked as a
run checks it; then each stand-in puts the reference in the program's
place ('tf32': the control, computed with TF32 on; 'reorder': float32 on
blocks of another size; 'half_batch' and others as the family offers)
and is checked the same way. `--fault` breaks the program underneath
first (`faults.py`). One JSON line a seed. The benchmark's own runs never
run this.
"""
import argparse
import json
import os
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--seconds', type=float, default=4.0)
    ap.add_argument('--stand-ins', default='')
    ap.add_argument('--fault', default=None)
    args = ap.parse_args(argv)
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))
    from portbench import faults, harness
    import torch
    if not torch.cuda.is_available():
        print('calibrate: no CUDA device', file=sys.stderr)
        return 3
    if args.fault:
        faults.plant(args.fault)
    for seed in [int(s) for s in args.seeds.split(',')]:
        t0 = time.perf_counter()
        line = harness.calibration_run(args.workload, seed, args.seconds,
                                       'cuda:0', t0,
                                       [s for s in args.stand_ins.split(',')
                                        if s])
        line.update(seed=seed, fault=args.fault,
                    seconds=time.perf_counter() - t0)
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
