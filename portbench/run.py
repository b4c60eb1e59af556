#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the chips of this
machine, and print its result as the last line of standard output.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

`--trace 0` prints the cell's end-to-end metrics, `--trace 1` its
per-layer metrics read from a profiled window. Exits with another code
than 0, and prints no result, without the CUDA devices the cell needs or
when a JAX module was loaded. See `portbench/README.md`.
"""
import argparse
import os
import sys
import time

T_START = time.perf_counter()


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


if __name__ == '__main__':
    args = parse()
    # the checkout's root in place of this script's folder
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    from portbench import harness
    sys.exit(harness.main(args, T_START))
