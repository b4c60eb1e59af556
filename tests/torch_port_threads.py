"""Pins torch's intra-op thread count for the port's test files.

Tier-1 runs six xdist workers on an eight-CPU host; each worker's torch
would otherwise start one intra-op thread per CPU, so the workers'
convolutions fight over the cores (one thread a worker took the suite's
worker time from 6,155 s to 1,600 s). Every `tests/test_torch_port_*.py`
imports this module first."""
import torch

torch.set_num_threads(1)
