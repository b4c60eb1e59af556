"""Data parallelism over `torch.distributed` (counterpart of
`sc2bench_tpu/parallel/`): `dist.py`."""
