"""Parallelism over `torch.distributed` (counterpart of
`sc2bench_tpu/parallel/`): data parallelism in `dist.py`, the ('data',
'model') mesh and the row-sharded encoder in `mesh.py`."""
