"""Dataset helpers (counterpart of `sc2bench_tpu/datasets/util.py`)."""


def get_num_iterations(data_loader, num_epochs: int, world_size: int = 1):
    """Total optimizer steps for poly-LR schedules."""
    return len(data_loader) * num_epochs // max(world_size, 1)
