"""The training process's peak device memory, in GiB
(`torch.cuda.max_memory_allocated` at the window's close)."""


def read(ctx):
    peak = ctx['counters'].get('memory_peak_bytes')
    return peak / 2 ** 30 if peak else None
