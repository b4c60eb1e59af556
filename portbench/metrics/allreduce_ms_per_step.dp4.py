"""Device ms a training step in the gradients' all-reduce: the device
time between the ends of the program span `dist.allreduce` (a CUDA event
pair around the coalesced all-reduce inside `dist.average_gradients`)
over the counter `train.steps`, both from rank 0's recorder
(`sc2bench_tpu_torch.utils.profiling.recorder`), summed over the traced
windows. None without a trace, or from a program without the span."""


def read(ctx):
    if not ctx['trace']:
        return None
    try:
        from sc2bench_tpu_torch.utils.profiling import recorder
    except ImportError:
        return None
    s = recorder.summarize()
    steps = s.get('train.steps', {}).get('count')
    device_ms = s.get('dist.allreduce', {}).get('device_ms')
    if device_ms is None or not steps:
        return None
    return device_ms / steps
