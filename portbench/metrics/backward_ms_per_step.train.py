"""Device ms a training step in the backward pass: the device time
between the ends of the program span `train.backward` (a CUDA event
pair) over the counter `train.steps`, both from the program's own
recorder (`sc2bench_tpu_torch.utils.profiling.recorder`), summed over
the traced windows. None without a trace, or from a program without the
recorder."""


def read(ctx):
    if not ctx['trace']:
        return None
    try:
        from sc2bench_tpu_torch.utils.profiling import recorder
    except ImportError:
        return None
    s = recorder.summarize()
    steps = s.get('train.steps', {}).get('count')
    device_ms = s.get('train.backward', {}).get('device_ms')
    if device_ms is None or not steps:
        return None
    return device_ms / steps
