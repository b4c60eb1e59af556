"""The share of the codec's wavefront fronts that ran through the front
kernels, in %: 100 x the counter `codec.fused_fronts` over the counter
`codec.front_steps` (fronts run, both loops), both from the program's own
recorder (`sc2bench_tpu_torch.utils.profiling.recorder`), summed over the
traced windows. None without a trace, or from a program without the
recorder or without the counter (one that has no front kernels, or ran no
front through them)."""


def read(ctx):
    if not ctx['trace']:
        return None
    try:
        from sc2bench_tpu_torch.utils.profiling import recorder
    except ImportError:
        return None
    s = recorder.summarize()
    steps = s.get('codec.front_steps', {}).get('count')
    if 'codec.fused_fronts' not in s or not steps:
        return None
    return 100.0 * s['codec.fused_fronts']['count'] / steps
