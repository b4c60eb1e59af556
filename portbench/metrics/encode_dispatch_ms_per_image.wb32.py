"""Host ms an image served in the encoder's dispatch: the program span
`deploy.encode` (the encoder calls and rounding of one coding launch's
images) over the counter
`deploy.images`, both from the program's own recorder
(`sc2bench_tpu_torch.utils.profiling.recorder`), summed over the traced
windows. None without a trace, or from a program without the recorder."""


def read(ctx):
    if not ctx['trace']:
        return None
    try:
        from sc2bench_tpu_torch.utils.profiling import recorder
    except ImportError:
        return None
    s = recorder.summarize()
    images = s.get('deploy.images', {}).get('count')
    if 'deploy.encode' not in s or not images:
        return None
    return s['deploy.encode']['total_ms'] / images
