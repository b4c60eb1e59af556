"""Host ms an image in the codec's two wavefront loops: the program spans
`codec.scan` (the encoder's) and `codec.fronts` (the decoder's) over the
counter `codec.images`, all from the program's own recorder
(`sc2bench_tpu_torch.utils.profiling.recorder`), summed over the traced
windows. None without a trace, or from a program without the spans."""


def read(ctx):
    if not ctx['trace']:
        return None
    try:
        from sc2bench_tpu_torch.utils.profiling import recorder
    except ImportError:
        return None
    s = recorder.summarize()
    images = s.get('codec.images', {}).get('count')
    if 'codec.scan' not in s or 'codec.fronts' not in s or not images:
        return None
    return (s['codec.scan']['total_ms'] + s['codec.fronts']['total_ms']) \
        / images
