"""The share of the images served whose encoder ran as a CUDA graph
replay, in %: 100 x the counter `deploy.encode_graph.replays` (images a
replay encoded) over the counter `deploy.images`, both from the
program's own recorder (`sc2bench_tpu_torch.utils.profiling.recorder`),
summed over the traced windows. None without a trace, or from a program
without the recorder or without the counter (one that has no encoder
graphs, or served no image through one)."""


def read(ctx):
    if not ctx['trace']:
        return None
    try:
        from sc2bench_tpu_torch.utils.profiling import recorder
    except ImportError:
        return None
    s = recorder.summarize()
    images = s.get('deploy.images', {}).get('count')
    if 'deploy.encode_graph.replays' not in s or not images:
        return None
    return 100.0 * s['deploy.encode_graph.replays']['count'] / images
