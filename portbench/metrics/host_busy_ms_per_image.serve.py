"""The host's own ms an image served: the program span `deploy.request`
(one serving call) less the wait spans inside it (where the host blocks
on the device), over the counter `deploy.images`, both from the
program's own recorder (`sc2bench_tpu_torch.utils.profiling.recorder`),
summed over the traced windows. None without a trace, or from a program
without the recorder."""


def read(ctx):
    if not ctx['trace']:
        return None
    try:
        from sc2bench_tpu_torch.utils.profiling import recorder
    except ImportError:
        return None
    s = recorder.summarize()
    images = s.get('deploy.images', {}).get('count')
    if 'deploy.request' not in s or not images:
        return None
    req = s['deploy.request']
    return (req['total_ms'] - req['wait_ms']) / images
