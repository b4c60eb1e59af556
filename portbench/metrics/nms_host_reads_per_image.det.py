"""Device-to-host reads an image served in the tiled NMS (`nms_mask`'s
convergence flag, read every few fixed-point steps of every tile): the
program's counter `nms.host_reads` over its counter `deploy.images`,
both from the program's own recorder
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
    if 'nms.host_reads' not in s or not images:
        return None
    return s['nms.host_reads']['count'] / images
