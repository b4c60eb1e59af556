"""The arithmetic of the per-layer metrics that more than one metric
shares; each metric's file under `metrics/` binds its `read` to one of
these. Each returns None where it finds nothing to read."""
from portbench.roofline import PEAK_FLOPS


def idle_share(ctx):
    """Share of the traced window in which no operation ran on the device
    (the union of kernel, copy and set intervals), in %."""
    t = ctx['trace']
    if not t or t['busy_s'] <= 0:
        return None
    return 100.0 * (1.0 - t['busy_s'] / t['window_s'])


def serve_mfu(ctx):
    """The served model step's share of the chip's float32 peak, in %:
    the FLOPs of one image (the reference's encoder, decoder, tail and
    heads at the traffic's image sizes, counted on meta tensors) times the
    traced window's images a second, over 67 TFLOP/s."""
    c = ctx['counters']
    if not c.get('images'):
        return None
    flops = ctx['system'].flops_per_image() * c['images']
    return 100.0 * flops / c['window_s'] / PEAK_FLOPS['float32']


def rans_roofline(ctx):
    """The rANS coder's share of its roofline, in %: over the traced
    window's rANS launches, the summed bound time (bytes read and written
    once over 3.35 TB/s, or integer operations over 67 T, whichever is
    longer, from the reference's shapes) over the summed device time of
    the coder's kernels."""
    t = ctx['trace']
    if not t:
        return None
    bounds = ctx['system'].rans_bounds()
    bound = sum(n * per for name, n in t['launches'].items()
                for part, per in bounds.items() if part in name)
    device = sum(s for name, s in t['by_kernel'].items()
                 if 'rans_' in name or 'build_lane_tables' in name)
    if bound <= 0 or device <= 0:
        return None
    return 100.0 * bound / device


def drain_ms_per_request(ctx):
    """The deploy loop's drain a request, in ms: the runtime's own
    `account_d2h` host-clock timing (reading every image's size and
    validity after the stream) over the traced window's requests."""
    c = ctx['counters']
    d2h = c.get('timings', {}).get('account_d2h')
    if d2h is None or not c.get('requests'):
        return None
    return 1e3 * d2h / c['requests']
