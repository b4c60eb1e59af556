"""The masked rANS kernels' share of their roofline, in %: over the
traced window's launches of `rans_masked_encode_aligned` (the aligned
encoder's kernel with its activity map) and `rans_masked_decode_front`,
the summed bound time (bytes over 3.35 TB/s or integer operations over
67 T, whichever is longer, at the served shapes:
`roofline_masked.masked_bounds`) over their summed device time. None
without a trace or a launch."""


def read(ctx):
    t = ctx['trace']
    if not t:
        return None
    bounds = ctx['system'].masked_bounds()
    bound = sum(n * per for name, n in t['launches'].items()
                for part, per in bounds.items() if part in name)
    device = sum(s for name, s in t['by_kernel'].items()
                 if any(part in name for part in bounds))
    if bound <= 0 or device <= 0:
        return None
    return 100.0 * bound / device
