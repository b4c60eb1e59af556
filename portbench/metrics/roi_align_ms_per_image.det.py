"""Device ms an image under the `multiscale_roi_align` range (the box
head's RoIAlign, wrapped from outside), over the images served in the
traced window that recorded the ranges (`range_images`)."""


def read(ctx):
    t, c = ctx['trace'], ctx['counters']
    if (not t or 'roi_align' not in t['by_range']
            or not c.get('range_images')):
        return None
    return 1e3 * t['by_range']['roi_align'] / c['range_images']
