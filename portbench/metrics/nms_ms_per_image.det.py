"""Device ms an image under the `batched_nms_mask` range (the RPN's and
the box head's NMS, wrapped from outside), over the images served in
the traced window that recorded the ranges (`range_images`)."""


def read(ctx):
    t, c = ctx['trace'], ctx['counters']
    if not t or 'nms' not in t['by_range'] or not c.get('range_images'):
        return None
    return 1e3 * t['by_range']['nms'] / c['range_images']
