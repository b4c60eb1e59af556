"""The training step's share of the chip's float32 peak, in %: the FLOPs
of one step (the reference's teacher forward, student forward and
backward at the cell's batch, counted on meta tensors) times the traced
window's steps a second, over 67 TFLOP/s."""
from portbench.roofline import PEAK_FLOPS


def read(ctx):
    c = ctx['counters']
    if not c.get('steps'):
        return None
    flops = ctx['system'].flops_per_step() * c['steps']
    return 100.0 * flops / c['window_s'] / PEAK_FLOPS['float32']
