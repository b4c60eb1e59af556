"""The data-parallel group's share of its chips' float32 peak, in %: the
FLOPs of one group step (the reference's teacher forward, student forward
and backward over the whole global batch, counted on meta tensors:
`families/stage2_group.py` `flops_per_step`) times the traced window's
steps a second, over 67 TFLOP/s a rank."""
from portbench.roofline import PEAK_FLOPS


def read(ctx):
    c = ctx['counters']
    if not c.get('steps'):
        return None
    from portbench.families.stage2_group import flops_per_step
    mix = ctx['traffic']
    flops = flops_per_step(ctx['config']['model'], mix) * c['steps']
    return 100.0 * flops / c['window_s'] / (
        PEAK_FLOPS['float32'] * int(mix['ranks']))
