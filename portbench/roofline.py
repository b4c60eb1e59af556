"""The yardstick's arithmetic: the chip's peaks, the rANS kernels' bytes
and operations, and the FLOPs of a reference computation.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W
limit): 67 TFLOP/s in float32 outside the tensor cores (the configs'
precision: TF32 off), 67 T integer operations a second, 3.35 TB/s of
HBM. The rANS costs are copied from the port's kernel smoke
(`chip_smoke.py`: `cyclic_stats`, `bound` and the per-symbol operation
counts), each input byte read once and each output byte written once.
"""
from __future__ import annotations

PEAK_FLOPS = {'float32': 67e12}
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12
# integer operations a coded symbol, counted from the kernels' code:
# encode = compare, shift, mask, select, divide, remainder, shift, two adds
# and the stream write; decode = one compare+add per CDF entry searched
# plus mask, shift, multiply, add, subtract, compare, shift, or, add
ENCODE_OPS_PER_SYMBOL = 10
DECODE_OPS_PER_SYMBOL = 9


def bound_s(nbytes, ops):
    """The least time of a launch: bytes over HBM bandwidth or integer
    operations over the integer rate, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, ops / INT_OPS_PER_S)


def cyclic_encode_cost(k, lanes, steps, cols):
    """(bytes, operations) of one cyclic encode launch over k images:
    symbols in, the lane tables, streams, lengths and states out."""
    nbytes = 4 * k * steps * lanes + 4 * lanes * cols \
        + 4 * k * lanes * steps + 4 * k * lanes + 8 * k * lanes
    return nbytes, ENCODE_OPS_PER_SYMBOL * k * steps * lanes


def cyclic_decode_cost(k, lanes, steps, cols, search):
    """(bytes, operations) of one cyclic decode launch over k images;
    `search` is the CDF entries scanned a row (the lanes' summed CDF
    lengths)."""
    table_bytes = 4 * lanes * cols + 8 * lanes
    nbytes = 4 * k * lanes * steps + 8 * k * lanes + table_bytes \
        + 4 * k * steps * lanes + 8 * k * lanes
    return nbytes, k * steps * (2 * search + DECODE_OPS_PER_SYMBOL * lanes)


def rans_bound_s(kernel, k, lanes, steps, cols, search):
    """The bound of one launch of a cyclic rANS kernel by name."""
    if 'encode' in kernel:
        return bound_s(*cyclic_encode_cost(k, lanes, steps, cols))
    return bound_s(*cyclic_decode_cost(k, lanes, steps, cols, search))


def count_flops(fn):
    """FLOPs that `torch.utils.flop_counter.FlopCounterMode` counts in one
    call of `fn` (convolutions and matrix products, forward and, where
    `fn` runs one, backward). Run it on meta tensors: it costs no device
    time or memory."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return float(counter.get_total_flops())
