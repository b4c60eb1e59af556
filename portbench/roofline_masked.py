"""Bytes and integer operations of the masked rANS kernels of the joint
autoregressive codec's device wire (`csrc/rans_indexed.cu`:
`rans_masked_encode_aligned`, the aligned encoder's template with an
activity map, and `rans_masked_decode_front`), each input byte read once
and each output byte written once. Where the work depends on the data,
what these inputs need: the table entries of the active symbols only.
The peaks and `bound_s` are `roofline.py`'s."""
from __future__ import annotations

from portbench.roofline import (DECODE_OPS_PER_SYMBOL,
                                ENCODE_OPS_PER_SYMBOL, bound_s)

# the encoder reads one prepared entry a coded symbol: (start, freq and
# the reciprocal's two words), 16 bytes
ENCODE_ENTRY_BYTES = 16
# the front decoder's table walk a coded symbol: the row's base, the
# bucket's two bounds, one bisection probe and the (start, next) pair,
# 4 bytes each (the kernel's "about 5 dependent loads"), one compare and
# select a probe beside the decoder's own operations
DECODE_WALK_WORDS = 5
DECODE_OPS = DECODE_OPS_PER_SYMBOL + 2


def masked_encode_cost(steps, slots, m, active):
    """(bytes, operations) of one masked encode launch: values and rows
    (T, N) int32 and the activity map (T, F) in, the active symbols'
    entries, the aligned streams (N, T) int32, lengths (N,) int32 and
    states (N,) int64 out; `active` the coded symbols."""
    lanes = slots * m
    nbytes = 8 * steps * lanes + steps * slots + ENCODE_ENTRY_BYTES * active \
        + 4 * lanes * steps + 4 * lanes + 8 * lanes
    return nbytes, ENCODE_OPS_PER_SYMBOL * active


def masked_decode_front_cost(slots, m, active):
    """(bytes, operations) of one front's decode launch over N = F * m
    lanes: the chunk column, states (int64), rows and the activity map in,
    the active symbols' table walk, symbols (int32) and states out."""
    lanes = slots * m
    nbytes = 4 * lanes + 8 * lanes + 4 * lanes + slots \
        + 4 * DECODE_WALK_WORDS * active + 4 * lanes + 8 * lanes
    return nbytes, DECODE_OPS * active


def masked_bounds(counts, m):
    """{kernel name part: the bound of one launch} for an image whose
    fronts hold `counts` positions each: the encoder's one launch, and
    the front decoder's launches' mean."""
    steps, slots = len(counts), max(counts)
    active = sum(counts) * m
    decode = [bound_s(*masked_decode_front_cost(slots, m, c * m))
              for c in counts]
    return {'rans_indexed_encode_aligned_warp_kernel': bound_s(
                *masked_encode_cost(steps, slots, m, active)),
            'rans_masked_decode_front_kernel': sum(decode) / len(decode)}
