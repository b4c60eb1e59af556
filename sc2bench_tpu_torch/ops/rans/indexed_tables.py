"""Prepared tables of the per-index rANS kernels (`csrc/rans_indexed.cu`).

They depend on the coding tables alone, so a caller builds them once with
`prepare_indexed_tables` (the runtimes do when they upload their Gaussian
tables, `update()`) and passes them to every launch:

  enc   (R, cols, 4) int32: per CDF entry (start, freq, m_lo, m_hi), an
        encoder's step in one 16-byte load. freq = cdf[v+1] - cdf[v] (0 in
        the last column), m = ceil(2^48 / freq) split in two u32 halves (0
        where freq <= 0): the reciprocal the encoder divides by. All three
        encoders read it (`rans_indexed_encode`, and since their redesign
        `rans_indexed_encode_aligned` and `rans_masked_encode_aligned`,
        which codes an entry of freq <= 0 with freq 1, m = 2^48).
  dec   int32, three sections, each padded to a multiple of 4 words so the
        kernel can stage it with 16-byte copies:
          ragged   row r's entries [0, min(cdf_len[r], cols)) from
                   row_start[r] on, E in all (27,256 for the 64 default
                   Gaussian rows of up to 3,133 entries: 109 KB);
          buckets  (R, 257) at `bucket_at`: buckets[r, b] = row_start[r] +
                   the largest v < len_r - 1 with cdf[r, v] <= 256 b. The
                   symbol of a slot in bucket b = slot >> 8 lies in
                   [buckets[r, b], buckets[r, b + 1]];
          base     (R,) at `base_at`: off[r] - row_start[r], so entry e of
                   row r decodes to symbol e + base[r].

The decoders (`rans_indexed_decode`, `rans_indexed_decode_aligned`,
`rans_masked_decode_front`) find a slot's entry with `bucket_lookup`: the
bucket's range, then a search inside it, which gives `cdf_bisect`'s index
for every slot of a row that is non-decreasing over [0, len - 1). The
search is a bisection bounded by the bucket's width: at most 9 probes
where 256 frequency-1 symbols share one bucket, none where a bucket holds
one symbol.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field

import torch

BUCKET_SHIFT = 8                            # bucket of a slot: slot >> 8
BUCKET_STRIDE = (1 << (16 - BUCKET_SHIFT)) + 1   # 257 bounds a row


@dataclass(frozen=True)
class IndexedTables:
    """The coding tables (int32, as the plain versions take them) and what
    the batch-1 kernels read instead (see the module doc)."""
    cdf: torch.Tensor
    cdf_len: torch.Tensor
    off: torch.Tensor
    enc: torch.Tensor
    dec: torch.Tensor
    row_start: torch.Tensor
    bucket_at: int
    base_at: int

    # per coding table ('cdf', 'cdf_len', 'off'): (weak reference, version)
    # of the other tensors found to hold its values
    _equal: dict = field(default_factory=dict, repr=False, compare=False)

    def holds(self, name: str, given: torch.Tensor) -> bool:
        """Whether `given` holds the values of the coding table `name`
        ('cdf', 'cdf_len' or 'off') these tables were prepared from: it is
        that tensor, or a tensor found equal before and not changed since
        (the same object at the same version), or it is equal now. Only
        the last compares values (a device sync on a card), once a
        tensor."""
        mine = getattr(self, name)
        if given is mine:
            return True
        seen = self._equal.setdefault(name, [])
        if any(ref() is given and version == given._version
               for ref, version in seen):
            return True
        if given.shape != mine.shape or given.device != mine.device \
                or not torch.equal(mine, given.to(mine.dtype)):
            return False
        seen[:] = [e for e in seen if e[0]() is not None]
        seen.append((weakref.ref(given), given._version))
        return True

    @property
    def rows(self) -> int:
        return self.cdf.shape[0]

    @property
    def cols(self) -> int:
        return self.cdf.shape[1]


def _pad4(t: torch.Tensor) -> torch.Tensor:
    """`t` (1-D) with at least one trailing zero, to a multiple of 4."""
    return torch.cat([t, t.new_zeros(4 - t.numel() % 4)])


def _u32(t: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as the int32 with the same bits."""
    return torch.where(t >= 1 << 31, t - (1 << 32), t).to(torch.int32)


def encode_entries(cdf: torch.Tensor) -> torch.Tensor:
    """`enc` (R, cols, 4) int32 of `cdf` (R, cols), on its device."""
    c = cdf.to(torch.int64)
    freq = torch.cat([c[:, 1:] - c[:, :-1], torch.zeros_like(c[:, :1])],
                     dim=1)
    m = torch.where(freq > 0, ((1 << 48) + freq - 1) // freq.clamp_min(1),
                    torch.zeros_like(freq))
    return torch.stack([c.to(torch.int32), _u32(freq & 0xFFFFFFFF),
                        _u32(m & 0xFFFFFFFF), _u32(m >> 32)],
                       dim=-1).contiguous()


def prepare_indexed_tables(cdf, cdf_len, off) -> IndexedTables:
    """Both kernels' tables from `cdf` (R, cols), `cdf_len` and `off` (R,),
    on the device of `cdf` (a tensor) or the CPU."""
    cdf = torch.as_tensor(cdf, dtype=torch.int32).contiguous()
    dev = cdf.device
    cdf_len, off = (torch.as_tensor(a, dtype=torch.int32, device=dev)
                    .contiguous() for a in (cdf_len, off))
    rows, cols = cdf.shape
    c = cdf.to(torch.int64)
    lens = cdf_len.to(torch.int64).clamp(0, cols)       # entries kept a row
    row_start = torch.cumsum(lens, 0) - lens
    col = torch.arange(cols, device=dev)
    ragged = c[col[None, :] < lens[:, None]]
    # the searched entries [0, len - 1); the rest above any threshold
    searched = torch.where(col[None, :] < (lens - 1)[:, None], c,
                           torch.full_like(c, 1 << 40))
    thresholds = (torch.arange(BUCKET_STRIDE, device=dev) << BUCKET_SHIFT) \
        .expand(rows, BUCKET_STRIDE).contiguous()
    below = torch.searchsorted(searched, thresholds, right=True)
    buckets = row_start[:, None] + (below - 1).clamp_min(0)
    sections = [_pad4(ragged), _pad4(buckets.reshape(-1)),
                _pad4(off.to(torch.int64) - row_start)]
    bucket_at = sections[0].numel()
    base_at = bucket_at + sections[1].numel()
    return IndexedTables(cdf=cdf, cdf_len=cdf_len, off=off,
                         enc=encode_entries(cdf),
                         dec=torch.cat(sections).to(torch.int32),
                         row_start=row_start.to(torch.int32),
                         bucket_at=bucket_at, base_at=base_at)


def bucket_lookup(t: IndexedTables, rows: torch.Tensor, slot: torch.Tensor):
    """The decoders' search, as the kernels run it, for rows `rows` and
    slots `slot` (any matching shapes): (v with cdf[row, v] <= slot <
    cdf[row, v + 1], int64; the probes each took)."""
    dec = t.dec.to(torch.int64)
    r = rows.to(torch.int64)
    s = slot.to(torch.int64)
    b = t.bucket_at + r * BUCKET_STRIDE + (s >> BUCKET_SHIFT)
    lo, hi = dec[b], dec[b + 1] + 1
    probes = torch.zeros_like(lo)
    while True:
        live = hi - lo > 1
        if not bool(live.any()):
            break
        mid = (lo + hi) // 2
        right = dec[torch.where(live, mid, 0)] <= s
        lo = torch.where(live & right, mid, lo)
        hi = torch.where(live & ~right, mid, hi)
        probes += live.to(torch.int64)
    return lo - t.row_start.to(torch.int64)[r], probes


def reciprocal_quotient(x: torch.Tensor, enc_entry: torch.Tensor):
    """floor(x / freq) as the encoder computes it from an `enc` entry's
    m = m_hi * 2^32 + m_lo: (umulhi(x, m_lo) + x * m_hi) >> 16, in int64
    (each term below 2^32 for the states the encoder divides). umulhi is
    taken in 16-bit halves of m_lo, so no int64 product overflows."""
    m_lo = enc_entry[..., 2].to(torch.int64) & 0xFFFFFFFF
    m_hi = enc_entry[..., 3].to(torch.int64) & 0xFFFFFFFF
    x = x.to(torch.int64)
    umulhi = (x * (m_lo >> 16) + ((x * (m_lo & 0xFFFF)) >> 16)) >> 16
    return (umulhi + x * m_hi) >> 16
