// Byte-aligned rANS range coder with escape/bypass coding.
//
// The port's copy of the host coder of sc2bench_tpu/ops/rans/rans.cpp
// (single-stream encode/decode with indexes, the streaming decoder, and the
// cyclic int16 wire with its coarse-table decoder), the entropy-coding stage
// the reference gets from CompressAI's C++ rANS. Runs on the host: the
// bitstream is serial and CPU-bound; symbols/indexes arrive as int32 arrays
// computed on the GPU. Built with g++ and bound with ctypes
// (sc2bench_tpu_torch/ops/rans/coder.py). The runtime uses it for the
// host wire of stream_deploy (cyclic int16) and for the escape path of the
// device wire: images whose latent leaves the CDF support are re-coded here.
//
// Design: 32-bit rANS state, 8-bit renormalization, 16-bit probability
// precision. Out-of-range symbols escape to the final CDF slot and the
// overflow magnitude is bypass-coded in 4-bit chunks (count first, unary in
// base-15, then LSB-first chunks). Encoding walks the op list in reverse so
// the decoder reads forward.
//
// The interleaved multi-lane coder (rans_encode_interleaved) is the
// reference's layout, its lanes on std::thread workers.
//
// One change from the reference: the escape magnitude is held in 64 bits.
// The reference counts its chunks with a u32 shift, which reaches a shift by
// 32 (undefined; on x86 it never ends) once the magnitude needs 8 chunks,
// |value| >= 2^27; and -2 * value - 1 overflows int32 at INT_MIN. In 64 bits
// every int32 symbol codes, with the bytes of the Python reference, which are
// the reference's wherever it terminates.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t kRansL = 1u << 23;   // lower bound of the state interval
constexpr int kPrecision = 16;          // probability bits
constexpr int kBypassBits = 4;
constexpr int32_t kMaxBypass = (1 << kBypassBits) - 1;

struct RansEncState {
    uint32_t x = kRansL;
    std::vector<uint8_t> buf;  // filled back-to-front conceptually; we push and reverse

    inline void put(uint32_t start, uint32_t freq) {
        uint32_t x_max = ((kRansL >> kPrecision) << 8) * freq;
        while (x >= x_max) {
            buf.push_back(static_cast<uint8_t>(x & 0xff));
            x >>= 8;
        }
        x = ((x / freq) << kPrecision) + (x % freq) + start;
    }

    // Append `kBypassBits` raw bits (value in [0, kMaxBypass]) as a uniform
    // symbol: start = val << (precision - bits), freq = 1 << (precision - bits).
    inline void put_bypass(uint32_t val) {
        constexpr uint32_t freq = 1u << (kPrecision - kBypassBits);
        put(val << (kPrecision - kBypassBits), freq);
    }

    inline void flush() {
        for (int i = 0; i < 4; ++i) {
            buf.push_back(static_cast<uint8_t>(x & 0xff));
            x >>= 8;
        }
    }
};

struct RansDecState {
    uint32_t x = 0;
    const uint8_t* ptr;
    const uint8_t* end;

    inline void init(const uint8_t* bytes, int n) {
        // Stream is stored with the flush bytes first (encoder output is
        // reversed): read 4 state bytes big-to-small.
        ptr = bytes;
        end = bytes + n;
        x = 0;
        for (int i = 0; i < 4; ++i)
            x = (x << 8) | (ptr < end ? *ptr++ : 0);
    }

    inline uint32_t peek() const { return x & ((1u << kPrecision) - 1); }

    inline void advance(uint32_t start, uint32_t freq) {
        x = freq * (x >> kPrecision) + peek() - start;
        while (x < kRansL)
            x = (x << 8) | (ptr < end ? *ptr++ : 0);
    }

    inline uint32_t get_bypass() {
        uint32_t slot = peek();
        uint32_t val = slot >> (kPrecision - kBypassBits);
        constexpr uint32_t freq = 1u << (kPrecision - kBypassBits);
        advance(val << (kPrecision - kBypassBits), freq);
        return val;
    }
};

struct Op {
    uint32_t start;
    uint32_t freq;
};

}  // namespace

namespace {

inline void emit_symbol_ops(std::vector<Op>& ops, const int32_t* cdf,
                            int32_t max_value, int64_t value) {
    uint64_t raw_val = 0;
    bool escape = false;
    if (value < 0) {
        raw_val = static_cast<uint64_t>(-2 * value - 1);
        value = max_value;
        escape = true;
    } else if (value >= max_value) {
        raw_val = static_cast<uint64_t>(2 * (value - max_value));
        value = max_value;
        escape = true;
    }
    ops.push_back({static_cast<uint32_t>(cdf[value]),
                   static_cast<uint32_t>(cdf[value + 1] - cdf[value])});
    if (escape) {
        int32_t n_bypass = 0;
        while ((raw_val >> (n_bypass * kBypassBits)) != 0) ++n_bypass;
        int32_t val = n_bypass;
        while (val >= kMaxBypass) {
            ops.push_back({static_cast<uint32_t>(kMaxBypass)
                               << (kPrecision - kBypassBits),
                           1u << (kPrecision - kBypassBits)});
            val -= kMaxBypass;
        }
        ops.push_back({static_cast<uint32_t>(val)
                           << (kPrecision - kBypassBits),
                       1u << (kPrecision - kBypassBits)});
        for (int32_t j = 0; j < n_bypass; ++j) {
            const uint32_t chunk = static_cast<uint32_t>(
                (raw_val >> (j * kBypassBits)) & kMaxBypass);
            ops.push_back({chunk << (kPrecision - kBypassBits),
                           1u << (kPrecision - kBypassBits)});
        }
    }
}

inline int64_t read_symbol_escape(RansDecState& dec, int32_t max_value) {
    int32_t n_bypass = 0;
    uint32_t val;
    do {
        val = dec.get_bypass();
        n_bypass += static_cast<int32_t>(val);
    } while (val == static_cast<uint32_t>(kMaxBypass));
    // a valid stream has at most 9 chunks (raw_val < 2^34); more would
    // shift past 64 bits
    uint64_t raw_val = 0;
    for (int32_t j = 0; j < n_bypass; ++j) {
        const uint64_t chunk = dec.get_bypass();
        if (j < 16) raw_val |= chunk << (j * kBypassBits);
    }
    return (raw_val & 1) ? -static_cast<int64_t>((raw_val + 1) >> 1)
                         : static_cast<int64_t>(raw_val >> 1) + max_value;
}

// One symbol of row idx from `dec`: the largest s with cdf[s] <= slot by
// bisection, then the escape of the last slot; the offset re-applied.
inline int32_t decode_symbol(RansDecState& dec, int32_t idx,
                             const int32_t* cdfs, int cdf_stride,
                             const int32_t* cdf_lengths,
                             const int32_t* offsets) {
    const int32_t* cdf = cdfs + static_cast<int64_t>(idx) * cdf_stride;
    const int32_t cdf_len = cdf_lengths[idx];
    const int32_t max_value = cdf_len - 2;
    const uint32_t slot = dec.peek();
    int lo = 0, hi = cdf_len - 1;
    while (hi - lo > 1) {
        int mid = (lo + hi) >> 1;
        if (static_cast<uint32_t>(cdf[mid]) <= slot) lo = mid;
        else hi = mid;
    }
    const int s = lo;
    dec.advance(static_cast<uint32_t>(cdf[s]),
                static_cast<uint32_t>(cdf[s + 1] - cdf[s]));
    const int64_t value = (s == max_value)
        ? read_symbol_escape(dec, max_value) : s;
    return static_cast<int32_t>(value + offsets[idx]);
}

// n symbols from `dec`, symbol i with row indexes[i].
inline int rans_decode_with_state(RansDecState& dec, const int32_t* indexes,
                                  int n, const int32_t* cdfs, int cdf_stride,
                                  const int32_t* cdf_lengths,
                                  const int32_t* offsets, int32_t* out) {
    for (int i = 0; i < n; ++i)
        out[i] = decode_symbol(dec, indexes[i], cdfs, cdf_stride,
                               cdf_lengths, offsets);
    return 0;
}

// Run fn(lane) for every lane on up to `threads` threads, each taking a
// contiguous block of lanes; every lane's work is independent of the
// others', so the result does not depend on the thread count.
template <typename Fn>
inline void for_each_lane(int num_lanes, int threads, Fn fn) {
    threads = std::max(1, std::min(threads, num_lanes));
    if (threads == 1) {
        for (int lane = 0; lane < num_lanes; ++lane) fn(lane);
        return;
    }
    std::vector<std::thread> pool;
    pool.reserve(threads);
    for (int t = 0; t < threads; ++t) {
        const int lo = static_cast<int>(
            static_cast<int64_t>(num_lanes) * t / threads);
        const int hi = static_cast<int>(
            static_cast<int64_t>(num_lanes) * (t + 1) / threads);
        pool.emplace_back([lo, hi, &fn] {
            for (int lane = lo; lane < hi; ++lane) fn(lane);
        });
    }
    for (auto& th : pool) th.join();
}

}  // namespace


extern "C" {

// Encode n symbols. cdfs is row-major (num_dists, cdf_stride); row i holds
// cdf_lengths[i] int32 entries, cdf[0]=0 .. cdf[len-1]=65536. Returns number
// of bytes written to `out`, or -1 if out_capacity is insufficient.
int rans_encode_with_indexes(const int32_t* symbols, const int32_t* indexes,
                             int n, const int32_t* cdfs, int cdf_stride,
                             const int32_t* cdf_lengths, const int32_t* offsets,
                             uint8_t* out, int out_capacity) {
    std::vector<Op> ops;
    ops.reserve(static_cast<size_t>(n) + 16);
    for (int i = 0; i < n; ++i) {
        const int32_t idx = indexes[i];
        const int32_t* cdf = cdfs + static_cast<int64_t>(idx) * cdf_stride;
        const int32_t cdf_len = cdf_lengths[idx];
        emit_symbol_ops(ops, cdf, cdf_len - 2,
                        static_cast<int64_t>(symbols[i]) - offsets[idx]);
    }

    RansEncState enc;
    enc.buf.reserve(static_cast<size_t>(n) * 2 + 8);
    for (auto it = ops.rbegin(); it != ops.rend(); ++it)
        enc.put(it->start, it->freq);
    enc.flush();

    const int total = static_cast<int>(enc.buf.size());
    if (total > out_capacity) return -1;
    // Reverse: decoder reads flush bytes first, then ops forward.
    for (int i = 0; i < total; ++i)
        out[i] = enc.buf[total - 1 - i];
    return total;
}

// Decode n symbols from `bytes`. Writes int32 values (offset re-applied).
int rans_decode_with_indexes(const uint8_t* bytes, int n_bytes,
                             const int32_t* indexes, int n,
                             const int32_t* cdfs, int cdf_stride,
                             const int32_t* cdf_lengths, const int32_t* offsets,
                             int32_t* out) {
    RansDecState dec;
    dec.init(bytes, n_bytes);
    return rans_decode_with_state(dec, indexes, n, cdfs, cdf_stride,
                                  cdf_lengths, offsets, out);
}

// Cyclic int16 wire: symbols in the device's NHWC-flat (channels-last)
// order, symbol i coded with distribution i % num_dists, so the host builds
// no index array, transposes nothing and never widens to int32. Same
// bitstream format as rans_encode_with_indexes; only the symbol order
// differs from the channel-major coding of the host codec.
int rans_encode_cyclic_i16(const int16_t* symbols, int n, int num_dists,
                           const int32_t* cdfs, int cdf_stride,
                           const int32_t* cdf_lengths, const int32_t* offsets,
                           uint8_t* out, int out_capacity) {
    std::vector<Op> ops;
    ops.reserve(static_cast<size_t>(n) + 16);
    int idx = 0;
    for (int i = 0; i < n; ++i) {
        const int32_t* cdf = cdfs + static_cast<int64_t>(idx) * cdf_stride;
        emit_symbol_ops(ops, cdf, cdf_lengths[idx] - 2,
                        static_cast<int64_t>(symbols[i]) - offsets[idx]);
        if (++idx == num_dists) idx = 0;
    }
    RansEncState enc;
    enc.buf.reserve(static_cast<size_t>(n) * 2 + 8);
    for (auto it = ops.rbegin(); it != ops.rend(); ++it)
        enc.put(it->start, it->freq);
    enc.flush();
    const int total = static_cast<int>(enc.buf.size());
    if (total > out_capacity) return -1;
    for (int i = 0; i < total; ++i)
        out[i] = enc.buf[total - 1 - i];
    return total;
}

// int16 indexed wire (the hyperprior's y-stream): int16 symbols and int16
// per-element distribution indexes, in the device's NHWC-flat order; same
// bitstream format as rans_encode_with_indexes.
int rans_encode_with_indexes_i16(const int16_t* symbols,
                                 const int16_t* indexes, int n,
                                 const int32_t* cdfs, int cdf_stride,
                                 const int32_t* cdf_lengths,
                                 const int32_t* offsets, uint8_t* out,
                                 int out_capacity) {
    std::vector<Op> ops;
    ops.reserve(static_cast<size_t>(n) + 16);
    for (int i = 0; i < n; ++i) {
        const int32_t idx = indexes[i];
        const int32_t* cdf = cdfs + static_cast<int64_t>(idx) * cdf_stride;
        emit_symbol_ops(ops, cdf, cdf_lengths[idx] - 2,
                        static_cast<int64_t>(symbols[i]) - offsets[idx]);
    }
    RansEncState enc;
    enc.buf.reserve(static_cast<size_t>(n) * 2 + 8);
    for (auto it = ops.rbegin(); it != ops.rend(); ++it)
        enc.put(it->start, it->freq);
    enc.flush();
    const int total = static_cast<int>(enc.buf.size());
    if (total > out_capacity) return -1;
    for (int i = 0; i < total; ++i)
        out[i] = enc.buf[total - 1 - i];
    return total;
}

}  // extern "C"

namespace {

// Decode with a 256-entry coarse table per distribution (slot >> 8 -> the
// first symbol whose interval can hold the slot) and a short forward scan
// over the CDF row: every row stays in L1 whatever the index order.
template <typename IndexFn, typename OutT>
inline int coarse_decode_core(const uint8_t* bytes, int n_bytes, int n,
                              const int32_t* cdfs, int cdf_stride,
                              const int32_t* cdf_lengths,
                              const int32_t* offsets, const int16_t* coarse,
                              int coarse_stride, OutT* out, IndexFn idx_of) {
    RansDecState dec;
    dec.init(bytes, n_bytes);
    for (int i = 0; i < n; ++i) {
        const int32_t idx = idx_of(i);
        const int32_t* cdf = cdfs + static_cast<int64_t>(idx) * cdf_stride;
        const int32_t max_value = cdf_lengths[idx] - 2;
        const uint32_t slot = dec.peek();
        int s = coarse[static_cast<int64_t>(idx) * coarse_stride
                       + (slot >> 8)];
        while (static_cast<uint32_t>(cdf[s + 1]) <= slot) ++s;
        dec.advance(static_cast<uint32_t>(cdf[s]),
                    static_cast<uint32_t>(cdf[s + 1] - cdf[s]));
        const int64_t value = (s == max_value)
            ? read_symbol_escape(dec, max_value) : s;
        out[i] = static_cast<OutT>(value + offsets[idx]);
    }
    return 0;
}

}  // namespace

extern "C" {

// Inverse of rans_encode_cyclic_i16: n int16 symbols, distribution
// i % num_dists, through the coarse table (num_dists rows of coarse_stride).
int rans_decode_cyclic_i16_coarse(const uint8_t* bytes, int n_bytes, int n,
                                  int num_dists, const int32_t* cdfs,
                                  int cdf_stride,
                                  const int32_t* cdf_lengths,
                                  const int32_t* offsets,
                                  const int16_t* coarse, int coarse_stride,
                                  int16_t* out) {
    return coarse_decode_core(
        bytes, n_bytes, n, cdfs, cdf_stride, cdf_lengths, offsets, coarse,
        coarse_stride, out,
        [num_dists](int i) { return static_cast<int32_t>(i % num_dists); });
}

// Inverse of rans_encode_with_indexes_i16: n int16 symbols, distribution
// indexes[i], through the coarse table.
int rans_decode_with_indexes_i16_coarse(const uint8_t* bytes, int n_bytes,
                                        const int16_t* indexes, int n,
                                        const int32_t* cdfs, int cdf_stride,
                                        const int32_t* cdf_lengths,
                                        const int32_t* offsets,
                                        const int16_t* coarse,
                                        int coarse_stride, int16_t* out) {
    return coarse_decode_core(
        bytes, n_bytes, n, cdfs, cdf_stride, cdf_lengths, offsets, coarse,
        coarse_stride, out,
        [indexes](int i) { return static_cast<int32_t>(indexes[i]); });
}

}  // extern "C"

// Streaming decode: the state (x, byte position) persists across calls, so a
// consumer whose indexes depend on symbols it has already decoded (the
// joint autoregressive codec's context model) decodes one chunk a wavefront
// in one call. state = int64[2] {x, pos}. Same format and symbol search as
// rans_decode_with_indexes.

extern "C" {

void rans_stream_init(const uint8_t* bytes, int n_bytes, int64_t* state) {
    RansDecState dec;
    dec.init(bytes, n_bytes);
    state[0] = static_cast<int64_t>(dec.x);
    state[1] = static_cast<int64_t>(dec.ptr - bytes);
}

int rans_stream_decode(const uint8_t* bytes, int n_bytes, int64_t* state,
                       const int32_t* indexes, int n, const int32_t* cdfs,
                       int cdf_stride, const int32_t* cdf_lengths,
                       const int32_t* offsets, int32_t* out) {
    RansDecState dec;
    dec.x = static_cast<uint32_t>(state[0]);
    dec.ptr = bytes + state[1];
    dec.end = bytes + n_bytes;
    const int rc = rans_decode_with_state(dec, indexes, n, cdfs, cdf_stride,
                                          cdf_lengths, offsets, out);
    state[0] = static_cast<int64_t>(dec.x);
    state[1] = static_cast<int64_t>(dec.ptr - bytes);
    return rc;
}

}  // extern "C"

// Interleaved multi-lane coding (the layout of the reference's
// rans_encode_interleaved): lane j codes symbols j, j+L, j+2L, ... with its
// own state and buffer, in the single-stream format (escapes included).
// Stream: int32 lane count L, L int32 lane byte sizes, then the lanes'
// payloads one after another. Lanes run on up to `threads` threads; the
// bytes do not depend on the thread count.

extern "C" {

// Returns the bytes written, or -1 if out_capacity is too small.
int rans_encode_interleaved(const int32_t* symbols, const int32_t* indexes,
                            int n, int num_lanes, const int32_t* cdfs,
                            int cdf_stride, const int32_t* cdf_lengths,
                            const int32_t* offsets, uint8_t* out,
                            int out_capacity, int threads) {
    if (num_lanes < 1) num_lanes = 1;
    std::vector<std::vector<uint8_t>> lanes(num_lanes);
    for_each_lane(num_lanes, threads, [&](int lane) {
        std::vector<Op> ops;
        ops.reserve(n / num_lanes + 8);
        for (int i = lane; i < n; i += num_lanes) {
            const int32_t idx = indexes[i];
            const int32_t* cdf = cdfs + static_cast<int64_t>(idx) * cdf_stride;
            emit_symbol_ops(ops, cdf, cdf_lengths[idx] - 2,
                            static_cast<int64_t>(symbols[i]) - offsets[idx]);
        }
        RansEncState enc;
        enc.buf.reserve(ops.size() * 2 + 8);
        for (auto it = ops.rbegin(); it != ops.rend(); ++it)
            enc.put(it->start, it->freq);
        enc.flush();
        lanes[lane].assign(enc.buf.rbegin(), enc.buf.rend());
    });
    int64_t total = 4 + 4 * static_cast<int64_t>(num_lanes);
    for (const auto& lane : lanes) total += static_cast<int64_t>(lane.size());
    if (total > out_capacity) return -1;
    uint8_t* p = out;
    std::memcpy(p, &num_lanes, 4);
    p += 4;
    for (const auto& lane : lanes) {
        const int32_t size = static_cast<int32_t>(lane.size());
        std::memcpy(p, &size, 4);
        p += 4;
    }
    for (const auto& lane : lanes) {
        std::memcpy(p, lane.data(), lane.size());
        p += lane.size();
    }
    return static_cast<int>(total);
}

// Returns 0, or -1 for a corrupt header: fewer than 4 bytes, a lane count
// below 1, a negative lane size, or sizes running past the end.
int rans_decode_interleaved(const uint8_t* bytes, int n_bytes,
                            const int32_t* indexes, int n,
                            const int32_t* cdfs, int cdf_stride,
                            const int32_t* cdf_lengths,
                            const int32_t* offsets, int32_t* out,
                            int threads) {
    if (n_bytes < 4) return -1;
    int32_t num_lanes = 0;
    std::memcpy(&num_lanes, bytes, 4);
    if (num_lanes < 1 || 4 + 4 * static_cast<int64_t>(num_lanes) > n_bytes)
        return -1;
    std::vector<int32_t> sizes(num_lanes);
    std::vector<int64_t> starts(num_lanes);
    int64_t pos = 4 + 4 * static_cast<int64_t>(num_lanes);
    for (int lane = 0; lane < num_lanes; ++lane) {
        std::memcpy(&sizes[lane], bytes + 4 + 4 * static_cast<int64_t>(lane),
                    4);
        if (sizes[lane] < 0) return -1;
        starts[lane] = pos;
        pos += sizes[lane];
    }
    if (pos > n_bytes) return -1;
    for_each_lane(num_lanes, threads, [&](int lane) {
        RansDecState dec;
        dec.init(bytes + starts[lane], sizes[lane]);
        for (int i = lane; i < n; i += num_lanes)
            out[i] = decode_symbol(dec, indexes[i], cdfs, cdf_stride,
                                   cdf_lengths, offsets);
    });
    return 0;
}

}  // extern "C"
