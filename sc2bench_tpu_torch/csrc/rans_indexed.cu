// General per-index rANS encode/decode kernels for Hopper (sm_90a).
//
// Six kernels. The JAX package runs these codecs as XLA scans, with no
// Pallas kernel; four replace the scans of sc2bench_tpu/ops/rans/device.py,
// two those of the joint autoregressive codec's device wire
// (sc2bench_tpu/models/zoo_jahp_device.py, after the first four's notes):
//
//   rans_indexed_encode          <- device_rans_encode's `step` scan + its
//                                   `_finish_encode` compaction (batch 1,
//                                   compacted streams)
//   rans_indexed_decode          <- device_rans_decode's `step` scan with
//                                   `cdf_bisect` (compacted streams, a
//                                   per-lane read pointer)
//   rans_indexed_encode_aligned  <- the same encode scan with aligned=True
//                                   (wire_batch, time-aligned streams)
//   rans_indexed_decode_aligned  <- the aligned decode scan (`step_a`)
//
// Format: the cyclic kernels' (rans_cyclic.cu): 32-bit state, 16-bit
// precision, 16-bit renormalisation, so each step emits or consumes exactly
// 0 or 1 u16. Lane j codes positions j, j+N, j+2N, ... of the flat symbol
// array, but each symbol uses its own CDF row, idx[p]: for the hyperprior's
// y-stream the row of its Gaussian scale, one of 64 rows of up to 3,133
// entries (802 KB as int32).
//
// Design (simple and right): one thread per (image, lane), 32 threads a
// block so that a batch-1 image's 512 lanes spread over 16 SMs; symbols
// and indexes are read lane-major, so a warp's loads of one step are one
// coalesced line; the table is read from device memory, where all of it
// stays in L2 (and hot rows in L1). The encoder reads the two entries
// cdf[idx, v] and cdf[idx, v+1], which do not depend on the state, and
// divides exactly with the hardware 32-bit divide; its compacted form
// writes emission e at column T-1-e of the lane's row and, when the lane is
// done, moves the row's tail to its front (decode order) and zeroes the
// rest. The decoder finds v by bisection of row idx over [0, len-1): about
// 12 dependent probes at 3,133 entries. Nothing is staged in shared memory,
// so the kernels take any step count T and any row width.
//
// What bounds them on this card: as for the cyclic pair, each lane is a
// serial chain of T dependent steps and a batch-1 image has only 512
// lanes, so the time is the chain's latency; the decoder's step is the
// longer one, its bisection a chain of dependent L1/L2 loads.
//
// The next design, not built here: the table packed ragged (27,256
// entries, 109 KB) fits a block's shared memory, and a coarse bucket per
// row (slot >> 8 -> lowest candidate symbol, as the cyclic decoders keep)
// would replace most of the bisection's probes with one shared load and a
// short forward scan.
//
// The kernels hold the plain versions' contract bit for bit on valid
// tables: CDF rows non-decreasing from 0 to 2^16 within cdf_length, every
// coded symbol of frequency >= 1, indexes in [0, rows), stream values in
// 0..65535. A read past a lane's stream row yields 0, and the final states
// say whether each lane returned to 2^16.
//
// Layouts (all row-major, int32 unless stated):
//   cdf      (R, cols); cdf_len, off (R,)
//   vc, idx  (k, T, N)  in-support symbol values and their rows, forward
//   streams  (k, N, W)  per-lane u16 chunks held in int32
//   states   (k, N)     int64 holding the u32 state
//   out      (k, T, N)  decoded symbols, row offset added
//   masks    (k, N, T)  uint8 (torch.bool), aligned encode only, optional
//
// The masked pair (zoo_jahp_device.py's device wire, format
// "jahp-lane-v1"):
//
//   rans_masked_encode_aligned  <- the scan of `_rans_encode_step` (:122,
//                                  driven at :258): the T fronts in reverse,
//                                  aligned (N, T) chunks, lengths, states
//   rans_masked_decode_front    <- `_rans_decode_step` (:142), one launch a
//                                  front from the decode loop (:331)
//
// Lane (slot, channel) = slot * m + channel of N = F * m lanes codes at most
// one symbol a front, against row idx of the Gaussian tables, and only where
// that front's activity bit act[t, slot] is set; elsewhere the lane is inert
// (no table read, no renormalisation, no state change, chunk 0), so encoder
// and decoder renormalise at the same steps and the decoder reads column t.
// One thread a lane, the table read from device memory (in L2) as above;
// the decoder's bisection is the indexed decoder's `cdf_bisect`. The
// indexed aligned encoder cannot stand in for the masked one with an
// "identity" row: a row of frequency 2^16 would leave the state as it is,
// but 2^16 << 16 wraps to 0 in 32 bits, so every such step would
// renormalise. The context model between decode fronts stays torch ops.
//
// Layouts: vc, idx (T, N) int32 forward order; act (T, F) uint8; streams
// (N, T) int32; lengths (N,) int32; states (N,) int64. The decoder takes
// front t's idx (N,) and act (F,), states in, and writes the symbols (N,)
// (row offset added, 0 on inactive lanes) and the states out.
//
// Each C entry point launches on the given stream and returns
// cudaGetLastError(), or cudaErrorInvalidValue (without launching) when
// aligned streams are not T columns wide, or the masked lanes are not F * m
// (a front index outside [0, T)).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kRansL = 1u << 16;
constexpr int kThreads = 32;      // (image, lane) pairs per block

inline unsigned blocks_for(int num_images, int lanes) {
  const int64_t total = static_cast<int64_t>(num_images) * lanes;
  return static_cast<unsigned>((total + kThreads - 1) / kThreads);
}

// Largest v < len - 1 with row[v] <= slot, by bisection over [0, len - 1):
// row[0] = 0 <= slot < 2^16 = row[len - 1] holds for any state.
__device__ __forceinline__ int cdf_bisect(const int32_t* __restrict__ row,
                                          int len, uint32_t slot) {
  int lo = 0, hi = len - 1;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (static_cast<uint32_t>(row[mid]) <= slot) lo = mid;
    else hi = mid;
  }
  return lo;
}

template <bool kAligned>
__global__ void __launch_bounds__(kThreads)
rans_indexed_encode_kernel(const int32_t* __restrict__ cdf, int cols,
                           const int32_t* __restrict__ vc,
                           const int32_t* __restrict__ idx, int num_images,
                           int steps, int lanes,
                           int32_t* __restrict__ streams,
                           int32_t* __restrict__ lengths,
                           int64_t* __restrict__ states,
                           uint8_t* __restrict__ masks) {
  const int64_t gid =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (gid >= static_cast<int64_t>(num_images) * lanes) return;
  const int64_t img = gid / lanes;
  const int lane = static_cast<int>(gid % lanes);
  const int64_t base = img * steps * lanes + lane;   // (img, t=0, lane)
  int32_t* row = streams + gid * steps;
  uint8_t* mrow = masks != nullptr ? masks + gid * steps : nullptr;
  uint32_t x = kRansL;
  int count = 0;
  for (int t = steps - 1; t >= 0; --t) {
    const int64_t p = base + static_cast<int64_t>(t) * lanes;
    const int32_t* e = cdf + static_cast<int64_t>(idx[p]) * cols + vc[p];
    const uint32_t st = static_cast<uint32_t>(e[0]);
    const uint32_t fr = static_cast<uint32_t>(e[1]) - st;
    // uint32 arithmetic throughout, wrapping exactly as the plain version
    const bool renorm = x >= (fr << 16);
    if (kAligned) {
      row[t] = renorm ? static_cast<int32_t>(x & 0xFFFFu) : 0;
      if (mrow != nullptr) mrow[t] = renorm ? 1 : 0;
    } else if (renorm) {
      row[steps - 1 - count] = static_cast<int32_t>(x & 0xFFFFu);
    }
    if (renorm) {
      ++count;
      x >>= 16;
    }
    x = ((x / fr) << 16) + (x % fr) + st;
  }
  if (!kAligned) {
    // the chunks sit at [T - count, T) in decode order: move them to the
    // front (each source lies at or after its destination) and zero the rest
    const int shift = steps - count;
    for (int c = 0; c < count; ++c) row[c] = row[shift + c];
    for (int c = count; c < steps; ++c) row[c] = 0;
  }
  lengths[gid] = count;
  states[gid] = static_cast<int64_t>(x);
}

template <bool kAligned>
__global__ void __launch_bounds__(kThreads)
rans_indexed_decode_kernel(const int32_t* __restrict__ streams, int width,
                           const int64_t* __restrict__ states,
                           const int32_t* __restrict__ cdf, int cols,
                           const int32_t* __restrict__ cdf_len,
                           const int32_t* __restrict__ off,
                           const int32_t* __restrict__ idx, int num_images,
                           int steps, int lanes, int32_t* __restrict__ out,
                           int64_t* __restrict__ xend) {
  const int64_t gid =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (gid >= static_cast<int64_t>(num_images) * lanes) return;
  const int64_t img = gid / lanes;
  const int lane = static_cast<int>(gid % lanes);
  const int64_t base = img * steps * lanes + lane;
  const int32_t* srow = streams + gid * width;
  uint32_t x = static_cast<uint32_t>(states[gid]);
  int ptr = 0;
  for (int t = 0; t < steps; ++t) {
    const int64_t p = base + static_cast<int64_t>(t) * lanes;
    const int32_t r = idx[p];
    const int32_t* crow = cdf + static_cast<int64_t>(r) * cols;
    const uint32_t slot = x & 0xFFFFu;
    const int lo = cdf_bisect(crow, min(cdf_len[r], cols), slot);
    const uint32_t st = static_cast<uint32_t>(crow[lo]);
    const uint32_t fr = static_cast<uint32_t>(crow[lo + 1]) - st;
    x = fr * (x >> 16) + slot - st;
    if (x < kRansL) {
      uint32_t chunk;
      if (kAligned) {
        chunk = static_cast<uint32_t>(srow[t]);
      } else {
        chunk = ptr < width ? static_cast<uint32_t>(srow[ptr]) : 0u;
        ++ptr;
      }
      x = (x << 16) | chunk;
    }
    out[p] = lo + off[r];
  }
  xend[gid] = static_cast<int64_t>(x);
}

// Masked lanes of the joint autoregressive codec's device wire: lane
// (slot, channel) = slot * m + channel, N = F * m lanes, T fronts; the lane
// codes at most one symbol a front, and only where act[t, slot] is set.
// An inactive lane is inert at that step: no table read, no
// renormalisation, no state change, chunk 0.

__global__ void __launch_bounds__(kThreads)
rans_masked_encode_aligned_kernel(const int32_t* __restrict__ cdf, int cols,
                                  const int32_t* __restrict__ vc,
                                  const int32_t* __restrict__ idx,
                                  const uint8_t* __restrict__ act, int steps,
                                  int lanes, int slots, int m,
                                  int32_t* __restrict__ streams,
                                  int32_t* __restrict__ lengths,
                                  int64_t* __restrict__ states) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const int slot = lane / m;
  int32_t* row = streams + static_cast<int64_t>(lane) * steps;
  uint32_t x = kRansL;
  int count = 0;
  for (int t = steps - 1; t >= 0; --t) {
    if (act[static_cast<int64_t>(t) * slots + slot] == 0) {
      row[t] = 0;
      continue;
    }
    const int64_t p = static_cast<int64_t>(t) * lanes + lane;
    const int32_t* e = cdf + static_cast<int64_t>(idx[p]) * cols + vc[p];
    const uint32_t st = static_cast<uint32_t>(e[0]);
    const uint32_t fr = max(static_cast<uint32_t>(e[1]) - st, 1u);
    // uint32 arithmetic throughout, wrapping exactly as the plain version
    const bool renorm = x >= (fr << 16);
    row[t] = renorm ? static_cast<int32_t>(x & 0xFFFFu) : 0;
    if (renorm) {
      ++count;
      x >>= 16;
    }
    x = ((x / fr) << 16) + (x % fr) + st;
  }
  lengths[lane] = count;
  states[lane] = static_cast<int64_t>(x);
}

__global__ void __launch_bounds__(kThreads)
rans_masked_decode_front_kernel(const int32_t* __restrict__ streams,
                                int steps, int t,
                                const int64_t* __restrict__ x_in,
                                const int32_t* __restrict__ cdf, int cols,
                                const int32_t* __restrict__ cdf_len,
                                const int32_t* __restrict__ off,
                                const int32_t* __restrict__ idx,
                                const uint8_t* __restrict__ act, int lanes,
                                int m, int32_t* __restrict__ out,
                                int64_t* __restrict__ x_out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  uint32_t x = static_cast<uint32_t>(x_in[lane]);
  if (act[lane / m] == 0) {
    out[lane] = 0;
    x_out[lane] = static_cast<int64_t>(x);
    return;
  }
  const int32_t r = idx[lane];
  const int32_t* crow = cdf + static_cast<int64_t>(r) * cols;
  const uint32_t slot = x & 0xFFFFu;
  const int v = cdf_bisect(crow, min(cdf_len[r], cols), slot);
  const uint32_t st = static_cast<uint32_t>(crow[v]);
  const uint32_t fr = max(static_cast<uint32_t>(crow[v + 1]) - st, 1u);
  x = fr * (x >> 16) + slot - st;
  if (x < kRansL)
    x = (x << 16) | static_cast<uint32_t>(
        streams[static_cast<int64_t>(lane) * steps + t]);
  out[lane] = v + off[r];
  x_out[lane] = static_cast<int64_t>(x);
}

}  // namespace

extern "C" {

int rans_indexed_encode(const int32_t* cdf, int cols, const int32_t* vc,
                        const int32_t* idx, int num_images, int steps,
                        int lanes, int32_t* streams, int32_t* lengths,
                        int64_t* states, cudaStream_t stream) {
  rans_indexed_encode_kernel<false>
      <<<blocks_for(num_images, lanes), kThreads, 0, stream>>>(
          cdf, cols, vc, idx, num_images, steps, lanes, streams, lengths,
          states, nullptr);
  return static_cast<int>(cudaGetLastError());
}

int rans_indexed_encode_aligned(const int32_t* cdf, int cols,
                                const int32_t* vc, const int32_t* idx,
                                int num_images, int steps, int lanes,
                                int32_t* streams, int32_t* lengths,
                                int64_t* states, uint8_t* masks,
                                cudaStream_t stream) {
  rans_indexed_encode_kernel<true>
      <<<blocks_for(num_images, lanes), kThreads, 0, stream>>>(
          cdf, cols, vc, idx, num_images, steps, lanes, streams, lengths,
          states, masks);
  return static_cast<int>(cudaGetLastError());
}

int rans_indexed_decode(const int32_t* streams, int width,
                        const int64_t* states, const int32_t* cdf, int cols,
                        const int32_t* cdf_len, const int32_t* off,
                        const int32_t* idx, int num_images, int steps,
                        int lanes, int32_t* out, int64_t* xend,
                        cudaStream_t stream) {
  rans_indexed_decode_kernel<false>
      <<<blocks_for(num_images, lanes), kThreads, 0, stream>>>(
          streams, width, states, cdf, cols, cdf_len, off, idx, num_images,
          steps, lanes, out, xend);
  return static_cast<int>(cudaGetLastError());
}

int rans_indexed_decode_aligned(const int32_t* streams, int width,
                                const int64_t* states, const int32_t* cdf,
                                int cols, const int32_t* cdf_len,
                                const int32_t* off, const int32_t* idx,
                                int num_images, int steps, int lanes,
                                int32_t* out, int64_t* xend,
                                cudaStream_t stream) {
  if (width != steps) return static_cast<int>(cudaErrorInvalidValue);
  rans_indexed_decode_kernel<true>
      <<<blocks_for(num_images, lanes), kThreads, 0, stream>>>(
          streams, width, states, cdf, cols, cdf_len, off, idx, num_images,
          steps, lanes, out, xend);
  return static_cast<int>(cudaGetLastError());
}

int rans_masked_encode_aligned(const int32_t* cdf, int cols,
                               const int32_t* vc, const int32_t* idx,
                               const uint8_t* act, int steps, int lanes,
                               int slots, int m, int32_t* streams,
                               int32_t* lengths, int64_t* states,
                               cudaStream_t stream) {
  if (m <= 0 || lanes != slots * m)
    return static_cast<int>(cudaErrorInvalidValue);
  rans_masked_encode_aligned_kernel
      <<<blocks_for(1, lanes), kThreads, 0, stream>>>(
          cdf, cols, vc, idx, act, steps, lanes, slots, m, streams, lengths,
          states);
  return static_cast<int>(cudaGetLastError());
}

int rans_masked_decode_front(const int32_t* streams, int steps, int t,
                             const int64_t* x_in, const int32_t* cdf,
                             int cols, const int32_t* cdf_len,
                             const int32_t* off, const int32_t* idx,
                             const uint8_t* act, int lanes, int m,
                             int32_t* out, int64_t* x_out,
                             cudaStream_t stream) {
  if (m <= 0 || lanes % m != 0 || t < 0 || t >= steps)
    return static_cast<int>(cudaErrorInvalidValue);
  rans_masked_decode_front_kernel
      <<<blocks_for(1, lanes), kThreads, 0, stream>>>(
          streams, steps, t, x_in, cdf, cols, cdf_len, off, idx, act, lanes,
          m, out, x_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
