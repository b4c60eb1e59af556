// Cyclic-lane rANS encode/decode kernels for Hopper (sm_90a).
//
// Four kernels, one thread per (image, lane). They replace the Pallas TPU
// kernels of sc2bench_tpu/ops/rans/pallas_kernel.py:
//
//   rans_cyclic_encode          <- _encode_kernel          (batch-1 encode,
//                                  compacted streams)
//   rans_cyclic_decode          <- _decode_kernel          (batch-1 decode)
//   rans_cyclic_encode_aligned  <- _encode_kernel_aligned  (wire_batch encode,
//                                  time-aligned streams)
//   rans_cyclic_decode_aligned  <- _decode_kernel_aligned  (wire_batch decode)
//
// Format: 32-bit state, 16-bit probability precision, 16-bit
// renormalisation, so each step emits or consumes exactly 0 or 1 u16. Lane j
// codes positions j, j+N, j+2N, ... of the flat symbol array against one
// fixed CDF row (channel j mod C, expanded per lane by the caller).
//
// What bounds them on this card: each lane is a serial chain of T dependent
// steps (T = 190 at the flagship 55x55x24 latent over 384 lanes), and the
// whole problem is k*N threads -- 384 at batch 1, a few warps on a few of
// the 132 SMs. The bytes moved (~0.3 MB at batch 1) and the integer
// operations are far below the card's rates, so the time is the latency of
// the chain: per step an L1 load of the CDF entries, an integer divide (or
// a short search), and a dependent state update. The design keeps the state
// in a register, reads each lane's row from L1 (the rows of all lanes fit),
// reads the step's symbols coalesced across lanes, and uses CUDA's exact
// 32-bit divide in place of the TPU's f32 quotient with its +-2 correction.
// The TPU kernels' one-hot "gather-free" reads and their 128-lane inert
// padding are gone: a thread per lane with a bounds guard replaces them.
// Batching k images gives the card more independent chains (wire_batch).
//
// Layouts (all row-major, int32 unless stated):
//   cdf_lane (N, cols); len_lane, off_lane (N,)
//   vc       (k, T, N)  in-support symbol values, forward order
//   streams  (k, N, W)  per-lane u16 chunks held in int32
//   states   (k, N)     int64 holding the u32 state
//   out      (k, T, N)  decoded symbols, lane offset added
//   masks    (k, N, T)  uint8 (torch.bool), aligned encode only, optional
//
// Each C entry point launches on the given stream and returns
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kRansL = 1u << 16;
constexpr int kThreads = 128;

template <bool kAligned>
__global__ void __launch_bounds__(kThreads)
rans_encode_kernel(const int32_t* __restrict__ cdf_lane, int cols,
                   const int32_t* __restrict__ vc, int num_images, int steps,
                   int lanes, int32_t* __restrict__ streams,
                   int32_t* __restrict__ lengths, int64_t* __restrict__ states,
                   uint8_t* __restrict__ masks) {
  const int64_t gid = static_cast<int64_t>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (gid >= static_cast<int64_t>(num_images) * lanes) return;
  const int img = static_cast<int>(gid / lanes);
  const int lane = static_cast<int>(gid % lanes);
  const int32_t* row = cdf_lane + static_cast<int64_t>(lane) * cols;
  const int32_t* v_img = vc + static_cast<int64_t>(img) * steps * lanes;
  int32_t* out = streams + gid * steps;
  uint8_t* mrow = masks ? masks + gid * steps : nullptr;

  uint32_t x = kRansL;
  int count = 0;
  // rANS encodes in reverse symbol order
  for (int t = steps - 1; t >= 0; --t) {
    const int v = v_img[static_cast<int64_t>(t) * lanes + lane];
    const uint32_t st = static_cast<uint32_t>(row[v]);
    const uint32_t fr = static_cast<uint32_t>(row[v + 1]) - st;
    // uint32 arithmetic throughout, wrapping exactly as the reference's
    const bool renorm = x >= (fr << 16);
    const uint32_t chunk = x & 0xFFFFu;
    if (renorm) x >>= 16;
    x = ((x / fr) << 16) + (x % fr) + st;
    if (kAligned) {
      out[t] = renorm ? static_cast<int32_t>(chunk) : 0;
      if (mrow) mrow[t] = renorm ? 1 : 0;
    } else if (renorm) {
      // emission e goes to column steps-1-e: once the loop ends, the
      // chunks sit at [steps-count, steps) already in decode order
      out[steps - 1 - count] = static_cast<int32_t>(chunk);
    }
    count += renorm ? 1 : 0;
  }
  if (!kAligned) {
    // compact to the front (source index >= destination, so a forward
    // copy is safe) and zero the rest of the row
    const int base = steps - count;
    for (int i = 0; i < count; ++i) out[i] = out[base + i];
    for (int i = count; i < steps; ++i) out[i] = 0;
  }
  lengths[gid] = count;
  states[gid] = static_cast<int64_t>(x);
}

template <bool kAligned>
__global__ void __launch_bounds__(kThreads)
rans_decode_kernel(const int32_t* __restrict__ streams, int width,
                   const int64_t* __restrict__ states,
                   const int32_t* __restrict__ cdf_lane, int cols,
                   const int32_t* __restrict__ len_lane,
                   const int32_t* __restrict__ off_lane, int num_images,
                   int steps, int lanes, int32_t* __restrict__ out,
                   int64_t* __restrict__ xend) {
  const int64_t gid = static_cast<int64_t>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (gid >= static_cast<int64_t>(num_images) * lanes) return;
  const int img = static_cast<int>(gid / lanes);
  const int lane = static_cast<int>(gid % lanes);
  const int32_t* row = cdf_lane + static_cast<int64_t>(lane) * cols;
  const int len = min(len_lane[lane], cols);
  const int off = off_lane[lane];
  const int32_t* s = streams + gid * width;
  int32_t* o = out + static_cast<int64_t>(img) * steps * lanes + lane;

  uint32_t x = static_cast<uint32_t>(states[gid]);
  int ptr = 0;
  for (int t = 0; t < steps; ++t) {
    const int32_t slot = static_cast<int32_t>(x & 0xFFFFu);
    // v = (number of entries below cdf_length with cdf[i] <= slot) - 1,
    // the largest such index for a monotone row; row[0] == 0 <= slot and
    // row[len-1] == 2^16 > slot keep v in [0, len-2]
    int cnt = 0;
    for (int i = 0; i < len; ++i) cnt += row[i] <= slot ? 1 : 0;
    const int v = max(cnt - 1, 0);
    const uint32_t st = static_cast<uint32_t>(row[v]);
    const uint32_t fr = static_cast<uint32_t>(row[v + 1]) - st;
    x = fr * (x >> 16) + static_cast<uint32_t>(slot) - st;
    if (x < kRansL) {
      uint32_t chunk;
      if (kAligned) {
        chunk = static_cast<uint32_t>(s[t]);
      } else {
        // a read past the lane's row yields 0, as the reference's one-hot
        chunk = ptr < width ? static_cast<uint32_t>(s[ptr]) : 0u;
        ++ptr;
      }
      x = (x << 16) | chunk;
    }
    o[static_cast<int64_t>(t) * lanes] = v + off;
  }
  xend[gid] = static_cast<int64_t>(x);
}

inline unsigned blocks_for(int num_images, int lanes) {
  const int64_t n = static_cast<int64_t>(num_images) * lanes;
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int rans_cyclic_encode(const int32_t* cdf_lane, int cols, const int32_t* vc,
                       int num_images, int steps, int lanes, int32_t* streams,
                       int32_t* lengths, int64_t* states,
                       cudaStream_t stream) {
  rans_encode_kernel<false><<<blocks_for(num_images, lanes), kThreads, 0,
                              stream>>>(cdf_lane, cols, vc, num_images, steps,
                                        lanes, streams, lengths, states,
                                        nullptr);
  return static_cast<int>(cudaGetLastError());
}

int rans_cyclic_encode_aligned(const int32_t* cdf_lane, int cols,
                               const int32_t* vc, int num_images, int steps,
                               int lanes, int32_t* streams, int32_t* lengths,
                               int64_t* states, uint8_t* masks,
                               cudaStream_t stream) {
  rans_encode_kernel<true><<<blocks_for(num_images, lanes), kThreads, 0,
                             stream>>>(cdf_lane, cols, vc, num_images, steps,
                                       lanes, streams, lengths, states,
                                       masks);
  return static_cast<int>(cudaGetLastError());
}

int rans_cyclic_decode(const int32_t* streams, int width,
                       const int64_t* states, const int32_t* cdf_lane,
                       int cols, const int32_t* len_lane,
                       const int32_t* off_lane, int num_images, int steps,
                       int lanes, int32_t* out, int64_t* xend,
                       cudaStream_t stream) {
  rans_decode_kernel<false><<<blocks_for(num_images, lanes), kThreads, 0,
                              stream>>>(streams, width, states, cdf_lane,
                                        cols, len_lane, off_lane, num_images,
                                        steps, lanes, out, xend);
  return static_cast<int>(cudaGetLastError());
}

int rans_cyclic_decode_aligned(const int32_t* streams, int width,
                               const int64_t* states, const int32_t* cdf_lane,
                               int cols, const int32_t* len_lane,
                               const int32_t* off_lane, int num_images,
                               int steps, int lanes, int32_t* out,
                               int64_t* xend, cudaStream_t stream) {
  rans_decode_kernel<true><<<blocks_for(num_images, lanes), kThreads, 0,
                             stream>>>(streams, width, states, cdf_lane, cols,
                                       len_lane, off_lane, num_images, steps,
                                       lanes, out, xend);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
