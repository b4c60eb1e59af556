// Cyclic-lane rANS encode/decode kernels for Hopper (sm_90a).
//
// Four kernels. They replace the Pallas TPU kernels of
// sc2bench_tpu/ops/rans/pallas_kernel.py:
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
// whole problem is k*N lanes -- 384 at batch 1. The bytes moved (~0.3 MB at
// batch 1) and the integer operations are far below the card's rates, so the
// time is the latency of the chain: T times the dependent cycles of one step,
// plus the launch.
//
// The batch-1 pair (rans_cyclic_encode, rans_cyclic_decode) is built for
// that latency:
//   - one warp per block, each block 32 lanes of one image, so that the 384
//     lanes of a batch-1 image spread over 12 SMs and each chain has an SM
//     sub-partition nearly to itself;
//   - the block's inputs (the encoder's symbol columns vc[img, :, lane0:+32],
//     the decoder's stream rows streams[img, lane0:+32, :]) are staged into
//     shared memory by cp.async in tiles of kTile steps or columns,
//     double-buffered, so the next tile is in flight while the chain runs;
//   - each lane's CDF row becomes a shared-memory table of (start, freq)
//     per symbol, laid out [symbol][lane] so a warp's lookups never share a
//     bank; the decoder adds a coarse table of 256 buckets (slot >> 8 ->
//     lowest candidate symbol) and finishes with a short forward scan, in
//     place of a scan over the whole row;
//   - the encoder's emitted chunks go to a per-lane u16 row in shared memory
//     (emission e at column T-1-e, so a finished lane's chunks sit at
//     [T-count, T) in decode order); after the chain the warp writes the
//     block's 32 x T output region (compacted rows, zero tails) with
//     coalesced stores;
//   - the encoder divides by a per-(lane, symbol) reciprocal, one 64-bit
//     multiply and a shift (`reciprocal48`), which measured faster than
//     the hardware 32-bit divide on an H100 (PERF.md).
// Then the dependent chain touches only shared memory and registers. The
// shared memory a block needs grows with T (encoder) or min(W, T) (decoder);
// rans_cyclic_max_steps gives the largest that fits when the lane tables are
// in global memory (below).
//
// Measured on an H100 (bench_rans_kernels.py, 384 lanes, T = 32..600): a
// decode step costs about 285 SM cycles and an encode step about 120, plus
// 8-10 us per launch (prologue, write-out, launch gap). With one warp
// per SM sub-partition nothing hides the chain: each step is ~20 dependent
// instructions (SASS), and ptxas rebuilds the shared addresses from S2R and
// constant loads inside the loop. A coarse table holding whole entries (one
// dependent load a step instead of two) measured no faster, because that
// address path, not the load, is the longer chain.
//
// The wire_batch pair (rans_cyclic_encode_aligned, rans_cyclic_decode_aligned)
// codes k images at once, and step t's chunk sits at stream column t, so no
// lane needs a pointer or a compaction. It is built for both regimes of k:
// at k = 8 (3,072 lanes) it is latency-bound like the batch-1 pair; at
// k = 128 (49,152 lanes, ~75 MB in and out) the bytes start to count.
//   - a block holds the same 32 lanes for G images, one warp per image. The lane tables depend on the
//     lane only, so the G warps build one set together, each taking a share
//     of the symbol values (and of the decoder's 256 coarse buckets), then
//     one barrier; a block's prologue, the encoder's reciprocals above all,
//     costs 1/G of the batch-1 pair's per image. Warps beyond the last
//     image help build the tables, then leave. G follows a rule measured
//     on an H100 (aligned_group): 4 to encode, 4 or 8 to decode;
//   - each warp stages its own image's inputs tile by tile with cp.async,
//     double-buffered: the encoder's symbol columns vc[img, t, lane0:+32]
//     in reverse, the decoder's stream rows streams[img, lane0:+32, c:c+32]
//     (row pitch kTile+1, so that a lane's column reads never share a
//     bank). Shared memory does not grow with T, so any T is taken;
//   - the encoder writes each step's chunk into a per-warp ring of 64
//     columns (u16, the renorm bits kept a word per tile) and, when a tile
//     is done, stores from each of its 32 rows the 32 columns that start at
//     the row's first 32-byte sector boundary at or after the tile: whole
//     sectors, coalesced. Rows are T int32 apart (760 bytes at T = 190), so
//     tile-aligned stores would cut a sector at both ends of every row
//     segment; a variant that did so was slower at k = 128 and no faster at
//     k = 8. The decoder's symbol store out[img, t, lane0:+32] is whole
//     128-byte lines as it is;
//   - the encoder divides by reciprocal48, as the batch-1 encoder does.
//
// Wide CDF rows. The lane tables grow with the CDF width (16 bytes an entry
// to encode, 8 to decode, per lane). When a launch's shared-memory plan
// with the tables does not fit a block, the same kernels run with the
// tables in global memory (template parameter kGlobalTables): a first
// kernel, build_lane_tables_kernel, writes them into a buffer the caller
// passes ([lane chunk][symbol][32 lanes], the shared layout for every
// chunk), and the coding kernel reads them through L1. Only the staging
// (and the decoder's fixed coarse table) then stays in shared memory, so
// the aligned pair takes rows of any width and the batch-1 pair's step
// limit no longer depends on the width. rans_cyclic_table_bytes tells the
// caller which plan a launch takes and how large a buffer it needs. Narrow
// rows (the flagship's 23 columns) keep the shared tables and their code.
//
// Measured on an H100 (bench_rans_kernels.py, flagship shape): 0.0186 ms
// (encode) and 0.0374 ms (decode) at k = 8, against 0.0403 and 0.1190 for
// the first design (one thread per (image, lane), CDF rows through L1, the
// hardware divide, a linear CDF scan); 0.0428 and 0.0539 ms at k = 128,
// about twice the bytes bound, against 0.202 and 0.229. At k <= 32 the
// time is one warp's chain, as for the batch-1 pair; from k = 64 each more
// image costs about 0.28 us (encode) and 0.23 us (decode), where the
// stores and the reads of the staged tiles compete with the chains.
//
// Both pairs hold the plain versions' contract bit for bit on valid
// tables: CDF rows non-decreasing from 0 to 2^16 within cdf_length, every
// coded symbol of frequency >= 1, stream values in 0..65535. A read past a
// lane's stream row yields 0, and the final states say whether each lane
// returned to 2^16.
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
// cudaGetLastError(), or cudaErrorInvalidValue (without launching) when the
// shapes need more shared memory than a block can have, or when aligned
// streams are not T columns wide. Its `tables` argument is null for the
// shared-memory plan, else a device buffer of rans_cyclic_table_bytes bytes
// for the global-table plan.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kRansL = 1u << 16;
constexpr int kWarp = 32;       // lanes per block (batch 1: threads)
constexpr int kTile = 32;       // steps / stream columns per staged tile
constexpr int kBuckets = 256;   // coarse decode table: slot >> 8
// aligned kernels: images (warps) per block, as aligned_group picks them
constexpr int kEncodeGroup = 4;
constexpr int kMaxDecodeGroup = 8;
constexpr int kRing = 2 * kTile;        // aligned encoder: output ring columns
constexpr int kRingPitch = kRing + 2;   // its row pitch in u16 (33 words)
// aligned encoder, per warp: two symbol tiles, the output ring, its bits
constexpr int kEncodeWarpWords =
    2 * kTile * kWarp + kWarp * kRingPitch / 2 + 2 * kWarp;

// ---- asynchronous global -> shared copies --------------------------------

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one group (the newest) is still in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// the block's `n` contiguous CDF entries into shared memory, coalesced; the
// copies join the next committed group
__device__ __forceinline__ void stage_rows(int32_t* dst, const int32_t* src,
                                           int n, int l) {
  for (int e = l; e < n; e += kWarp) cp_async4(dst + e, src + e);
}

// ---- exact division by a reciprocal ----------------------------------------
//
// reciprocal48(fr) = m = ceil(2^48 / fr) for fr in [1, 2^16], and then
// floor(x / fr) == (x * m) >> 48 for every state the encoder divides,
// x < fr * 2^16 (after renormalisation x < fr << 16, or x < 2^16 when
// fr << 16 wraps to 0 at fr = 2^16). Proof: let d = m*fr - 2^48, so
// 0 <= d < fr. Then x*m / 2^48 = x/fr + x*d / (fr * 2^48), and
// x*d < fr*2^16 * fr <= 2^48, so the second term is below 1/fr. With
// x = q*fr + r, r <= fr - 1: q <= x*m / 2^48 < q + (r + 1)/fr <= q + 1, so
// the floor is q. The product fits 64 bits: x*m <= (fr*2^16 - 1)(2^48 + d)/fr
// = 2^64 + 2^16*d - (2^48 + d)/fr, and 2^16*d*fr < 2^16 * 2^32 = 2^48, so
// x*m < 2^64.
// m is computed exactly: __ddiv_ru gives the least double >= 2^48/fr, and
// the integer ceil(2^48/fr) < 2^53 is itself a double >= 2^48/fr, so the
// rounded quotient lies between 2^48/fr and that integer and its ceil is it.
__device__ __forceinline__ uint64_t reciprocal48(uint32_t fr) {
  return static_cast<uint64_t>(
      ceil(__ddiv_ru(281474976710656.0, static_cast<double>(fr))));
}

// ---- shared-memory plans (bytes) -------------------------------------------

// Each plan takes `cols`, the CDF entries a lane's tables hold in shared
// memory: the row width, or 0 when the tables are in global memory.
//
// encoder: (start, freq, m_lo, m_hi) per [symbol][lane], two symbol tiles,
// the block's raw CDF rows, the lanes' counts, then the u16 output rows of
// pitch T+1
inline size_t encode_smem(int cols, int steps) {
  return sizeof(uint4) * cols * kWarp + sizeof(int32_t) * 2 * kTile * kWarp
         + sizeof(int32_t) * cols * kWarp + sizeof(int32_t) * kWarp
         + sizeof(uint16_t) * kWarp * (static_cast<size_t>(steps) + 1);
}

// decoder: (start, freq) per [symbol][lane], the coarse table, two stream
// tiles, the block's raw CDF rows, then the u16 stream rows of pitch
// min(W, T)+1
inline size_t decode_smem(int cols, int width, int steps) {
  const int wc = width < steps ? width : steps;
  return sizeof(uint2) * cols * kWarp + sizeof(uint16_t) * kBuckets * kWarp
         + sizeof(int32_t) * 2 * kTile * kWarp
         + sizeof(int32_t) * cols * kWarp
         + sizeof(uint16_t) * kWarp * (static_cast<size_t>(wc) + 1);
}

// aligned encoder: (start, freq, m_lo, m_hi) per [symbol][lane], then per
// warp two symbol tiles [kTile][32] int32, an output ring [32][kRingPitch]
// u16 and its renorm bits [32][2] u32
inline size_t encode_aligned_smem(int cols, int group) {
  return sizeof(uint4) * cols * kWarp
         + sizeof(int32_t) * group * kEncodeWarpWords;
}

// aligned decoder: (start, freq) per [symbol][lane], the coarse table, then
// per warp two stream tiles [32][kTile+1]
inline size_t decode_aligned_smem(int cols, int group) {
  return sizeof(uint2) * cols * kWarp + sizeof(uint16_t) * kBuckets * kWarp
         + sizeof(int32_t) * group * 2 * kWarp * (kTile + 1);
}

inline int smem_optin() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  return bytes;
}

// ---- lane tables in global memory ------------------------------------------
//
// Entry v of lane chunk*32 + l at tables[(chunk * cols + v) * 32 + l]: the
// encoder's (start, freq, m_lo, m_hi), the decoder's (start, freq), with
// freq = cdf[v+1] - cdf[v] (0 for the last entry), as the kernels build
// them in shared memory. Lanes past the last are zero.

__device__ __forceinline__ void put_entry(uint4* e, uint32_t st, uint32_t fr) {
  const uint64_t m = fr ? reciprocal48(fr) : 0;
  *e = make_uint4(st, fr, static_cast<uint32_t>(m),
                  static_cast<uint32_t>(m >> 32));
}

__device__ __forceinline__ void put_entry(uint2* e, uint32_t st, uint32_t fr) {
  *e = make_uint2(st, fr);
}

template <typename Entry>
__global__ void build_lane_tables_kernel(const int32_t* __restrict__ cdf_lane,
                                         int cols, int lanes,
                                         Entry* __restrict__ tables) {
  const int64_t total =
      static_cast<int64_t>((lanes + kWarp - 1) / kWarp) * cols * kWarp;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int l = static_cast<int>(i % kWarp);
    const int64_t cv = i / kWarp;
    const int v = static_cast<int>(cv % cols);
    const int lane = static_cast<int>(cv / cols) * kWarp + l;
    uint32_t st = 0, fr = 0;
    if (lane < lanes) {
      const int32_t* row = cdf_lane + static_cast<int64_t>(lane) * cols;
      st = static_cast<uint32_t>(row[v]);
      fr = v + 1 < cols ? static_cast<uint32_t>(row[v + 1]) - st : 0u;
    }
    put_entry(tables + i, st, fr);
  }
}

template <typename Entry>
void build_lane_tables(const int32_t* cdf_lane, int cols, int lanes,
                       Entry* tables, cudaStream_t stream) {
  const int64_t total =
      static_cast<int64_t>((lanes + kWarp - 1) / kWarp) * cols * kWarp;
  const int64_t want = (total + 255) / 256;
  const unsigned blocks = static_cast<unsigned>(want < 1024 ? want : 1024);
  build_lane_tables_kernel<Entry><<<blocks, 256, 0, stream>>>(
      cdf_lane, cols, lanes, tables);
}

// ---- batch-1 encode --------------------------------------------------------

template <bool kGlobalTables>
__global__ void __launch_bounds__(kWarp)
rans_encode_warp_kernel(const int32_t* __restrict__ cdf_lane, int cols,
                        const int32_t* __restrict__ vc, int steps, int lanes,
                        int32_t* __restrict__ streams,
                        int32_t* __restrict__ lengths,
                        int64_t* __restrict__ states,
                        const uint4* __restrict__ gtab) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int scols = kGlobalTables ? 0 : cols;   // table entries held here
  const int chunks = (lanes + kWarp - 1) / kWarp;
  const int img = blockIdx.x / chunks;
  const int lane0 = (blockIdx.x % chunks) * kWarp;
  const int l = threadIdx.x;
  const int lane = lane0 + l;
  const bool active = lane < lanes;
  const int nrow = min(kWarp, lanes - lane0);
  const int pitch = steps + 1;
  uint4* stab = reinterpret_cast<uint4*>(smem);               // [cols][32]
  int32_t* vtile = reinterpret_cast<int32_t*>(stab + scols * kWarp);
  int32_t* raw = vtile + 2 * kTile * kWarp;                    // [32][cols]
  int32_t* counts = raw + scols * kWarp;                       // [32]
  uint16_t* obuf = reinterpret_cast<uint16_t*>(counts + kWarp);
  const uint4* tab = stab;
  if (kGlobalTables)
    tab = gtab + static_cast<int64_t>(blockIdx.x % chunks) * cols * kWarp;
  const int32_t* v_img = vc + static_cast<int64_t>(img) * steps * lanes;
  const int ntiles = (steps + kTile - 1) / kTile;

  // stage tile s (steps [s*kTile, s*kTile+kTile)) of the block's symbol
  // columns into buffer s&1: per step, 32 lanes' int32 values, coalesced;
  // an empty group for s < 0 keeps the wait count uniform
  auto stage = [&](int s) {
    if (s >= 0 && active) {
      int32_t* dst = vtile + (s & 1) * kTile * kWarp;
      const int t0 = s * kTile, t1 = min(t0 + kTile, steps);
      for (int t = t0; t < t1; ++t)
        cp_async4(dst + (t - t0) * kWarp + l,
                  v_img + static_cast<int64_t>(t) * lanes + lane);
    }
    cp_async_commit();
  };
  // the block's CDF rows (contiguous) go with the first symbol tile; the
  // symbols are coded in reverse order, so the last tile comes first
  if (!kGlobalTables)
    stage_rows(raw, cdf_lane + static_cast<int64_t>(lane0) * cols,
               nrow * cols, l);
  stage(ntiles - 1);
  stage(ntiles - 2);
  cp_async_wait_one();
  __syncwarp();

  // lane tables: each thread expands its own lane's row (unrolled: the
  // reciprocals of neighbouring entries are independent)
  if (!kGlobalTables && active) {
    const int32_t* row = raw + l * cols;
#pragma unroll 4
    for (int v = 0; v < cols; ++v) {
      const uint32_t st = static_cast<uint32_t>(row[v]);
      const uint32_t fr =
          v + 1 < cols ? static_cast<uint32_t>(row[v + 1]) - st : 0u;
      const uint64_t m = fr ? reciprocal48(fr) : 0;
      stab[v * kWarp + l] = make_uint4(st, fr, static_cast<uint32_t>(m),
                                       static_cast<uint32_t>(m >> 32));
    }
  }
  __syncwarp();

  uint32_t x = kRansL;
  int count = 0;
  uint16_t* orow = obuf + l * pitch;
  for (int s = ntiles - 1; s >= 0; --s) {
    cp_async_wait_one();          // tile s has landed (s-1 may be in flight)
    __syncwarp();
    if (active) {
      const int32_t* vt = vtile + (s & 1) * kTile * kWarp;
      const int t0 = s * kTile, t1 = min(t0 + kTile, steps);
      // the symbols and table entries do not depend on the state: fetch
      // step t-1's entry and step t-2's symbol while step t runs
      int vn = t1 - 2 >= t0 ? vt[(t1 - 2 - t0) * kWarp + l] : 0;
      uint4 next = tab[vt[(t1 - 1 - t0) * kWarp + l] * kWarp + l];
      for (int t = t1 - 1; t >= t0; --t) {
        const uint4 e = next;
        if (t - 1 >= t0) next = tab[vn * kWarp + l];
        if (t - 2 >= t0) vn = vt[(t - 2 - t0) * kWarp + l];
        const uint32_t st = e.x, fr = e.y;
        // uint32 arithmetic throughout, wrapping exactly as the reference's
        const bool renorm = x >= (fr << 16);
        if (renorm) {
          // the count-th emission goes to column steps-1-count
          orow[steps - 1 - count] = static_cast<uint16_t>(x & 0xFFFFu);
          ++count;
          x >>= 16;
        }
        const uint64_t m = (static_cast<uint64_t>(e.w) << 32) | e.z;
        const uint32_t q =
            static_cast<uint32_t>((static_cast<uint64_t>(x) * m) >> 48);
        x = (q << 16) + (x - q * fr) + st;
      }
    }
    __syncwarp();                 // buffer s&1 is read; refill it
    stage(s - 2);
  }
  if (active) {
    counts[l] = count;
    const int64_t gid = static_cast<int64_t>(img) * lanes + lane;
    lengths[gid] = count;
    states[gid] = static_cast<int64_t>(x);
  }
  __syncwarp();

  // coalesced write-out of the block's rows: chunks at the front in decode
  // order, zeros after; four rows at a time so their shared loads overlap
  int32_t* out = streams + (static_cast<int64_t>(img) * lanes + lane0) * steps;
  for (int r0 = 0; r0 < nrow; r0 += 4) {
    int cnt[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) cnt[i] = r0 + i < nrow ? counts[r0 + i] : 0;
    for (int c = l; c < steps; c += kWarp) {
      int32_t val[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        val[i] = c < cnt[i] ? obuf[(r0 + i) * pitch + (steps - cnt[i]) + c]
                            : 0;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (r0 + i < nrow)
          out[static_cast<int64_t>(r0 + i) * steps + c] = val[i];
    }
  }
}

// ---- batch-1 decode --------------------------------------------------------

template <bool kGlobalTables>
__global__ void __launch_bounds__(kWarp)
rans_decode_warp_kernel(const int32_t* __restrict__ streams, int width,
                        const int64_t* __restrict__ states,
                        const int32_t* __restrict__ cdf_lane, int cols,
                        const int32_t* __restrict__ len_lane,
                        const int32_t* __restrict__ off_lane, int steps,
                        int lanes, int32_t* __restrict__ out,
                        int64_t* __restrict__ xend,
                        const uint2* __restrict__ gtab) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int scols = kGlobalTables ? 0 : cols;   // table entries held here
  const int chunks = (lanes + kWarp - 1) / kWarp;
  const int img = blockIdx.x / chunks;
  const int lane0 = (blockIdx.x % chunks) * kWarp;
  const int l = threadIdx.x;
  const int lane = lane0 + l;
  const bool active = lane < lanes;
  const int nrow = min(kWarp, lanes - lane0);
  // a lane reads at most one chunk per step, so column ptr <= t < steps:
  // only the first min(W, T) columns can ever be read
  const int wc = min(width, steps);
  const int pitch = wc + 1;
  uint2* stab = reinterpret_cast<uint2*>(smem);               // [cols][32]
  uint16_t* coarse = reinterpret_cast<uint16_t*>(stab + scols * kWarp);
  int32_t* stile = reinterpret_cast<int32_t*>(coarse + kBuckets * kWarp);
  int32_t* raw = stile + 2 * kWarp * kTile;                    // [32][cols]
  uint16_t* rowbuf = reinterpret_cast<uint16_t*>(raw + scols * kWarp);
  const uint2* tab = stab;
  if (kGlobalTables)
    tab = gtab + static_cast<int64_t>(blockIdx.x % chunks) * cols * kWarp;
  const int32_t* s_blk =
      streams + (static_cast<int64_t>(img) * lanes + lane0) * width;
  const int ncol = (wc + kTile - 1) / kTile;

  // stage stream columns [s*kTile, s*kTile+kTile) of the block's rows into
  // buffer s&1 (per row, 32 consecutive int32, coalesced)
  auto stage = [&](int s) {
    const int c = s * kTile + l;
    if (s < ncol && c < wc) {
      int32_t* dst = stile + (s & 1) * kWarp * kTile;
      for (int r = 0; r < nrow; ++r)
        cp_async4(dst + r * kTile + l,
                  s_blk + static_cast<int64_t>(r) * width + c);
    }
    cp_async_commit();
  };
  if (!kGlobalTables)
    stage_rows(raw, cdf_lane + static_cast<int64_t>(lane0) * cols,
               nrow * cols, l);
  stage(0);
  stage(1);
  uint32_t x = 0;
  int len = 0, off = 0;
  if (active) {
    x = static_cast<uint32_t>(states[static_cast<int64_t>(img) * lanes
                                     + lane]);
    len = min(len_lane[lane], cols);
    off = off_lane[lane];
  }
  cp_async_wait_one();           // the CDF rows and stream tile 0
  __syncwarp();

  if (active) {
    // lane table, and the coarse table: coarse[b] = largest v < len with
    // cdf[v] <= b << 8, i.e. the smallest v whose cdf[v+1] exceeds b << 8
    // (for a non-decreasing row); the symbol of any slot in bucket b is at
    // or after it
    int b = 0;
    if (!kGlobalTables) {
      const int32_t* row = raw + l * cols;
      for (int v = 0; v < cols; ++v) {
        const uint32_t st = static_cast<uint32_t>(row[v]);
        const uint32_t nx = v + 1 < cols ? static_cast<uint32_t>(row[v + 1])
                                         : st;
        stab[v * kWarp + l] = make_uint2(st, nx - st);
        if (v + 1 < len)
          for (; b < kBuckets && (static_cast<uint32_t>(b) << 8) < nx; ++b)
            coarse[b * kWarp + l] = static_cast<uint16_t>(v);
      }
    } else {
      // the table is built: cdf[v+1] = start + freq of entry v
      for (int v = 0; v + 1 < len && b < kBuckets; ++v) {
        const uint2 e = tab[v * kWarp + l];
        for (; b < kBuckets && (static_cast<uint32_t>(b) << 8) < e.x + e.y;
             ++b)
          coarse[b * kWarp + l] = static_cast<uint16_t>(v);
      }
    }
    for (; b < kBuckets; ++b) coarse[b * kWarp + l] = 0;
  }

  int32_t* o = out + static_cast<int64_t>(img) * steps * lanes + lane;
  const uint16_t* row = rowbuf + l * pitch;
  int ptr = 0;
  for (int s = 0; s * kTile < steps; ++s) {
    if (s < ncol) {
      // tile s has landed: narrow it into the u16 rows, then refill its
      // buffer with tile s+2
      cp_async_wait_one();
      __syncwarp();
      const int c = s * kTile + l;
      if (c < wc) {
        // eight rows at a time, loads before stores, so the loads overlap
        const int32_t* src = stile + (s & 1) * kWarp * kTile;
        for (int r0 = 0; r0 < nrow; r0 += 8) {
          int32_t val[8];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            val[i] = r0 + i < nrow ? src[(r0 + i) * kTile + l] : 0;
#pragma unroll
          for (int i = 0; i < 8; ++i)
            if (r0 + i < nrow)
              rowbuf[(r0 + i) * pitch + c] = static_cast<uint16_t>(val[i]);
        }
      }
      __syncwarp();
      stage(s + 2);
    }
    if (!active) continue;
    const int t1 = min(s * kTile + kTile, steps);
    for (int t = s * kTile; t < t1; ++t) {
      const uint32_t slot = x & 0xFFFFu;
      // the coarse bucket's first candidate, then a forward scan while
      // cdf[v+1] = start + freq <= slot: usually no step for narrow rows
      int v = coarse[(slot >> 8) * kWarp + l];
      uint2 e = tab[v * kWarp + l];
      while (v + 1 < len && e.x + e.y <= slot) e = tab[++v * kWarp + l];
      // the next chunk does not depend on x: load it off the chain; a read
      // past the lane's row yields 0, as the reference's one-hot
      const uint32_t chunk = ptr < wc ? row[ptr] : 0u;
      x = e.y * (x >> 16) + slot - e.x;
      if (x < kRansL) {
        x = (x << 16) | chunk;
        ++ptr;
      }
      o[static_cast<int64_t>(t) * lanes] = v + off;
    }
  }
  if (active)
    xend[static_cast<int64_t>(img) * lanes + lane] = static_cast<int64_t>(x);
}

// ---- wire_batch (aligned) kernels ------------------------------------------
//
// Grid (lane groups, image groups); block: `group` warps, warp w coding
// image blockIdx.y * group + w on lanes blockIdx.x * 32 + [0, 32).

template <bool kGlobalTables>
__global__ void __launch_bounds__(kEncodeGroup * kWarp)
rans_encode_aligned_kernel(const int32_t* __restrict__ cdf_lane, int cols,
                           const int32_t* __restrict__ vc, int num_images,
                           int steps, int lanes, int32_t* __restrict__ streams,
                           int32_t* __restrict__ lengths,
                           int64_t* __restrict__ states,
                           uint8_t* __restrict__ masks,
                           const uint4* __restrict__ gtab) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int scols = kGlobalTables ? 0 : cols;   // table entries held here
  const int group = blockDim.x / kWarp;
  const int w = threadIdx.x / kWarp;
  const int l = threadIdx.x % kWarp;
  const int lane0 = blockIdx.x * kWarp;
  const int lane = lane0 + l;
  const int img = blockIdx.y * group + w;
  const bool has_img = img < num_images;
  const bool active = has_img && lane < lanes;
  const int nrow = min(kWarp, lanes - lane0);
  uint4* stab = reinterpret_cast<uint4*>(smem);               // [cols][32]
  int32_t* vtile = reinterpret_cast<int32_t*>(stab + scols * kWarp)
                   + w * kEncodeWarpWords;                     // [2][kTile][32]
  const uint4* tab = stab;
  if (kGlobalTables)
    tab = gtab + static_cast<int64_t>(blockIdx.x) * cols * kWarp;
  uint16_t* ring = reinterpret_cast<uint16_t*>(vtile + 2 * kTile * kWarp);
  uint32_t* rbits = reinterpret_cast<uint32_t*>(ring + kWarp * kRingPitch);
  const int64_t row0 = static_cast<int64_t>(img) * lanes + lane0;
  const int32_t* v_img = vc + static_cast<int64_t>(img) * steps * lanes;
  const int ntiles = (steps + kTile - 1) / kTile;
  // the warp's output rows; row r's column 0 lies ph0 + r * phs int32
  // (mod 8) past a 32-byte sector boundary, so its first boundary at or
  // after a column t0 = 32s is column t0 + dcol[r & 7]
  int32_t* out_w = streams + row0 * steps;
  uint8_t* mask_w = masks ? masks + row0 * steps : nullptr;
  const int ph0 = static_cast<int>((row0 * steps) & 7);
  const int phs = steps & 7;
  int dcol[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) dcol[i] = (-(ph0 + i * phs)) & 7;

  // stage tile s of the warp's symbol columns into buffer s&1 (per step,
  // 32 lanes' int32 values, coalesced); an empty group for s < 0 keeps the
  // wait count uniform. Coded in reverse: the last tile comes first.
  auto stage = [&](int s) {
    if (s >= 0 && active) {
      int32_t* dst = vtile + (s & 1) * kTile * kWarp;
      const int t0 = s * kTile, t1 = min(t0 + kTile, steps);
      for (int t = t0; t < t1; ++t)
        cp_async4(dst + (t - t0) * kWarp + l,
                  v_img + static_cast<int64_t>(t) * lanes + lane);
    }
    cp_async_commit();
  };
  stage(ntiles - 1);
  stage(ntiles - 2);

  // the block's lane tables, while the first tiles land: warp w expands
  // symbol values w, w + group, ... of the 32 lanes' rows
  if (!kGlobalTables && lane < lanes) {
    const int32_t* row = cdf_lane + static_cast<int64_t>(lane) * cols;
#pragma unroll 4
    for (int v = w; v < cols; v += group) {
      const uint32_t st = static_cast<uint32_t>(__ldg(row + v));
      const uint32_t fr =
          v + 1 < cols ? static_cast<uint32_t>(__ldg(row + v + 1)) - st : 0u;
      const uint64_t m = fr ? reciprocal48(fr) : 0;
      stab[v * kWarp + l] = make_uint4(st, fr, static_cast<uint32_t>(m),
                                       static_cast<uint32_t>(m >> 32));
    }
  }
  __syncthreads();
  if (!has_img) return;

  uint32_t x = kRansL;
  int count = 0;
  uint16_t* orow = ring + l * kRingPitch;
  for (int s = ntiles - 1; s >= 0; --s) {
    const int t0 = s * kTile, t1 = min(t0 + kTile, steps);
    cp_async_wait_one();          // tile s has landed (s-1 may be in flight)
    __syncwarp();
    if (active) {
      uint32_t bits = 0;
      const int32_t* vt = vtile + (s & 1) * kTile * kWarp;
      // the symbols and table entries do not depend on the state: fetch
      // step t-1's entry and step t-2's symbol while step t runs
      int vn = t1 - 2 >= t0 ? vt[(t1 - 2 - t0) * kWarp + l] : 0;
      uint4 next = tab[vt[(t1 - 1 - t0) * kWarp + l] * kWarp + l];
      for (int t = t1 - 1; t >= t0; --t) {
        const uint4 e = next;
        if (t - 1 >= t0) next = tab[vn * kWarp + l];
        if (t - 2 >= t0) vn = vt[(t - 2 - t0) * kWarp + l];
        const uint32_t st = e.x, fr = e.y;
        // uint32 arithmetic throughout, wrapping exactly as the reference's
        const bool renorm = x >= (fr << 16);
        // column t of the ring: the chunk, 0 where none; bit t - t0: renorm
        orow[t & (kRing - 1)] = static_cast<uint16_t>(renorm ? x : 0u);
        bits |= static_cast<uint32_t>(renorm) << (t - t0);
        count += renorm;
        if (renorm) x >>= 16;
        const uint64_t m = (static_cast<uint64_t>(e.w) << 32) | e.z;
        const uint32_t q =
            static_cast<uint32_t>((static_cast<uint64_t>(x) * m) >> 48);
        x = (q << 16) + (x - q * fr) + st;
      }
      rbits[l * 2 + (s & 1)] = bits;
    }
    __syncwarp();                 // buffer s&1 is read, the ring written
    stage(s - 2);
    // coalesced write-out: columns >= t0 are final. Each of the warp's rows
    // stores the 32 columns from its first 32-byte sector boundary at or
    // after t0 (the columns above were stored after tile s+1), so no store
    // but a row's head writes part of a sector; eight rows' shared loads
    // go before their stores
    for (int r0 = 0; r0 < nrow; r0 += 8) {
      uint32_t val[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)         // row r0 + i < 32: in the ring
        val[i] = r0 + i < nrow
                     ? ring[(r0 + i) * kRingPitch
                            + ((t0 + dcol[i] + l) & (kRing - 1))]
                     : 0u;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = t0 + dcol[i] + l;
        if (r0 + i < nrow && col < steps)
          out_w[(r0 + i) * steps + col] = static_cast<int32_t>(val[i]);
      }
    }
    if (mask_w) {
      for (int r0 = 0; r0 < nrow; r0 += 8) {
        uint32_t bit[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          bit[i] = r0 + i < nrow
                       ? rbits[(r0 + i) * 2 + (((t0 + dcol[i] + l) >> 5) & 1)]
                       : 0u;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int col = t0 + dcol[i] + l;
          if (r0 + i < nrow && col < steps)
            mask_w[(r0 + i) * steps + col] = (bit[i] >> (col & 31)) & 1u;
        }
      }
    }
    if (s == 0) {
      // the rows' heads: the columns before their first sector boundary
      for (int r = 0; r < nrow; ++r) {
        if (l < ((-(ph0 + r * phs)) & 7) && l < steps) {
          out_w[r * steps + l] = ring[r * kRingPitch + l];
          if (mask_w) mask_w[r * steps + l] = (rbits[r * 2] >> l) & 1u;
        }
      }
    }
    __syncwarp();                 // the ring is free for tile s-1
  }
  if (active) {
    lengths[row0 + l] = count;
    states[row0 + l] = static_cast<int64_t>(x);
  }
}

template <bool kGlobalTables>
__global__ void __launch_bounds__(kMaxDecodeGroup * kWarp)
rans_decode_aligned_kernel(const int32_t* __restrict__ streams, int width,
                           const int64_t* __restrict__ states,
                           const int32_t* __restrict__ cdf_lane, int cols,
                           const int32_t* __restrict__ len_lane,
                           const int32_t* __restrict__ off_lane,
                           int num_images, int steps, int lanes,
                           int32_t* __restrict__ out,
                           int64_t* __restrict__ xend,
                           const uint2* __restrict__ gtab) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int scols = kGlobalTables ? 0 : cols;   // table entries held here
  const int group = blockDim.x / kWarp;
  const int w = threadIdx.x / kWarp;
  const int l = threadIdx.x % kWarp;
  const int lane0 = blockIdx.x * kWarp;
  const int lane = lane0 + l;
  const int img = blockIdx.y * group + w;
  const bool has_img = img < num_images;
  const bool active = has_img && lane < lanes;
  const int nrow = min(kWarp, lanes - lane0);
  // step t reads column t of a row T wide (width == steps)
  const int spitch = kTile + 1;
  uint2* stab = reinterpret_cast<uint2*>(smem);               // [cols][32]
  uint16_t* coarse = reinterpret_cast<uint16_t*>(stab + scols * kWarp);
  int32_t* stile = reinterpret_cast<int32_t*>(coarse + kBuckets * kWarp)
                   + w * 2 * kWarp * spitch;                   // [2][32][33]
  const uint2* tab = stab;
  if (kGlobalTables)
    tab = gtab + static_cast<int64_t>(blockIdx.x) * cols * kWarp;
  const int64_t row0 = static_cast<int64_t>(img) * lanes + lane0;
  const int32_t* s_blk = streams + row0 * width;
  const int ntiles = (steps + kTile - 1) / kTile;

  // stage stream columns [s*kTile, s*kTile+kTile) of the warp's rows into
  // buffer s&1 (per row, 32 consecutive int32, coalesced)
  auto stage = [&](int s) {
    const int c = s * kTile + l;
    if (has_img && s < ntiles && c < steps) {
      int32_t* dst = stile + (s & 1) * kWarp * spitch + l;
      for (int r = 0; r < nrow; ++r)
        cp_async4(dst + r * spitch,
                  s_blk + static_cast<int64_t>(r) * width + c);
    }
    cp_async_commit();
  };
  stage(0);
  stage(1);

  // the block's lane tables, while the first tiles land: warp w expands
  // symbol values w, w + group, ...; then fills its share of the coarse
  // table, coarse[b] = the smallest v < len-1 with cdf[v+1] > b << 8 (0
  // where none), the lowest candidate symbol of any slot in bucket b
  int len = 0;
  if (lane < lanes) {
    len = min(len_lane[lane], cols);
    const int32_t* row = cdf_lane + static_cast<int64_t>(lane) * cols;
#pragma unroll 4
    for (int v = w; !kGlobalTables && v < cols; v += group) {
      const uint32_t st = static_cast<uint32_t>(__ldg(row + v));
      const uint32_t nx =
          v + 1 < cols ? static_cast<uint32_t>(__ldg(row + v + 1)) : st;
      stab[v * kWarp + l] = make_uint2(st, nx - st);
    }
  }
  __syncthreads();
  if (lane < lanes) {
    const int share = kBuckets / group;
    const int b1 = (w + 1) * share;
    int b = w * share;
    for (int v = 0; v + 1 < len && b < b1; ++v) {
      const uint2 e = tab[v * kWarp + l];
      for (; b < b1 && (static_cast<uint32_t>(b) << 8) < e.x + e.y; ++b)
        coarse[b * kWarp + l] = static_cast<uint16_t>(v);
    }
    for (; b < b1; ++b) coarse[b * kWarp + l] = 0;
  }
  __syncthreads();
  if (!has_img) return;

  uint32_t x = 0;
  int off = 0;
  if (active) {
    x = static_cast<uint32_t>(states[row0 + l]);
    off = off_lane[lane];
  }
  int32_t* o = out + static_cast<int64_t>(img) * steps * lanes + lane;
  for (int s = 0; s < ntiles; ++s) {
    cp_async_wait_one();          // tile s has landed (s+1 may be in flight)
    __syncwarp();
    if (active) {
      const int t0 = s * kTile, t1 = min(t0 + kTile, steps);
      const int32_t* srow = stile + (s & 1) * kWarp * spitch + l * spitch
                            - t0;
      for (int t = t0; t < t1; ++t, o += lanes) {
        const uint32_t slot = x & 0xFFFFu;
        // the coarse bucket's first candidate, then a forward scan while
        // cdf[v+1] = start + freq <= slot: usually no step for narrow rows
        int v = coarse[(slot >> 8) * kWarp + l];
        uint2 e = tab[v * kWarp + l];
        while (v + 1 < len && e.x + e.y <= slot) e = tab[++v * kWarp + l];
        // the chunk does not depend on x: loaded off the chain
        const uint32_t chunk = static_cast<uint32_t>(srow[t]);
        x = e.y * (x >> 16) + slot - e.x;
        if (x < kRansL) x = (x << 16) | chunk;
        *o = v + off;
      }
    }
    __syncwarp();                 // buffer s&1 is read; refill it
    stage(s + 2);
  }
  if (active) xend[row0 + l] = static_cast<int64_t>(x);
}

// The rule for G, from device times on an H100 at the
// flagship shape (PERF.md): the encoder is fastest at G = 4 for every k;
// the decoder at G = 4 while a G = 4 grid has at most one block per SM
// (k <= 32 there), and at G = 8 beyond, where its per-block prologue (the
// coarse table) is shared by more images.
inline int aligned_group(int decode, int num_images, int lanes) {
  if (!decode) return kEncodeGroup;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t blocks = static_cast<int64_t>((num_images + 3) / 4)
                         * ((lanes + kWarp - 1) / kWarp);
  return blocks <= sms ? 4 : kMaxDecodeGroup;
}

inline dim3 aligned_grid(int num_images, int lanes, int group) {
  return dim3(static_cast<unsigned>((lanes + kWarp - 1) / kWarp),
              static_cast<unsigned>((num_images + group - 1) / group));
}

inline unsigned warp_blocks(int num_images, int lanes) {
  return static_cast<unsigned>(num_images)
         * static_cast<unsigned>((lanes + kWarp - 1) / kWarp);
}

// raise a kernel's dynamic shared-memory cap when `bytes` needs it;
// false when no block can have that much
template <typename Kernel>
bool fit_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return true;
  if (bytes > static_cast<size_t>(smem_optin())) return false;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes)) == cudaSuccess;
}


// the shared-memory plan of one launch of kernel `kernel` (0 encode,
// 1 decode, 2 aligned encode, 3 aligned decode) with `cols` table entries
// in shared memory
inline size_t launch_smem(int kernel, int cols, int width, int steps,
                          int num_images, int lanes) {
  switch (kernel) {
    case 0: return encode_smem(cols, steps);
    case 1: return decode_smem(cols, width, steps);
    case 2: return encode_aligned_smem(
        cols, aligned_group(0, num_images, lanes));
    default: return decode_aligned_smem(
        cols, aligned_group(1, num_images, lanes));
  }
}

// launch one coding kernel: with its tables in shared memory when `tables`
// is null, else after build_lane_tables writes them into `tables`
template <typename Entry, typename Shared, typename Global, typename... Args>
int launch_coder(Shared shared_kernel, Global global_kernel, dim3 grid,
                 int threads, size_t smem_shared, size_t smem_global,
                 const int32_t* cdf_lane, int cols, int lanes, void* tables,
                 cudaStream_t stream, Args... args) {
  if (tables == nullptr) {
    if (!fit_smem(shared_kernel, smem_shared))
      return static_cast<int>(cudaErrorInvalidValue);
    shared_kernel<<<grid, threads, smem_shared, stream>>>(
        args..., static_cast<const Entry*>(nullptr));
  } else {
    if (!fit_smem(global_kernel, smem_global))
      return static_cast<int>(cudaErrorInvalidValue);
    Entry* tab = static_cast<Entry*>(tables);
    build_lane_tables<Entry>(cdf_lane, cols, lanes, tab, stream);
    global_kernel<<<grid, threads, smem_global, stream>>>(
        args..., static_cast<const Entry*>(tab));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Largest steps T (decode = 0: encode) or stream width min(W, T)
// (decode = 1) that the batch-1 kernels take on the current device, at any
// CDF width (the global-table plan's staging bound).
int rans_cyclic_max_steps(int decode) {
  const int64_t avail = smem_optin();
  const int64_t fixed = decode ? static_cast<int64_t>(decode_smem(0, 0, 0))
                               : static_cast<int64_t>(encode_smem(0, 0));
  // both plans add kWarp u16 per step or column beyond `fixed`
  const int64_t per = static_cast<int64_t>(sizeof(uint16_t)) * kWarp;
  return avail < fixed ? 0 : static_cast<int>((avail - fixed) / per);
}

// 0 when a launch of kernel `kernel` (0 encode, 1 decode, 2 aligned encode,
// 3 aligned decode) at this shape keeps its lane tables in shared memory;
// else the bytes of the global table buffer it needs.
int64_t rans_cyclic_table_bytes(int kernel, int cols, int width, int steps,
                                int num_images, int lanes) {
  if (launch_smem(kernel, cols, width, steps, num_images, lanes)
      <= static_cast<size_t>(smem_optin()))
    return 0;
  const int64_t entry = (kernel == 0 || kernel == 2) ? sizeof(uint4)
                                                     : sizeof(uint2);
  return static_cast<int64_t>((lanes + kWarp - 1) / kWarp) * cols * kWarp
         * entry;
}

// The group that an aligned encode (decode = 0) or decode launch of
// `num_images` images on `lanes` lanes uses on the current device.
int rans_cyclic_aligned_group(int decode, int num_images, int lanes) {
  return aligned_group(decode, num_images, lanes);
}

int rans_cyclic_encode(const int32_t* cdf_lane, int cols, const int32_t* vc,
                       int num_images, int steps, int lanes, int32_t* streams,
                       int32_t* lengths, int64_t* states, void* tables,
                       cudaStream_t stream) {
  return launch_coder<uint4>(
      rans_encode_warp_kernel<false>, rans_encode_warp_kernel<true>,
      dim3(warp_blocks(num_images, lanes)), kWarp, encode_smem(cols, steps),
      encode_smem(0, steps), cdf_lane, cols, lanes, tables, stream, cdf_lane,
      cols, vc, steps, lanes, streams, lengths, states);
}

int rans_cyclic_encode_aligned(const int32_t* cdf_lane, int cols,
                               const int32_t* vc, int num_images, int steps,
                               int lanes, int32_t* streams, int32_t* lengths,
                               int64_t* states, uint8_t* masks, void* tables,
                               cudaStream_t stream) {
  const int group = aligned_group(0, num_images, lanes);
  return launch_coder<uint4>(
      rans_encode_aligned_kernel<false>, rans_encode_aligned_kernel<true>,
      aligned_grid(num_images, lanes, group), group * kWarp,
      encode_aligned_smem(cols, group), encode_aligned_smem(0, group),
      cdf_lane, cols, lanes, tables, stream, cdf_lane, cols, vc, num_images,
      steps, lanes, streams, lengths, states, masks);
}

int rans_cyclic_decode(const int32_t* streams, int width,
                       const int64_t* states, const int32_t* cdf_lane,
                       int cols, const int32_t* len_lane,
                       const int32_t* off_lane, int num_images, int steps,
                       int lanes, int32_t* out, int64_t* xend, void* tables,
                       cudaStream_t stream) {
  return launch_coder<uint2>(
      rans_decode_warp_kernel<false>, rans_decode_warp_kernel<true>,
      dim3(warp_blocks(num_images, lanes)), kWarp,
      decode_smem(cols, width, steps), decode_smem(0, width, steps), cdf_lane,
      cols, lanes, tables, stream, streams, width, states, cdf_lane, cols,
      len_lane, off_lane, steps, lanes, out, xend);
}

int rans_cyclic_decode_aligned(const int32_t* streams, int width,
                               const int64_t* states, const int32_t* cdf_lane,
                               int cols, const int32_t* len_lane,
                               const int32_t* off_lane, int num_images,
                               int steps, int lanes, int32_t* out,
                               int64_t* xend, void* tables,
                               cudaStream_t stream) {
  if (width != steps) return static_cast<int>(cudaErrorInvalidValue);
  const int group = aligned_group(1, num_images, lanes);
  return launch_coder<uint2>(
      rans_decode_aligned_kernel<false>, rans_decode_aligned_kernel<true>,
      aligned_grid(num_images, lanes, group), group * kWarp,
      decode_aligned_smem(cols, group), decode_aligned_smem(0, group),
      cdf_lane, cols, lanes, tables, stream, streams, width, states, cdf_lane,
      cols, len_lane, off_lane, num_images, steps, lanes, out, xend);
}

}  // extern "C"
