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
// What bounds them on this card: as for the cyclic pair, each lane is a
// serial chain of T dependent steps and a batch-1 image has only 512
// lanes, so the time is the chain's latency, plus the launch.
//
// The batch-1 pair (rans_indexed_encode, rans_indexed_decode) is built for
// that latency, as the cyclic batch-1 pair is. One warp a block, 32 lanes
// of one image, so a batch-1 image's 512 lanes spread over 16 SMs. Both
// read prepared tables that depend on the coding tables alone and are
// built once by the caller (ops/rans/indexed_tables.py), not per launch:
//   - the decoder's table is the used part of every row packed ragged
//     (27,256 int32 entries, 109 KB, for the default Gaussian tables), a
//     coarse table of 257 bounds a row (slot >> 8 -> the range of
//     candidate entries, absolute indexes into the ragged table, 66 KB)
//     and a per-row symbol base. In the shared-table plan the block copies
//     all three into shared memory with 16-byte cp.async copies (191 KB
//     with the staging); a step is then one coarse load (two words), a
//     bisection bounded by the bucket's width (none where a bucket holds
//     one symbol, at most 9 probes where 256 frequency-1 symbols share
//     one), and one pair of entry loads, all from shared memory, in place
//     of ~12 dependent L1/L2 probes over the whole row. Its result equals
//     `cdf_bisect`'s for every slot of a non-decreasing row;
//   - the decoder stages each 32-step tile of the block's row indexes with
//     cp.async, and each lane's stream row through a ring of 64 chunks in
//     shared memory, refilled at every tile for the next 64 columns past
//     the lane's read pointer (a lane reads at most one chunk a step), so
//     the chunk read leaves the chain and any T and width are taken;
//   - the encoder reads a prepared (start, freq, m_lo, m_hi) entry per CDF
//     entry (16 bytes, 3.2 MB for the default tables, in L2): its symbols
//     and row indexes are staged a tile ahead, each step's entry is
//     gathered into shared memory two tiles ahead with 16-byte cp.async
//     copies, so the loads leave the chain; it divides by the reciprocal
//     m = ceil(2^48 / freq) (exact, see rans_cyclic.cu's reciprocal48) as
//     umulhi(x, m_lo) + x * m_hi, in place of the hardware divide, and
//     folds the quotient into one multiply-add, x = q * (2^16 - freq) +
//     x + start;
//   - the encoder's chunks go to a u16 row per lane (emission e at column
//     T-1-e); after the chain the warp writes the block's compacted rows
//     (chunks at the front in decode order, zeros after) with coalesced
//     stores, in place of a store a step and a serial compaction pass.
//
// Two plans each, chosen by the wrapper from their shared-memory sizes:
// the decoder keeps its tables in shared memory, or (a custom table too
// large for a block) reads them in place from device memory (template
// parameter kGlobalTables); the encoder keeps its u16 rows in shared
// memory, or beyond about 2,600 steps in a device buffer the wrapper
// passes (kGlobalRows). The code of a step is the same in both.
//
// Measured on an H100 (bench_rans_kernels.py, PERF.md), at 512 lanes x 142
// steps: decode 0.048 ms, encode 0.020 ms, against 0.225 and 0.034 for the
// first design (one thread per lane, the table read from L2, the hardware
// divide) in the same run. From the steps sweep (T = 32 to 600) a decode
// step costs about 600 SM cycles (the first design 2,490) and an encode
// step about 195 (450), plus about 4.5-5 us a launch. The decoder's step
// is the bucket load, the bisection and the entry loads in a row; the
// warp runs the bisection as long as its slowest lane, and a lane whose
// slot falls in a bucket of the frequency-1 tails (the first and last
// slots of a wide row) needs up to 9 probes. Tried and measured slower:
// gathering a tile's encoder entries in one burst at the tile's start
// rather than one a step, and a warp-uniform probe count (the warp's
// largest, with no divergent loop). Finer buckets at the two ends of the
// slot range measured faster but need 31 KB more shared memory, which
// would leave custom tables little room before the global plan.
//
// All three decoders (rans_indexed_decode, rans_indexed_decode_aligned,
// rans_masked_decode_front) find a slot's entry with one device function,
// `bucket_lookup`, on the same prepared pack, wherever it lies (shared or
// device memory):
//   - the aligned decoder applies the batch-1 decoder's design with one
//     image a warp: a block holds the same 32 lanes of G images, whose
//     warps share one copy of the pack in shared memory (or read it in
//     place, kGlobalTables, when it does not fit beside one warp's
//     staging). The chunk of step t sits at column t, so there is no read
//     pointer and no ring: the warp stages its 32 lanes' next kATile
//     columns as one cp.async tile a tile ahead (coalesced row segments,
//     row pitch kATile + 1 so the column reads never share a bank), and
//     each lane prefetches its next tile's row indexes (coalesced across
//     the warp) into registers, which leaves shared memory for more warps
//     a block. G follows a rule measured on an H100 (aligned_group_rule);
//   - the masked front decoder runs one step a lane a launch, so copying
//     the pack costs more than it saves: it reads the pack in place (L2
//     resident across a JAHP image's fronts). Its loads that do not depend
//     on the table walk (state, row, activity, the chunk at column t) are
//     issued first; the walk is then the bucket's two bounds (two
//     independent loads), the bounded bisection and the entry pair, so
//     about 5 dependent loads in place of ~16. A search probing 7
//     candidates a round was tried and dropped: faster on the bench's
//     evenly drawn rows, not on the JAHP path's own fronts (PERF.md).
//
// Measured on an H100 (bench_rans_kernels.py, PERF.md): the aligned
// decoder at k = 8 on 512 lanes x 142 steps 0.0506 ms (G = 4) against
// 0.229 for the first design (one thread per (image, lane), the whole row
// bisected in L2) in the same run, 0.085 ms at k = 128 (G = 16) against
// 0.275; the masked front decoder about 0.003 ms a launch at 1,152 lanes
// on the JAHP path, over an empty kernel's 0.0019 on the same grid.
//
// Both aligned encoders (rans_indexed_encode_aligned and the masked
// rans_masked_encode_aligned, one kernel template) apply the batch-1
// encoder's design with one image a warp, on the same prepared entries
// (`encode_step`): a block holds the same 32 lanes of G images (the masked
// encoder's one image: G = 1), whose symbol and row tiles are staged a
// tile ahead and whose entries are gathered two tiles ahead (16-byte
// cp.async from L2), so no load stays on the state's chain. The chunk of
// step t sits at column t, so the warp keeps its lanes' last 64 columns in
// a u16 ring in shared memory and the renormalisation bits of a 32-column
// window in a word, and after each window writes the streams (and, where
// asked, the masks) with coalesced stores that start at a 32-byte sector
// boundary of each row (as rans_cyclic.cu's aligned encoder does), in
// place of a 4-byte store a step whose warp touched 32 sectors. Shared
// memory does not grow with T, so any T is taken. The plan follows a rule
// measured on an H100 (encode_plan_rule): 16-step tiles while the warps
// take at most two an SM, else 8-step tiles (20,864 bytes a warp against
// 37,248, so 8 warps fit a block), and the largest G whose blocks still
// cover every SM. The masked encoder first stages the activity map whole
// in shared memory; an inactive lane gathers nothing and stays inert, and
// an entry of frequency 0 codes with frequency 1 (max(freq, 1), as the JAX
// step). Its one image has 36 warps at the JAHP's 1,152 lanes, so its
// bound is the chain's latency over 61 fronts plus the launch.
//
// Measured on an H100 (bench_rans_kernels.py, PERF.md), in one call with
// the first design (one thread per (image, lane), the CDF rows read from
// L2, the hardware divide, a 4-byte store a step): the aligned encoder at
// 512 lanes x 142 steps 0.0229 ms at k = 8 (16-step tiles, G = 1)
// against 0.0280, 0.0665 at k = 128 (8-step tiles, G = 8) against 0.228
// (the bytes' bound about 0.034); the masked encoder 0.0167 ms an image on
// the JAHP path against 0.0255, over an empty kernel's 0.0019 on its grid.
// At k = 128, G = 1 measured 1.5x slower than G = 8 at the same tile: ten
// one-warp blocks an SM code slower than one block of eight warps.
//
// All kernels hold the plain versions' contract bit for bit on valid
// tables: CDF rows non-decreasing from 0 to 2^16 within cdf_length, every
// coded symbol of frequency >= 1, indexes in [0, rows), stream values in
// 0..65535. A read past a lane's stream row yields 0, and the final states
// say whether each lane returned to 2^16.
//
// Layouts (all row-major, int32 unless stated):
//   cdf      (R, cols); cdf_len, off (R,)
//   enc      (R, cols, 4) prepared encoder entries; dec the decoder's pack
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
// Both read the prepared tables (above): the encoder the entries, the
// decoder the pack in place. The masked encoder is the aligned encoder's
// kernel with the activity test (kMasked): an "identity" row could not
// stand in for it, since a row of frequency 2^16 would leave the state as
// it is, but 2^16 << 16 wraps to 0 in 32 bits, so every such step would
// renormalise. The context model between decode fronts stays torch ops.
//
// Layouts: vc, idx (T, N) int32 forward order; act (T, F) uint8; streams
// (N, T) int32; lengths (N,) int32; states (N,) int64. The decoder takes
// front t's idx (N,) and act (F,), states in, and the prepared pack, and
// writes the symbols (N,) (row offset added, 0 on inactive lanes) and the
// states out.
//
// Each C entry point launches on the given stream and returns
// cudaGetLastError(), or cudaErrorInvalidValue (without launching) when
// aligned streams are not T columns wide, the masked lanes are not F * m
// (a front index outside [0, T)), or a plan needs more shared memory than
// a block can have (the masked encoder's activity map of T x F bytes
// beside one warp's staging).

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kRansL = 1u << 16;
constexpr int kThreads = 32;      // (image, lane) pairs per block
constexpr int kTile = 32;         // batch-1 pair: steps per staged tile
constexpr int kRing = 64;         // batch-1 decoder: stream chunks per lane
constexpr int kBucketShift = 8;   // batch-1 decoder: bucket = slot >> 8
constexpr int kBucketStride = (1 << (16 - kBucketShift)) + 1;  // bounds a row
constexpr int kATile = 8;         // aligned decoder: steps per staged tile
constexpr int kAPitch = kATile + 1;                  // words a lane's row
constexpr int kAWarpWords = 2 * kThreads * kAPitch;  // a warp's two tiles
constexpr int kMaxAlignedGroup = 16;                 // images (warps) a block
constexpr int kMinAlignedGroup = 4;                  // ... where k allows
// the aligned encoders: the columns a write-out covers, the u16 output
// ring and its row pitch (33 words, so the lanes' ring stores never share
// a bank), the most warps a block
constexpr int kEWindow = 32;
constexpr int kERing = 2 * kEWindow;
constexpr int kERingPitch = kERing + 2;
constexpr int kMaxEncodeGroup = 8;

// an aligned encoder warp's shared bytes at tiles of `tile` steps: entry
// tiles [3][tile][32] of 16 bytes, symbol and row tiles [2][tile][32]
// each, the renormalisation bits [32][2], the ring [32][kERingPitch]
__host__ __device__ constexpr size_t encode_warp_bytes(int tile) {
  return sizeof(uint4) * 3 * tile * kThreads
         + sizeof(int32_t) * 2 * 2 * tile * kThreads
         + sizeof(uint32_t) * 2 * kThreads
         + sizeof(uint16_t) * kThreads * kERingPitch;
}
static_assert(encode_warp_bytes(8) % 16 == 0
              && encode_warp_bytes(16) % 16 == 0, "aligned encoder tiles");

inline unsigned blocks_for(int num_images, int lanes) {
  const int64_t total = static_cast<int64_t>(num_images) * lanes;
  return static_cast<unsigned>((total + kThreads - 1) / kThreads);
}

// one block per (image, 32-lane chunk)
inline unsigned warp_blocks(int num_images, int lanes) {
  return static_cast<unsigned>(num_images)
         * static_cast<unsigned>((lanes + kThreads - 1) / kThreads);
}

// The prepared pack's search (ops/rans/indexed_tables.py bucket_lookup):
// for `slot` in the row whose coarse bounds start at `brow`, the ragged
// index e (the row's start plus cdf_bisect's v) of the entry with tab[e] <=
// slot < tab[e + 1], and that entry's start and frequency. The bucket gives
// the candidate entries [lo, hi) with tab[lo] <= slot; a bisection inside
// finishes. `tab` (the ragged entries) and `brow` lie in shared or device
// memory.
__device__ __forceinline__ int bucket_lookup(const int32_t* __restrict__ tab,
                                             const int32_t* __restrict__ brow,
                                             uint32_t slot, uint32_t& st,
                                             uint32_t& fr) {
  int lo = brow[slot >> kBucketShift];
  int hi = brow[(slot >> kBucketShift) + 1] + 1;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (static_cast<uint32_t>(tab[mid]) <= slot) lo = mid;
    else hi = mid;
  }
  st = static_cast<uint32_t>(tab[lo]);
  fr = static_cast<uint32_t>(tab[lo + 1]) - st;
  return lo;
}

// The encoders' step on a prepared (start, freq, m_lo, m_hi) entry:
// renormalise (the caller keeps x's low 16 bits, the chunk emitted when
// this returns true), then x = floor(x / fr) * 2^16 + x mod fr + st, the
// quotient by the reciprocal m = ceil(2^48 / fr) = m_hi * 2^32 + m_lo
// (exact, see rans_cyclic.cu's reciprocal48) as umulhi(x, m_lo) + x * m_hi,
// folded into one multiply-add. uint32 arithmetic throughout, wrapping
// exactly as the plain versions'.
__device__ __forceinline__ bool encode_step(uint32_t& x, uint32_t st,
                                            uint32_t fr, uint32_t m_lo,
                                            uint32_t m_hi) {
  const bool renorm = x >= (fr << 16);
  if (renorm) x >>= 16;
  const uint32_t q = (__umulhi(x, m_lo) + x * m_hi) >> 16;
  x = q * (kRansL - fr) + x + st;
  return renorm;
}

// ---- asynchronous global -> shared copies ----------------------------------

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one group (the newest) of this thread is in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ---- shared-memory plans (bytes) -------------------------------------------

// encoder: entry tiles [3][kTile][32] (16 bytes), symbol and row tiles
// [2][kTile][32] each, the lanes' counts, then (shared-row plan) the u16
// output rows of pitch T+1
inline size_t encode_smem(int steps, bool global_rows) {
  return sizeof(uint4) * 3 * kTile * kThreads
         + sizeof(int32_t) * 2 * 2 * kTile * kThreads
         + sizeof(int32_t) * kThreads
         + (global_rows ? 0
                        : sizeof(uint16_t) * kThreads
                              * (static_cast<size_t>(steps) + 1));
}

// decoder: (shared-table plan) the table pack, then row-index tiles
// [2][kTile][32] and the stream ring [kRing][32]
inline size_t decode_smem(int pack_words, bool global_tables) {
  return (global_tables ? 0 : sizeof(int32_t) * pack_words)
         + sizeof(int32_t) * (2 * kTile + kRing) * kThreads;
}

inline int smem_optin() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  return bytes;
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

// aligned decoder: (shared-table plan) the table pack, then each of the
// block's `group` warps' two stream tiles
inline size_t decode_aligned_smem(int pack_words, bool global_tables,
                                  int group) {
  return (global_tables ? 0 : sizeof(int32_t) * pack_words)
         + sizeof(int32_t) * group * kAWarpWords;
}

// The images a block of an aligned decode (G), from `lane_groups` blocks of
// 32 lanes an image, k images, at most `gmax` warps a block (the shared
// memory beside the pack, kMaxAlignedGroup, k) and `sms` SMs, one block an
// SM in the shared-table plan. The rule, from device times on an H100 at
// the MSHP y shapes, k = 1, 8 and 128 (PERF.md): the fewest waves of
// blocks there can be, then the smallest G of at least kMinAlignedGroup
// (where k allows) that keeps them. Four warps an SM decode as fast a
// step as one, and share one copy of the pack: at k = 8, G = 4 measured
// 8% faster than G = 1 (a quarter of the pack copies) and 4% faster than
// G = 8 (more warps contending for an SM); at k = 128 the waves decide
// (G = 16, one wave on 512 lanes, 10x faster than G = 1).
inline int aligned_group_rule(int64_t lane_groups, int num_images, int gmax,
                              int sms) {
  const int64_t fewest =
      (lane_groups * ((num_images + gmax - 1) / gmax) + sms - 1) / sms;
  for (int g = std::min(kMinAlignedGroup, gmax); g < gmax; ++g)
    if (lane_groups * ((num_images + g - 1) / g) <= fewest * sms) return g;
  return gmax;
}

inline int aligned_decode_group(int num_images, int lanes, int pack_words,
                                bool global_tables) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int gmax = kMaxAlignedGroup;
  if (!global_tables) {
    const int64_t room = static_cast<int64_t>(smem_optin())
                         - static_cast<int64_t>(sizeof(int32_t)) * pack_words;
    gmax = static_cast<int>(std::min<int64_t>(
        gmax, room / static_cast<int64_t>(sizeof(int32_t) * kAWarpWords)));
  }
  gmax = std::max(1, std::min(gmax, num_images));
  return aligned_group_rule((lanes + kThreads - 1) / kThreads, num_images,
                            gmax, std::max(sms, 1));
}

// aligned encoders: (masked) the activity map (T, F) bytes, padded to 16,
// then each of the block's `group` warps' tiles, bits and ring
__host__ __device__ inline size_t act_smem(int steps, int slots) {
  return (static_cast<size_t>(steps) * slots + 15) / 16 * 16;
}

// An aligned encode's plan: steps a staged tile (8 or 16) and images
// (warps) a block.
struct EncodePlan {
  int tile;
  int group;
};

// the most warps a block of `tile`-step tiles holds beside `act_bytes`,
// capped by kMaxEncodeGroup and k
inline int encode_gmax(int tile, int num_images, size_t act_bytes) {
  const int64_t room = static_cast<int64_t>(smem_optin())
                       - static_cast<int64_t>(act_bytes);
  const int64_t fit = room / static_cast<int64_t>(encode_warp_bytes(tile));
  return std::max(1, static_cast<int>(std::min<int64_t>(
      fit, std::min(kMaxEncodeGroup, num_images))));
}

// The plan of an aligned encode of k images of `lane_groups` blocks of 32
// lanes on `sms` SMs (the masked encoder: k = 1, the activity map's
// `act_bytes` beside the warps). The rule, from device times on an H100
// at the MSHP y shapes, k = 1, 8 and 128 (PERF.md): 16-step tiles while
// the warps take at most two an SM (7% faster than 8 at k = 1 and 8: half
// the tiles' waits and staging), else 8-step tiles (20,864 bytes a warp
// against 37,248, so more warps fit an SM); then the largest G whose
// blocks still cover every SM. At k = 128, G = 8 measured 1.5-1.75x
// faster than G = 1, whose one-warp blocks sat 10 to an SM; at k = 8,
// G = 1 keeps the 128 warps on 128 SMs (G = 8: 16 SMs, 1.4x slower).
inline EncodePlan encode_plan_rule(int64_t lane_groups, int num_images,
                                   int sms, size_t act_bytes) {
  const int tile = lane_groups * num_images <= 2 * sms ? 16 : 8;
  int g = encode_gmax(tile, num_images, act_bytes);
  while (g > 1 && lane_groups * ((num_images + g - 1) / g) < sms) --g;
  return {tile, g};
}

inline EncodePlan encode_plan(int num_images, int lanes, size_t act_bytes) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return encode_plan_rule((lanes + kThreads - 1) / kThreads, num_images,
                          std::max(sms, 1), act_bytes);
}

inline size_t encode_aligned_smem(const EncodePlan& plan, size_t act_bytes) {
  return act_bytes + encode_warp_bytes(plan.tile) * plan.group;
}

// ---- batch-1 encode --------------------------------------------------------
//
// Tiles of kTile steps are coded in reverse. Three kinds of cp.async group,
// committed in this order by each thread for its own lane (so no lane reads
// another's copies): A(s), tile s's symbols and row indexes; B(s), tile s's
// entries, gathered from `enc` at the staged (row, value). Iteration s
// stages A(s-3) first, then codes tile s while it gathers B(s-2), one
// entry a step; at its start only B(s-1) may still be in flight, so B(s)
// and A(s-2) have landed. Buffers: A in s & 1, B in s % 3.

template <bool kGlobalRows>
__global__ void __launch_bounds__(kThreads)
rans_indexed_encode_warp_kernel(const uint4* __restrict__ enc, int cols,
                                const int32_t* __restrict__ vc,
                                const int32_t* __restrict__ idx, int steps,
                                int lanes, int32_t* __restrict__ streams,
                                int32_t* __restrict__ lengths,
                                int64_t* __restrict__ states,
                                uint16_t* __restrict__ grows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int chunks = (lanes + kThreads - 1) / kThreads;
  const int img = blockIdx.x / chunks;
  const int lane0 = (blockIdx.x % chunks) * kThreads;
  const int l = threadIdx.x;
  const int lane = lane0 + l;
  const bool active = lane < lanes;
  const int nrow = min(kThreads, lanes - lane0);
  const int pitch = steps + 1;
  uint4* ent = reinterpret_cast<uint4*>(smem);          // [3][kTile][32]
  int32_t* vt = reinterpret_cast<int32_t*>(ent + 3 * kTile * kThreads);
  int32_t* rt = vt + 2 * kTile * kThreads;              // [2][kTile][32]
  int32_t* counts = rt + 2 * kTile * kThreads;          // [32]
  uint16_t* obuf = kGlobalRows
      ? grows + static_cast<int64_t>(blockIdx.x) * kThreads * pitch
      : reinterpret_cast<uint16_t*>(counts + kThreads);  // [32][pitch]
  const int64_t base = static_cast<int64_t>(img) * steps * lanes + lane;
  const int ntiles = (steps + kTile - 1) / kTile;

  // A(s): tile s's symbols and rows for this lane (coalesced across the
  // warp); an empty group for s < 0 keeps the wait count uniform
  auto stage = [&](int s) {
    if (s >= 0 && active) {
      const int t0 = s * kTile, t1 = min(t0 + kTile, steps);
      const int o = (s & 1) * kTile * kThreads + l;
      for (int t = t0; t < t1; ++t) {
        const int64_t p = base + static_cast<int64_t>(t) * lanes;
        cp_async4(vt + o + (t - t0) * kThreads, vc + p);
        cp_async4(rt + o + (t - t0) * kThreads, idx + p);
      }
    }
    cp_async_commit();
  };
  // step s*kTile + j's entry into B(s)'s buffer (A(s) has landed)
  auto gather = [&](int s, int j) {
    if (s >= 0 && active && s * kTile + j < steps) {
      const int o = (s & 1) * kTile * kThreads + j * kThreads + l;
      const int64_t e = static_cast<int64_t>(rt[o]) * cols + vt[o];
      cp_async16(ent + ((s % 3) * kTile + j) * kThreads + l, enc + e);
    }
  };

  stage(ntiles - 1);
  stage(ntiles - 2);
  cp_async_wait_one();                          // A(S-1)
  for (int j = 0; j < kTile; ++j) gather(ntiles - 1, j);
  cp_async_commit();                            // B(S-1)
  stage(ntiles - 3);
  cp_async_wait_one();                          // A(S-2)
  for (int j = 0; j < kTile; ++j) gather(ntiles - 2, j);
  cp_async_commit();                            // B(S-2)

  uint32_t x = kRansL;
  int count = 0;
  uint16_t* orow = obuf + l * pitch;
  for (int s = ntiles - 1; s >= 0; --s) {
    cp_async_wait_one();                        // B(s), A(s-2)
    stage(s - 3);
    const int t0 = s * kTile, n = min(kTile, steps - t0);
    if (active) {
      const uint4* et = ent + (s % 3) * kTile * kThreads + l;
      // the entries do not depend on the state: step t-1's is read while
      // step t runs
      uint4 next = et[(n - 1) * kThreads];
      for (int j = n - 1; j >= 0; --j) {
        const uint4 e = next;
        if (j > 0) next = et[(j - 1) * kThreads];
        gather(s - 2, j);
        const uint16_t low = static_cast<uint16_t>(x);
        // the count-th emission goes to column steps-1-count
        if (encode_step(x, e.x, e.y, e.z, e.w))
          orow[steps - 1 - count++] = low;
      }
      for (int j = n; j < kTile; ++j) gather(s - 2, j);
    }
    cp_async_commit();                          // B(s-2)
  }
  const int64_t gid = static_cast<int64_t>(img) * lanes + lane;
  if (active) {
    counts[l] = count;
    lengths[gid] = count;
    states[gid] = static_cast<int64_t>(x);
  }
  __syncwarp();

  // coalesced write-out of the block's rows: chunks at the front in decode
  // order, zeros after; eight rows at a time so their loads overlap
  int32_t* out =
      streams + (static_cast<int64_t>(img) * lanes + lane0) * steps;
  for (int r0 = 0; r0 < nrow; r0 += 8) {
    int cnt[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) cnt[i] = r0 + i < nrow ? counts[r0 + i] : 0;
    for (int c = l; c < steps; c += kThreads) {
      int32_t val[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        val[i] = c < cnt[i]
                     ? obuf[(r0 + i) * pitch + (steps - cnt[i]) + c]
                     : 0;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (r0 + i < nrow)
          out[static_cast<int64_t>(r0 + i) * steps + c] = val[i];
    }
  }
}

// ---- batch-1 decode --------------------------------------------------------
//
// Per tile s, each thread commits one group G(s): row-index tile s+1 and
// its lane's stream columns up to ptr + kRing, then waits for G(s-1). A
// lane reads at most kTile chunks a tile, so the columns it reads in tile
// s, [ptr, ptr + kTile), were staged in G(s-1) or before, and a refilled
// ring slot held a column below ptr, already read.

template <bool kGlobalTables>
__global__ void __launch_bounds__(kThreads)
rans_indexed_decode_warp_kernel(const int32_t* __restrict__ streams,
                                int width,
                                const int64_t* __restrict__ states,
                                const int32_t* __restrict__ pack,
                                int pack_words, int bucket_at, int base_at,
                                const int32_t* __restrict__ idx, int steps,
                                int lanes, int32_t* __restrict__ out,
                                int64_t* __restrict__ xend) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int chunks = (lanes + kThreads - 1) / kThreads;
  const int img = blockIdx.x / chunks;
  const int lane0 = (blockIdx.x % chunks) * kThreads;
  const int l = threadIdx.x;
  const int lane = lane0 + l;
  const bool active = lane < lanes;
  int32_t* stab = reinterpret_cast<int32_t*>(smem);
  int32_t* itile = stab + (kGlobalTables ? 0 : pack_words);  // [2][kTile][32]
  int32_t* ring = itile + 2 * kTile * kThreads;               // [kRing][32]
  const int32_t* tab = kGlobalTables ? pack : stab;  // ragged entries first
  const int32_t* bkt = tab + bucket_at;
  const int32_t* rbase = tab + base_at;
  const int64_t gid = static_cast<int64_t>(img) * lanes + lane;
  const int64_t base = static_cast<int64_t>(img) * steps * lanes + lane;
  const int32_t* srow = streams + gid * width;
  const int ntiles = (steps + kTile - 1) / kTile;

  // stream columns [issued, upto) of the lane's row into the ring; a
  // column past the row is 0
  int issued = 0;
  auto refill = [&](int upto) {
    for (; issued < upto; ++issued) {
      int32_t* dst = ring + (issued & (kRing - 1)) * kThreads + l;
      if (issued < width) cp_async4(dst, srow + issued);
      else *dst = 0;
    }
  };
  // row-index tile s for this lane (coalesced across the warp)
  auto stage_rows = [&](int s) {
    if (s < ntiles && active) {
      const int t0 = s * kTile, t1 = min(t0 + kTile, steps);
      int32_t* dst = itile + (s & 1) * kTile * kThreads + l;
      for (int t = t0; t < t1; ++t)
        cp_async4(dst + (t - t0) * kThreads,
                  idx + base + static_cast<int64_t>(t) * lanes);
    }
  };

  // G(-1): the tables (16-byte copies; pack_words is a multiple of 4),
  // row-index tile 0, the first kRing stream columns
  if (!kGlobalTables)
    for (int i = 4 * l; i < pack_words; i += 4 * kThreads)
      cp_async16(stab + i, pack + i);
  stage_rows(0);
  if (active) refill(kRing);
  cp_async_commit();
  uint32_t x = active ? static_cast<uint32_t>(states[gid]) : 0u;
  int ptr = 0;
  int32_t* o = out + base;
  for (int s = 0; s < ntiles; ++s) {
    stage_rows(s + 1);
    if (active) refill(ptr + kRing);
    cp_async_commit();                          // G(s)
    cp_async_wait_one();                        // G(s-1) has landed
    if (s == 0) __syncthreads();                // every thread's table copies
    if (!active) continue;
    const int t0 = s * kTile, t1 = min(t0 + kTile, steps);
    const int32_t* it = itile + (s & 1) * kTile * kThreads + l;
    int r = it[0];
    for (int t = t0; t < t1; ++t, o += lanes) {
      // the row's coarse bounds and base, and the next row index, do not
      // depend on the state
      const int32_t* brow = bkt + r * kBucketStride;
      const int rb = rbase[r];
      const int rn = t + 1 < t1 ? it[(t + 1 - t0) * kThreads] : 0;
      const uint32_t slot = x & 0xFFFFu;
      uint32_t st, fr;
      const int lo = bucket_lookup(tab, brow, slot, st, fr);
      const uint32_t chunk =
          static_cast<uint32_t>(ring[(ptr & (kRing - 1)) * kThreads + l]);
      x = fr * (x >> 16) + slot - st;
      if (x < kRansL) {
        x = (x << 16) | chunk;
        ++ptr;
      }
      *o = lo + rb;
      r = rn;
    }
  }
  if (active) xend[gid] = static_cast<int64_t>(x);
}

// ---- the aligned encoders (wire_batch, and the masked lanes) --------------
//
// Grid (lane groups, image groups); block: G warps, warp w coding image
// blockIdx.y * G + w on lanes blockIdx.x * 32 + [0, 32) (the masked encoder:
// one image, G = 1). The batch-1 encoder's pipeline on tiles of kETile
// steps, coded in reverse: A(s), tile s's symbols and rows, staged three
// tiles ahead (coalesced across the warp); B(s), tile s's prepared
// entries, gathered at the staged (row, value) two tiles ahead, one a step;
// A in buffer s & 1, B in s % 3, each lane copying and reading only its
// own. The chunk of step t goes to column t & (kERing - 1) of the lane's
// u16 ring (0 where none), its renormalisation to bit t & 31 of a word a
// kEWindow-column window. After the tile that completes a window [t0, t0 +
// 32) the warp stores each of its rows' 32 columns from the row's first
// 32-byte sector boundary at or after t0 (the columns above were stored
// after the window before), so no store but a row's head writes part of a
// sector; eight rows' shared loads go before their stores. The masked
// encoder first stages the activity map (T, F) in shared memory; a lane
// inactive at a step gathers nothing, keeps its state and writes chunk 0,
// and an entry of frequency 0 codes with frequency 1 (max(freq, 1), as the
// plain version and the JAX step).

template <bool kMasked, int kETile>
__global__ void __launch_bounds__(kMaxEncodeGroup * kThreads)
rans_indexed_encode_aligned_warp_kernel(const uint4* __restrict__ enc,
                                        int cols,
                                        const int32_t* __restrict__ vc,
                                        const int32_t* __restrict__ idx,
                                        const uint8_t* __restrict__ act,
                                        int slots, int m, int num_images,
                                        int steps, int lanes,
                                        int32_t* __restrict__ streams,
                                        int32_t* __restrict__ lengths,
                                        int64_t* __restrict__ states,
                                        uint8_t* __restrict__ masks) {
  static_assert(kEWindow % kETile == 0, "a tile divides the window");
  extern __shared__ __align__(16) unsigned char smem[];
  const int group = blockDim.x / kThreads;
  const int w = threadIdx.x / kThreads;
  const int l = threadIdx.x % kThreads;
  const int lane0 = blockIdx.x * kThreads;
  const int lane = lane0 + l;
  const int img = blockIdx.y * group + w;
  const bool active = img < num_images && lane < lanes;
  const int nrow = min(kThreads, lanes - lane0);
  const uint8_t* sact = smem;                         // masked: [T][F]
  uint4* ent = reinterpret_cast<uint4*>(
      smem + (kMasked ? act_smem(steps, slots) : 0)
      + w * encode_warp_bytes(kETile));
  int32_t* vt = reinterpret_cast<int32_t*>(ent + 3 * kETile * kThreads);
  int32_t* rt = vt + 2 * kETile * kThreads;           // [2][kETile][32]
  uint32_t* rbits = reinterpret_cast<uint32_t*>(rt + 2 * kETile * kThreads);
  uint16_t* ring = reinterpret_cast<uint16_t*>(rbits + 2 * kThreads);
  if (kMasked) {
    // sixteen loads a thread in flight before their stores
    const int bytes = steps * slots;
    for (int i0 = threadIdx.x; i0 < bytes; i0 += 16 * blockDim.x) {
      uint8_t a[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int i = i0 + u * blockDim.x;
        a[u] = i < bytes ? act[i] : 0;
      }
#pragma unroll
      for (int u = 0; u < 16; ++u)
        if (i0 + u * blockDim.x < bytes) smem[i0 + u * blockDim.x] = a[u];
    }
    __syncthreads();
  }
  if (img >= num_images) return;
  const int slot = kMasked && active ? lane / m : 0;
  auto on = [&](int t) { return !kMasked || sact[t * slots + slot] != 0; };
  const int64_t row0 = static_cast<int64_t>(img) * lanes + lane0;
  const int64_t base = static_cast<int64_t>(img) * steps * lanes + lane;
  const int ntiles = (steps + kETile - 1) / kETile;

  // A(s): tile s's symbols and rows for this lane; an empty group for s < 0
  // keeps the wait count uniform
  auto stage = [&](int s) {
    if (s >= 0 && active) {
      const int t0 = s * kETile, t1 = min(t0 + kETile, steps);
      const int o = (s & 1) * kETile * kThreads + l;
      for (int t = t0; t < t1; ++t) {
        const int64_t p = base + static_cast<int64_t>(t) * lanes;
        cp_async4(vt + o + (t - t0) * kThreads, vc + p);
        cp_async4(rt + o + (t - t0) * kThreads, idx + p);
      }
    }
    cp_async_commit();
  };
  // step s*kETile + j's entry into B(s)'s buffer (A(s) has landed)
  auto gather = [&](int s, int j) {
    const int t = s * kETile + j;
    if (s >= 0 && active && t < steps && on(t)) {
      const int o = (s & 1) * kETile * kThreads + j * kThreads + l;
      const int64_t e = static_cast<int64_t>(rt[o]) * cols + vt[o];
      cp_async16(ent + ((s % 3) * kETile + j) * kThreads + l, enc + e);
    }
  };

  // the warp's output rows; row r's column 0 lies ph0 + r * phs int32
  // (mod 8) past a 32-byte sector boundary, so its first boundary at or
  // after a column t0 = 32w is column t0 + dcol[r & 7]
  int32_t* out_w = streams + row0 * steps;
  uint8_t* mask_w = masks != nullptr ? masks + row0 * steps : nullptr;
  const int ph0 = static_cast<int>((row0 * steps) & 7);
  const int phs = steps & 7;
  int dcol[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) dcol[i] = (-(ph0 + i * phs)) & 7;

  stage(ntiles - 1);
  stage(ntiles - 2);
  cp_async_wait_one();                          // A(S-1)
  for (int j = 0; j < kETile; ++j) gather(ntiles - 1, j);
  cp_async_commit();                            // B(S-1)
  stage(ntiles - 3);
  cp_async_wait_one();                          // A(S-2)
  for (int j = 0; j < kETile; ++j) gather(ntiles - 2, j);
  cp_async_commit();                            // B(S-2)

  uint32_t x = kRansL, bits = 0;
  int count = 0;
  uint16_t* orow = ring + l * kERingPitch;
  for (int s = ntiles - 1; s >= 0; --s) {
    cp_async_wait_one();                        // B(s), A(s-2)
    stage(s - 3);
    const int t0 = s * kETile, n = min(kETile, steps - t0);
    if (active) {
      const uint4* et = ent + (s % 3) * kETile * kThreads + l;
      // the entries do not depend on the state: step t-1's is read while
      // step t runs
      uint4 next = et[(n - 1) * kThreads];
      for (int j = n - 1; j >= 0; --j) {
        const uint4 e = next;
        if (j > 0) next = et[(j - 1) * kThreads];
        gather(s - 2, j);
        const int t = t0 + j;
        uint32_t chunk = 0;
        if (on(t)) {
          uint32_t fr = e.y, m_hi = e.w;
          if (kMasked && static_cast<int32_t>(fr) <= 0) {
            fr = 1;                             // m = 2^48: m_lo is 0
            m_hi = 1u << 16;
          }
          const uint32_t low = x & 0xFFFFu;
          const bool renorm = encode_step(x, e.x, fr, e.z, m_hi);
          chunk = renorm ? low : 0u;
          bits |= static_cast<uint32_t>(renorm) << (t & (kEWindow - 1));
          count += renorm;
        }
        orow[t & (kERing - 1)] = static_cast<uint16_t>(chunk);
      }
      for (int j = n; j < kETile; ++j) gather(s - 2, j);
    }
    cp_async_commit();                          // B(s-2)
    if (t0 % kEWindow != 0) continue;
    // the window [t0, t0 + 32) is coded: columns >= t0 are final
    if (active) rbits[l * 2 + ((t0 / kEWindow) & 1)] = bits;
    bits = 0;
    __syncwarp();                               // the ring and bits written
    for (int r0 = 0; r0 < nrow; r0 += 8) {
      uint32_t val[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)               // row r0 + i < 32: in the ring
        val[i] = r0 + i < nrow
                     ? ring[(r0 + i) * kERingPitch
                            + ((t0 + dcol[i] + l) & (kERing - 1))]
                     : 0u;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = t0 + dcol[i] + l;
        if (r0 + i < nrow && col < steps)
          out_w[(r0 + i) * steps + col] = static_cast<int32_t>(val[i]);
      }
    }
    if (mask_w != nullptr) {
      for (int r0 = 0; r0 < nrow; r0 += 8) {
        uint32_t bit[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          bit[i] = r0 + i < nrow
                       ? rbits[(r0 + i) * 2
                               + (((t0 + dcol[i] + l) / kEWindow) & 1)]
                       : 0u;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int col = t0 + dcol[i] + l;
          if (r0 + i < nrow && col < steps)
            mask_w[(r0 + i) * steps + col] =
                (bit[i] >> (col & (kEWindow - 1))) & 1u;
        }
      }
    }
    if (t0 == 0) {
      // the rows' heads: the columns before their first sector boundary
      for (int r = 0; r < nrow; ++r) {
        if (l < ((-(ph0 + r * phs)) & 7) && l < steps) {
          out_w[r * steps + l] = ring[r * kERingPitch + l];
          if (mask_w != nullptr)
            mask_w[r * steps + l] = (rbits[r * 2] >> l) & 1u;
        }
      }
    }
    __syncwarp();                               // the ring is free again
  }
  if (active) {
    lengths[row0 + l] = count;
    states[row0 + l] = static_cast<int64_t>(x);
  }
}

// ---- the aligned (wire_batch) decoder --------------------------------------
//
// Grid (lane groups, image groups); block: G warps, warp w decoding image
// blockIdx.y * G + w on lanes blockIdx.x * 32 + [0, 32). Per tile s of
// kATile steps each warp commits one group G(s), its 32 lanes' stream
// columns of tile s+1, into buffer (s+1) & 1, then waits for G(s-1); G(-1)
// also holds the block's copy of the pack. The copies are coalesced (a
// warp instruction copies 4 rows x kATile columns), so a lane reads what
// other lanes copied: a __syncwarp after the wait makes them visible, and
// one before the next tile's copies keeps a buffer until every lane has
// read it. The row indexes of tile s+1 are loaded into registers at tile
// s's start.

template <bool kGlobalTables>
__global__ void __launch_bounds__(kMaxAlignedGroup * kThreads)
rans_indexed_decode_aligned_warp_kernel(const int32_t* __restrict__ streams,
                                        const int64_t* __restrict__ states,
                                        const int32_t* __restrict__ pack,
                                        int pack_words, int bucket_at,
                                        int base_at,
                                        const int32_t* __restrict__ idx,
                                        int num_images, int steps, int lanes,
                                        int32_t* __restrict__ out,
                                        int64_t* __restrict__ xend) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int group = blockDim.x / kThreads;
  const int w = threadIdx.x / kThreads;
  const int l = threadIdx.x % kThreads;
  const int lane0 = blockIdx.x * kThreads;
  const int img = blockIdx.y * group + w;
  const int lane = lane0 + l;
  const bool live = img < num_images;          // the warp has an image
  const bool active = live && lane < lanes;
  const int nrow = min(kThreads, lanes - lane0);
  int32_t* stab = reinterpret_cast<int32_t*>(smem);
  int32_t* tiles = stab + (kGlobalTables ? 0 : pack_words)
                   + w * kAWarpWords;        // [2][32 lanes][kAPitch]
  const int32_t* tab = kGlobalTables ? pack : stab;  // ragged entries first
  const int32_t* bkt = tab + bucket_at;
  const int32_t* rbase = tab + base_at;
  const int64_t gid = static_cast<int64_t>(img) * lanes + lane;
  const int64_t base = static_cast<int64_t>(img) * steps * lanes + lane;
  const int ntiles = (steps + kATile - 1) / kATile;
  // this thread's share of a tile: rows rr, rr + 4, ..., column cc
  const int rr = l / kATile, cc = l % kATile;
  const int32_t* srows = streams
      + (static_cast<int64_t>(img) * lanes + lane0) * steps;

  // tile s's stream columns of the warp's rows into buffer s & 1
  auto stage = [&](int s) {
    const int c = s * kATile + cc;
    if (s >= ntiles || c >= steps) return;
    int32_t* dst = tiles + (s & 1) * kThreads * kAPitch + cc;
    for (int r = rr; r < nrow; r += kThreads / kATile)
      cp_async4(dst + r * kAPitch, srows + static_cast<int64_t>(r) * steps
                                       + c);
  };
  // tile s's row indexes of this lane (coalesced across the warp)
  auto load_rows = [&](int s, int (&rows)[kATile]) {
#pragma unroll
    for (int j = 0; j < kATile; ++j) {
      const int t = s * kATile + j;
      rows[j] = active && t < steps
                    ? idx[base + static_cast<int64_t>(t) * lanes] : 0;
    }
  };

  // G(-1): the pack (16-byte copies; pack_words is a multiple of 4) and
  // stream tile 0
  if (!kGlobalTables)
    for (int i = 4 * static_cast<int>(threadIdx.x); i < pack_words;
         i += 4 * static_cast<int>(blockDim.x))
      cp_async16(stab + i, pack + i);
  if (live) stage(0);
  cp_async_commit();
  if (!live) {                   // past the last image: helped with the pack
    if (!kGlobalTables) {
      cp_async_wait_all();
      __syncthreads();
    }
    return;
  }
  int next[kATile];
  load_rows(0, next);
  uint32_t x = active ? static_cast<uint32_t>(states[gid]) : 0u;
  int32_t* o = out + base;
  for (int s = 0; s < ntiles; ++s) {
    int rows[kATile];
#pragma unroll
    for (int j = 0; j < kATile; ++j) rows[j] = next[j];
    __syncwarp();                               // buffer (s+1) & 1 is free
    stage(s + 1);
    cp_async_commit();                          // G(s)
    load_rows(s + 1, next);
    cp_async_wait_one();                        // G(s-1): tile s has landed
    if (!kGlobalTables && s == 0) __syncthreads();   // and the pack
    else __syncwarp();
    if (!active) continue;
    const int32_t* tile = tiles + (s & 1) * kThreads * kAPitch + l * kAPitch;
    const int n = min(kATile, steps - s * kATile);
#pragma unroll
    for (int j = 0; j < kATile; ++j) {
      if (j >= n) break;
      const int r = rows[j];
      const int rb = rbase[r];
      const uint32_t chunk = static_cast<uint32_t>(tile[j]);
      const uint32_t slot = x & 0xFFFFu;
      uint32_t st, fr;
      const int e = bucket_lookup(tab, bkt + r * kBucketStride, slot, st,
                                  fr);
      x = fr * (x >> 16) + slot - st;
      if (x < kRansL) x = (x << 16) | chunk;
      *o = e + rb;
      o += lanes;
    }
  }
  if (active) xend[gid] = static_cast<int64_t>(x);
}

// One step of every lane, front t, on the prepared pack read in place.
__global__ void __launch_bounds__(kThreads)
rans_masked_decode_front_kernel(const int32_t* __restrict__ streams,
                                int steps, int t,
                                const int64_t* __restrict__ x_in,
                                const int32_t* __restrict__ pack,
                                int bucket_at, int base_at,
                                const int32_t* __restrict__ idx,
                                const uint8_t* __restrict__ act, int lanes,
                                int m, int32_t* __restrict__ out,
                                int64_t* __restrict__ x_out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  // the loads that do not depend on the table walk, issued together
  const uint32_t x = static_cast<uint32_t>(x_in[lane]);
  const int32_t r = idx[lane];
  const bool on = act[lane / m] != 0;
  const uint32_t chunk = static_cast<uint32_t>(
      streams[static_cast<int64_t>(lane) * steps + t]);
  if (!on) {
    out[lane] = 0;
    x_out[lane] = static_cast<int64_t>(x);
    return;
  }
  const int rb = pack[base_at + r];
  const uint32_t slot = x & 0xFFFFu;
  uint32_t st, fr;
  const int e = bucket_lookup(
      pack, pack + bucket_at + r * kBucketStride, slot, st, fr);
  fr = max(fr, 1u);            // as the JAX step (zoo_jahp_device.py:147)
  uint32_t xn = fr * (x >> 16) + slot - st;
  if (xn < kRansL) xn = (xn << 16) | chunk;
  out[lane] = e + rb;
  x_out[lane] = static_cast<int64_t>(xn);
}

// A measurement aid, not a coder: an empty kernel, launched on the masked
// front decoder's grid, whose device time is the floor no kernel body on
// that grid can go below.
__global__ void __launch_bounds__(kThreads) rans_empty_kernel() {}

// The launch of an aligned encoder on `plan` (the masked one's activity
// map of act_bytes beside its warps); cudaErrorInvalidValue, without
// launching, when the plan needs more shared memory than a block can have.
template <bool kMasked, int kETile>
int encode_aligned_launch(const EncodePlan& plan, size_t act_bytes,
                          const int32_t* enc, int cols, const int32_t* vc,
                          const int32_t* idx, const uint8_t* act, int slots,
                          int m, int num_images, int steps, int lanes,
                          int32_t* streams, int32_t* lengths,
                          int64_t* states, uint8_t* masks,
                          cudaStream_t stream) {
  auto kernel = rans_indexed_encode_aligned_warp_kernel<kMasked, kETile>;
  const size_t smem = encode_aligned_smem(plan, act_bytes);
  if (!fit_smem(kernel, smem)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((lanes + kThreads - 1) / kThreads),
                  static_cast<unsigned>((num_images + plan.group - 1)
                                        / plan.group));
  kernel<<<grid, plan.group * kThreads, smem, stream>>>(
      reinterpret_cast<const uint4*>(enc), cols, vc, idx, act, slots, m,
      num_images, steps, lanes, streams, lengths, states, masks);
  return static_cast<int>(cudaGetLastError());
}

template <bool kMasked>
int encode_aligned(int steps, int slots, int m, int num_images, int lanes,
                   const int32_t* enc, int cols, const int32_t* vc,
                   const int32_t* idx, const uint8_t* act,
                   int32_t* streams, int32_t* lengths, int64_t* states,
                   uint8_t* masks, cudaStream_t stream) {
  const size_t act_bytes = kMasked ? act_smem(steps, slots) : 0;
  const EncodePlan plan = encode_plan(num_images, lanes, act_bytes);
  auto launch = plan.tile == 16 ? encode_aligned_launch<kMasked, 16>
                                : encode_aligned_launch<kMasked, 8>;
  return launch(plan, act_bytes, enc, cols, vc, idx, act, slots, m,
                num_images, steps, lanes, streams, lengths, states, masks,
                stream);
}

}  // namespace

extern "C" {

// Shared memory (bytes) of a batch-1 launch's plan: the encoder at T steps
// with its u16 rows in shared memory (global_rows = 0) or in a device
// buffer; the decoder with a table pack of pack_words int32 in shared
// memory (global_tables = 0) or read in place. And the most a block may
// have on the current device.
int64_t rans_indexed_encode_smem(int steps, int global_rows) {
  return static_cast<int64_t>(encode_smem(steps, global_rows != 0));
}

int64_t rans_indexed_decode_smem(int pack_words, int global_tables) {
  return static_cast<int64_t>(decode_smem(pack_words, global_tables != 0));
}

int rans_indexed_smem_optin() { return smem_optin(); }

// `enc` (R, cols, 4) prepared entries; `rows` null for the shared-row plan,
// else a u16 buffer of k * ceil(N / 32) * 32 * (T + 1) entries
int rans_indexed_encode(const int32_t* enc, int cols, const int32_t* vc,
                        const int32_t* idx, int num_images, int steps,
                        int lanes, int32_t* streams, int32_t* lengths,
                        int64_t* states, uint16_t* rows,
                        cudaStream_t stream) {
  const uint4* entries = reinterpret_cast<const uint4*>(enc);
  const dim3 grid(warp_blocks(num_images, lanes));
  const size_t smem = encode_smem(steps, rows != nullptr);
  if (rows == nullptr) {
    if (!fit_smem(rans_indexed_encode_warp_kernel<false>, smem))
      return static_cast<int>(cudaErrorInvalidValue);
    rans_indexed_encode_warp_kernel<false><<<grid, kThreads, smem, stream>>>(
        entries, cols, vc, idx, steps, lanes, streams, lengths, states,
        nullptr);
  } else {
    if (!fit_smem(rans_indexed_encode_warp_kernel<true>, smem))
      return static_cast<int>(cudaErrorInvalidValue);
    rans_indexed_encode_warp_kernel<true><<<grid, kThreads, smem, stream>>>(
        entries, cols, vc, idx, steps, lanes, streams, lengths, states,
        rows);
  }
  return static_cast<int>(cudaGetLastError());
}

// The plan an aligned indexed encode of k images on `lanes` lanes takes:
// its steps a tile, images a block and shared memory (bytes).
int rans_indexed_encode_aligned_tile(int num_images, int lanes) {
  return encode_plan(num_images, lanes, 0).tile;
}

int rans_indexed_encode_aligned_group(int num_images, int lanes) {
  return encode_plan(num_images, lanes, 0).group;
}

int64_t rans_indexed_encode_aligned_smem(int num_images, int lanes) {
  return static_cast<int64_t>(
      encode_aligned_smem(encode_plan(num_images, lanes, 0), 0));
}

// `enc` as for rans_indexed_encode; `masks` null, or (k, N, T) bytes
int rans_indexed_encode_aligned(const int32_t* enc, int cols,
                                const int32_t* vc, const int32_t* idx,
                                int num_images, int steps, int lanes,
                                int32_t* streams, int32_t* lengths,
                                int64_t* states, uint8_t* masks,
                                cudaStream_t stream) {
  return encode_aligned<false>(steps, 0, 1, num_images, lanes, enc, cols,
                               vc, idx, nullptr, streams, lengths, states,
                               masks, stream);
}

// `pack` the prepared decoder tables (pack_words int32, a multiple of 4,
// 16-byte aligned): ragged entries at 0, coarse bounds at bucket_at, row
// bases at base_at
int rans_indexed_decode(const int32_t* streams, int width,
                        const int64_t* states, const int32_t* pack,
                        int pack_words, int bucket_at, int base_at,
                        int global_tables, const int32_t* idx,
                        int num_images, int steps, int lanes, int32_t* out,
                        int64_t* xend, cudaStream_t stream) {
  if (pack_words % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(warp_blocks(num_images, lanes));
  const size_t smem = decode_smem(pack_words, global_tables != 0);
  if (global_tables == 0) {
    if (!fit_smem(rans_indexed_decode_warp_kernel<false>, smem))
      return static_cast<int>(cudaErrorInvalidValue);
    rans_indexed_decode_warp_kernel<false><<<grid, kThreads, smem, stream>>>(
        streams, width, states, pack, pack_words, bucket_at, base_at, idx,
        steps, lanes, out, xend);
  } else {
    if (!fit_smem(rans_indexed_decode_warp_kernel<true>, smem))
      return static_cast<int>(cudaErrorInvalidValue);
    rans_indexed_decode_warp_kernel<true><<<grid, kThreads, smem, stream>>>(
        streams, width, states, pack, pack_words, bucket_at, base_at, idx,
        steps, lanes, out, xend);
  }
  return static_cast<int>(cudaGetLastError());
}

// The aligned decoder's shared memory at `group` images a block, and the
// group a launch of k images on `lanes` lanes takes.
int64_t rans_indexed_decode_aligned_smem(int pack_words, int global_tables,
                                         int group) {
  return static_cast<int64_t>(
      decode_aligned_smem(pack_words, global_tables != 0, group));
}

int rans_indexed_aligned_group(int num_images, int lanes, int pack_words,
                               int global_tables) {
  return aligned_decode_group(num_images, lanes, pack_words,
                              global_tables != 0);
}

// `pack` as for rans_indexed_decode; `streams` (k, N, T)
int rans_indexed_decode_aligned(const int32_t* streams, int width,
                                const int64_t* states, const int32_t* pack,
                                int pack_words, int bucket_at, int base_at,
                                int global_tables, const int32_t* idx,
                                int num_images, int steps, int lanes,
                                int32_t* out, int64_t* xend,
                                cudaStream_t stream) {
  if (width != steps || pack_words % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int group = aligned_decode_group(num_images, lanes, pack_words,
                                         global_tables != 0);
  const dim3 grid(static_cast<unsigned>((lanes + kThreads - 1) / kThreads),
                  static_cast<unsigned>((num_images + group - 1) / group));
  const size_t smem =
      decode_aligned_smem(pack_words, global_tables != 0, group);
  if (global_tables == 0) {
    if (!fit_smem(rans_indexed_decode_aligned_warp_kernel<false>, smem))
      return static_cast<int>(cudaErrorInvalidValue);
    rans_indexed_decode_aligned_warp_kernel<false>
        <<<grid, group * kThreads, smem, stream>>>(
            streams, states, pack, pack_words, bucket_at, base_at, idx,
            num_images, steps, lanes, out, xend);
  } else {
    if (!fit_smem(rans_indexed_decode_aligned_warp_kernel<true>, smem))
      return static_cast<int>(cudaErrorInvalidValue);
    rans_indexed_decode_aligned_warp_kernel<true>
        <<<grid, group * kThreads, smem, stream>>>(
            streams, states, pack, pack_words, bucket_at, base_at, idx,
            num_images, steps, lanes, out, xend);
  }
  return static_cast<int>(cudaGetLastError());
}

// The masked encoder's shared memory for T fronts of F slots on `lanes`
// lanes (its plan: one image, one warp a block).
int64_t rans_masked_encode_aligned_smem(int steps, int slots, int lanes) {
  const size_t act_bytes = act_smem(steps, slots);
  return static_cast<int64_t>(encode_aligned_smem(
      encode_plan(1, lanes, act_bytes), act_bytes));
}

// `enc` as for rans_indexed_encode
int rans_masked_encode_aligned(const int32_t* enc, int cols,
                               const int32_t* vc, const int32_t* idx,
                               const uint8_t* act, int steps, int lanes,
                               int slots, int m, int32_t* streams,
                               int32_t* lengths, int64_t* states,
                               cudaStream_t stream) {
  if (m <= 0 || lanes != slots * m)
    return static_cast<int>(cudaErrorInvalidValue);
  return encode_aligned<true>(steps, slots, m, 1, lanes, enc, cols, vc, idx,
                              act, streams, lengths, states, nullptr,
                              stream);
}

// `pack` as for rans_indexed_decode, read in place
int rans_masked_decode_front(const int32_t* streams, int steps, int t,
                             const int64_t* x_in, const int32_t* pack,
                             int bucket_at, int base_at, const int32_t* idx,
                             const uint8_t* act, int lanes, int m,
                             int32_t* out, int64_t* x_out,
                             cudaStream_t stream) {
  if (m <= 0 || lanes % m != 0 || t < 0 || t >= steps)
    return static_cast<int>(cudaErrorInvalidValue);
  rans_masked_decode_front_kernel
      <<<blocks_for(1, lanes), kThreads, 0, stream>>>(
          streams, steps, t, x_in, pack, bucket_at, base_at, idx, act,
          lanes, m, out, x_out);
  return static_cast<int>(cudaGetLastError());
}

// The empty kernel on the grid of a masked front of `lanes` lanes.
int rans_launch_floor(int lanes, cudaStream_t stream) {
  rans_empty_kernel<<<blocks_for(1, lanes), kThreads, 0, stream>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
