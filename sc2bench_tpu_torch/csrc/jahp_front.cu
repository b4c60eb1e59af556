// The joint autoregressive codec's context model at one wavefront front,
// for Hopper (sm_90a): the card's path of ContextModel.front_params
// (sc2bench_tpu_torch/models/zoo_jahp.py), which stays as its plain
// version.
//
// It replaces no TPU kernel: the JAX package evaluates a front with XLA's
// ops (sc2bench_tpu/models/zoo_jahp.py, _HostAutoregressive and its device
// twin). On the card those ops ran as about 15 library launches a front
// (a tap gather, a SIMT sgemm with its split-K reduction, bias, cat, three
// more products with LeakyReLU, the float64 scale-index compare, round,
// the write), 61 fronts an image each way.
//
// A front, for F <= 8 of its positions (ii, jj) of an h x w latent, m
// channels (models/zoo_jahp_front.py launches each layer of a wider front
// once a group of at most 8 rows; a row's sums do not depend on the
// others):
//
//   ctx    = taps . K + b          taps (F, 12m) gathered from the
//                                  halo-padded HWC y_hat, K (12m, 2m)
//   h1     = leaky([hyper[ii, jj], ctx] . W1 + b1)      (F, 4m) -> m*10/3
//   h2     = leaky(h1 . W2 + b2)                         -> m*8/3
//   params = h2 . W3 + b3                                -> 2m: scales, means
//   idx    = #{scale_table[:-1] < (double) max(scale, 0.11f)}
//   scan:    sym = rint(y - mean), y_hat[ii, jj] = sym + mean
//   decode:  the means, and after the masked decode step of
//            rans_indexed.cu, y_hat[ii, jj] = sym + mean (jahp_front_write)
//
// What bounds it on this card: the weights and the chain of dependent
// steps. A front at m = 320 reads 21.1 MB of float32 weights (3840x640,
// 1280x1066, 1066x853, 853x640) and does about 63 MFLOP: the weights fit in
// the 50 MB L2, so a front is bound near 5-6 us by the card's L2 bandwidth
// (about 3.9 TB/s when every SM reads) or 6.3 us by device memory, near 1
// us by float32 FMA. The rows are few (F <= 8), so each layer is a product
// of a handful of rows by a wide matrix, four such layers in a row, and
// each step's latency (a launch, a gather, a reduction across blocks)
// counts as much as its bytes.
//
// What the design does about it: one launch a layer (four a front), each
// spreading its weight matrix over the whole card. Output columns are cut
// into tiles of TN = 64 and K into KS = 8 slices; the 8 blocks of one
// column tile form a thread block cluster. Each launch lets the next one
// start at once (programmatic dependent launch), so a block copies its
// (K/8) x 64 slice of the weights into shared memory with cp.async, and
// loads its bias, the scale table, y and the hyper feature, while the
// previous layer still runs; then it waits, stages its slice of the F
// input rows (the taps, the context features or the previous layer's
// activations), and sums 4 rows x 4 columns at a step with F x 4 sums a
// thread in registers. The sums are reduced in a fixed order: rows
// ascending within a thread, a shuffle butterfly over a warp, the warps in
// order, then the cluster's eight slices in rank order, pushed into the
// shared memory of the block that finishes them, then the bias. No
// atomics: the encoder's and the decoder's fronts run the same launches on
// the same shapes and give the same bits, which the wire needs. Float32
// FFMA only (the configuration keeps TF32 off). The last layer's epilogue
// computes the scale index, and in the scan the symbol and the y_hat
// write, so a scan front is four launches and a decode front four, the
// masked decode step and one write. A front's positions and the taps go
// by value in each launch's arguments.
//
// Weights are given with their columns zero-padded to a multiple of TN
// and, from the third layer on, their rows zero-padded to the previous
// layer's padded width (models/zoo_jahp_front.py pads them once); a
// padded column's activation is leaky(0) = 0, so it adds nothing.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int TN = 64;                 // output columns of a cluster
constexpr int QUADS = TN / 4;          // threads across a weight row
constexpr int KG = THREADS / QUADS;    // weight rows a block reads at once
constexpr int WARPS = THREADS / 32;
constexpr int KS = 8;                  // blocks of a cluster: slices of K
constexpr int MAX_SLOTS = 8;
constexpr int MAX_TAPS = 16;
constexpr int HALO = 2;

enum In { IN_TAPS, IN_HYPER, IN_ACT };
enum Out { OUT_ACT, OUT_LEAKY, OUT_SCAN, OUT_DECODE };

// A front's positions and the causal taps, by value: a graph replay keeps
// them with its launch, and no load of them stands before a gather.
struct Front {
  int ii[MAX_SLOTS];         // row of each slot, -1 in pad slots (row 0 read)
  int jj[MAX_SLOTS];
  signed char dr[MAX_TAPS];  // tap offsets into the halo-padded y_hat
  signed char dc[MAX_TAPS];
  int w, m;
};

struct Layer {
  Front p;
  // input: IN_TAPS y_hat (h+4, w+4, m) at the taps; IN_HYPER hyper (h, w,
  // 2m) then src (F, src_stride); IN_ACT src (F, src_stride)
  const float* src;
  int src_stride;
  const float* hyper;
  // product: weight (K, np) row-major, bias (np,)
  const float* weight;
  const float* bias;
  int K, np;
  // output: OUT_ACT / OUT_LEAKY out (F, np); OUT_DECODE out = means (F, m);
  // idxs (F, m) (OUT_SCAN, OUT_DECODE), and scales (F, m) where given;
  // OUT_SCAN y (h, w, m) -> syms (F, m) and y_hat
  float* out;
  float* scales;
  int* idxs;
  int* syms;
  const float* y;
  float* y_hat;
  const double* table;
  int table_n;
};

// rows of K a block takes: a multiple of 4, so a thread reads 4 rows at once
__host__ __device__ inline int slice_rows(int K) {
  return ((K + KS - 1) / KS + 3) & ~3;
}

// Shared memory: the scale table (the last layer), the weight slice
// [tk][TN], the input slice [F][tk], the warps' sums [WARPS][F][TN] and the
// cluster's sums of the outputs the block finishes [KS][F*TN/KS]; each part
// starts on 16 bytes.
__host__ __device__ inline int table_words(int table_n) {
  return (table_n + 1) & ~1;                 // doubles
}

__host__ __device__ inline int slice_words(int slots, int K) {
  return slots * slice_rows(K);              // floats
}

__host__ __device__ inline size_t layer_smem(int slots, int K, int table_n) {
  return sizeof(double) * (size_t)table_words(table_n)
         + sizeof(float) * ((size_t)slice_rows(K) * TN
                            + (size_t)slice_words(slots, K)
                            + (size_t)WARPS * slots * TN
                            + (size_t)KS * ((slots * TN + KS - 1) / KS));
}

template <int IN>
__device__ __forceinline__ float input_at(const Layer& a, int f, int k) {
  const int i = max(a.p.ii[f], 0), j = a.p.jj[f], m = a.p.m;
  if (IN == IN_TAPS) {
    const int tap = k / m, c = k - tap * m;
    const size_t pos = (size_t)(i + a.p.dr[tap]) * (a.p.w + 2 * HALO)
                       + j + a.p.dc[tap];
    return a.src[pos * m + c];
  } else if (IN == IN_HYPER) {
    if (k < 2 * m) return a.hyper[((size_t)i * a.p.w + j) * 2 * m + k];
    return a.src[(size_t)f * a.src_stride + k - 2 * m];
  } else {
    return a.src[(size_t)f * a.src_stride + k];
  }
}

// Programmatic dependent launch: each launch lets the next one in its
// stream start at once. Before it waits for the previous launch to finish,
// a launch reads only what no launch of a loop writes: its weights and
// bias, the scale table, y and the hyper feature (each loop's inputs,
// complete before its first launch starts).
__device__ __forceinline__ void let_next_launch_start() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ void wait_for_previous_launch() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// A split cluster barrier: every block of the cluster arrives at its
// start, and waits before its first store into another block's shared
// memory, so that the other block has started.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// 16 bytes from device to shared memory, in flight until cp_async_wait.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;" :::
                   "memory");
}

// acc += x[f][k..k+3] . w[k..k+3][4 columns], the 4 rows in order.
template <int F>
__device__ __forceinline__ void fma_rows4(float (&acc)[F][4], const float* x,
                                          int stride, const float* w) {
  float4 wr[4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
    wr[r] = *reinterpret_cast<const float4*>(w + r * TN);
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const float4 v = *reinterpret_cast<const float4*>(x + f * stride);
    const float vr[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      acc[f][0] = fmaf(vr[r], wr[r].x, acc[f][0]);
      acc[f][1] = fmaf(vr[r], wr[r].y, acc[f][1]);
      acc[f][2] = fmaf(vr[r], wr[r].z, acc[f][2]);
      acc[f][3] = fmaf(vr[r], wr[r].w, acc[f][3]);
    }
  }
}

// The row of the Gaussian tables of a scale, as scale_indexes counts it.
__device__ __forceinline__ int scale_index(float s, const double* table,
                                           int n) {
  const double v = (double)fmaxf(s, 0.11f);
  int c = 0;
  for (int i = 0; i < n; ++i) c += v > table[i];
  return c;
}

// Output (f, n) = v; `yv` is y at (f, n - m) in the scan.
template <int OUT>
__device__ __forceinline__ void finish(const Layer& a, const double* table,
                                       int f, int n, float v, float yv) {
  if (OUT == OUT_ACT) {
    a.out[(size_t)f * a.np + n] = v;
    return;
  }
  if (OUT == OUT_LEAKY) {
    a.out[(size_t)f * a.np + n] = v > 0.f ? v : 0.01f * v;
    return;
  }
  const int m = a.p.m;
  if (n >= 2 * m) return;                        // a padded column
  if (n < m) {
    if (a.scales != nullptr) a.scales[f * m + n] = v;
    a.idxs[f * m + n] = scale_index(v, table, a.table_n);
    return;
  }
  const int c = n - m;
  if (OUT == OUT_DECODE) {
    a.out[f * m + c] = v;
    return;
  }
  const int i = a.p.ii[f], j = a.p.jj[f];
  const float sym = rintf(yv - v);
  a.syms[f * m + c] = (int)sym;
  if (i >= 0)
    a.y_hat[((size_t)(i + HALO) * (a.p.w + 2 * HALO) + j + HALO) * m + c] =
        sym + v;
}

// One layer of a front: grid (np / TN, KS), clusters of the KS blocks of a
// column tile (the file's notes).
template <int F, int IN, int OUT>
__global__ void __cluster_dims__(1, KS, 1) __launch_bounds__(THREADS)
    front_layer(const Layer a) {
  let_next_launch_start();
  cluster_arrive();
  constexpr bool LAST = OUT == OUT_SCAN || OUT == OUT_DECODE;
  extern __shared__ double smem[];
  const int tn = LAST ? a.table_n : 0;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tk = slice_rows(a.K);
  const int k0 = rank * tk, k1 = min(a.K, k0 + tk), nk = max(k1 - k0, 0);
  double* table = smem;                                // [table_n]
  float* ws = reinterpret_cast<float*>(smem + table_words(tn));  // [tk][TN]
  float* xs = ws + tk * TN;                            // [F][tk]
  float* red = xs + slice_words(F, a.K);               // [WARPS][F][TN]
  float* inbox = red + WARPS * F * TN;                 // [KS][per]

  // before the wait: the block's weight slice in flight, the bias (and y)
  // of the outputs this block finishes, the table, the hyper feature
  const float* wsrc = a.weight + (size_t)k0 * a.np + blockIdx.x * TN;
  for (int e = threadIdx.x; e < nk * QUADS; e += THREADS) {
    const int r = e / QUADS, c = e - r * QUADS;
    cp_async16(ws + r * TN + 4 * c, wsrc + (size_t)r * a.np + 4 * c);
  }
  const int per = (F * TN + KS - 1) / KS;
  const int o = rank * per + threadIdx.x;
  const bool finishes = threadIdx.x < per && o < F * TN;
  const int fo = finishes ? o / TN : 0;
  const int n = blockIdx.x * TN + o - fo * TN;
  float bias = 0.f, yv = 0.f;
  if (finishes) {
    bias = __ldg(a.bias + n);
    const int m = a.p.m;
    if (OUT == OUT_SCAN && n >= m && n < 2 * m)
      yv = __ldg(a.y + ((size_t)max(a.p.ii[fo], 0) * a.p.w + a.p.jj[fo]) * m
                 + n - m);
  }
  for (int i = threadIdx.x; i < tn; i += THREADS) table[i] = a.table[i];
  for (int e = threadIdx.x; e < F * nk; e += THREADS) {
    const int f = e / nk, k = k0 + e - f * nk;
    if (IN == IN_HYPER && k < 2 * a.p.m)
      xs[f * tk + k - k0] = input_at<IN>(a, f, k);
  }
  wait_for_previous_launch();

  for (int e = threadIdx.x; e < F * nk; e += THREADS) {
    const int f = e / nk, k = k0 + e - f * nk;
    if (IN != IN_HYPER || k >= 2 * a.p.m)
      xs[f * tk + k - k0] = input_at<IN>(a, f, k);
  }
  // rows nk up to a multiple of 4 read as zeros
  const int nk4 = (nk + 3) & ~3;
  for (int e = threadIdx.x; e < (nk4 - nk) * (F + TN); e += THREADS) {
    const int r = nk + e % (nk4 - nk), c = e / (nk4 - nk);
    if (c < F) xs[c * tk + r] = 0.f;
    else ws[r * TN + c - F] = 0.f;
  }
  cp_async_wait();
  __syncthreads();

  // rows 4g .. 4g + 3, then 4(g + KG) .., of the slice, 4 columns a thread
  const int q = threadIdx.x % QUADS, g = threadIdx.x / QUADS;
  float acc[F][4];
#pragma unroll
  for (int f = 0; f < F; ++f)
    acc[f][0] = acc[f][1] = acc[f][2] = acc[f][3] = 0.f;
#pragma unroll 2
  for (int k = 4 * g; k < nk4; k += 4 * KG)
    fma_rows4<F>(acc, xs + k, tk, ws + k * TN + 4 * q);

  // a warp's row groups (lanes q, q + QUADS, ...), a butterfly
#pragma unroll
  for (int f = 0; f < F; ++f)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int lanes = QUADS; lanes < 32; lanes *= 2)
        acc[f][j] += __shfl_xor_sync(0xffffffffu, acc[f][j], lanes);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane < QUADS) {
#pragma unroll
    for (int f = 0; f < F; ++f)
      *reinterpret_cast<float4*>(red + (warp * F + f) * TN + 4 * lane) =
          make_float4(acc[f][0], acc[f][1], acc[f][2], acc[f][3]);
  }
  __syncthreads();
  // the block's sums, each into the inbox of the block that finishes it
  cluster_wait();
  for (int e = threadIdx.x; e < F * TN; e += THREADS) {
    float s = red[e];
    for (int wi = 1; wi < WARPS; ++wi) s += red[wi * F * TN + e];
    const int owner = e / per;
    *cluster.map_shared_rank(inbox + rank * per + e - owner * per, owner) = s;
  }
  cluster.sync();

  // the cluster's slices, in rank order; each block finishes F*TN/KS sums
  if (finishes) {
    float s = inbox[threadIdx.x];
    for (int r = 1; r < KS; ++r) s += inbox[r * per + threadIdx.x];
    finish<OUT>(a, table, fo, n, s + bias, yv);
  }
}

// The decoder's write: y_hat[ii, jj] = sym + mean on the active slots.
__global__ void front_write(const Front p, int slots, const int* sym,
                            const float* means, float* y_hat) {
  let_next_launch_start();
  wait_for_previous_launch();
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int m = p.m;
  if (e >= slots * m) return;
  const int f = e / m, c = e - f * m, i = p.ii[f];
  if (i < 0) return;
  y_hat[((size_t)(i + HALO) * (p.w + 2 * HALO) + p.jj[f] + HALO) * m + c] =
      (float)sym[e] + means[e];
}

// A launch that the next launch in `stream` may overlap (the notes above
// let_next_launch_start).
template <typename... Params, typename... Args>
cudaError_t launch_overlapped(void (*kernel)(Params...), dim3 grid,
                              int block, size_t smem, cudaStream_t stream,
                              Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(block);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <int F, int IN, int OUT>
cudaError_t launch_f(const Layer& a, cudaStream_t stream) {
  const bool last = OUT == OUT_SCAN || OUT == OUT_DECODE;
  const size_t smem = layer_smem(F, a.K, last ? a.table_n : 0);
  cudaError_t e = launch_overlapped(front_layer<F, IN, OUT>,
                                    dim3(a.np / TN, KS), THREADS, smem,
                                    stream, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int IN, int OUT>
cudaError_t opt_in(int bytes) {
  void (*kernels[])(const Layer) = {
      front_layer<1, IN, OUT>, front_layer<2, IN, OUT>,
      front_layer<3, IN, OUT>, front_layer<4, IN, OUT>,
      front_layer<5, IN, OUT>, front_layer<6, IN, OUT>,
      front_layer<7, IN, OUT>, front_layer<8, IN, OUT>};
  for (auto kernel : kernels) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

template <int IN, int OUT>
int launch(int slots, const Layer& a, cudaStream_t stream) {
  if (a.np % TN != 0 || a.K <= 0) return (int)cudaErrorInvalidValue;
  switch (slots) {
    case 1: return (int)launch_f<1, IN, OUT>(a, stream);
    case 2: return (int)launch_f<2, IN, OUT>(a, stream);
    case 3: return (int)launch_f<3, IN, OUT>(a, stream);
    case 4: return (int)launch_f<4, IN, OUT>(a, stream);
    case 5: return (int)launch_f<5, IN, OUT>(a, stream);
    case 6: return (int)launch_f<6, IN, OUT>(a, stream);
    case 7: return (int)launch_f<7, IN, OUT>(a, stream);
    case 8: return (int)launch_f<8, IN, OUT>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The front of `slots` positions pos = (ii[0..slots), jj[0..slots)) of a
// latent w wide, m channels, and the taps (dr, dc) where given.
bool front_of(Front* p, int slots, const int* pos, int w, int m,
              const int* taps, int n_taps) {
  if (slots < 1 || slots > MAX_SLOTS || n_taps > MAX_TAPS) return false;
  *p = Front{};
  for (int f = 0; f < slots; ++f) {
    p->ii[f] = pos[f];
    p->jj[f] = pos[slots + f];
  }
  for (int t = 0; t < n_taps; ++t) {
    p->dr[t] = (signed char)taps[t];
    p->dc[t] = (signed char)taps[n_taps + t];
  }
  p->w = w;
  p->m = m;
  return true;
}

}  // namespace

extern "C" {

// Shared memory bytes a block of a layer with K input rows takes at
// `slots` positions (with a scale table of table_n entries for the last
// layer); -1 beyond the kernels' positions a front.
long long jahp_front_smem(int slots, int K, int table_n) {
  if (slots < 1 || slots > MAX_SLOTS) return -1;
  return (long long)layer_smem(slots, K, table_n);
}

int jahp_front_max_slots() { return MAX_SLOTS; }

// Lets every layer kernel take up to `bytes` of shared memory on the
// current device (a block's opt-in); before the first launch there.
int jahp_front_init(int bytes) {
  cudaError_t e = opt_in<IN_TAPS, OUT_ACT>(bytes);
  if (e == cudaSuccess) e = opt_in<IN_HYPER, OUT_LEAKY>(bytes);
  if (e == cudaSuccess) e = opt_in<IN_ACT, OUT_LEAKY>(bytes);
  if (e == cudaSuccess) e = opt_in<IN_ACT, OUT_SCAN>(bytes);
  if (e == cudaSuccess) e = opt_in<IN_ACT, OUT_DECODE>(bytes);
  return (int)e;
}

int jahp_front_max_taps() { return MAX_TAPS; }

int jahp_front_tile() { return TN; }

// `pos` is a host array: the front's rows ii then its columns jj, `slots`
// each (ii < 0 in pad slots); `taps` the taps' row offsets then their
// column offsets. The launches copy both.

// Layer 1: ctx (F, np) = taps . weight + bias, the taps of the positions
// gathered from y_hat (h+4, w+4, m); K = n_taps * m.
int jahp_front_ctx(int slots, const int* pos, int w, int m, const int* taps,
                   int n_taps, const float* y_hat, const float* weight,
                   const float* bias, int np, float* out,
                   cudaStream_t stream) {
  Layer a = {};
  if (!front_of(&a.p, slots, pos, w, m, taps, n_taps))
    return (int)cudaErrorInvalidValue;
  a.src = y_hat;
  a.weight = weight;
  a.bias = bias;
  a.K = n_taps * m;
  a.np = np;
  a.out = out;
  return launch<IN_TAPS, OUT_ACT>(slots, a, stream);
}

// Layers 2 and 3: out (F, np) = leaky(x . weight + bias); x = [hyper[ii,
// jj], src[:, :2m]] (K = 4m) when `hyper` is given, else src[:, :K].
int jahp_front_hidden(int slots, const int* pos, int w, int m,
                      const float* hyper, const float* src, int src_stride,
                      int K, const float* weight, const float* bias, int np,
                      float* out, cudaStream_t stream) {
  Layer a = {};
  if (!front_of(&a.p, slots, pos, w, m, nullptr, 0))
    return (int)cudaErrorInvalidValue;
  a.hyper = hyper;
  a.src = src;
  a.src_stride = src_stride;
  a.weight = weight;
  a.bias = bias;
  a.K = K;
  a.np = np;
  a.out = out;
  return hyper != nullptr ? launch<IN_HYPER, OUT_LEAKY>(slots, a, stream)
                          : launch<IN_ACT, OUT_LEAKY>(slots, a, stream);
}

// Layer 4: params = src . weight + bias, split into scales (the rows
// `idxs` (F, m) of `table`, table_n entries compared) and means. With `y`
// (h, w, m) the scan's tail: syms (F, m) = rint(y[ii, jj] - mean) and
// y_hat[ii, jj] = sym + mean on the active slots; else `means` (F, m).
// `scales` (F, m), where given, gets the scales.
int jahp_front_params(int slots, const int* pos, int w, int m,
                      const float* src, int src_stride, int K,
                      const float* weight, const float* bias, int np,
                      const double* table, int table_n, const float* y,
                      float* y_hat, int* syms, int* idxs, float* means,
                      float* scales, cudaStream_t stream) {
  Layer a = {};
  if (np < 2 * m || !front_of(&a.p, slots, pos, w, m, nullptr, 0))
    return (int)cudaErrorInvalidValue;
  a.src = src;
  a.src_stride = src_stride;
  a.weight = weight;
  a.bias = bias;
  a.K = K;
  a.np = np;
  a.table = table;
  a.table_n = table_n;
  a.idxs = idxs;
  a.scales = scales;
  if (y != nullptr) {
    a.y = y;
    a.y_hat = y_hat;
    a.syms = syms;
    return launch<IN_ACT, OUT_SCAN>(slots, a, stream);
  }
  a.out = means;
  return launch<IN_ACT, OUT_DECODE>(slots, a, stream);
}

// The decoder's write of a front: y_hat[ii, jj] = sym + mean, sym (F * m)
// int32 and means (F, m) float32, on the slots with ii >= 0.
int jahp_front_write(int slots, const int* pos, int w, int m, const int* sym,
                     const float* means, float* y_hat, cudaStream_t stream) {
  Front p;
  if (!front_of(&p, slots, pos, w, m, nullptr, 0))
    return (int)cudaErrorInvalidValue;
  const int n = slots * m;
  cudaError_t e = launch_overlapped(front_write, dim3((n + 255) / 256), 256,
                                    0, stream, p, slots, sym, means, y_hat);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // extern "C"
