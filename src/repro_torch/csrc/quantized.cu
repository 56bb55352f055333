// int8 symmetric per-channel quantization and the fused int8 GEMM for
// Hopper (sm_90a): three kernels behind a plain C interface.
//
// Replaces the three Pallas TPU kernels of repro/kernels/quantized.py:
//   * quantize_rowwise  (:64)  scale = max|x| / 127 per row (1.0 on an
//     all-zero row), q = clip(round_half_even(x / scale), -127, 127);
//     x in float32, bfloat16 or float16, which the Pallas body casts to
//     float32 first: the kernel converts each element exactly as it loads
//     it, so a half-type call equals the float32 call on the up-cast rows
//     bit for bit;
//   * dequantize_rowwise (:89) out = float(q) * scale[m];
//   * int8_matmul        (:123) out[m, n] = (float(acc) * sx[m]) * sw[n]
//     with acc = sum_k xq[m, k] * wq[k, n] exact in int32.
// Both divisions are IEEE divisions (__fdiv_rn: no reciprocal, no
// fast-math flag), rounding is rintf (half to even, like jnp.round) and
// the max is exact in any order, so each kernel is bit-equal to its plain
// PyTorch version in kernels/quantized.py.
//
// What bounds them on this card. The quantized glass tier calls them per
// text layer at M = 64 tokens: the GEMMs are (64,312)x(312,936),
// (64,312)x(312,312), (64,312)x(312,1200) and (64,1200)x(1200,312), at
// most 48 MOP and 0.7 MB each. At the H100 SXM's published peaks (700 W
// limit) that is ~0.02 us of int8 tensor-core time (1,979 TOP/s) and
// ~0.2 us of HBM traffic (3.35 TB/s); the quantize/dequantize passes move
// a few hundred KB at most (0.03-0.11 us). What bounds a call is latency:
// the launch itself (~2 us back to back for an empty kernel, whatever it
// moves), then the chain of dependent steps each thread walks — memory
// round trips, and IEEE divisions, which are serial since each one
// branches on its exceptional cases — and how many SMs share the loads.
//
// What the design does about that.
// Quantize takes one of three forms, as the host's plan_quantize picks
// from the view's strides (kernels/quantized.py):
//   * rows (x_sk == 1, K <= 2,048): tpr threads a row (a warp at
//     K <= 128, 3 warps at K = 312, 8 at K = 1200), so a thread holds 1-2
//     slots of 4 elements. Each thread issues all its loads before it uses
//     any — one 16-byte (float32) or 8-byte (bf16, fp16) load a slot when
//     the row starts on that many bytes, else 4 scalar loads in its
//     place — so the row costs one memory round trip. The
//     abs-max takes 5 shuffles (and one barrier across a row's warps),
//     the scale one division, and q comes from the registers, 4 int8
//     stored as one 32-bit word where K % 4 == 0. Nothing is read twice.
//   * cols (x_sm == 1: quantize_colwise's view w.T, row m of the view is
//     column m of w): a block takes 32 columns, each lane one column, and
//     reads rows of w 128 bytes at a time (coalesced). K is split over
//     a cluster of up to 8 blocks, each holding its rows in registers;
//     each block stores its partial abs-maxes into every block's shared
//     memory (distributed shared memory) ahead of one cluster barrier,
//     and writes its q bytes through a shared-memory transpose (an odd
//     word pitch: no bank conflicts), so every row of q is stored as
//     contiguous words.
//   * loop (K over either form's cap, or any other stride pair): 1-8
//     warps a row, two passes over it with 8 loads in flight a thread.
// Dequantize is a grid-stride loop, an element a thread, the row's scale
// at i / K: at the tiered path's shapes (M = 1, K <= 312) its time is the
// launch's, and a row-indexed body measured no faster (PERF.md).
// Both launch through cudaLaunchKernelEx with programmatic stream
// serialization (PDL): the kernel may be scheduled while its predecessor
// in the stream drains, which took ~1 us off every call back to back and
// off quantize-then-GEMM on the H100 (PERF.md, section 6). It touches no
// global memory, read or write, before griddepcontrol.wait (the caching
// allocator may hand it memory a predecessor still reads), and lets its
// own dependents be scheduled once its loads are issued.
// The GEMM runs on the int8 tensor cores: one warpgroup a
// block issues wgmma.m64n64k32.s32.s8.s8 over a 64 x 64 output tile
// (M = 64, the text layer's rows, is one row tile; other M and the N
// tail are zero-filled). Both operands sit in shared memory in wgmma's
// K-major layout without swizzle: xq (M, K) is K-major as it lies and
// goes in by 4-byte cp.async; wq (K, N) is row-major, as quantize_colwise
// lays it out, and is transposed to (n, k) on the way in, 4 x 4 bytes at
// a time in registers. K stages of 64 bytes are double-buffered, the
// next one loading while wgmma runs, and the K tail (K = 312, 100, 6 and
// 3 occur) is zero-filled to the next 32. K is split across the blocks
// of a thread-block cluster (up to 8, the host's plan_k_splits picks
// about one wave of the 132 SMs: 5 N tiles x 8 K chunks of 160 at
// (64,1200)x(1200,312)); the int32 partials are summed through
// distributed shared memory before the scale, and integer addition is
// exact in any order, so the GEMM stays bit-equal to its plain version.
// Operands that are not 4-byte aligned (K or N not a multiple of 4) are
// staged byte by byte.
//
// C interface (bound with ctypes): pointers as void*, sizes and strides in
// elements, quantize's plan fields, the CUDA stream last; each entry point
// returns the launch's CUDA error as an int (0 on success).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// ------------------------------------------------- quantize, dequantize

constexpr int ROWS_VECS = 2;            // rows form: float4 slots a thread
constexpr int MAX_WARPS = 8;            // rows / loop: warps a block
constexpr int COL_MAX_WARPS = 32;       // cols form: warps a block, a lane a column
constexpr int COL_TILE = 384;           // cols form: rows of w a block takes at most
constexpr int MAX_CLUSTER = 8;          // portable cluster size
constexpr int LOOP_UNROLL = 8;          // loop form: loads in flight a thread

enum Form { ROWS = 0, ROWS_SCALAR = 1, COLS = 2, LOOP = 3 };

// T: the element type of x (float, __nv_bfloat16 or __half)
template <typename T>
struct Quant {
  const T* x;                           // (M, K) view: x[m * x_sm + k * x_sk]
  int8_t* q;                            // (M, K) contiguous
  float* scale;                         // (M,)
  int M, K;
  long long x_sm, x_sk;
  int tpr;                              // rows / loop: threads a row (32 .. 256)
  int kchunk;                           // cols: rows of w a block of the cluster takes
};

// PDL: wait for the stream's predecessors (a no-op without the launch
// attribute), and let this grid's dependents be scheduled
__device__ __forceinline__ void grid_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void grid_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// an element of x as float32, exactly
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

// 4 contiguous elements from p in one load (16 bytes of float32, 8 of a
// half type; p aligned to that), as float32
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}
template <typename TH>
__device__ __forceinline__ void load4(const TH* p, float (&v)[4]) {
  static_assert(sizeof(TH) == 2, "bf16 or fp16");
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  const unsigned short h[4] = {
      static_cast<unsigned short>(w.x & 0xffffu), static_cast<unsigned short>(w.x >> 16),
      static_cast<unsigned short>(w.y & 0xffffu), static_cast<unsigned short>(w.y >> 16)};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    TH x;
    *reinterpret_cast<unsigned short*>(&x) = h[e];
    v[e] = to_f32(x);
  }
}

__device__ __forceinline__ float scale_of(float amax) {
  return amax > 0.0f ? __fdiv_rn(amax, 127.0f) : 1.0f;
}

// clip(rint(v / s)). An exact zero divides s by itself instead and is
// selected back to 0 (0 / s is 0): a zero numerator sends the IEEE
// division down its slow path (all-zero rows took 2x a random row's time
// on the H100), and a branch around it would serialize the divisions.
__device__ __forceinline__ int8_t quant1(float v, float s) {
  const bool zero = v == 0.0f;
  const float r = rintf(__fdiv_rn(zero ? s : v, s));
  return static_cast<int8_t>(zero ? 0.0f : fminf(fmaxf(r, -127.0f), 127.0f));
}

__device__ __forceinline__ uint32_t pack4(const int8_t (&b)[4]) {
  return static_cast<uint32_t>(static_cast<uint8_t>(b[0])) |
         static_cast<uint32_t>(static_cast<uint8_t>(b[1])) << 8 |
         static_cast<uint32_t>(static_cast<uint8_t>(b[2])) << 16 |
         static_cast<uint32_t>(static_cast<uint8_t>(b[3])) << 24;
}

__device__ __forceinline__ float warp_max(float a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, off));
  return a;
}

// the max over the tpr threads of this thread's row (tpr a multiple of
// 32); every thread of the block calls it
__device__ __forceinline__ float row_max(float a, int tpr) {
  __shared__ float red[MAX_WARPS];
  a = warp_max(a);
  if (tpr == 32) return a;
  const int warp = threadIdx.x >> 5, w0 = warp - warp % (tpr >> 5);
  if ((threadIdx.x & 31) == 0) red[warp] = a;
  __syncthreads();
  for (int w = 0; w < (tpr >> 5); ++w) a = fmaxf(a, red[w0 + w]);
  return a;
}

// rows form: tpr threads a row; thread t of the row holds elements
// 4 (tpr j + t) .. + 3 for j < NV in registers. VEC: one load of 4
// elements (the row starts on 4 elements' bytes), else four scalar loads
// in its place.
template <typename T, bool VEC, int NV>
__global__ void __launch_bounds__(MAX_WARPS * 32)
quantize_rows_kernel(const Quant<T> a) {
  const int tpr = a.tpr, t = threadIdx.x % tpr;
  const int m = blockIdx.x * (blockDim.x / tpr) + threadIdx.x / tpr;
  const bool live = m < a.M;
  const int K = a.K;
  const T* row = a.x + static_cast<long long>(live ? m : 0) * a.x_sm;
  float v[NV][4];
  grid_wait();
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int k = 4 * (tpr * j + t);
    if (VEC && live && k + 3 < K) {
      load4(row + k, v[j]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[j][e] = live && k + e < K ? to_f32(row[k + e]) : 0.0f;
    }
  }
  grid_launch_dependents();
  float amax = 0.0f;
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) amax = fmaxf(amax, fabsf(v[j][e]));
  const float s = scale_of(row_max(amax, tpr));
  if (!live) return;
  int8_t* out = a.q + static_cast<long long>(m) * K;
  const bool words = (K & 3) == 0;      // the row starts 4-byte aligned
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int k = 4 * (tpr * j + t);
    if (k >= K) break;
    int8_t b[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) b[e] = quant1(v[j][e], s);
    if (words) {
      *reinterpret_cast<uint32_t*>(out + k) = pack4(b);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k + e < K) out[k + e] = b[e];
    }
  }
  if (t == 0) a.scale[m] = s;
}

// loop form: tpr threads a row, any strides, two passes over the row
// with LOOP_UNROLL loads in flight a thread
template <typename T>
__global__ void __launch_bounds__(MAX_WARPS * 32)
quantize_loop_kernel(const Quant<T> a) {
  const int tpr = a.tpr, t = threadIdx.x % tpr;
  const int m = blockIdx.x * (blockDim.x / tpr) + threadIdx.x / tpr;
  const bool live = m < a.M;
  const int K = live ? a.K : 0;
  const T* row = a.x + static_cast<long long>(live ? m : 0) * a.x_sm;
  const long long sk = a.x_sk;
  grid_wait();
  float amax = 0.0f;
  for (int k0 = 0; k0 < K; k0 += tpr * LOOP_UNROLL) {
    float f[LOOP_UNROLL];
#pragma unroll
    for (int u = 0; u < LOOP_UNROLL; ++u) {
      const int k = k0 + tpr * u + t;
      f[u] = k < K ? to_f32(row[k * sk]) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < LOOP_UNROLL; ++u) amax = fmaxf(amax, fabsf(f[u]));
  }
  grid_launch_dependents();
  const float s = scale_of(row_max(amax, tpr));
  if (!live) return;
  int8_t* out = a.q + static_cast<long long>(m) * K;
  for (int k0 = 0; k0 < K; k0 += tpr * LOOP_UNROLL) {
    float f[LOOP_UNROLL];
#pragma unroll
    for (int u = 0; u < LOOP_UNROLL; ++u) {
      const int k = k0 + tpr * u + t;
      f[u] = k < K ? to_f32(row[k * sk]) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < LOOP_UNROLL; ++u) {
      const int k = k0 + tpr * u + t;
      if (k < K) out[k] = quant1(f[u], s);
    }
  }
  if (t == 0) a.scale[m] = s;
}

// cluster barrier halves: arrive (relaxed: orders nothing, or release:
// orders this thread's shared-memory writes, remote ones included) and
// wait (acquire)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// cols form: x_sm == 1, so the view's row m is column m of w (K, M) with
// row stride x_sk. Block (g, z) takes columns m0 = 32 g .. m0 + 31, lane
// l column m0 + l, and rows k of w in [z kchunk, (z + 1) kchunk): warp w
// of W holds rows kb + w + W i (i < NR) in registers, so every load of a
// warp is 128 contiguous bytes. CLUSTER: the gridDim.y blocks of a
// column group form a cluster; each block stores its partial abs-maxes
// into every block's shared memory and one barrier later reads them all
// locally, so no block reads another's memory and none waits at exit.
template <typename T, int NR, bool CLUSTER>
__global__ void __launch_bounds__(COL_MAX_WARPS * 32)
quantize_cols_kernel(const Quant<T> a) {
  __shared__ float red[COL_MAX_WARPS][32];
  __shared__ float parts[MAX_CLUSTER][32];   // [z][lane]: block z's abs-max
  __shared__ float s_col[32];
  __shared__ __align__(16) int8_t tile[32 * (COL_TILE + 4)];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int z = blockIdx.y, nz = gridDim.y;
  const int m0 = blockIdx.x * 32, m = m0 + lane;
  const int kb = z * a.kchunk, ke = min(a.K, kb + a.kchunk), n = ke - kb;
  // row pitch of the tile: an odd number of words, so the 32 lanes'
  // byte writes of one row k fall in 32 banks
  const int pitch = 4 * ((((n + 3) >> 2)) | 1);
  // every block of the cluster has started before any stores into it
  if constexpr (CLUSTER) cluster_arrive_relaxed();
  grid_wait();
  float v[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int kk = warp + nwarps * i;
    v[i] = (m < a.M && kk < n) ? to_f32(a.x[m + static_cast<long long>(kb + kk) * a.x_sk])
                               : 0.0f;
  }
  grid_launch_dependents();
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < NR; ++i) amax = fmaxf(amax, fabsf(v[i]));
  red[warp][lane] = amax;
  __syncthreads();
  float b = 0.0f;
  if (warp == 0)
    for (int w = 0; w < nwarps; ++w) b = fmaxf(b, red[w][lane]);
  if constexpr (CLUSTER) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster_wait();
    if (warp == 0)
      for (int r = 0; r < nz; ++r) *cluster.map_shared_rank(&parts[z][lane], r) = b;
    cluster_arrive_release();
    cluster_wait();                     // every block's partials are here
    if (warp == 0) {
      b = 0.0f;
      for (int r = 0; r < nz; ++r) b = fmaxf(b, parts[r][lane]);
    }
  }
  if (warp == 0) {
    const float s = scale_of(b);
    s_col[lane] = s;
    if (z == 0 && m < a.M) a.scale[m] = s;
  }
  __syncthreads();
  const float s = s_col[lane];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int kk = warp + nwarps * i;
    if (kk < n) tile[lane * pitch + kk] = quant1(v[i], s);
  }
  __syncthreads();
  // row r of the tile is q[m0 + r, kb .. ke): words where K % 4 == 0
  // (kchunk is a multiple of 4, so kb and n are too), else bytes
  const int rows = min(32, a.M - m0);
  if ((a.K & 3) == 0) {
    const int nw = n >> 2;
    for (int i = threadIdx.x; i < rows * nw; i += blockDim.x) {
      const int r = i / nw, c = i - r * nw;
      *reinterpret_cast<uint32_t*>(a.q + static_cast<long long>(m0 + r) * a.K + kb + 4 * c) =
          *reinterpret_cast<const uint32_t*>(tile + r * pitch + 4 * c);
    }
  } else {
    for (int i = threadIdx.x; i < rows * n; i += blockDim.x) {
      const int r = i / n, c = i - r * n;
      a.q[static_cast<long long>(m0 + r) * a.K + kb + c] = tile[r * pitch + c];
    }
  }
}

// dequantize: a grid-stride loop over the M * K elements
__global__ void dequantize_rowwise_kernel(const int8_t* __restrict__ q,
                                          const float* __restrict__ scale,
                                          float* __restrict__ out, int M,
                                          int K) {
  const long long n = static_cast<long long>(M) * K;
  grid_wait();
  // a dependent waits for this whole grid in its own grid_wait, so it may
  // be scheduled at once
  grid_launch_dependents();
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x)
    out[i] = __fmul_rn(static_cast<float>(q[i]), scale[i / K]);
}

// One PDL launch of kernel on stream s, in a (1, cluster_y, 1) cluster
// when cluster_y > 0. Returns the CUDA error, cleared.
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), dim3 grid, dim3 block, int cluster_y,
           cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.stream = s;
  cudaLaunchAttribute attr[2];
  int n = 0;
  if (cluster_y > 0) {
    attr[n].id = cudaLaunchAttributeClusterDimension;
    attr[n].val.clusterDim.x = 1;
    attr[n].val.clusterDim.y = cluster_y;
    attr[n].val.clusterDim.z = 1;
    ++n;
  }
  attr[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[n].val.programmaticStreamSerializationAllowed = 1;
  ++n;
  cfg.attrs = attr;
  cfg.numAttrs = n;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) {
    cudaGetLastError();                 // clear it; the caller raises
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool VEC>
int dispatch_rows(const Quant<T>& a, int depth, int blocks, int warps, cudaStream_t s) {
  switch (depth) {
    case 1: return launch(quantize_rows_kernel<T, VEC, 1>, dim3(blocks), dim3(32 * warps), 0, s, a);
    case 2: return launch(quantize_rows_kernel<T, VEC, 2>, dim3(blocks), dim3(32 * warps), 0, s, a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int NR>
int launch_cols(const Quant<T>& a, int groups, int warps, int ksplit, cudaStream_t s) {
  return ksplit > 1
             ? launch(quantize_cols_kernel<T, NR, true>, dim3(groups, ksplit),
                      dim3(32 * warps), ksplit, s, a)
             : launch(quantize_cols_kernel<T, NR, false>, dim3(groups), dim3(32 * warps),
                      0, s, a);
}

template <typename T>
int dispatch_cols(const Quant<T>& a, int depth, int groups, int warps, int ksplit,
                  cudaStream_t s) {
  switch (depth) {
    case 1: return launch_cols<T, 1>(a, groups, warps, ksplit, s);
    case 4: return launch_cols<T, 4>(a, groups, warps, ksplit, s);
    case 8: return launch_cols<T, 8>(a, groups, warps, ksplit, s);
    case 12: return launch_cols<T, 12>(a, groups, warps, ksplit, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// ------------------------------------------------------------- int8 GEMM

constexpr int BM = 64;                  // output rows per block: one wgmma row tile
constexpr int BN = 64;                  // output columns per block (wgmma n)
constexpr int BK = 64;                  // contraction bytes per shared-memory stage
constexpr int KSTEP = 32;               // wgmma's depth for 8-bit operands
constexpr int GEMM_THREADS = 128;       // one warpgroup
constexpr int MAX_KSPLIT = 8;           // portable cluster size
constexpr int RED_STRIDE = BN + 1;      // int32 row stride of the split-K sum

// Byte offset of (row, k) in a 64 x BK tile laid out for wgmma without
// swizzle, K-major: 8-row x 16-byte core matrices of 128 contiguous
// bytes, the K-adjacent ones 128 bytes apart (the descriptor's leading
// byte offset), the next 8 rows (BK / 16) * 128 bytes on (its stride
// byte offset).
__device__ __forceinline__ int core_offset(int row, int k) {
  return ((row >> 3) * (BK / 16) + (k >> 4)) * 128 + (row & 7) * 16 + (k & 15);
}

__device__ __forceinline__ uint64_t smem_desc(const void* tile) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(tile));
  uint64_t d = static_cast<uint64_t>((a & 0x3FFFF) >> 4);   // start address
  d |= static_cast<uint64_t>(128 >> 4) << 16;               // leading byte offset
  d |= static_cast<uint64_t>((BK / 16) * 128 >> 4) << 32;   // stride byte offset
  return d;                             // base offset 0, layout 0: no swizzle
}

// d (64 x 64 s32, in registers) += A (64 x 32 s8) * B (32 x 64 s8), both
// K-major in shared memory
__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]),
        "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),
        "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]),
        "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// shared-memory writes of this thread become visible to wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

struct Gemm {
  const int8_t* xq;                     // (M, K) row-major: K-major as it lies
  const float* sx;
  const int8_t* wq;                     // (K, N) row-major: transposed on staging
  const float* sw;
  float* out;
  int M, K, N, kchunk;                  // split z sums k in [z * kchunk, (z + 1) * kchunk)
};

// A rows [m0, m0 + 64) x k [kt, kt + BK) into a tile, zero past M and ke.
// WORDS: 4-byte cp.async (K and the pointer 4-byte aligned), else bytes.
template <bool WORDS>
__device__ __forceinline__ void stage_a(const Gemm& g, int8_t* As, int m0, int kt, int ke) {
  if constexpr (WORDS) {
    for (int i = threadIdx.x; i < BM * BK / 4; i += GEMM_THREADS) {
      const int r = i / (BK / 4), k = kt + 4 * (i % (BK / 4)), m = m0 + r;
      const bool in = m < g.M && k < ke;
      cp_async4(As + core_offset(r, k - kt),
                in ? g.xq + static_cast<long long>(m) * g.K + k : g.xq, in ? 4 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < BM * BK; i += GEMM_THREADS) {
      const int r = i / BK, k = kt + i % BK, m = m0 + r;
      As[core_offset(r, k - kt)] =
          (m < g.M && k < ke) ? g.xq[static_cast<long long>(m) * g.K + k] : int8_t(0);
    }
  }
}

// B k [kt, kt + BK) x n [n0, n0 + 64), transposed to (n, k), zero past N
// and ke. WORDS: 4 x 4 byte blocks read as four 4-byte words (N and the
// pointer 4-byte aligned) and transposed in registers; the loads go out
// in load_b, the stores wait for store_b. Else bytes, all in store_b.
constexpr int B_BLOCKS = (BK / 4) * (BN / 4) / GEMM_THREADS;   // 4x4 blocks a thread

template <bool WORDS>
__device__ __forceinline__ void load_b(const Gemm& g, uint32_t (&w)[B_BLOCKS][4],
                                       int n0, int kt, int ke) {
  if constexpr (WORDS) {
#pragma unroll
    for (int j = 0; j < B_BLOCKS; ++j) {
      const int i = threadIdx.x + j * GEMM_THREADS;
      const int n = n0 + 4 * (i % (BN / 4)), k = kt + 4 * (i / (BN / 4));
#pragma unroll
      for (int r = 0; r < 4; ++r)
        w[j][r] = (n < g.N && k + r < ke)
                      ? *reinterpret_cast<const uint32_t*>(
                            g.wq + static_cast<long long>(k + r) * g.N + n)
                      : 0u;
    }
  }
}

template <bool WORDS>
__device__ __forceinline__ void store_b(const Gemm& g, int8_t* Bs,
                                        const uint32_t (&w)[B_BLOCKS][4], int n0,
                                        int kt, int ke) {
  if constexpr (WORDS) {
#pragma unroll
    for (int j = 0; j < B_BLOCKS; ++j) {
      const int i = threadIdx.x + j * GEMM_THREADS;
      const int nl = 4 * (i % (BN / 4)), kl = 4 * (i / (BN / 4));
      // word r holds n .. n + 3 of row k + r; column c of the block is
      // byte c of each word
      const uint32_t lo01 = __byte_perm(w[j][0], w[j][1], 0x5140);
      const uint32_t hi01 = __byte_perm(w[j][0], w[j][1], 0x7362);
      const uint32_t lo23 = __byte_perm(w[j][2], w[j][3], 0x5140);
      const uint32_t hi23 = __byte_perm(w[j][2], w[j][3], 0x7362);
      const uint32_t col[4] = {__byte_perm(lo01, lo23, 0x5410), __byte_perm(lo01, lo23, 0x7632),
                               __byte_perm(hi01, hi23, 0x5410), __byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
      for (int c = 0; c < 4; ++c)
        *reinterpret_cast<uint32_t*>(Bs + core_offset(nl + c, kl)) = col[c];
    }
  } else {
    for (int i = threadIdx.x; i < BK * BN; i += GEMM_THREADS) {
      const int kl = i / BN, nl = i % BN, k = kt + kl, n = n0 + nl;
      Bs[core_offset(nl, kl)] =
          (n < g.N && k < ke) ? g.wq[static_cast<long long>(k) * g.N + n] : int8_t(0);
    }
  }
}

template <bool WORDS>
__global__ void __launch_bounds__(GEMM_THREADS)
int8_matmul_kernel(const Gemm g) {
  __shared__ __align__(128) int8_t As[2][BM * BK];
  __shared__ __align__(128) int8_t Bs[2][BN * BK];
  __shared__ int red[BM * RED_STRIDE];
  __shared__ float s_sx[BM], s_sw[BN];
  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.block_rank());   // == blockIdx.z
  const int nsplit = static_cast<int>(cluster.num_blocks());
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int kb = split * g.kchunk, ke = min(g.K, kb + g.kchunk);
  const int ntiles = (ke - kb + BK - 1) / BK;

  // the scales of this tile, read while the operands load
  if (threadIdx.x < BM) {
    const int m = m0 + threadIdx.x;
    s_sx[threadIdx.x] = m < g.M ? g.sx[m] : 0.f;
  } else {
    const int n = n0 + threadIdx.x - BM;
    s_sw[threadIdx.x - BM] = n < g.N ? g.sw[n] : 0.f;
  }
  int d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0;
  uint32_t w[B_BLOCKS][4];
  if (ntiles > 0) {
    stage_a<WORDS>(g, As[0], m0, kb, ke);
    cp_async_commit();
    load_b<WORDS>(g, w, n0, kb, ke);
    store_b<WORDS>(g, Bs[0], w, n0, kb, ke);
  }
  for (int it = 0; it < ntiles; ++it) {
    const int kt = kb + it * BK, cur = it & 1;
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();
    wgmma_fence();
    wgmma_s8(d, smem_desc(As[cur]), smem_desc(Bs[cur]));
    if (kt + KSTEP < ke)                // the second 32 bytes of the stage
      wgmma_s8(d, smem_desc(As[cur] + 2 * 128), smem_desc(Bs[cur] + 2 * 128));
    wgmma_commit();
    if (it + 1 < ntiles) {              // the next stage loads while wgmma runs
      stage_a<WORDS>(g, As[cur ^ 1], m0, kt + BK, ke);
      cp_async_commit();
      load_b<WORDS>(g, w, n0, kt + BK, ke);
    }
    wgmma_wait_all();
    if (it + 1 < ntiles) store_b<WORDS>(g, Bs[cur ^ 1], w, n0, kt + BK, ke);
  }

  // accumulator fragment: warp q holds rows 16q .. 16q + 15; register
  // 4i + 2h + e is (row 16q + lane / 4 + 8h, col 8i + 2 (lane % 4) + e)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (nsplit == 1) {                    // no other split: scale from the registers
    __syncthreads();                    // the scales are in (K = 0 runs no stage)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = 16 * warp + lane / 4 + 8 * h, col = 8 * i + 2 * (lane % 4) + e;
          if (m0 + row < g.M && n0 + col < g.N)
            g.out[static_cast<long long>(m0 + row) * g.N + n0 + col] = __fmul_rn(
                __fmul_rn(__int2float_rn(d[4 * i + 2 * h + e]), s_sx[row]), s_sw[col]);
        }
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * warp + lane / 4 + 8 * h, col = 8 * i + 2 * (lane % 4);
      red[row * RED_STRIDE + col] = d[4 * i + 2 * h];
      red[row * RED_STRIDE + col + 1] = d[4 * i + 2 * h + 1];
    }
  // sum the splits' int32 partials (exact, any order; all reads in
  // flight at once), then scale once
  cluster.sync();
  for (int e = split * GEMM_THREADS + threadIdx.x; e < BM * BN; e += nsplit * GEMM_THREADS) {
    const int row = e / BN, col = e % BN, m = m0 + row, n = n0 + col;
    if (m >= g.M || n >= g.N) continue;
    int part[MAX_KSPLIT];
#pragma unroll
    for (int s = 0; s < MAX_KSPLIT; ++s)
      part[s] = s < nsplit ? *cluster.map_shared_rank(red + row * RED_STRIDE + col, s) : 0;
    int acc = 0;
#pragma unroll
    for (int s = 0; s < MAX_KSPLIT; ++s) acc += part[s];
    // (float(acc) * sx[m]) * sw[n], in that order
    g.out[static_cast<long long>(m) * g.N + n] =
        __fmul_rn(__fmul_rn(__int2float_rn(acc), s_sx[row]), s_sw[col]);
  }
  cluster.sync();                       // no block leaves while its memory is read
}

template <bool WORDS>
int launch_gemm(const Gemm& g, int ksplit, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((g.N + BN - 1) / BN, (g.M + BM - 1) / BM, ksplit);
  cfg.blockDim = dim3(GEMM_THREADS);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = ksplit;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, int8_matmul_kernel<WORDS>, g);
  if (err != cudaSuccess) {
    cudaGetLastError();                 // clear it; the caller raises
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// The plan (kernels/quantized.py::plan_quantize): the form, its depth
// (rows: 4-element slots a thread; cols: rows of w a lane), warps a
// block, tpr threads a row (rows and loop forms), the grid (its y is the
// cols form's split of K: ksplit blocks of kchunk rows, a multiple of 4,
// none empty, a cluster when ksplit > 1).
template <typename T>
int quantize(const void* x, void* q, void* scale, int M, int K, long long x_sm,
             long long x_sk, int form, int depth, int warps, int tpr, int grid,
             int ksplit, int kchunk, cudaStream_t s) {
  Quant<T> a;
  a.x = static_cast<const T*>(x);
  a.q = static_cast<int8_t*>(q);
  a.scale = static_cast<float*>(scale);
  a.M = M; a.K = K; a.x_sm = x_sm; a.x_sk = x_sk; a.tpr = tpr; a.kchunk = kchunk;
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (M < 1 || K < 0) return invalid;
  if (form == COLS) {
    if (x_sm != 1 || K < 1 || grid != (M + 31) / 32 || warps < 1 ||
        warps > COL_MAX_WARPS || ksplit < 1 || ksplit > MAX_CLUSTER ||
        kchunk < 4 || kchunk % 4 || kchunk > COL_TILE || kchunk > warps * depth ||
        static_cast<long long>(ksplit) * kchunk < K ||
        static_cast<long long>(ksplit - 1) * kchunk >= K)
      return invalid;
    return dispatch_cols(a, depth, grid, warps, ksplit, s);
  }
  const int rows = tpr > 0 ? 32 * warps / tpr : 0;
  if (warps < 1 || warps > MAX_WARPS || tpr < 32 || tpr % 32 || rows < 1 ||
      rows * tpr != 32 * warps || ksplit != 1 ||
      static_cast<long long>(grid) * rows < M || static_cast<long long>(grid - 1) * rows >= M)
    return invalid;
  if (form == LOOP)
    return launch(quantize_loop_kernel<T>, dim3(grid), dim3(32 * warps), 0, s, a);
  if ((x_sk != 1 && K > 1) || depth < 1 || depth > ROWS_VECS || 4LL * tpr * depth < K)
    return invalid;
  if (form == ROWS) {
    if (reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) || (x_sm % 4 && M > 1))
      return invalid;
    return dispatch_rows<T, true>(a, depth, grid, warps, s);
  }
  if (form == ROWS_SCALAR)
    return dispatch_rows<T, false>(a, depth, grid, warps, s);
  return invalid;
}

}  // namespace

// dtype of x: 0 float32, 1 bfloat16, 2 float16
extern "C" int repro_quantize_rowwise(const void* x, void* q, void* scale,
                                      int M, int K, long long x_sm,
                                      long long x_sk, int form, int depth,
                                      int warps, int tpr, int grid, int ksplit,
                                      int kchunk, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return quantize<float>(x, q, scale, M, K, x_sm, x_sk, form, depth, warps,
                                   tpr, grid, ksplit, kchunk, s);
    case 1: return quantize<__nv_bfloat16>(x, q, scale, M, K, x_sm, x_sk, form, depth,
                                           warps, tpr, grid, ksplit, kchunk, s);
    case 2: return quantize<__half>(x, q, scale, M, K, x_sm, x_sk, form, depth, warps,
                                    tpr, grid, ksplit, kchunk, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int repro_dequantize_rowwise(const void* q, const void* scale,
                                        void* out, int M, int K,
                                        void* stream) {
  const long long n = static_cast<long long>(M) * K;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;     // grid-stride loop covers the rest
  return launch(dequantize_rowwise_kernel, dim3(static_cast<int>(blocks)), dim3(threads),
                0, static_cast<cudaStream_t>(stream), static_cast<const int8_t*>(q),
                static_cast<const float*>(scale), static_cast<float*>(out), M, K);
}

// ksplit chunks of kchunk bytes (a multiple of 32) cover [0, K), none
// empty, ksplit <= 8.
extern "C" int repro_int8_matmul(const void* xq, const void* sx,
                                 const void* wq, const void* sw, void* out,
                                 int M, int K, int N, int ksplit, int kchunk,
                                 void* stream) {
  if (ksplit < 1 || ksplit > MAX_KSPLIT || kchunk < KSTEP || kchunk % KSTEP ||
      static_cast<long long>(ksplit) * kchunk < K ||
      (ksplit > 1 && static_cast<long long>(ksplit - 1) * kchunk >= K))
    return static_cast<int>(cudaErrorInvalidValue);
  Gemm g;
  g.xq = static_cast<const int8_t*>(xq);
  g.sx = static_cast<const float*>(sx);
  g.wq = static_cast<const int8_t*>(wq);
  g.sw = static_cast<const float*>(sw);
  g.out = static_cast<float*>(out);
  g.M = M; g.K = K; g.N = N; g.kchunk = kchunk;
  const bool words = K % 4 == 0 && N % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(xq) % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(wq) % 4 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return words ? launch_gemm<true>(g, ksplit, s) : launch_gemm<false>(g, ksplit, s);
}
