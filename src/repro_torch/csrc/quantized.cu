// int8 symmetric per-channel quantization and the fused int8 GEMM for
// Hopper (sm_90a): three kernels behind a plain C interface.
//
// Replaces the three Pallas TPU kernels of repro/kernels/quantized.py:
//   * quantize_rowwise  (:64)  scale = max|x| / 127 per row (1.0 on an
//     all-zero row), q = clip(round_half_even(x / scale), -127, 127);
//   * dequantize_rowwise (:89) out = float(q) * scale[m];
//   * int8_matmul        (:123) out[m, n] = (float(acc) * sx[m]) * sw[n]
//     with acc = sum_k xq[m, k] * wq[k, n] exact in int32.
// Both divisions are IEEE divisions (no reciprocal, no fast-math flag)
// and rounding is rintf (half to even, like jnp.round), so each kernel is
// bit-equal to its plain PyTorch version in kernels/quantized.py.
//
// What bounds them on this card. The quantized glass tier calls them per
// text layer at M = 64 tokens: the GEMMs are (64,312)x(312,936),
// (64,312)x(312,312), (64,312)x(312,1200) and (64,1200)x(1200,312), at
// most 48 MOP and 0.7 MB each. At the H100 SXM's published peaks (700 W
// limit) that is ~0.02 us of int8 tensor-core time (1,979 TOP/s) and
// ~0.2 us of HBM traffic (3.35 TB/s); the quantize/dequantize passes move
// a few hundred KB at most. What bounds a call on this card is latency:
// how many SMs share its loads and how long each one's serial K walk is
// (a CUDA-core GEMM on 10 blocks took 50 us at K = 1200).
//
// What the design does about that. One launch per call, no layout copies
// around it: the quantize kernel reads its input through (row, col)
// strides, so per-output-channel weight quantization runs on the view
// w.T as it is. The GEMM runs on the int8 tensor cores: one warpgroup a
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
// elements, the CUDA stream last; each entry point returns the launch's
// CUDA error as an int (0 on success).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int Q_WARPS = 8;              // rows per quantize block: one warp each

__global__ void quantize_rowwise_kernel(const float* __restrict__ x,
                                        int8_t* __restrict__ q,
                                        float* __restrict__ scale, int M,
                                        int K, long long x_sm, long long x_sk) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * Q_WARPS + (threadIdx.x >> 5);
  if (m >= M) return;
  const float* row = x + static_cast<long long>(m) * x_sm;
  float amax = 0.0f;
  for (int k = lane; k < K; k += 32) amax = fmaxf(amax, fabsf(row[k * x_sk]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float s = amax > 0.0f ? amax / 127.0f : 1.0f;   // IEEE division
  int8_t* out = q + static_cast<long long>(m) * K;
  for (int k = lane; k < K; k += 32) {
    const float r = rintf(row[k * x_sk] / s);              // half to even
    out[k] = static_cast<int8_t>(fminf(fmaxf(r, -127.0f), 127.0f));
  }
  if (lane == 0) scale[m] = s;
}

__global__ void dequantize_rowwise_kernel(const int8_t* __restrict__ q,
                                          const float* __restrict__ scale,
                                          float* __restrict__ out, int M,
                                          int K) {
  const long long n = static_cast<long long>(M) * K;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x)
    out[i] = __fmul_rn(static_cast<float>(q[i]), scale[i / K]);
}

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

}  // namespace

extern "C" int repro_quantize_rowwise(const void* x, void* q, void* scale,
                                      int M, int K, long long x_sm,
                                      long long x_sk, void* stream) {
  const int blocks = (M + Q_WARPS - 1) / Q_WARPS;
  quantize_rowwise_kernel<<<blocks, Q_WARPS * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(scale), M, K, x_sm, x_sk);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_dequantize_rowwise(const void* q, const void* scale,
                                        void* out, int M, int K,
                                        void* stream) {
  const long long n = static_cast<long long>(M) * K;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;     // grid-stride loop covers the rest
  dequantize_rowwise_kernel<<<static_cast<int>(blocks), threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scale),
      static_cast<float*>(out), M, K);
  return static_cast<int>(cudaGetLastError());
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
