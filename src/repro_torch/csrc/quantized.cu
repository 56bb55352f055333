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
// a few hundred KB at most. Every call is bound by launch latency, not by
// operations or bytes.
//
// What the design does about that. One launch per call, no layout copies
// around it: the quantize kernel reads its input through (row, col)
// strides, so per-output-channel weight quantization runs on the view
// w.T as it is. The GEMM is a plain tiled shared-memory kernel on the
// CUDA cores: 32x64 output tiles, 64-deep K tiles staged in shared memory
// with the K tail (K = 6 and 3 on the vitals and scene encoders) and the
// M/N edges filled with zeros, four int8 products per __dp4a into an
// int32 accumulator. int8 tensor cores (mma.sync / wgmma) would not move
// a launch-bound call; they are later work for the batched path.
//
// C interface (bound with ctypes): pointers as void*, sizes and strides in
// elements, the CUDA stream last; each entry point returns
// cudaGetLastError() as an int.

#include <cuda_runtime.h>
#include <stdint.h>

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

constexpr int BM = 32;                  // output rows per block
constexpr int BN = 64;                  // output columns per block
constexpr int BK = 64;                  // contraction depth per shared tile
constexpr int PAD = 4;                  // keeps 4-byte alignment of each row
constexpr int GEMM_THREADS = 256;       // 16 x 16; each thread 2 rows x 4 cols

__global__ void __launch_bounds__(GEMM_THREADS)
int8_matmul_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                   const int8_t* __restrict__ wq, const float* __restrict__ sw,
                   float* __restrict__ out, int M, int K, int N) {
  // A tile as (m, k); B tile transposed to (n, k) so both dp4a operands
  // are four consecutive k of one row
  __shared__ __align__(16) int8_t As[BM][BK + PAD];
  __shared__ __align__(16) int8_t Bs[BN][BK + PAD];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  int acc[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += GEMM_THREADS) {
      const int r = i / BK, c = i % BK, gm = m0 + r, gk = k0 + c;
      As[r][c] = (gm < M && gk < K)
                     ? xq[static_cast<long long>(gm) * K + gk] : int8_t(0);
    }
    for (int i = tid; i < BK * BN; i += GEMM_THREADS) {
      const int r = i / BN, c = i % BN, gk = k0 + r, gn = n0 + c;
      Bs[c][r] = (gk < K && gn < N)
                     ? wq[static_cast<long long>(gk) * N + gn] : int8_t(0);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; kk += 4) {
      int a[2], b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        a[i] = *reinterpret_cast<const int*>(&As[ty + 16 * i][kk]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const int*>(&Bs[tx + 16 * j][kk]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N)   // (float(acc) * sx[m]) * sw[n], in that order
        out[static_cast<long long>(m) * N + n] =
            __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j]), sx[m]), sw[n]);
    }
  }
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

extern "C" int repro_int8_matmul(const void* xq, const void* sx,
                                 const void* wq, const void* sw, void* out,
                                 int M, int K, int N, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_matmul_kernel<<<grid, GEMM_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(sx),
      static_cast<const int8_t*>(wq), static_cast<const float*>(sw),
      static_cast<float*>(out), M, K, N);
  return static_cast<int>(cudaGetLastError());
}
