// The RWKV6 time-mix recurrence for Hopper (sm_90a), float32.
//
// Replaces repro/kernels/rwkv6.py::rwkv6_scan (the Pallas TPU kernel) and
// computes what its oracles, repro/kernels/ref.py::rwkv6_ref and
// repro/models/rwkv.py::_wkv_scan, compute. Per (batch, head), with head
// dim n and the (n, n) state S (S0 = s0, or zeros):
//     y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
//     S_t = diag(w_t) S_{t-1} + k_t^T v_t
// for t = 0 .. S-1; returns every y_t and the final state.
//
// What bounds it on this card. RWKV6-1.6B's prefill of a 520-token prompt
// (B=1, H=32, n=64) reads r, k, v and w (17 MB) and writes y (4.3 MB),
// plus the state in and out (2 x 0.5 MB), about 22 MB or ~6.6 us of HBM
// time at the H100 SXM's 3.35 TB/s (700 W limit); it does about 6 n^2
// float32 operations per (step, head), ~0.4 GFLOP or ~6 us at 67 TFLOP/s.
// Both are a few microseconds. What actually bounds this kernel is the
// recurrence: S steps one after the other, each a few hundred cycles.
//
// What the design does about that. One block per (batch, head) keeps the
// whole (n, n) state on chip for the whole sequence: thread j holds
// column j of S in registers (n floats), so the state never touches
// device memory between steps and is read and written once per call.
// The inputs are staged through shared memory 16 steps at a time with
// cp.async, double buffered: while the block runs the recurrence over
// one chunk, the next chunk's r, k, w and v rows are already in flight,
// and the 16 steps of a chunk run with no barrier and no global load.
// Each step reads (r_i, k_i, w_i, u_i) as one broadcast float4 per i and
// sums y_j over i in four partial sums, so its dependency chain is a
// quarter of n long. Any S >= 1 runs with no padding (the Pallas w=1/k=0
// padding is a TPU blocking device). Only B*H blocks run (32 at full
// width, for 132 SMs); a chunked form that spreads the sequence itself
// over more of the card is later work. n <= 64; the host refuses more.
//
// C interface (bound with ctypes): pointers as void*, sizes as int, the
// CUDA stream last; returns cudaGetLastError() as an int. r, k, v, w and
// y are contiguous (B, S, H, n); u is (H, n); s0 (or null) and the final
// state are contiguous (B, H, n, n).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int NMAX = 64;                // head dim limit; also the block size
constexpr int TC = 16;                  // steps per staged chunk

struct Params {
  const float* r;
  const float* k;
  const float* v;
  const float* w;
  const float* u;
  const float* s0;                      // or null: zeros
  float* y;
  float* sf;
  int B, S, H, n;
};

__global__ void __launch_bounds__(NMAX) rwkv6_scan_kernel(const Params p) {
  __shared__ float4 sx[2][TC][NMAX];    // (r, k, w, u) of each step and lane i
  __shared__ float sv[2][TC][NMAX];

  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int j = threadIdx.x, n = p.n;
  const bool act = j < n;
  const long long nn = static_cast<long long>(n) * n;

  float s[NMAX];                        // column j of the state: s[i] = S[i][j]
#pragma unroll
  for (int i = 0; i < NMAX; ++i)
    s[i] = (act && i < n && p.s0) ? p.s0[bh * nn + i * n + j] : 0.f;
  if (act) {
    const float uj = p.u[h * n + j];
    for (int c = 0; c < 2; ++c)
      for (int tt = 0; tt < TC; ++tt) sx[c][tt][j].w = uj;
  }

  // element (b, t, h, j) of a contiguous (B, S, H, n) array
  const long long row = static_cast<long long>(p.H) * n;
  const long long base = static_cast<long long>(b) * p.S * row + h * n + j;
  const int chunks = (p.S + TC - 1) / TC;

  // lane j copies element j of each step of chunk c into buffer c & 1
  auto stage = [&](int c) {
    const int buf = c & 1;
    for (int tt = 0; tt < TC && c * TC + tt < p.S; ++tt) {
      if (!act) break;
      const long long o = base + (c * TC + tt) * row;
      __pipeline_memcpy_async(&sx[buf][tt][j].x, p.r + o, sizeof(float));
      __pipeline_memcpy_async(&sx[buf][tt][j].y, p.k + o, sizeof(float));
      __pipeline_memcpy_async(&sx[buf][tt][j].z, p.w + o, sizeof(float));
      __pipeline_memcpy_async(&sv[buf][tt][j], p.v + o, sizeof(float));
    }
    __pipeline_commit();
  };

  stage(0);
  for (int c = 0; c < chunks; ++c) {
    const int buf = c & 1;
    if (c + 1 < chunks) {
      stage(c + 1);                     // in flight while chunk c runs
      __pipeline_wait_prior(1);         // chunk c has landed
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();                    // ... for every lane
    const int steps = min(TC, p.S - c * TC);
    for (int tt = 0; tt < steps; ++tt) {
      if (!act) break;
      const float vj = sv[buf][tt][j];
      float y0 = 0.f, y1 = 0.f, y2 = 0.f, y3 = 0.f;
#pragma unroll
      for (int i = 0; i < NMAX; ++i) {
        if (i < n) {
          const float4 x = sx[buf][tt][i];      // r_i, k_i, w_i, u_i
          const float kv = x.y * vj;
          const float term = x.x * (s[i] + x.w * kv);
          if (i % 4 == 0) y0 += term;
          else if (i % 4 == 1) y1 += term;
          else if (i % 4 == 2) y2 += term;
          else y3 += term;
          s[i] = x.z * s[i] + kv;
        }
      }
      p.y[base + (c * TC + tt) * row] = (y0 + y1) + (y2 + y3);
    }
    __syncthreads();                    // buffer buf is free for chunk c + 2
  }
  if (act) {
#pragma unroll
    for (int i = 0; i < NMAX; ++i)
      if (i < n) p.sf[bh * nn + i * n + j] = s[i];
  }
}

}  // namespace

extern "C" int repro_rwkv6_scan(
    const void* r, const void* k, const void* v, const void* w,
    const void* u, const void* s0, void* y, void* sf,
    int B, int S, int H, int n, void* stream) {
  if (n < 1 || n > NMAX || S < 1) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.r = static_cast<const float*>(r);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.w = static_cast<const float*>(w);
  p.u = static_cast<const float*>(u);
  p.s0 = static_cast<const float*>(s0);
  p.y = static_cast<float*>(y);
  p.sf = static_cast<float*>(sf);
  p.B = B; p.S = S; p.H = H; p.n = n;
  rwkv6_scan_kernel<<<B * H, NMAX, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
