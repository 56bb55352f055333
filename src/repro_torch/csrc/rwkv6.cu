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
// (B=1, H=32, n=64) moves about 22 MB (r, k, v, w in, y out, the state in
// and out): 6.7 us of HBM time at the H100 SXM's 3.35 TB/s (700 W limit),
// and its 5 n^2 float32 operations per (step, head) take about as long at
// 67 TFLOP/s. A decode step (S=1) moves 1 MB: 0.3 us. What bounds a
// step-by-step kernel is neither: it is the chain of S dependent steps,
// and with one block per (batch, head) only B*H = 32 SMs of 132 work.
//
// What the design does about that.
// - Split over value columns. Column j of S depends only on v[:, j], so
//   the grid is B * H * ceil(n / 16) blocks (128 at full width), each
//   owning a 64 x 16 slice of the state for the whole sequence, in
//   registers (8 elements a lane) and mirrored in shared memory.
// - Chunk the time axis (rwkv6_chunk_kernel). The sequence runs in chunks
//   of L = 16 steps (kernels/rwkv6.py::plan_chunks). With
//   a_t = prod_{tau<t} w_tau (decay from the chunk's start) and
//   b_s = prod_{s<tau<L} w_tau (decay to its end), a chunk is a few small
//   products and no per-step chain:
//     A[t,s] = sum_i r_t[i] k_s[i] prod_{s<tau<t} w_tau[i]   (s < t)
//     y_t    = (r_t * a_t) S + (sum_i r_t[i] u[i] k_t[i]) v_t
//              + sum_{s<t} A[t,s] v_s
//     S     <- diag(a_L) S + sum_s (k_s * b_s)^T v_s
//   The sequential chain shrinks from S steps to ceil(S / L) chunks.
// - Decay products are running products, never differences of log
//   cumsums: w = exp(-exp(.)) can be exactly 0 or 1 in float32, where a
//   log gives -inf and -inf - -inf is NaN. Products give exact zeros.
// - Every phase is a latency chain of shared-memory reads on a single
//   block per SM, so the block's 16 warps take roles and overlap two
//   chunks: while 8 warps form chunk c+1's products (A, the decays), 8
//   warps finish chunk c (y, and the state). Four of the first eight also
//   copy chunk c+3's r, k, w and v rows in by cp.async 16-byte copies
//   (element by element when n is not a multiple of 4), so a chunk's
//   inputs have two iterations to land. One barrier a chunk.
// - A decode step (S=1) takes rwkv6_step_kernel on the same grid: every
//   lane reads its inputs and state straight from device memory, all in
//   flight at once, and the step is a handful of FMAs and a sum over the
//   rows by shuffles, with no chunk phases to wait for. One launch per
//   call either way.
//
// C interface (bound with ctypes): pointers as void*, sizes as int, the
// CUDA stream last; returns cudaGetLastError() as an int. r, k, v, w and
// y are contiguous (B, S, H, n); u is (H, n); s0 (or null) and the final
// state are contiguous (B, H, n, n). n <= 64.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NMAX = 64;                // head dim limit: rows of a slice
constexpr int CW = 16;                  // state columns a block owns
constexpr int THREADS = 512;            // 16 warps in five roles (below)
constexpr int RS = NMAX + 4;            // padded row stride of float32 rows (w, the products)

// r, k and v in TI (float, __nv_bfloat16 or __half, the three alike); w,
// u, s0, y and the final state in float32
template <typename TI>
struct Params {
  const TI* r;
  const TI* k;
  const TI* v;
  const float* w;
  const float* u;
  const float* s0;                      // or null: zeros
  float* y;
  float* sf;
  int B, S, H, n;
  int vec;                              // rows on 16-byte boundaries
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// padded row stride of r and k rows in TI: 68 floats, or 72 halves (144
// bytes, so every staged row starts on a 16-byte boundary)
template <typename TI>
__host__ __device__ constexpr int rs_of() { return sizeof(TI) == 4 ? RS : NMAX + 8; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows x PAD elements into dst (row stride ld) from src (row stride ss),
// as they are, by lanes lane = 0 .. nlanes-1: rows at or past nvalid and
// columns at or past width are zero-filled. 16-byte cp.async copies (4
// floats or 8 halves); rows off 16 bytes element by element, by 4-byte
// cp.async for floats and by plain loads and stores for 2-byte elements
// (cp.async copies no fewer than 4 bytes). The caller commits; a barrier
// makes either visible.
template <int PAD, typename TE>
__device__ __forceinline__ void stage(TE* dst, int ld, const TE* src,
                                      long long ss, int rows, int nvalid,
                                      int width, bool vec, int lane, int nlanes) {
  if (vec) {
    constexpr int W = 16 / sizeof(TE);
    constexpr int C = PAD / W;
    for (int e = lane; e < rows * C; e += nlanes) {
      const int t = e / C, c = e % C;
      const bool in = t < nvalid && W * c < width;
      cp_async16(dst + t * ld + W * c, in ? src + t * ss + W * c : src, in);
    }
  } else {
    for (int e = lane; e < rows * PAD; e += nlanes) {
      const int t = e / PAD, c = e % PAD;
      const bool in = t < nvalid && c < width;
      if constexpr (sizeof(TE) == 4) {
        cp_async4(dst + t * ld + c, in ? src + t * ss + c : src, in);
      } else {
        dst[t * ld + c] = in ? src[t * ss + c] : TE(0.f);
      }
    }
  }
}

// stage's 16-byte path when each of BT lanes copies at most one piece:
// lane e copies piece e % C of row e / C (C pieces a row), without a loop
template <int PAD, typename TE>
__device__ __forceinline__ void stage_one(TE* dst, int ld, const TE* src, long long ss,
                                       int rows, int nvalid, int width, int lane) {
  constexpr int W = 16 / sizeof(TE);
  constexpr int C = PAD / W;
  if (lane < rows * C) {
    static_assert(C > 0 && (C & (C - 1)) == 0, "pieces a row: a power of two");
    const int t = lane / C, c = lane % C;
    const bool in = t < nvalid && W * c < width;
    cp_async16(dst + t * ld + W * c, in ? src + t * ss + W * c : src, in);
  }
}

// Roles of the block's 16 warps. Within iteration c of the chunk loop
// the producers prepare chunk c+1 while the consumers finish chunk c:
constexpr int A_LANES = 128;            // warps 0-3: A of chunk c+1
constexpr int PRE0 = 128;               // warps 4-5: a_t, r*a, r*u*k of chunk c+1
constexpr int SUF0 = 192;               // warps 6-7: b_s, k*b of chunk c+1; warps 4-7
                                        //   also copy in chunk c+3
constexpr int Y0 = 256;                 // warps 8-11: y of chunk c
constexpr int ST0 = 384;                // warps 12-15: the state through chunk c
constexpr int L = 16;                   // steps a chunk
constexpr int STAGES = 4;               // input buffers: chunks c .. c+3

// N (2, 4 or 8) contiguous floats from shared memory in one or two loads
template <int N>
__device__ __forceinline__ void lds(float (&out)[N], const float* src) {
  static_assert(N == 2 || N == 4 || N == 8, "a float2, a float4 or two");
  if constexpr (N == 8) {
    const float4 x = *reinterpret_cast<const float4*>(src);
    const float4 z = *reinterpret_cast<const float4*>(src + 4);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
    out[4] = z.x; out[5] = z.y; out[6] = z.z; out[7] = z.w;
  } else if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(src);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  } else {
    const float2 x = *reinterpret_cast<const float2*>(src);
    out[0] = x.x; out[1] = x.y;
  }
}

// two bf16 or fp16 values packed in 32 bits (the lower address in the
// low half) as exact float32s
__device__ __forceinline__ float2 unpack2(unsigned u, const __nv_bfloat16*) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}
__device__ __forceinline__ float2 unpack2(unsigned u, const __half*) {
  return make_float2(__half2float(__ushort_as_half(static_cast<unsigned short>(u & 0xffffu))),
                     __half2float(__ushort_as_half(static_cast<unsigned short>(u >> 16))));
}

// N (2, 4 or 8) contiguous bf16 or fp16 values from shared memory in one
// load of 2 N bytes, converted exactly to float32 in registers
template <int N, typename TH>
__device__ __forceinline__ void lds(float (&out)[N], const TH* src) {
  static_assert(N == 2 || N == 4 || N == 8, "4, 8 or 16 bytes");
  static_assert(sizeof(TH) == 2, "bf16 or fp16");
  unsigned w[N / 2];
  if constexpr (N == 8) {
    const uint4 x = *reinterpret_cast<const uint4*>(src);
    w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
  } else if constexpr (N == 4) {
    const uint2 x = *reinterpret_cast<const uint2*>(src);
    w[0] = x.x; w[1] = x.y;
  } else {
    w[0] = *reinterpret_cast<const unsigned*>(src);
  }
#pragma unroll
  for (int x = 0; x < N / 2; ++x) {
    const float2 f = unpack2(w[x], src);
    out[2 * x] = f.x;
    out[2 * x + 1] = f.y;
  }
}

// a chunk's staged inputs, in bytes: r and k (rows of rs_of<TI>() TI), w
// (rows of RS floats), v (rows of CW TI); each region 16-byte aligned
template <typename TI>
__host__ __device__ constexpr int in_bytes() {
  return static_cast<int>(2 * L * rs_of<TI>() * sizeof(TI) + 4 * L * RS + L * CW * sizeof(TI));
}

__host__ __device__ constexpr int prod_floats() { return 3 * L * RS + L * (L + 1) + NMAX; }   // r*a, k*b, r*u*k, A, a_L

template <typename TI>
constexpr int smem_bytes() {
  return STAGES * in_bytes<TI>()      // inputs
         + 4 * (2 * prod_floats()     // a chunk's products, two buffers
                + 2 * NMAX * CW);     // the state slice, two buffers
}

template <typename TI>
__global__ void __launch_bounds__(THREADS) rwkv6_chunk_kernel(const Params<TI> p) {
  constexpr int G = L / 2;               // pairs (s, L-1-s) of the A phase
  constexpr int IG = A_LANES / G;        // lanes that share one pair's sum over i
  constexpr int IPT = NMAX / IG;         // i a lane sums over
  constexpr int JPT = L / 8;             // y columns a lane computes
  constexpr int TPR = CW / JPT;          // lanes on one y row
  constexpr int AS = L + 1;              // row stride of A
  constexpr int VW = 4;                  // floats a lane loads at once in the A phase
  static_assert(IG <= 32 && IG >= L - 1 && IPT % VW == 0 && JPT == 2, "tile plan");
  constexpr int RSI = rs_of<TI>();       // row stride of staged r and k
  static_assert(in_bytes<TI>() % 16 == 0 && (L * RSI * sizeof(TI)) % 16 == 0, "16-byte regions");

  extern __shared__ float4 smem4[];
  unsigned char* in = reinterpret_cast<unsigned char*>(smem4);
  float* prod = reinterpret_cast<float*>(in + STAGES * in_bytes<TI>());
  float* St = prod + 2 * prod_floats();
  // the staged inputs of chunk c: r, k (TI), w (float32), v (TI)
  auto in_r = [&](int c) { return reinterpret_cast<TI*>(in + (c % STAGES) * in_bytes<TI>()); };
  auto in_k = [&](int c) { return in_r(c) + L * RSI; };
  auto in_w = [&](int c) { return reinterpret_cast<float*>(in_k(c) + L * RSI); };
  auto in_v = [&](int c) { return reinterpret_cast<TI*>(in_w(c) + L * RS); };

  const int ncb = (p.n + CW - 1) / CW;
  const int bh = blockIdx.x / ncb, cb = blockIdx.x % ncb;
  const int b = bh / p.H, h = bh % p.H, j0 = cb * CW;
  const int tid = threadIdx.x, n = p.n;
  const bool vec = p.vec;
  const long long row = static_cast<long long>(p.H) * n;       // stride of t
  const long long base = static_cast<long long>(b) * p.S * row + h * n;
  const int chunks = (p.S + L - 1) / L;
  auto steps_of = [&](int c) { return min(L, p.S - c * L); };

  auto stage_chunk = [&](int c, int lane, int nlanes) {
    const long long o = base + static_cast<long long>(c) * L * row;
    const int nv = steps_of(c);
    stage<NMAX>(in_r(c), RSI, p.r + o, row, L, nv, n, vec, lane, nlanes);
    stage<NMAX>(in_k(c), RSI, p.k + o, row, L, nv, n, vec, lane, nlanes);
    stage<NMAX>(in_w(c), RS, p.w + o, row, L, nv, n, vec, lane, nlanes);
    stage<CW>(in_v(c), CW, p.v + o + j0, row, L, nv, min(CW, n - j0), vec,
              lane, nlanes);
    cp_async_commit();
  };

  // The producers: the products of chunk c from its inputs, into buffer c & 1
  auto produce = [&](int c) {
    const int steps = steps_of(c);
    const TI* R = in_r(c);
    const TI* K = in_k(c);
    const float* W = in_w(c);
    float* P = prod + (c & 1) * prod_floats();
    float* ra = P;
    float* kb = ra + L * RS;
    float* ruk = kb + L * RS;
    float* A = ruk + L * RS;
    float* aL = A + L * AS;
    if (tid < A_LANES) {
      // A below the diagonal: pair sp takes s = sp for t = sp+1 .. L-1,
      // then s = L-1-sp for t = L-sp .. L-1: L - 1 entries for every
      // lane, with no branch. kp = k_s * prod_{s<tau<t} w_tau starts as
      // k_s at each s. The partial sums over this lane's i are summed over
      // the i-group after the loop, so the shuffles run converged. A
      // decode step (one step a chunk) has no such entry.
      if (steps < 2) return;
      const int ig = tid % IG, sp = tid / IG;
      float part[L - 1];
      float kp[IPT];
#pragma unroll
      for (int e = 0; e < L - 1; ++e) {
        const bool first = e < L - 1 - sp;
        const int s = first ? sp : L - 1 - sp;
        const int t = first ? sp + 1 + e : e + 1;
        const bool fresh = e == 0 || e == L - 1 - sp;
        float acc = 0.f;
#pragma unroll
        for (int q = 0; q < IPT; q += VW) {
          if (fresh) {
            float kx[VW];
            lds(kx, K + s * RSI + ig * IPT + q);
#pragma unroll
            for (int x = 0; x < VW; ++x) kp[q + x] = kx[x];
          }
          float rx[VW], wx[VW];
          lds(rx, R + t * RSI + ig * IPT + q);
          lds(wx, W + t * RS + ig * IPT + q);
#pragma unroll
          for (int x = 0; x < VW; ++x) {
            acc = fmaf(rx[x], kp[q + x], acc);
            kp[q + x] *= wx[x];
          }
        }
        part[e] = acc;
      }
      // sum over the i-group as a reduce-scatter: at each level a lane
      // keeps half of its entries and adds its partner's half, so lane ig
      // ends with the whole sum of entry ig (IG - 1 shuffles in all)
      float red[IG];
#pragma unroll
      for (int e = 0; e < IG; ++e) red[e] = e < L - 1 ? part[e] : 0.f;
#pragma unroll
      for (int off = IG / 2; off > 0; off >>= 1) {
        const bool hi = ig & off;
#pragma unroll
        for (int k = 0; k < off; ++k) {
          const float send = hi ? red[k] : red[k + off];
          const float keep = hi ? red[k + off] : red[k];
          red[k] = keep + __shfl_xor_sync(0xffffffffu, send, off);
        }
      }
      const int e = ig;
      const bool first = e < L - 1 - sp;
      const int s = first ? sp : L - 1 - sp;
      const int t = first ? sp + 1 + e : e + 1;
      if (e < L - 1 && t < steps) A[t * AS + s] = red[0];
    } else if (tid < SUF0) {
      // a_t forward along i, with r_t a_t and r_t u k_t; every load comes
      // before the first store, so none waits behind one
      const int i = tid - PRE0;
      const float ui = i < n ? p.u[h * n + i] : 0.f;
      float rv[L], kv[L], wv[L];
#pragma unroll
      for (int t = 0; t < L; ++t) {
        rv[t] = to_f32(R[t * RSI + i]);
        kv[t] = to_f32(K[t * RSI + i]);
        wv[t] = t < steps ? W[t * RS + i] : 1.f;
      }
      float a = 1.f;
#pragma unroll
      for (int t = 0; t < L; ++t) {
        ra[t * RS + i] = rv[t] * a;
        ruk[t * RS + i] = rv[t] * ui * kv[t];
        a *= wv[t];
      }
      aL[i] = a;
    } else {
      // b_s backward along i, with k_s b_s
      const int i = tid - SUF0;
      float kv[L], wv[L];
#pragma unroll
      for (int t = 0; t < L; ++t) {
        kv[t] = to_f32(K[t * RSI + i]);
        wv[t] = t < steps ? W[t * RS + i] : 1.f;
      }
      float bb = 1.f;
#pragma unroll
      for (int t = L - 1; t >= 0; --t) {
        kb[t * RS + i] = kv[t] * bb;
        bb *= wv[t];
      }
    }
  };

  // the state lanes: row si, columns sj .. sj + 7 of the slice
  const int sl = tid - ST0;
  const int si = sl >> 1, sj = (sl & 1) * 8;
  const long long sbase = static_cast<long long>(bh) * n * n + static_cast<long long>(si) * n + j0 + sj;
  float st[8];
  if (tid >= ST0) {
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const bool ok = p.s0 && si < n && j0 + sj + jj < n;
      st[jj] = ok ? p.s0[sbase + jj] : 0.f;
      St[si * CW + sj + jj] = st[jj];
    }
  }
  // the copying lanes: warps 4-7, which each copy a chunk's inputs two
  // iterations ahead of its products
  const bool copier = tid >= PRE0 && tid < Y0;
  auto copy_ahead = [&](int c) {
    if (c < chunks) stage_chunk(c, tid - PRE0, Y0 - PRE0);
    else cp_async_commit();             // an empty group keeps the count
  };
  stage_chunk(0, tid, THREADS);
  if (chunks > 1) stage_chunk(1, tid, THREADS);
  cp_async_wait_all();
  __syncthreads();                      // chunks 0 and 1 and the state mirror are in
  if (copier) copy_ahead(2);
  if (tid < Y0) produce(0);
  __syncthreads();                      // chunk 0's products are in

  for (int c = 0; c < chunks; ++c) {
    if (tid < Y0) {
      if (copier) copy_ahead(c + 3);    // into the buffer of chunk c - 1
      if (c + 1 < chunks) produce(c + 1);
      if (copier)                       // chunk c + 2, copied since the last
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");   // iteration, has landed
    } else {
      const int steps = steps_of(c);
      const TI* V = in_v(c);
      const float* P = prod + (c & 1) * prod_floats();
      const float* ra = P;
      const float* kb = ra + L * RS;
      const float* ruk = kb + L * RS;
      const float* A = ruk + L * RS;
      const float* aL = A + L * AS;
      const float* Sc = St + (c & 1) * NMAX * CW;
      if (tid < ST0) {
        // y_t = (r_t a_t) S + (sum_i r_t u k_t) v_t + sum_{s<t} A[t,s] v_s
        // from the state mirror before chunk c
        const int yl = tid - Y0;
        const int yt = yl / TPR, yj = (yl % TPR) * JPT;
        // the row's TPR lanes each sum 64 / TPR of r_t u k_t, then share
        // the sum by shuffles (every lane, so they run converged)
        float dg = 0.f;
#pragma unroll
        for (int i = 0; i < NMAX / TPR; i += 4) {
          const float4 d = *reinterpret_cast<const float4*>(
              ruk + yt * RS + (yl % TPR) * (NMAX / TPR) + i);
          dg += (d.x + d.y) + (d.z + d.w);
        }
#pragma unroll
        for (int off = TPR / 2; off > 0; off >>= 1)
          dg += __shfl_xor_sync(0xffffffffu, dg, off);
        if (yt < steps) {
          float acc[4][JPT];
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int jj = 0; jj < JPT; ++jj) acc[q][jj] = 0.f;
#pragma unroll
          for (int i = 0; i < NMAX; i += 4) {
            const float4 x = *reinterpret_cast<const float4*>(ra + yt * RS + i);
            const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              float sv[JPT];
              lds(sv, Sc + (i + q) * CW + yj);
#pragma unroll
              for (int jj = 0; jj < JPT; ++jj) acc[q][jj] = fmaf(xs[q], sv[jj], acc[q][jj]);
            }
          }
#pragma unroll
          for (int jj = 0; jj < JPT; ++jj)
            acc[0][jj] = fmaf(dg, to_f32(V[yt * CW + yj + jj]), acc[0][jj]);
#pragma unroll
          for (int s = 0; s < L - 1; ++s) {
            if (s < yt) {
              const float a = A[yt * AS + s];
#pragma unroll
              for (int jj = 0; jj < JPT; ++jj)
                acc[(s + 1) & 3][jj] = fmaf(a, to_f32(V[s * CW + yj + jj]), acc[(s + 1) & 3][jj]);
            }
          }
          float* yrow = p.y + base + static_cast<long long>(c * L + yt) * row + j0 + yj;
#pragma unroll
          for (int jj = 0; jj < JPT; ++jj)
            if (j0 + yj + jj < n) yrow[jj] = (acc[0][jj] + acc[1][jj]) + (acc[2][jj] + acc[3][jj]);
        }
      } else {
        // S <- diag(a_L) S + sum_s (k_s b_s)^T v_s, into the other mirror
        const float a = aL[si];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) st[jj] *= a;
#pragma unroll
        for (int s = 0; s < L; ++s) {
          if (s < steps) {
            const float x = kb[s * RS + si];
            float vs[8];
            lds(vs, V + s * CW + sj);
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) st[jj] = fmaf(x, vs[jj], st[jj]);
          }
        }
        float* Sn = St + ((c + 1) & 1) * NMAX * CW + si * CW + sj;
        *reinterpret_cast<float4*>(Sn) = make_float4(st[0], st[1], st[2], st[3]);
        *reinterpret_cast<float4*>(Sn + 4) = make_float4(st[4], st[5], st[6], st[7]);
      }
    }
    __syncthreads();                    // chunk c+1's products, chunk c+2's inputs,
                                        // the state after chunk c are in
  }
  cp_async_wait_all();                  // nothing left in flight at exit
  if (tid >= ST0 && si < n) {
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
      if (j0 + sj + jj < n) p.sf[sbase + jj] = st[jj];
  }
}

// One step at a time, on the same grid: lane (si, sj) holds S[si][j0+sj ..
// j0+sj+7] in registers; each step reads r, k, w of row si and v of the
// lane's 8 columns straight from device memory (a decode step's inputs
// and state slice all in flight at once), updates the 8 elements, and sums
// the lane's share of y_t over the 64 rows: shuffles within a warp, then
// shared memory across the 4 warps. The plan takes it for a decode step
// (S=1), where the chunked kernel's phases and barriers would be the
// whole cost.
constexpr int STEP_THREADS = 2 * NMAX;  // two lanes per state row

template <typename TI>
__global__ void __launch_bounds__(STEP_THREADS) rwkv6_step_kernel(const Params<TI> p) {
  __shared__ float ypart[STEP_THREADS / 32][CW];
  const int ncb = (p.n + CW - 1) / CW;
  const int bh = blockIdx.x / ncb, cb = blockIdx.x % ncb;
  const int b = bh / p.H, h = bh % p.H, j0 = cb * CW;
  const int tid = threadIdx.x, n = p.n, lane = tid & 31, warp = tid >> 5;
  const int si = tid >> 1, sj = (tid & 1) * 8;
  const bool row_ok = si < n;
  const long long row = static_cast<long long>(p.H) * n;
  const long long base = static_cast<long long>(b) * p.S * row + h * n;
  const long long sbase = static_cast<long long>(bh) * n * n + static_cast<long long>(si) * n + j0 + sj;
  bool col_ok[8];
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) col_ok[jj] = row_ok && j0 + sj + jj < n;

  float st[8];
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) st[jj] = (p.s0 && col_ok[jj]) ? p.s0[sbase + jj] : 0.f;
  const float ui = row_ok ? p.u[h * n + si] : 0.f;

  for (int t = 0; t < p.S; ++t) {
    const long long o = base + static_cast<long long>(t) * row;
    const float ri = row_ok ? to_f32(p.r[o + si]) : 0.f;
    const float ki = row_ok ? to_f32(p.k[o + si]) : 0.f;
    const float wi = row_ok ? p.w[o + si] : 0.f;
    float part[8];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int j = j0 + sj + jj;
      const float vj = j < n ? to_f32(p.v[o + j]) : 0.f;
      const float kv = ki * vj;
      part[jj] = ri * fmaf(ui, kv, st[jj]);
      st[jj] = fmaf(wi, st[jj], kv);
    }
    // sum over the rows: lanes of one parity hold the same 8 columns
#pragma unroll
    for (int off = 2; off < 32; off <<= 1)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        part[jj] += __shfl_xor_sync(0xffffffffu, part[jj], off);
    if (lane < 2)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) ypart[warp][sj + jj] = part[jj];
    __syncthreads();
    if (tid < CW && j0 + tid < n) {
      float y = 0.f;
#pragma unroll
      for (int w = 0; w < STEP_THREADS / 32; ++w) y += ypart[w][tid];
      p.y[o + j0 + tid] = y;
    }
    __syncthreads();                    // ypart is free for the next step
  }
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
    if (col_ok[jj]) p.sf[sbase + jj] = st[jj];
}

template <typename TI>
int launch_steps(const Params<TI>& p, cudaStream_t s) {
  const int ncb = (p.n + CW - 1) / CW;
  rwkv6_step_kernel<TI><<<p.B * p.H * ncb, STEP_THREADS, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename TI>
int launch_chunks(const Params<TI>& p, cudaStream_t s) {
  constexpr int bytes = smem_bytes<TI>();
  static_assert(bytes <= 232448, "shared memory of one block");
  static bool configured = false;       // the attribute is set once per type
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        rwkv6_chunk_kernel<TI>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int ncb = (p.n + CW - 1) / CW;
  rwkv6_chunk_kernel<TI><<<p.B * p.H * ncb, THREADS, bytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

template <typename TI>
int run(const void* r, const void* k, const void* v, const void* w,
        const void* u, const void* s0, void* y, void* sf,
        int B, int S, int H, int n, int chunk, cudaStream_t s) {
  Params<TI> p;
  p.r = static_cast<const TI*>(r);
  p.k = static_cast<const TI*>(k);
  p.v = static_cast<const TI*>(v);
  p.w = static_cast<const float*>(w);
  p.u = static_cast<const float*>(u);
  p.s0 = static_cast<const float*>(s0);
  p.y = static_cast<float*>(y);
  p.sf = static_cast<float*>(sf);
  p.B = B; p.S = S; p.H = H; p.n = n;
  // 16-byte copies: rows of r, k, v (16 / sizeof(TI) elements) and of w
  // (4 floats) on 16-byte boundaries
  p.vec = n % static_cast<int>(16 / sizeof(TI)) == 0 && n % 4 == 0 && aligned16(r) &&
          aligned16(k) && aligned16(v) && aligned16(w);
  switch (chunk) {
    case 1: return launch_steps(p, s);
    case L: return launch_chunks(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------
// The backward. With dy_t = dL/dy_t, G_t = dL/dS_t (G_{S-1} = dL/d final
// state, or zeros) and A_t = S_{t-1} + diag(u) k_t^T v_t:
//     dr_t = A_t dy_t                  du = sum_t r_t * k_t (v_t . dy_t)
//     M_t  = G_t + diag(u * r_t) 1 dy_t^T
//     dk_t = M_t v_t                   dv_t = M_t^T k_t
//     dw_t = rowsum(G_t * S_{t-1})     G_{t-1} = diag(w_t) G_t + r_t^T dy_t
//     ds0  = G_{-1}
//
// What bounds it on this card. At RWKV6-1.6B's training microbatch (B=16,
// S=64, H=32, n=64, bf16 r/k/v) it reads r, k, v, w and dy and writes dr,
// dk, dv, dw, du and ds0 once: 59 MB, 17.5 us of HBM time at 3.35 TB/s.
// Its float32 operations are 14 n^2 per (step, head): the state S_{t-1}
// again (3 n^2), S dy, G v, G^T k and rowsum(G * S) (2 n^2 each) and G's
// update (3 n^2); 1.88 GFLOP, 28.05 us at 67 TFLOP/s, so the operations
// bound it (chip_smoke.py::rwkv_bwd_bound). A 520-token scan (B=1, H=32,
// with s0 and a final-state gradient) is bounded at 14.2 us, by the
// operations too, with only 32 (batch, head) pairs to spread them over.
//
// What the design does about that.
// - Split over value columns, as a cluster. Column j of S and of G depends
//   only on v[:, j] and dy[:, j], so the grid is B * H * ceil(n / 16)
//   CTAs of 256 threads (2,048 at the microbatch, 128 at S=520), each
//   owning a 64 x 16 slice of S and of G, and the ceil(n / 16) CTAs of
//   one (batch, head) are one thread-block cluster (cudaLaunchKernelEx,
//   cudaLaunchAttributeClusterDimension). dv sums over rows, inside a
//   CTA. dr, dk and dw sum over columns: each CTA sends its slice's
//   partial sums to the CTA that owns the row (ceil(n / ncb) rows each)
//   by stores into that CTA's shared memory (distributed shared memory,
//   map_shared_rank), and after the cluster's barrier the owner adds them
//   in rank order. One barrier a chunk, split: a CTA arrives once its
//   stores are made, forms dv, then waits; the received sums alternate
//   between two buffers.
// - Chunks of L = 16 steps. A first walk keeps only the state at each
//   chunk's start, by the forward's update without y,
//   S <- diag(a_L) S + (k * b)^T V, with running products of w (never a
//   log: w may be exactly 0 or 1); (k * b)^T V does not wait for S, so
//   three chunks' products go side by side and the chain is one FMA a
//   chunk. The chunk starts go to device scratch, 4 KB a chunk and CTA,
//   each written and read back by the thread that owns it (the last one
//   stays in registers); the second walk loads the next chunk's start a
//   chunk ahead. Kept in shared memory instead, they measured within 1 %
//   at the microbatch (ahead in bf16, behind in float32), and at S=520
//   their 132 KB left one CTA an SM, 27 % slower.
// - The second walk takes the chunks last first; a chunk's inputs are
//   copied in (cp.async) while the chunk before it is worked on, and r, k
//   and v converted to float32 once. Phase 1 forms the forward's
//   intra-chunk matrix A (u on its diagonal) and k * b; phase 3 dv as
//   products with no per-step chain: with G_out the gradient after the
//   chunk and b_t the decay to its end, dV = (K * b) G_out + A^T dY.
// - dw_t = rowsum(G_t * S_{t-1}) has no division-free low-rank form (w may
//   be 0), so in phase 2 a thread walks its row's 4 slice columns step by
//   step: the chunk's states forward from its start (8 held at a time,
//   the first 8 recomputed once), then G back, summing dw's G * S, dr's
//   S dy and dk's G v in the thread. The walk holds S_{t-1} and G_t
//   anyway, so dr and dk cost one FMA an element there and need no
//   product form. The 4 threads of a row add their partial sums once
//   every 4 steps by shuffles (a reduce-scatter, 9 a thread), not once a
//   step; u's terms, which need all of v . dy (sent to every rank before
//   the walk), join in the owner's sum. Phase 1 runs after the walk, with
//   no barrier between them, while the walk's last stores land.
// - du sums over batch too: each CTA writes its rows' share of
//   r * k (v . dy) to scratch, and a second kernel adds them over batch
//   and step in order. Every sum is in a fixed order and nothing is
//   atomic, so the backward is deterministic, as the forward is. Float32
//   FMA throughout: TF32 products would not keep 1e-4.
constexpr int BT = 256;                 // threads of a backward CTA
constexpr int BQ = 4;                   // slice columns a thread walks: row tid / 4,
                                        //   columns 4 (tid % 4) .. +3
constexpr int SUB = 8;                  // states a walking thread holds at once
// a chunk's partial sums a CTA receives, for the <= 16 rows it owns:
// from each of <= 4 ranks, dr, dk and dw at the chunk's L steps (rows RBS
// apart), then each rank's v . dy at VDY0
constexpr int RBS = 16;
constexpr int VDY0 = 4 * 3 * L * RBS;
constexpr int RECV = VDY0 + 4 * L;
static_assert(BT == NMAX * BQ && BT == L * CW && L % SUB == 0 && SUB % BQ == 0 &&
              L % BQ == 0, "thread plan");

template <typename TI>
struct BwdParams {
  const TI* r;
  const TI* k;
  const TI* v;
  const float* w;
  const float* u;
  const float* s0;                      // or null: zeros
  const float* dy;
  const float* dsf;                     // or null: zeros
  TI* dr;
  TI* dk;
  TI* dv;
  float* dw;
  float* du_part;                       // (B, H, ncb, L, RBS) partial sums of du
  float* ds0;
  float* ckpt;                          // (B, H, ncb, chunks - 1, NMAX * CW): chunk starts
  int B, S, H, n;
  int ncb;                              // CTAs of a cluster: column slices of a head
  int vec;                              // rows on 16-byte boundaries
};

// a chunk's staged inputs: the forward's r, k, w and v, then dy (rows of
// CW floats)
template <typename TI>
__host__ __device__ constexpr int bwd_in_bytes() { return in_bytes<TI>() + 4 * L * CW; }

// floats after the two input buffers: k * b, G_out, A and its diagonal,
// r, k and v as float32, two buffers of received partial sums
constexpr int BWD_FLOATS = L * NMAX + NMAX * CW + L * (L + 1) + L + 2 * L * RS + L * CW + 2 * RECV;

template <typename TI>
__host__ __device__ constexpr int bwd_smem_bytes() {
  return 2 * bwd_in_bytes<TI>() + 4 * BWD_FLOATS;
}

__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void store_as(__half* p, float x) { *p = __float2half(x); }

// The cluster barrier in its two halves: a CTA arrives once its stores
// to its peers are made (release), works on, and waits before it reads
// what its peers stored (acquire)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One level of a reduce-scatter over the lanes ``off`` apart: of the
// 2 HALF values red[0 .. 2 HALF - 1], the lane with bit ``off`` of
// ``who`` set keeps the upper half and its partner the lower, each adding
// what the other sends, into red[0 .. HALF - 1]. HALF is a template
// argument so that every index is a constant and red stays in registers;
// the two selections are selp in inline PTX, since a ?: over two elements
// of a register array becomes one load from a computed address, which
// sends the array to local memory.
template <int OFF, int HALF = OFF, int N>
__device__ __forceinline__ void reduce_scatter(float (&red)[N], int who) {
  static_assert(2 * HALF <= N, "two halves");
  const unsigned hi = (who & OFF) != 0;
#pragma unroll
  for (int e = 0; e < HALF; ++e) {
    float keep, send;
    asm("{\n .reg .pred p;\n setp.ne.u32 p, %4, 0;\n selp.f32 %0, %3, %2, p;\n"
        " selp.f32 %1, %2, %3, p;\n}"
        : "=f"(keep), "=f"(send) : "f"(red[e]), "f"(red[e + HALF]), "r"(hi));
    red[e] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
}

// A lane's share of a chunk's intra-chunk matrix A, for warp GRP: rows
// i2 and i2 + 1 of A[t][s] = sum_i r_t[i] k_s[i] prod_{s<tau<t} w_tau[i]
// at s = GRP (t = GRP+1 .. L-1), then s = L-1-GRP (t = L-GRP .. L-1), L - 1
// entries, with kp = k_s * prod w running along t; then the diagonal
// sum_i r_t u k_t at t = GRP and t = L-1-GRP. R, K and W are [t][i] rows of
// RS floats.
template <int GRP>
__device__ __forceinline__ void a_partials(float (&red)[L + 1], const float* R, const float* K,
                                           const float* W, int i2, float u0, float u1) {
  static_assert(GRP >= 0 && GRP < L / 2, "a pair of columns of A");
  float kp[2];
#pragma unroll
  for (int e = 0; e < L - 1; ++e) {
    const bool first = e < L - 1 - GRP;
    const int s = first ? GRP : L - 1 - GRP;
    const int t = first ? GRP + 1 + e : e + 1;
    if (e == 0 || e == L - 1 - GRP) lds(kp, K + s * RS + i2);
    float rx[2], wx[2];
    lds(rx, R + t * RS + i2);
    lds(wx, W + t * RS + i2);
    red[e] = fmaf(rx[1], kp[1], rx[0] * kp[0]);
    kp[0] *= wx[0];
    kp[1] *= wx[1];
  }
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    const int t = d ? L - 1 - GRP : GRP;
    float rx[2], kx[2];
    lds(rx, R + t * RS + i2);
    lds(kx, K + t * RS + i2);
    red[L - 1 + d] = fmaf(rx[1] * u1, kx[1], rx[0] * u0 * kx[0]);
  }
}

template <typename TI>
__global__ void __launch_bounds__(BT, 2) rwkv6_backward_kernel(const BwdParams<TI> p) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int RSI = rs_of<TI>();       // row stride of staged r and k
  constexpr int AS = L + 1;              // row stride of A
  constexpr int INB = bwd_in_bytes<TI>();
  static_assert(INB % 16 == 0 && BWD_FLOATS % 4 == 0, "16-byte regions");

  extern __shared__ float4 smem4[];
  unsigned char* in = reinterpret_cast<unsigned char*>(smem4);
  float* kb = reinterpret_cast<float*>(in + 2 * INB);   // k_t * b_t, [t][i]
  float* Gs = kb + L * NMAX;                             // G_out, [i][j]
  float* Am = Gs + NMAX * CW;                            // A[t][s], s < t
  float* Dg = Am + L * AS;                               // A's diagonal
  float* fr = Dg + L;                                    // r, k, v as float32
  float* fk = fr + L * RS;
  float* fv = fk + L * RS;
  float* recv = fv + L * CW;                             // two buffers of RECV
  // the staged inputs of chunk c: r, k (TI), w (float32), v (TI), dy (float32)
  auto in_r = [&](int c) { return reinterpret_cast<TI*>(in + (c & 1) * INB); };
  auto in_k = [&](int c) { return in_r(c) + L * RSI; };
  auto in_w = [&](int c) { return reinterpret_cast<float*>(in_k(c) + L * RSI); };
  auto in_v = [&](int c) { return reinterpret_cast<TI*>(in_w(c) + L * RS); };
  auto in_dy = [&](int c) { return reinterpret_cast<float*>(in_v(c) + L * CW); };

  const int ncb = p.ncb;
  const int bh = blockIdx.x / ncb, cb = blockIdx.x % ncb;    // cb: rank in the cluster
  const int b = bh / p.H, h = bh % p.H, j0 = cb * CW;
  const int tid = threadIdx.x, n = p.n;
  const int i = tid / BQ, q = tid % BQ, jq = q * BQ;        // the walk's row and columns
  const bool vec = p.vec;
  const bool row_ok = i < n;
  const int vcols = n - j0 - jq;        // of this thread's BQ columns, the valid ones
  const long long row = static_cast<long long>(p.H) * n;       // stride of t
  const long long base = static_cast<long long>(b) * p.S * row + static_cast<long long>(h) * n;
  const long long sbase = static_cast<long long>(bh) * n * n + static_cast<long long>(i) * n + j0 + jq;
  const int chunks = (p.S + L - 1) / L;
  auto steps_of = [&](int c) { return min(L, p.S - c * L); };
  // this thread's BQ state values at chunk c's start: ck[c * BT + tid],
  // c < chunks - 1
  float4* ck = reinterpret_cast<float4*>(p.ckpt) + static_cast<long long>(blockIdx.x) * (chunks - 1) * BT;

  // The first walk: the state at every chunk's start, a chunk at a time
  // as S <- diag(a_L) S + X, X = sum_t (k_t b_t)^T v_t. X does not wait
  // for S, so the chain is one FMA a chunk: the chunks go in groups of
  // G1, their X formed side by side after one barrier. k, w and v are
  // copied in a group ahead, into a ring of two groups over the space the
  // second walk uses later. Every chunk but the last (which this walk
  // skips) is whole.
  constexpr int G1 = 3;
  constexpr int P1B = static_cast<int>(L * RSI * sizeof(TI) + 4 * L * RS + L * CW * sizeof(TI));
  static_assert(P1B % 16 == 0 && 2 * G1 * P1B <= bwd_smem_bytes<TI>(), "the ring");
  auto p1_k = [&](int c) { return reinterpret_cast<TI*>(in + (c % (2 * G1)) * P1B); };
  auto p1_w = [&](int c) { return reinterpret_cast<float*>(p1_k(c) + L * RSI); };
  auto p1_v = [&](int c) { return reinterpret_cast<TI*>(p1_w(c) + L * RS); };
  auto stage_group = [&](int c0) {
    for (int c = c0; c < c0 + G1 && c + 1 < chunks; ++c) {
      const long long o = base + static_cast<long long>(c) * L * row;
      if (vec) {
        stage_one<NMAX>(p1_k(c), RSI, p.k + o, row, L, L, n, tid);
        stage_one<NMAX>(p1_w(c), RS, p.w + o, row, L, L, n, tid);
        stage_one<CW>(p1_v(c), CW, p.v + o + j0, row, L, L, min(CW, n - j0), tid);
      } else {
        stage<NMAX>(p1_k(c), RSI, p.k + o, row, L, L, n, false, tid, BT);
        stage<NMAX>(p1_w(c), RS, p.w + o, row, L, L, n, false, tid, BT);
        stage<CW>(p1_v(c), CW, p.v + o + j0, row, L, L, min(CW, n - j0), false, tid, BT);
      }
    }
    cp_async_commit();
  };
  float s1[BQ];
#pragma unroll
  for (int jj = 0; jj < BQ; ++jj) s1[jj] = (p.s0 && row_ok && jj < vcols) ? p.s0[sbase + jj] : 0.f;
  stage_group(0);
  for (int c0 = 0; c0 + 1 < chunks; c0 += G1) {
    cp_async_wait_all();
    __syncthreads();                    // group c0 is in; the group before it is read
    stage_group(c0 + G1);
    float x[G1][BQ], aL[G1];
#pragma unroll
    for (int g1 = 0; g1 < G1; ++g1) {
      const TI* K1 = p1_k(c0 + g1);
      const float* W1 = p1_w(c0 + g1);
      const TI* V1 = p1_v(c0 + g1);
      float wv[L], kbv[L];
#pragma unroll
      for (int t = 0; t < L; ++t) {
        wv[t] = W1[t * RS + i];
        kbv[t] = to_f32(K1[t * RSI + i]);
      }
      float bb = 1.f;
#pragma unroll
      for (int t = L - 1; t >= 0; --t) {
        kbv[t] *= bb;
        bb *= wv[t];
      }
      aL[g1] = bb;
#pragma unroll
      for (int jj = 0; jj < BQ; ++jj) x[g1][jj] = 0.f;
#pragma unroll
      for (int t = 0; t < L; ++t) {
        float vv[BQ];
        lds(vv, V1 + t * CW + jq);
#pragma unroll
        for (int jj = 0; jj < BQ; ++jj) x[g1][jj] = fmaf(kbv[t], vv[jj], x[g1][jj]);
      }
    }
#pragma unroll
    for (int g1 = 0; g1 < G1; ++g1) {
      if (c0 + g1 + 1 < chunks) {       // a group past the last whole chunk: stale X
        ck[(c0 + g1) * BT + tid] = make_float4(s1[0], s1[1], s1[2], s1[3]);
#pragma unroll
        for (int jj = 0; jj < BQ; ++jj) s1[jj] = fmaf(aL[g1], s1[jj], x[g1][jj]);
      }
    }
  }
  // the last chunk's start stays in registers: the second walk takes it
  // first, and loads each chunk's start a chunk ahead
  float4 c4n = make_float4(s1[0], s1[1], s1[2], s1[3]);
  cp_async_wait_all();
  cluster.sync();                       // the ring's space is free, in every CTA
                                        //   of the cluster (its peers write there next)

  // The second walk, chunks last first. Each chunk's inputs are copied in
  // (cp.async) while the chunk before it is worked on; r, k and v of half
  // types are converted to float32 once, into fr, fk and fv. Partial row
  // sums go to the CTA that owns the row (rank i / RB, RB = ceil(n / ncb)
  // <= 16 rows each) by stores into its shared memory: recv[src][x][t][i -
  // rank RB] for output x (dr, dk, dw) of step t from rank src, then each
  // rank's v . dy of step t at VDY0 + src L + t.
  auto stage_chunk = [&](int c) {
    const long long o = base + static_cast<long long>(c) * L * row;
    const int nv = steps_of(c), nc = min(CW, n - j0);
    static_assert(L * NMAX / 4 <= BT, "one 16-byte piece a lane and array");
    if (vec) {
      stage_one<NMAX>(in_r(c), RSI, p.r + o, row, L, nv, n, tid);
      stage_one<NMAX>(in_k(c), RSI, p.k + o, row, L, nv, n, tid);
      stage_one<NMAX>(in_w(c), RS, p.w + o, row, L, nv, n, tid);
      stage_one<CW>(in_v(c), CW, p.v + o + j0, row, L, nv, nc, tid);
      stage_one<CW>(in_dy(c), CW, p.dy + o + j0, row, L, nv, nc, tid);
    } else {
      stage<NMAX>(in_r(c), RSI, p.r + o, row, L, nv, n, false, tid, BT);
      stage<NMAX>(in_k(c), RSI, p.k + o, row, L, nv, n, false, tid, BT);
      stage<NMAX>(in_w(c), RS, p.w + o, row, L, nv, n, false, tid, BT);
      stage<CW>(in_v(c), CW, p.v + o + j0, row, L, nv, nc, false, tid, BT);
      stage<CW>(in_dy(c), CW, p.dy + o + j0, row, L, nv, nc, false, tid, BT);
    }
    cp_async_commit();
  };
  const int RB = (n + ncb - 1) / ncb;   // rows a rank owns
  const int own = i / RB, il = i - own * RB;
  // where this thread's three partial sums of a group of BQ steps go in
  // the owner's buffer (lane q ends the reduce-scatter with entries 3q ..
  // 3q+2 of the 12, entry e being output e / BQ at step e % BQ of the group)
  int pofs[3];
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const int ent = 3 * q + e;
    pofs[e] = ((cb * 3 + ent / BQ) * L + ent % BQ) * RBS + il;
  }
  // the partial sums' phase: step t_r and row rl of this rank's rows
  const int t_r = tid / RBS, rl = tid % RBS, rrow = cb * RB + rl;
  const bool r_ok = rl < RB && rrow < n;
  static_assert(L * RBS == BT, "a lane a (step, row)");
  float g[BQ];                          // G, row i, this thread's columns
#pragma unroll
  for (int jj = 0; jj < BQ; ++jj) g[jj] = (p.dsf && row_ok && jj < vcols) ? p.dsf[sbase + jj] : 0.f;
  const float* uh = p.u + static_cast<long long>(h) * n;
  // u at rows 2 (tid % 32) and the next, for A's diagonal, and at rrow
  const int i2 = 2 * (tid % 32);
  const float u0 = i2 < n ? uh[i2] : 0.f, u1 = i2 + 1 < n ? uh[i2 + 1] : 0.f;
  const float ur = r_ok ? uh[rrow] : 0.f;
  float du_acc = 0.f;
  stage_chunk(chunks - 1);
  cp_async_wait_all();
  __syncthreads();
  {
    // the last chunk's steps past S get w = 1 (the copies left zeros), so
    // the running products of w need no test of t (r, k, v, dy stay 0)
    const int T = steps_of(chunks - 1);
    float* W = in_w(chunks - 1);
    for (int e = tid; e < (L - T) * NMAX; e += BT) W[(T + e / NMAX) * RS + e % NMAX] = 1.f;
    __syncthreads();
  }

  for (int c = chunks - 1; c >= 0; --c) {
    const int T = steps_of(c);
    const float* W = in_w(c);
    const float* DY = in_dy(c);
    float* rv = recv + (c & 1) * RECV;
    const float4 c4 = c4n;
    if (c > 0) c4n = ck[(c - 1) * BT + tid];
    // G_out into shared memory for dv; chunk c-1's inputs copied in behind
    *reinterpret_cast<float4*>(Gs + i * CW + jq) = make_float4(g[0], g[1], g[2], g[3]);
    if (c > 0) stage_chunk(c - 1);
    // r, k and v as float32: 8 elements of r or k a thread, one of v
    const float* R;
    const float* K;
    const float* V;
    if constexpr (sizeof(TI) == 4) {
      R = reinterpret_cast<const float*>(in_r(c));
      K = reinterpret_cast<const float*>(in_k(c));
      V = reinterpret_cast<const float*>(in_v(c));
    } else {
      const int e = tid % 128, t = e / 8, x8 = (e % 8) * 8;
      const TI* src = (tid < 128 ? in_r(c) : in_k(c)) + t * RSI + x8;
      float* dst = (tid < 128 ? fr : fk) + t * RS + x8;
      float f[8];
      lds(f, src);
      *reinterpret_cast<float4*>(dst) = make_float4(f[0], f[1], f[2], f[3]);
      *reinterpret_cast<float4*>(dst + 4) = make_float4(f[4], f[5], f[6], f[7]);
      fv[tid] = to_f32(in_v(c)[tid]);
      R = fr;
      K = fk;
      V = fv;
      __syncthreads();
    }

    // The slice's v . dy, to every rank of the cluster
    if (tid < L) {
      float a = 0.f;
#pragma unroll
      for (int j = 0; j < CW; ++j) a = fmaf(V[tid * CW + j], DY[tid * CW + j], a);
#pragma unroll
      for (int rk = 0; rk < 4; ++rk)
        if (rk < ncb) cluster.map_shared_rank(rv, rk)[VDY0 + cb * L + tid] = a;
    }

    // Phase 2: the walk. Sub-chunks of SUB steps, last first: the states
    // S_{t-1} of the sub-chunk forward from the chunk's start, then G back
    // through it with the partial sums of dr (S dy), dk (G v) and dw
    // (G * S) over this thread's columns; every BQ steps the row's BQ
    // lanes reduce-scatter them and send each to the row's owner.
    {
      float* dst = cluster.map_shared_rank(rv, own < ncb ? own : 0);
      // one sub-chunk; t0 a compile-time constant, so st stays in registers;
      // a whole chunk (FULL) tests no step against T
      auto sub_chunk = [&](auto t0c, auto fullc) {
        constexpr int t0 = decltype(t0c)::value;
        constexpr bool FULL = decltype(fullc)::value;
        float st[SUB][BQ];
        float red[3 * BQ];
        float sx[BQ] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int t = 0; t < t0 + SUB; ++t) {
          if (t >= t0) {
#pragma unroll
            for (int jj = 0; jj < BQ; ++jj) st[t - t0][jj] = sx[jj];
          }
          if (t + 1 < t0 + SUB && (FULL || t < T)) {
            const float wi = W[t * RS + i], ki = K[t * RS + i];
            float vv[BQ];
            lds(vv, V + t * CW + jq);
#pragma unroll
            for (int jj = 0; jj < BQ; ++jj) sx[jj] = fmaf(wi, sx[jj], ki * vv[jj]);
          }
        }
#pragma unroll
        for (int x = SUB - 1; x >= 0; --x) {
          const int t = t0 + x;
          float pdr = 0.f, pdk = 0.f, pdw = 0.f;
          if (FULL || t < T) {
            const float ri = R[t * RS + i], wi = W[t * RS + i];
            float vv[BQ], dd[BQ];
            lds(vv, V + t * CW + jq);
            lds(dd, DY + t * CW + jq);
#pragma unroll
            for (int jj = 0; jj < BQ; ++jj) {
              pdr = fmaf(st[x][jj], dd[jj], pdr);
              pdk = fmaf(g[jj], vv[jj], pdk);
              pdw = fmaf(g[jj], st[x][jj], pdw);
              g[jj] = fmaf(wi, g[jj], ri * dd[jj]);
            }
          }
          red[x % BQ] = pdr;
          red[BQ + x % BQ] = pdk;
          red[2 * BQ + x % BQ] = pdw;
          if (x % BQ == 0) {
            reduce_scatter<2, 6>(red, q);
            reduce_scatter<1, 3>(red, q);
            if (row_ok) {
#pragma unroll
              for (int e = 0; e < 3; ++e) dst[pofs[e] + t * RBS] = red[e];
            }
          }
        }
      };
      auto walk = [&](auto fullc) {
        static_assert(L == 2 * SUB, "two sub-chunks");
        sub_chunk(std::integral_constant<int, SUB>{}, fullc);
        sub_chunk(std::integral_constant<int, 0>{}, fullc);
      };
      if (T == L) walk(std::true_type{});
      else walk(std::false_type{});
    }
    // Phase 1, after the walk, so that the walk's last stores to its peers
    // land while it runs; no barrier between them: what phase 1 writes is
    // read after the cluster barrier. A and its diagonal, and k * b.
    // A below the diagonal as the forward forms it: warp grp takes s = grp
    // for t = grp+1 .. L-1, then s = L-1-grp for t = L-grp .. L-1 (L - 1
    // entries each), then the diagonal at t = grp and t = L-1-grp; a lane
    // sums rows 2 lane and 2 lane + 1. The warp adds its lanes 16 apart by
    // shuffles, then the 16 halves through the other receive buffer, free
    // until this chunk's cluster barrier (lane e sums entry e, in lane
    // order). Steps past T have r = 0.
    {
      const int grp = tid / 32, lane = tid % 32;
      float red[L + 1];
      switch (grp) {                    // warp-uniform: each warp's entries at constant indices
        case 0: a_partials<0>(red, R, K, W, i2, u0, u1); break;
        case 1: a_partials<1>(red, R, K, W, i2, u0, u1); break;
        case 2: a_partials<2>(red, R, K, W, i2, u0, u1); break;
        case 3: a_partials<3>(red, R, K, W, i2, u0, u1); break;
        case 4: a_partials<4>(red, R, K, W, i2, u0, u1); break;
        case 5: a_partials<5>(red, R, K, W, i2, u0, u1); break;
        case 6: a_partials<6>(red, R, K, W, i2, u0, u1); break;
        default: a_partials<7>(red, R, K, W, i2, u0, u1); break;
      }
#pragma unroll
      for (int e = 0; e < L + 1; ++e) red[e] += __shfl_xor_sync(0xffffffffu, red[e], 16);
      float* sa = recv + ((c + 1) & 1) * RECV + grp * (L + 1) * 16;
      if (lane < 16) {
#pragma unroll
        for (int e = 0; e < L + 1; ++e) sa[e * 16 + lane] = red[e];
      }
      __syncwarp();
      if (lane < L + 1) {
        float a = 0.f;
#pragma unroll
        for (int l = 0; l < 16; l += 4) {
          const float4 x = *reinterpret_cast<const float4*>(sa + lane * 16 + l);
          a += (x.x + x.y) + (x.z + x.w);
        }
        if (lane < L - 1) {
          const bool first = lane < L - 1 - grp;
          const int s = first ? grp : L - 1 - grp;
          const int t = first ? grp + 1 + lane : lane + 1;
          Am[t * AS + s] = a;
        } else {
          Dg[lane == L - 1 ? grp : L - 1 - grp] = a;
        }
      }
    }
    {
      // b_t = prod_{t<tau<T} w_tau[i] backward along the row; this thread
      // writes k_t b_t for its steps t = q, q + BQ, ...
      float wv[L];
#pragma unroll
      for (int t = 0; t < L; ++t) wv[t] = W[t * RS + i];
      float bb = 1.f;
#pragma unroll
      for (int t = L - 1; t >= 0; --t) {
        if (t % BQ == q) kb[t * NMAX + i] = K[t * RS + i] * bb;
        bb *= wv[t];
      }
    }
    cluster_arrive();                   // this CTA's partial sums of chunk c are sent
    __syncthreads();                    // A, k * b and G_out are in

    // Phase 3: dv_t[j] = sum_i (k_t b_t)[i] G_out[i][j] + A[t][t] dy_t[j]
    //                    + sum_{s>t} A[s][t] dy_s[j], lane (t, j), while the
    // cluster's barrier completes
    {
      const int t = tid / CW, j = tid % CW;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ii = 0; ii < NMAX; ii += 4) {
        const float4 x = *reinterpret_cast<const float4*>(kb + t * NMAX + ii);
        acc[0] = fmaf(x.x, Gs[ii * CW + j], acc[0]);
        acc[1] = fmaf(x.y, Gs[(ii + 1) * CW + j], acc[1]);
        acc[2] = fmaf(x.z, Gs[(ii + 2) * CW + j], acc[2]);
        acc[3] = fmaf(x.w, Gs[(ii + 3) * CW + j], acc[3]);
      }
      float ad = Dg[t] * DY[t * CW + j];
#pragma unroll
      for (int s2 = 1; s2 < L; ++s2)
        if (s2 > t && s2 < T) ad = fmaf(Am[s2 * AS + t], DY[s2 * CW + j], ad);
      if (t < T && j0 + j < n)
        store_as(p.dv + base + static_cast<long long>(c * L + t) * row + j0 + j,
                 ((acc[0] + acc[1]) + (acc[2] + acc[3])) + ad);
    }
    cluster_wait();                     // every CTA's partial sums of chunk c are in

    // Phase 4: this rank's rows, lane (t, rl): dr, dk and dw of row rrow
    // at step t, the partial sums received added in rank order, then u's
    // terms with the whole v . dy, and the step's share of du
    if (r_ok && t_r < T) {
      float sum[3] = {0.f, 0.f, 0.f}, vdy = 0.f;
#pragma unroll
      for (int src = 0; src < 4; ++src) {
        const bool on = src < ncb;      // loads stay inside the buffer either way
#pragma unroll
        for (int x = 0; x < 3; ++x) {
          const float part = rv[((src * 3 + x) * L + t_r) * RBS + rl];
          sum[x] += on ? part : 0.f;
        }
        const float part = rv[VDY0 + src * L + t_r];
        vdy += on ? part : 0.f;
      }
      const float ri = R[t_r * RS + rrow], ki = K[t_r * RS + rrow];
      const long long o = base + static_cast<long long>(c * L + t_r) * row + rrow;
      store_as(p.dr + o, fmaf(ur * ki, vdy, sum[0]));
      store_as(p.dk + o, fmaf(ur * ri, vdy, sum[1]));
      p.dw[o] = sum[2];
      du_acc = fmaf(ri * ki, vdy, du_acc);
    }
    cp_async_wait_all();
    __syncthreads();                    // chunk c-1's inputs are in; G_out, k * b, A are free
  }
#pragma unroll
  for (int jj = 0; jj < BQ; ++jj)
    if (row_ok && jj < vcols) p.ds0[sbase + jj] = g[jj];
  p.du_part[static_cast<long long>(blockIdx.x) * BT + tid] = du_acc;
}

// du[h][i] = sum over b, then over the chunk steps t of the row's owner
// (rank i / RB), in order, of the CTAs' partial sums
__global__ void rwkv6_du_kernel(const float* du_part, float* du, int B, int H, int n, int ncb) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= H * n) return;
  const int h = e / n, i = e % n, rb = (n + ncb - 1) / ncb, r = i / rb, il = i - r * rb;
  float acc = 0.f;
  for (int b = 0; b < B; ++b)
    for (int t = 0; t < L; ++t)
      acc += du_part[((static_cast<long long>(b) * H + h) * ncb + r) * BT + t * RBS + il];
  du[e] = acc;
}

template <typename TI>
int launch_backward(const BwdParams<TI>& p, int bytes, cudaStream_t s) {
  static bool configured = false;       // the attributes are set once per instantiation
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(rwkv6_backward_kernel<TI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(rwkv6_backward_kernel<TI>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.B * p.H * p.ncb);
  cfg.blockDim = dim3(BT);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.ncb;     // the column slices of one (batch, head)
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, rwkv6_backward_kernel<TI>, p);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

template <typename TI>
int run_backward(const void* r, const void* k, const void* v, const void* w,
                 const void* u, const void* s0, const void* dy, const void* dsf,
                 void* dr, void* dk, void* dv, void* dw, void* du, void* ds0,
                 void* scratch, int B, int S, int H, int n, int chunk, int cols,
                 int cluster, cudaStream_t s) {
  const int ncb = (n + CW - 1) / CW;
  const int chunks = (S + L - 1) / L;
  // the plan this file compiles (kernels/rwkv6.py::plan_backward)
  if (chunk != L || cols != CW || cluster != ncb) return static_cast<int>(cudaErrorInvalidValue);
  BwdParams<TI> p;
  p.r = static_cast<const TI*>(r);
  p.k = static_cast<const TI*>(k);
  p.v = static_cast<const TI*>(v);
  p.w = static_cast<const float*>(w);
  p.u = static_cast<const float*>(u);
  p.s0 = static_cast<const float*>(s0);
  p.dy = static_cast<const float*>(dy);
  p.dsf = static_cast<const float*>(dsf);
  p.dr = static_cast<TI*>(dr);
  p.dk = static_cast<TI*>(dk);
  p.dv = static_cast<TI*>(dv);
  p.dw = static_cast<float*>(dw);
  p.ds0 = static_cast<float*>(ds0);
  p.B = B; p.S = S; p.H = H; p.n = n; p.ncb = ncb;
  // 16-byte copies: rows of r, k, v (16 / sizeof(TI) elements), of w and
  // of dy (4 floats) on 16-byte boundaries
  p.vec = n % static_cast<int>(16 / sizeof(TI)) == 0 && n % 4 == 0 && aligned16(r) &&
          aligned16(k) && aligned16(v) && aligned16(w) && aligned16(dy);
  // scratch: the chunk starts, then du's partial sums
  float* sc = static_cast<float*>(scratch);
  p.ckpt = sc;
  p.du_part = sc + static_cast<long long>(B) * H * ncb * (chunks - 1) * NMAX * CW;
  const int e = launch_backward<TI>(p, bwd_smem_bytes<TI>(), s);
  if (e != 0) return e;
  rwkv6_du_kernel<<<(H * n + 255) / 256, 256, 0, s>>>(p.du_part, static_cast<float*>(du), B, H,
                                                      n, ncb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype of r, k and v: 0 float32, 1 bfloat16, 2 float16 (w, u, s0, y
// and the final state are float32 whatever it is)
extern "C" int repro_rwkv6_scan(
    const void* r, const void* k, const void* v, const void* w,
    const void* u, const void* s0, void* y, void* sf,
    int B, int S, int H, int n, int chunk, int dtype, void* stream) {
  if (n < 1 || n > NMAX || S < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return run<float>(r, k, v, w, u, s0, y, sf, B, S, H, n, chunk, s);
    case 1: return run<__nv_bfloat16>(r, k, v, w, u, s0, y, sf, B, S, H, n, chunk, s);
    case 2: return run<__half>(r, k, v, w, u, s0, y, sf, B, S, H, n, chunk, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The backward: dr, dk, dv in r's dtype, dw (B, S, H, n), du (H, n) and
// ds0 (B, H, n, n) float32, from the forward's inputs, dy (B, S, H, n)
// float32 and dsf (B, H, n, n) float32 or null (zeros). The plan
// (kernels/rwkv6.py::plan_backward), which this file compiles and checks:
// chunk (16) steps, cols (16) columns a CTA, cluster (ceil(n / 16)) CTAs.
// scratch holds backward_scratch_bytes of it: the chunk starts,
// B * H * cluster * (ceil(S / 16) - 1) * 64 * 16 floats, then
// B * H * cluster * 256 floats of du's partial sums. Two launches: the
// backward, then du's sum over the batch.
extern "C" int repro_rwkv6_scan_backward(
    const void* r, const void* k, const void* v, const void* w,
    const void* u, const void* s0, const void* dy, const void* dsf,
    void* dr, void* dk, void* dv, void* dw, void* du, void* ds0,
    void* scratch, int B, int S, int H, int n, int dtype,
    int chunk, int cols, int cluster, void* stream) {
  if (n < 1 || n > NMAX || S < 1 || B < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return run_backward<float>(r, k, v, w, u, s0, dy, dsf, dr, dk, dv, dw, du, ds0,
                                       scratch, B, S, H, n, chunk, cols, cluster, s);
    case 1: return run_backward<__nv_bfloat16>(r, k, v, w, u, s0, dy, dsf, dr, dk, dv, dw, du,
                                               ds0, scratch, B, S, H, n, chunk, cols, cluster,
                                               s);
    case 2: return run_backward<__half>(r, k, v, w, u, s0, dy, dsf, dr, dk, dv, dw, du, ds0,
                                        scratch, B, S, H, n, chunk, cols, cluster, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
