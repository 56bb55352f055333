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
