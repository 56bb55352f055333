// One-token decode attention against a ring-buffer KV cache, for Hopper
// (sm_90a); float32 or bfloat16 in, float32 accumulation, out in q's type.
//
// Replaces repro/kernels/decode_attention.py::decode_attention (the Pallas
// TPU kernel) and computes what its oracle,
// repro/models/attention.py::plain_attention_vs_cache, computes: the G =
// H / KV query heads of one new token that share kv head h attend to the
// W slots of the cache; slot j is valid iff 0 <= pos[j] <= t and, with a
// window, t - pos[j] < window. Invalid slots score -1e30, the oracle's
// mask value, and are NOT masked again after the exp: while no slot is
// valid every slot carries weight exp(0) = 1, so a cache with no valid
// slot gives the plain mean of v over the W slots, as the oracle's
// softmax does. No padded slot ever enters a sum: every loop runs to the
// real end of its chunk (the Pallas kernel pads W to a block multiple,
// and its padded slots would join that mean).
//
// What bounds it on this card. Mistral-NeMo-12B decodes with B=1, W=1024,
// H=32, KV=8, D=128 in bf16: the K and V rows of the valid slots (4.19 MB
// for all 1024) are read once, against 4 D operations per (query head,
// valid slot), ~17 MOP at most: ~0.3 us on the float32 cores against
// ~1.25 us of HBM traffic at 3.35 TB/s (the H100 SXM at its 700 W limit).
// The kernel is bound by bytes, and at this size by the latency of
// getting them in flight; no tensor core is worth its setup here.
//
// What the design does about that (flash-decode). The W slots are cut
// into nsplit contiguous chunks (the host's plan_splits picks nsplit for
// about one wave of the 132 SMs: 8 kv heads x 16 chunks of 64 slots at
// Mistral's shape), and the grid is (B * KV, ceil(G / GB), nsplit): each
// block reads its chunk's K and V once for the GB query heads that share
// them, through the cache's (B, W, KV, D) strides (no copy).
//   * At block start the chunk's K and V rows (64 slots a tile, 32 KB in
//     bf16) go into dynamic shared memory with 16-byte cp.async copies,
//     all in flight at once; a longer chunk streams through two such
//     tiles, the next one loading while the current one is scored. Rows
//     whose strides are not 16-byte multiples are staged element by
//     element instead.
//   * Each block first reads the W positions (4 KB): once it knows some
//     slot of the cache is valid, the rows of invalid slots are never
//     read (cp.async zero-fills them; their weight is exactly 0 after the
//     merge), and a chunk with no valid slot skips its work.
//   * Scores come from shared memory in 16-byte reads (8 bf16 or 4
//     float32 a lane, 16 or 32 lanes to a 128-wide row), an online
//     softmax per query row runs one warp a row, and p @ v accumulates in
//     registers per (slot group, 16-byte column) before one reduction
//     through shared memory.
//   * The nsplit partial (max, denominator, accumulator) of one (batch,
//     kv head, row group) merge inside a thread-block cluster along the
//     split axis, through distributed shared memory: one launch, no
//     scratch in device memory. A chunk without a valid slot beside one
//     with a valid slot gets factor exp(-1e30 - m) = 0; while no slot is
//     valid every factor is 1 and the denominators add up to W.
// t is read on the card from a 0-d int32 tensor, so a decode step never
// waits for the host. Head dims are padded to 32, 64 or 128 with zeros;
// the host refuses D > 128.
//
// C interface (bound with ctypes): pointers as void*, strides in
// elements, the CUDA stream last; returns the CUDA error of the attribute
// calls or the launch as an int (0 on success).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int GB = 4;                   // query rows (grouped heads) per block
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int TS = 64;                  // slots per shared-memory tile
constexpr int MAX_SPLIT = 16;           // cluster size; above 8 is non-portable
constexpr float NEG_INF = -1e30f;       // the oracle's mask value

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;                              // contiguous (B, 1, H, Dv)
  const int* pos;                       // (W,)
  const int* t;                         // 0-d
  int B, W, H, KV, D, Dv;
  long long q_sb, q_sh;
  long long k_sb, k_sw, k_sh;
  long long v_sb, v_sw, v_sh;
  float scale;
  int window;
  int nsplit, chunk;                    // chunk i holds slots [i * chunk, min(W, (i + 1) * chunk))
};

// per (dtype, padded head dim): 16-byte vectors of a row and who reads them
template <typename T, int DP>
struct Shape {
  static constexpr int VEC = 16 / static_cast<int>(sizeof(T));  // elements a lane
  static constexpr int LPR = DP / VEC;  // lanes to a row
  static constexpr int SPW = 32 / LPR;  // rows a warp scores at once
  static constexpr int NGRP = THREADS / LPR;  // slot groups of p @ v
};

// dynamic shared memory: [K/V tiles | reduction][scores][partial acc][m, l, corr]
struct Layout {
  size_t scores, acc, stats, bytes;
  __host__ __device__ Layout(int dp, int elem, int tile_rows, int nbuf) {
    const size_t tiles = static_cast<size_t>(nbuf) * 2 * tile_rows * dp * elem;
    const size_t red = static_cast<size_t>(THREADS) * (16 / elem) * GB * 4;
    scores = ((tiles > red ? tiles : red) + 15) & ~static_cast<size_t>(15);
    acc = scores + GB * TS * 4;
    stats = acc + static_cast<size_t>(GB) * dp * 4;
    bytes = stats + 3 * GB * 4;
  }
};

__host__ __device__ inline int tile_rows(int chunk) { return chunk < TS ? chunk : TS; }
__host__ __device__ inline int n_buffers(int chunk) { return chunk > TS ? 2 : 1; }

__device__ __forceinline__ bool is_valid(int pj, int t, int window) {
  return pj >= 0 && pj <= t && (window <= 0 || t - pj < window);
}

__device__ __forceinline__ void load_vec(const float* s, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(s);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* s, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(s);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}
__device__ __forceinline__ void store(float* o, float x) { *o = x; }
__device__ __forceinline__ void store(__nv_bfloat16* o, float x) {
  *o = __float2bfloat16(x);             // round to nearest even, as .to(bfloat16)
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// 16 bytes global -> shared; only the first `bytes` are read, the rest zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// K and V rows of slots [j0, j0 + n) into a tile (rows of DP elements,
// zero past the head dim, and zero for invalid slots when `skip`)
template <typename T, int DP, bool ALIGNED>
__device__ __forceinline__ void stage(const Params& p, const T* kb, const T* vb,
                                      T* Kt, T* Vt, int j0, int n, int t,
                                      bool skip) {
  if constexpr (ALIGNED) {
    constexpr int VEC = 16 / static_cast<int>(sizeof(T));
    constexpr int CH = DP / VEC;        // 16-byte pieces of a row
    for (int idx = threadIdx.x; idx < 2 * n * CH; idx += THREADS) {
      const bool is_v = idx >= n * CH;
      const int rem = is_v ? idx - n * CH : idx;
      const int j = rem / CH, ch = rem % CH;
      const T* row = is_v ? vb + (j0 + j) * p.v_sw : kb + (j0 + j) * p.k_sw;
      const int width = (is_v ? p.Dv : p.D) * static_cast<int>(sizeof(T));
      int bytes = min(16, max(0, width - ch * 16));
      if (skip && !is_valid(p.pos[j0 + j], t, p.window)) bytes = 0;
      cp_async16((is_v ? Vt : Kt) + j * DP + ch * VEC,
                 bytes > 0 ? row + ch * VEC : row, bytes);
    }
  } else {
    for (int idx = threadIdx.x; idx < 2 * n * DP; idx += THREADS) {
      const bool is_v = idx >= n * DP;
      const int rem = is_v ? idx - n * DP : idx;
      const int j = rem / DP, d = rem % DP;
      const T* row = is_v ? vb + (j0 + j) * p.v_sw : kb + (j0 + j) * p.k_sw;
      const bool keep = d < (is_v ? p.Dv : p.D) &&
                        !(skip && !is_valid(p.pos[j0 + j], t, p.window));
      (is_v ? Vt : Kt)[j * DP + d] = keep ? row[d] : zero<T>();
    }
  }
}

template <typename T, int DP, bool ALIGNED>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const Params p) {
  using S_ = Shape<T, DP>;
  constexpr int VEC = S_::VEC, LPR = S_::LPR, SPW = S_::SPW, NGRP = S_::NGRP;
  extern __shared__ __align__(16) unsigned char smem[];
  const int trows = tile_rows(p.chunk), nbuf = n_buffers(p.chunk);
  const Layout lay(DP, sizeof(T), trows, nbuf);
  T* tiles = reinterpret_cast<T*>(smem);
  float* S = reinterpret_cast<float*>(smem + lay.scores);   // [GB][TS]
  float* pacc = reinterpret_cast<float*>(smem + lay.acc);   // [GB][DP]
  float* pm = reinterpret_cast<float*>(smem + lay.stats);   // [GB] running max
  float* pl = pm + GB;                                      // [GB] denominator
  float* pcorr = pl + GB;                                   // [GB] last rescale

  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.block_rank());  // == blockIdx.z
  const int b = blockIdx.x / p.KV, kvh = blockIdx.x % p.KV;
  const int G = p.H / p.KV, g0 = blockIdx.y * GB;
  const int rows = min(GB, G - g0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = *p.t;
  const int c0 = split * p.chunk, c1 = min(p.W, c0 + p.chunk);

  // is any slot of the cache valid, and any of this chunk? (The first
  // SCAN positions a thread reads do not wait for t.)
  constexpr int SCAN = 4;
  int pv[SCAN];
#pragma unroll
  for (int u = 0; u < SCAN; ++u) {
    const int j = tid + u * THREADS;
    pv[u] = j < p.W ? p.pos[j] : -1;
  }
  int any = 0, mine = 0;
#pragma unroll
  for (int u = 0; u < SCAN; ++u) {
    const int j = tid + u * THREADS;
    if (is_valid(pv[u], t, p.window)) {
      any = 1;
      mine |= j >= c0 && j < c1;
    }
  }
  for (int j = tid + SCAN * THREADS; j < p.W; j += THREADS)
    if (is_valid(p.pos[j], t, p.window)) {
      any = 1;
      mine |= j >= c0 && j < c1;
    }
  any = __syncthreads_or(any);
  mine = __syncthreads_or(mine);

  if (tid < GB) {
    pm[tid] = NEG_INF;
    pl[tid] = 0.f;
  }
  if (any && !mine) {
    // every slot here scores -1e30 below a valid one elsewhere: weight 0
    for (int e = tid; e < GB * DP; e += THREADS) pacc[e] = 0.f;
  } else {
    const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
    const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
    const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + (kvh * G + g0) * p.q_sh;
    const int c = lane % LPR;           // this thread's 16-byte column
    float q[GB][VEC], acc[GB][VEC];
#pragma unroll
    for (int r = 0; r < GB; ++r)
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const int d = c * VEC + i;
        q[r][i] = (r < rows && d < p.D) ? to_f(qb[r * p.q_sh + d]) : 0.f;
        acc[r][i] = 0.f;
      }

    const int ntiles = (c1 - c0 + TS - 1) / TS;
    const int tile_elems = trows * DP;
    stage<T, DP, ALIGNED>(p, kb, vb, tiles, tiles + tile_elems, c0,
                          min(TS, c1 - c0), t, any);
    cp_async_commit();
    for (int it = 0; it < ntiles; ++it) {
      const int j0 = c0 + it * TS, n = min(TS, c1 - j0);
      if (it + 1 < ntiles) {            // the next tile flies while this one is scored
        T* nk = tiles + ((it + 1) & 1) * 2 * tile_elems;
        stage<T, DP, ALIGNED>(p, kb, vb, nk, nk + tile_elems, j0 + TS,
                              min(TS, c1 - j0 - TS), t, any);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const T* Kt = tiles + (it & 1) * 2 * tile_elems;
      const T* Vt = Kt + tile_elems;

      // scores: LPR lanes to a slot, a 16-byte read each
      for (int jb = 0; jb < n; jb += WARPS * SPW) {
        const int j = jb + warp * SPW + lane / LPR;
        float part[GB];
#pragma unroll
        for (int r = 0; r < GB; ++r) part[r] = 0.f;
        if (j < n) {
          float kx[VEC];
          load_vec(Kt + j * DP + c * VEC, kx);
#pragma unroll
          for (int r = 0; r < GB; ++r)
#pragma unroll
            for (int i = 0; i < VEC; ++i) part[r] += q[r][i] * kx[i];
        }
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1)
#pragma unroll
          for (int r = 0; r < GB; ++r)
            part[r] += __shfl_xor_sync(0xffffffffu, part[r], off);
        if (j < n && c == 0) {
          const bool valid = is_valid(p.pos[j0 + j], t, p.window);
#pragma unroll
          for (int r = 0; r < GB; ++r) S[r * TS + j] = valid ? part[r] * p.scale : NEG_INF;
        }
      }
      __syncthreads();

      // online softmax, one warp a row; no re-mask after the exp
      if (warp < GB) {
        float* Sr = S + warp * TS;
        float mx = NEG_INF;
        for (int j = lane; j < n; j += 32) mx = fmaxf(mx, Sr[j]);
        mx = warp_max(mx);
        const float m_old = pm[warp], m_new = fmaxf(m_old, mx);
        float sum = 0.f;
        for (int j = lane; j < n; j += 32) {
          const float e = expf(Sr[j] - m_new);
          Sr[j] = e;
          sum += e;
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          const float corr = expf(m_old - m_new);
          pcorr[warp] = corr;
          pl[warp] = pl[warp] * corr + sum;
          pm[warp] = m_new;
        }
      }
      __syncthreads();

      // acc += p @ v over this thread's slot group and column
      const int grp = tid / LPR;
#pragma unroll
      for (int r = 0; r < GB; ++r) {
        const float corr = pcorr[r];
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[r][i] *= corr;
      }
      for (int j = grp; j < n; j += NGRP) {
        float vx[VEC];
        load_vec(Vt + j * DP + c * VEC, vx);
#pragma unroll
        for (int r = 0; r < GB; ++r) {
          const float pr = S[r * TS + j];
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[r][i] += pr * vx[i];
        }
      }
      __syncthreads();                  // before the next tile overwrites this one
    }

    // sum the slot groups' accumulators through shared memory
    float* red = reinterpret_cast<float*>(smem);   // [NGRP][GB][DP], over the tiles
    const int grp = tid / LPR;
#pragma unroll
    for (int r = 0; r < GB; ++r)
#pragma unroll
      for (int i = 0; i < VEC; ++i) red[(grp * GB + r) * DP + c * VEC + i] = acc[r][i];
    __syncthreads();
    for (int e = tid; e < GB * DP; e += THREADS) {
      float s = 0.f;
      for (int g = 0; g < NGRP; ++g) s += red[g * GB * DP + e];
      pacc[e] = s;
    }
  }

  // merge the nsplit partial softmaxes of the cluster: every block
  // gathers the (max, denominator) pairs of its rows, then reads the
  // partial accumulators of its share of the outputs, all in flight at once
  __shared__ float s_m[GB][MAX_SPLIT], s_f[GB][MAX_SPLIT], s_den[GB];
  cluster.sync();
  if (tid < GB * MAX_SPLIT) {
    const int r = tid / MAX_SPLIT, sp = tid % MAX_SPLIT;
    const bool in = sp < p.nsplit;
    s_m[r][sp] = in ? *cluster.map_shared_rank(pm + r, sp) : NEG_INF;
    s_f[r][sp] = in ? *cluster.map_shared_rank(pl + r, sp) : 0.f;
  }
  __syncthreads();
  if (tid < GB) {
    float mx = NEG_INF, den = 0.f;
    for (int sp = 0; sp < p.nsplit; ++sp) mx = fmaxf(mx, s_m[tid][sp]);
    for (int sp = 0; sp < MAX_SPLIT; ++sp) {
      const float f = sp < p.nsplit ? expf(s_m[tid][sp] - mx) : 0.f;
      den += s_f[tid][sp] * f;
      s_f[tid][sp] = f;
    }
    s_den[tid] = fmaxf(den, 1e-30f);
  }
  __syncthreads();
  T* ob = static_cast<T*>(p.o) + (static_cast<long long>(b) * p.H + kvh * G + g0) * p.Dv;
  for (int e = split * THREADS + tid; e < rows * p.Dv; e += p.nsplit * THREADS) {
    const int r = e / p.Dv, d = e % p.Dv;
    float part[MAX_SPLIT];
#pragma unroll
    for (int sp = 0; sp < MAX_SPLIT; ++sp)
      part[sp] = sp < p.nsplit ? *cluster.map_shared_rank(pacc + r * DP + d, sp) : 0.f;
    float num = 0.f;
#pragma unroll
    for (int sp = 0; sp < MAX_SPLIT; ++sp) num += part[sp] * s_f[r][sp];
    store(ob + r * p.Dv + d, num / s_den[r]);
  }
  cluster.sync();                       // no block leaves while its memory is read
}

template <typename T, int DP, bool ALIGNED>
int launch_with(const Params& p, cudaStream_t s) {
  auto kernel = decode_attention_kernel<T, DP, ALIGNED>;
  const Layout lay(DP, sizeof(T), tile_rows(p.chunk), n_buffers(p.chunk));
  // attributes are set once per kernel, raised as a larger chunk needs it
  static size_t smem_set = 0;
  static bool non_portable = false;
  cudaError_t err;
  if (lay.bytes > smem_set) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(lay.bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = lay.bytes;
  }
  if (p.nsplit > 8 && !non_portable) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    non_portable = true;
  }
  const int G = p.H / p.KV;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.B * p.KV, (G + GB - 1) / GB, p.nsplit);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = lay.bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = p.nsplit;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) {
    cudaGetLastError();                 // clear it; the caller raises
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DP>
int launch_dp(const Params& p, cudaStream_t s) {
  // 16-byte copies need every row start on a 16-byte boundary
  const long long e = sizeof(T);
  const bool aligned =
      reinterpret_cast<uintptr_t>(p.k) % 16 == 0 && reinterpret_cast<uintptr_t>(p.v) % 16 == 0 &&
      (p.k_sb * e) % 16 == 0 && (p.k_sw * e) % 16 == 0 && (p.k_sh * e) % 16 == 0 &&
      (p.v_sb * e) % 16 == 0 && (p.v_sw * e) % 16 == 0 && (p.v_sh * e) % 16 == 0;
  return aligned ? launch_with<T, DP, true>(p, s) : launch_with<T, DP, false>(p, s);
}

template <typename T>
int launch(const Params& p, cudaStream_t s) {
  const int dp = p.D > p.Dv ? p.D : p.Dv;
  if (dp <= 32) return launch_dp<T, 32>(p, s);
  if (dp <= 64) return launch_dp<T, 64>(p, s);
  if (dp <= 128) return launch_dp<T, 128>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and the output alike).
// nsplit chunks of `chunk` slots cover [0, W), none empty, nsplit <= 16.
extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, void* o,
    const void* pos, const void* t, int dtype,
    int B, int W, int H, int KV, int D, int Dv,
    long long q_sb, long long q_sh,
    long long k_sb, long long k_sw, long long k_sh,
    long long v_sb, long long v_sw, long long v_sh,
    float scale, int window, int nsplit, int chunk, void* stream) {
  if (nsplit < 1 || nsplit > MAX_SPLIT || chunk < 1 ||
      static_cast<long long>(nsplit) * chunk < W ||
      static_cast<long long>(nsplit - 1) * chunk >= W)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.pos = static_cast<const int*>(pos);
  p.t = static_cast<const int*>(t);
  p.B = B; p.W = W; p.H = H; p.KV = KV; p.D = D; p.Dv = Dv;
  p.q_sb = q_sb; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_sw = k_sw; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_sw = v_sw; p.v_sh = v_sh;
  p.scale = scale; p.window = window;
  p.nsplit = nsplit; p.chunk = chunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
