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
// softmax does. The loop runs to W exactly: no padded slot ever enters
// the sum (the Pallas kernel pads W to a block multiple, and its padded
// slots would join that mean).
//
// What bounds it on this card. Mistral-NeMo-12B decodes with B=1, W=1024,
// H=32, KV=8, D=128 in bf16: the K and V caches are 2 x 1024 x 8 x 128 x
// 2 B = 4.19 MB, read once, against ~17 MFLOP; HBM bandwidth (3.35 TB/s
// at the H100 SXM's 700 W limit) bounds it at ~1.25 us.
//
// What the design does about that, for now: one block per (batch, kv
// head, group of up to 4 query heads) reads K and V once for all the
// query heads that share them, through the cache's (B, W, KV, D) strides
// (no transpose, no copy); t is read on the card from a 0-d int32 tensor,
// so a decode step never waits for the host. Inside the block each of 8
// warps streams its own share of the slots with no barrier, 4 slots at a
// time: the next 4 slots' K and V rows and positions are loaded into
// registers while the current ones are scored (lane l holds head-dim
// elements l, l + 32, ..., so each row read is coalesced); each warp
// keeps its own running max, denominator and accumulator per query row
// in float32, and the 8 partial softmaxes are merged once through shared
// memory at the end. Full width still gives only 8 blocks for 132 SMs, so
// the kernel sits far above its bound; a split-W (flash-decode) form with
// a combine pass, and TMA, are later work. Head dims are padded to 32, 64
// or 128 with zeros; the host refuses D > 128.
//
// C interface (bound with ctypes): pointers as void*, strides in
// elements, the CUDA stream last; returns cudaGetLastError() as an int.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int GB = 4;                   // query rows (grouped heads) per block
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int UNROLL = 4;               // slots a warp holds in registers at once
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
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* o, float x) { *o = x; }
__device__ __forceinline__ void store(__nv_bfloat16* o, float x) {
  *o = __float2bfloat16(x);             // round to nearest even, as .to(bfloat16)
}

__device__ __forceinline__ float warp_sum(float x) {   // every lane gets the sum
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// K and V rows and stored positions of slots j0 .. j0 + UNROLL - 1 into
// registers (zeros past W and past the head dim)
template <typename T, int E>
__device__ __forceinline__ void load_rows(const Params& p, const T* kb,
                                          const T* vb, int j0, int lane,
                                          float (&kx)[UNROLL][E],
                                          float (&vx)[UNROLL][E],
                                          int (&px)[UNROLL]) {
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int j = j0 + u;
    px[u] = j < p.W ? p.pos[j] : -1;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const int d = lane + 32 * i;
      kx[u][i] = (j < p.W && d < p.D) ? to_f(kb[j * p.k_sw + d]) : 0.f;
      vx[u][i] = (j < p.W && d < p.Dv) ? to_f(vb[j * p.v_sw + d]) : 0.f;
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const Params p) {
  constexpr int E = DP / 32;            // head-dim elements per lane
  __shared__ float s_m[WARPS][GB], s_l[WARPS][GB];
  __shared__ float s_acc[WARPS][GB][DP];

  const int b = blockIdx.x / p.KV, kvh = blockIdx.x % p.KV;
  const int G = p.H / p.KV;
  const int g0 = blockIdx.y * GB;
  const int rows = min(GB, G - g0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = *p.t;

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + (kvh * G + g0) * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  float q[GB][E], acc[GB][E], m[GB], l[GB];
#pragma unroll
  for (int r = 0; r < GB; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const int d = lane + 32 * i;
      q[r][i] = (r < rows && d < p.D) ? to_f(qb[r * p.q_sh + d]) : 0.f;
      acc[r][i] = 0.f;
    }
  }

  // warp w takes slots [w * UNROLL, (w + 1) * UNROLL), then WARPS * UNROLL on
  constexpr int STRIDE = WARPS * UNROLL;
  float kx[UNROLL][E], vx[UNROLL][E], nk[UNROLL][E], nv[UNROLL][E];
  int px[UNROLL], np[UNROLL];
  int j0 = warp * UNROLL;
  load_rows<T, E>(p, kb, vb, j0, lane, nk, nv, np);
  for (; j0 < p.W; j0 += STRIDE) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      px[u] = np[u];
#pragma unroll
      for (int i = 0; i < E; ++i) {
        kx[u][i] = nk[u][i];
        vx[u][i] = nv[u][i];
      }
    }
    if (j0 + STRIDE < p.W)              // the next slots' loads fly while these are scored
      load_rows<T, E>(p, kb, vb, j0 + STRIDE, lane, nk, nv, np);
    // no branch below: the (slot, row) chains interleave. A slot past W
    // scores -inf (weight exactly 0, the running max unchanged); rows past
    // the block's query heads hold q = 0 and are never written.
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int pj = px[u];
      bool valid = pj >= 0 && pj <= t;
      if (p.window > 0) valid = valid && t - pj < p.window;
      const float mask = j0 + u < p.W ? NEG_INF : -CUDART_INF_F;
#pragma unroll
      for (int r = 0; r < GB; ++r) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < E; ++i) part += q[r][i] * kx[u][i];
        const float sum = warp_sum(part);
        const float s = valid ? sum * p.scale : mask;
        // online softmax; an invalid slot keeps weight exp(0) = 1 while no
        // slot is valid (no re-mask: see the header)
        const float m_new = fmaxf(m[r], s);
        const float corr = expf(m[r] - m_new);
        const float pr = expf(s - m_new);
        l[r] = l[r] * corr + pr;
#pragma unroll
        for (int i = 0; i < E; ++i) acc[r][i] = acc[r][i] * corr + pr * vx[u][i];
        m[r] = m_new;
      }
    }
  }

  // merge the warps' partial softmaxes
#pragma unroll
  for (int r = 0; r < GB; ++r) {
    if (lane == 0) {
      s_m[warp][r] = m[r];
      s_l[warp][r] = l[r];
    }
#pragma unroll
    for (int i = 0; i < E; ++i) s_acc[warp][r][lane + 32 * i] = acc[r][i];
  }
  __syncthreads();
  T* ob = static_cast<T*>(p.o) + (static_cast<long long>(b) * p.H + kvh * G + g0) * p.Dv;
  for (int e = tid; e < rows * p.Dv; e += THREADS) {
    const int r = e / p.Dv, d = e % p.Dv;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, s_m[w][r]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = expf(s_m[w][r] - mx);
      den += s_l[w][r] * f;
      num += s_acc[w][r][d] * f;
    }
    store(ob + r * p.Dv + d, num / fmaxf(den, 1e-30f));
  }
}

template <typename T>
int launch(const Params& p, cudaStream_t s) {
  const int G = p.H / p.KV;
  const dim3 grid(p.B * p.KV, (G + GB - 1) / GB);
  const int dp = p.D > p.Dv ? p.D : p.Dv;
  if (dp <= 32) decode_attention_kernel<T, 32><<<grid, THREADS, 0, s>>>(p);
  else if (dp <= 64) decode_attention_kernel<T, 64><<<grid, THREADS, 0, s>>>(p);
  else if (dp <= 128) decode_attention_kernel<T, 128><<<grid, THREADS, 0, s>>>(p);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and the output alike)
extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, void* o,
    const void* pos, const void* t, int dtype,
    int B, int W, int H, int KV, int D, int Dv,
    long long q_sb, long long q_sh,
    long long k_sb, long long k_sw, long long k_sh,
    long long v_sb, long long v_sw, long long v_sh,
    float scale, int window, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.pos = static_cast<const int*>(pos);
  p.t = static_cast<const int*>(t);
  p.B = B; p.W = W; p.H = H; p.KV = KV; p.D = D; p.Dv = Dv;
  p.q_sb = q_sb; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_sw = k_sw; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_sw = v_sw; p.v_sh = v_sh;
  p.scale = scale; p.window = window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
