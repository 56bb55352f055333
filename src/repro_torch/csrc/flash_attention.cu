// Flash-attention forward for Hopper (sm_90a), float32 in and out.
//
// Replaces repro/kernels/flash_attention.py::flash_attention (the Pallas
// TPU kernel) in all of its modes: kv_lengths key padding, segment_ids
// (a query sees a key iff the ids are equal and the key's id is >= 0),
// causal with q_offset = Sk - Sq, a sliding window, and GQA (query head h
// reads kv head h / (H / KV)). Rows whose keys are all masked output
// exactly 0: the mask is applied again after the exp and the output is
// acc / max(l, 1e-30), as in the Pallas body.
//
// What bounds it on this card. EMSNet's per-event text encode calls it
// at B=1, S=64, H=12, D=26: about 5 MFLOP and about 320 KB of q, k, v
// and output, i.e. well under a microsecond of either float32 compute
// (67 TFLOP/s) or HBM traffic (3.35 TB/s) at the H100 SXM's published
// peaks (700 W limit). The call is bound by launch latency, not by FLOPs
// or bytes.
//
// What the design does about that. One launch per attention call, with
// no layout copies before it: the kernel reads q, k and v through their
// (B, S, H, D) strides, so the model passes views of its fused qkv
// projection as they are. One block of 4 warps per (batch*head, 16-query
// tile) keeps the small per-event shape spread over 48 SMs, and key tiles
// that the mask hides from every query of the tile (past kv_lengths, past
// the causal diagonal, before the window) are never loaded. Tensor cores,
// wgmma and TMA would not move a launch-bound call; they are left for the
// batched serving path, where the shapes grow.
//
// Layout of the work inside a block: the 16-query tile sits in shared
// memory; 32-key tiles of K and V are staged in shared memory in turn;
// each warp takes 4 query rows, one key per lane, and keeps the running
// max and denominator of the online softmax in float32; the float32
// accumulator (16 rows x padded head dim) lives in registers, spread
// over the 128 threads. The head dim is padded to a bucket of 32, 64 or
// 128 (template DP) with zeros in shared memory, so any D <= 128 works,
// 26 included; the host refuses D > 128.
//
// C interface (bound with ctypes): pointers as void*, strides in
// elements, the CUDA stream last; returns cudaGetLastError() as an int.

#include <cuda_runtime.h>

namespace {

constexpr int BQ = 16;                  // query rows per block
constexpr int BK = 32;                  // keys per shared-memory tile: one per lane
constexpr int THREADS = 128;            // 4 warps
constexpr int WARPS = THREADS / 32;
constexpr float NEG_INF = -1e30f;       // the Pallas kernel's mask value

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;                             // contiguous (B, Sq, H, Dv)
  const int* kv_lengths;                // (B,) or null
  const int* seg;                       // (B, S) row stride seg_sb, or null
  int B, Sq, Sk, H, KV, D, Dv;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long seg_sb;
  float scale;
  int causal, window, q_offset;
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int DP>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const Params p) {
  constexpr int LD = DP + 1;            // odd row stride: lanes on different keys hit different banks
  constexpr int ACC = BQ * DP / THREADS;
  __shared__ float sq[BQ][LD];
  __shared__ float sk[BK][LD];
  __shared__ float sv[BK][LD];
  __shared__ float sp[BQ][BK];
  __shared__ float s_m[BQ], s_l[BQ], s_corr[BQ];
  __shared__ int s_qseg[BQ];

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.KV);
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const float* qb = p.q + b * p.q_sb + h * p.q_sh;
  const float* kb = p.k + b * p.k_sb + kvh * p.k_sh;
  const float* vb = p.v + b * p.v_sb + kvh * p.v_sh;
  const int* segb = p.seg ? p.seg + b * p.seg_sb : nullptr;

  for (int e = tid; e < BQ * DP; e += THREADS) {
    const int r = e / DP, d = e % DP, qi = q0 + r;
    sq[r][d] = (qi < p.Sq && d < p.D) ? qb[qi * p.q_ss + d] : 0.f;
  }
  if (tid < BQ) {
    s_m[tid] = NEG_INF;
    s_l[tid] = 0.f;
    s_qseg[tid] = (segb && q0 + tid < p.Sq) ? segb[q0 + tid] : -1;
  }

  // Keys no query of this tile can see: past the row's length, past the
  // causal diagonal of the tile's last query, before the window of its
  // first. Skipping them is exact: a fully masked tile leaves m, l and
  // acc unchanged.
  int k_begin = 0, k_end = p.Sk;
  if (p.kv_lengths) k_end = min(k_end, max(p.kv_lengths[b], 0));
  if (!segb) {
    const int qfirst = p.q_offset + q0;
    const int qlast = p.q_offset + min(q0 + BQ, p.Sq) - 1;
    if (p.causal) k_end = min(k_end, qlast + 1);
    if (p.window > 0) k_begin = max(k_begin, qfirst - p.window + 1);
  }

  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;

  for (int kt = k_begin; kt < k_end; kt += BK) {
    __syncthreads();                    // the last tile is consumed; the q tile is in
    for (int e = tid; e < BK * DP; e += THREADS) {
      const int c = e / DP, d = e % DP, kj = kt + c;
      const bool in = kj < k_end;
      sk[c][d] = (in && d < p.D) ? kb[kj * p.k_ss + d] : 0.f;
      sv[c][d] = (in && d < p.Dv) ? vb[kj * p.v_ss + d] : 0.f;
    }
    __syncthreads();

    // scores and the online-softmax update: warp w takes rows w, w+4, ...
    const int kj = kt + lane;
    for (int r = warp; r < BQ; r += WARPS) {
      const int qi = q0 + r;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < DP; ++d) s += sq[r][d] * sk[lane][d];
      s *= p.scale;
      bool valid = qi < p.Sq && kj < k_end;
      if (segb) {
        const int kid = valid ? segb[kj] : -1;
        valid = valid && kid == s_qseg[r] && kid >= 0;
      } else {
        const int qpos = p.q_offset + qi;
        if (p.causal) valid = valid && kj <= qpos;
        if (p.window > 0) valid = valid && qpos - kj < p.window;
      }
      const float sm = valid ? s : NEG_INF;
      const float m_prev = s_m[r];
      const float m_new = fmaxf(m_prev, warp_max(sm));
      const float pr = valid ? expf(sm - m_new) : 0.f;  // re-masked after the exp
      const float psum = warp_sum(pr);
      sp[r][lane] = pr;
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        s_l[r] = s_l[r] * corr + psum;
        s_m[r] = m_new;
        s_corr[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + p @ v; thread t owns elements t, t+128, ... of
    // the (BQ, DP) accumulator
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      const int e = tid + i * THREADS, r = e / DP, d = e % DP;
      float a = acc[i] * s_corr[r];
#pragma unroll 8
      for (int c = 0; c < BK; ++c) a += sp[r][c] * sv[c][d];
      acc[i] = a;
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    const int e = tid + i * THREADS, r = e / DP, d = e % DP, qi = q0 + r;
    if (qi < p.Sq && d < p.Dv)
      p.o[((static_cast<long long>(b) * p.Sq + qi) * p.H + h) * p.Dv + d] =
          acc[i] / fmaxf(s_l[r], 1e-30f);
  }
}

}  // namespace

extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o,
    const void* kv_lengths, const void* segment_ids,
    int B, int Sq, int Sk, int H, int KV, int D, int Dv,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long seg_sb, float scale, int causal, int window, int q_offset,
    void* stream) {
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
  p.kv_lengths = static_cast<const int*>(kv_lengths);
  p.seg = static_cast<const int*>(segment_ids);
  p.B = B; p.Sq = Sq; p.Sk = Sk; p.H = H; p.KV = KV; p.D = D; p.Dv = Dv;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.seg_sb = seg_sb;
  p.scale = scale; p.causal = causal; p.window = window; p.q_offset = q_offset;

  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dp = D > Dv ? D : Dv;
  if (dp <= 32) flash_fwd_kernel<32><<<grid, THREADS, 0, s>>>(p);
  else if (dp <= 64) flash_fwd_kernel<64><<<grid, THREADS, 0, s>>>(p);
  else if (dp <= 128) flash_fwd_kernel<128><<<grid, THREADS, 0, s>>>(p);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
