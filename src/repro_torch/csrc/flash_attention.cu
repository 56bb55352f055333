// Flash-attention forward for Hopper (sm_90a): q, k and v in float32,
// bfloat16 or float16 (all three alike), float32 arithmetic, the output
// in the inputs' type.
//
// Replaces repro/kernels/flash_attention.py::flash_attention (the Pallas
// TPU kernel) in all of its modes: kv_lengths key padding, segment_ids
// (a query sees a key iff the ids are equal and the key's id is >= 0),
// causal with q_offset = Sk - Sq, a sliding window, and GQA (query head h
// reads kv head h / (H / KV)). Rows whose keys are all masked output
// exactly 0: the mask is applied again after the exp and the output is
// acc / max(l, 1e-30), as in the Pallas body.
//
// What bounds it on this card. The path's shapes are small: EMSNet's
// per-event text encode (B=1, S=64, H=12, D=26 for TinyBERT, D=64 for
// BERT-base) moves well under a megabyte and does a few MFLOP, so one
// call is bound by its own latency chain (launch, global round trips,
// barriers), not by HBM (3.35 TB/s) or float32 (67 TFLOP/s at the H100
// SXM's 700 W limit). Batches (B=8, S=128, D=64: 403 MFLOP, 6 us at the
// float32 peak) are bound by operations. TF32 tensor cores are ruled out
// by float32 parity, so the products run on the FFMA units, and what
// starves those units is shared memory: a kernel that reads two operands
// from shared memory per FMA runs at 1/8 of the float32 rate.
//
// What the design does about that.
// - Register micro-tiles. A warp owns 4*RPT query rows; within it lane
//   (ty, tx) takes rows ty, ty+4, ... (RPT of them) and keys tx, tx+8,
//   ..., tx+56 of a 64-key tile. Scores come from float4 reads of q and
//   k rows, so RPT + 8 shared loads feed 32*RPT FMAs (12 for 128 at
//   RPT=4). P goes through shared memory once per tile (its own warp's
//   rows only, so a __syncwarp suffices) and O += P V reads float4 rows
//   of P and V: RPT + 4*DP/32 loads feed 4*RPT*DP/8 FMAs.
// - The row max is reduced by three shuffles among the 8 lanes that
//   share a row; the denominator stays a per-lane partial sum until the
//   end. One block barrier per key tile.
// - K/V tiles are staged by cp.async 16-byte copies, double buffered:
//   the next tile is in flight while this one is used. Rows off a 16-byte
//   boundary (D=26, or an odd head's view of the fused qkv buffer) are
//   staged element by element. Out-of-range rows and the head-dim padding
//   (up to DP = 32, 64 or 128) are zero-filled by the copy itself.
// - A tile plan per shape (kernels/flash_attention.py::plan_tiles). At
//   the per-event shapes and the packed ragged buffer, 16 query rows a
//   block on 4 warps (one row a lane): the most blocks, each with the
//   shortest chain, and S <= 64 stages all of K/V in one round trip.
//   Where a 16-row grid would run more than 4 waves, 64 rows on 4 warps
//   or 128 on 8 (4 rows a lane), so each staged K/V tile serves 64 or 128
//   queries (B=8, S=128: 96 blocks of 8 warps). Key tiles that the mask
//   hides from every query of the block (past kv_lengths, past the causal
//   diagonal, before the window) are never loaded. q, k and v are read
//   through their (B, S, H, D) strides, so the model passes views of its
//   fused qkv projection as they are.
// - The exponentials are __expf (ex2.approx): their error, a few ulp, is
//   far inside the 1e-4 the outputs are held to.
// - bf16 and fp16 inputs (the LLM zoo's prefill through the reference's
//   kernel="pallas" switch, causal GQA at D=128). The Pallas body casts
//   q, k and v to float32 as it loads them and writes the output in q's
//   type; so does this kernel. Their tiles are loaded 16 bytes (8
//   elements) a lane, converted in registers and stored to shared memory
//   as float32, so the score and P V loops, the softmax and the
//   accumulator are the float32 kernel's, and the output is rounded to
//   nearest even as it is stored. Those loads are plain (cp.async cannot
//   convert), so a tile's load is not overlapped with the previous
//   tile's arithmetic as the float32 path's is: a simple first design,
//   timed in PERF.md against SDPA's bf16 tensor-core path; bf16 mma is
//   the next step.
//
// C interface (bound with ctypes): pointers as void*, strides in
// elements, the CUDA stream last; returns cudaGetLastError() as an int.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BK = 64;                  // keys per tile: 8 lanes x 8 keys
constexpr int LDP = BK + 8;             // row stride of P: lanes of a warp hit distinct banks
constexpr float NEG_INF = -1e30f;       // the Pallas kernel's mask value

template <typename T>
struct Params {
  const T* q;
  const T* k;
  const T* v;
  T* o;                                 // contiguous (B, Sq, H, Dv)
  const int* kv_lengths;                // (B,) or null
  const int* seg;                       // (B, S) row stride seg_sb, or null
  int B, Sq, Sk, H, KV, D, Dv;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long seg_sb;
  float scale;
  int causal, window, q_offset;
  int vec;                              // every row starts on a 16-byte boundary
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

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

// Rows r0 .. r0 + rows - 1 of a (S, width) matrix with row stride ss into
// dst[rows][LD] as float32, by the block's THREADS lanes; rows at or past
// r0 + nvalid and columns at or past width (up to DP) are zero-filled.
// float32 rows go by cp.async (the caller commits and waits); bf16 and
// fp16 rows are loaded, converted and stored here.
template <int DP, int THREADS, typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src,
                                           long long ss, int r0, int rows,
                                           int nvalid, int width, bool vec) {
  constexpr int LD = DP + 4;
  if constexpr (!std::is_same_v<T, float>) {
    if (vec) {                          // 16 bytes: 8 elements a copy
      constexpr int C = DP / 8;
      for (int e = threadIdx.x; e < rows * C; e += THREADS) {
        const int r = e / C, c = e % C;
        float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
        if (r < nvalid && 8 * c < width) {
          const uint4 u = __ldg(reinterpret_cast<const uint4*>(src + (r0 + r) * ss + 8 * c));
          const T* h = reinterpret_cast<const T*>(&u);
          lo = make_float4(to_f32(h[0]), to_f32(h[1]), to_f32(h[2]), to_f32(h[3]));
          hi = make_float4(to_f32(h[4]), to_f32(h[5]), to_f32(h[6]), to_f32(h[7]));
        }
        *reinterpret_cast<float4*>(dst + r * LD + 8 * c) = lo;
        *reinterpret_cast<float4*>(dst + r * LD + 8 * c + 4) = hi;
      }
    } else {
      for (int e = threadIdx.x; e < rows * DP; e += THREADS) {
        const int r = e / DP, d = e % DP;
        dst[r * LD + d] = r < nvalid && d < width ? to_f32(src[(r0 + r) * ss + d]) : 0.f;
      }
    }
  } else if (vec) {
    constexpr int C = DP / 4;
    for (int e = threadIdx.x; e < rows * C; e += THREADS) {
      const int r = e / C, c = e % C;
      const bool in = r < nvalid && 4 * c < width;
      cp_async16(dst + r * LD + 4 * c,
                 in ? src + (r0 + r) * ss + 4 * c : src, in);
    }
  } else {
    for (int e = threadIdx.x; e < rows * DP; e += THREADS) {
      const int r = e / DP, d = e % DP;
      const bool in = r < nvalid && d < width;
      cp_async4(dst + r * LD + d, in ? src + (r0 + r) * ss + d : src, in);
    }
  }
}

template <int DP, int RPT, int NW>
constexpr int smem_bytes() {
  return 4 * ((NW * 4 * RPT) * (DP + 4)         // q tile
              + 4 * BK * (DP + 4)               // K and V, two buffers each
              + (NW * 4 * RPT) * LDP            // P
              + 2 * BK);                        // key segment ids, two buffers
}

// NW warps of 4 * RPT query rows each: BQ = 16 NW RPT rows a block
template <int DP, int RPT, int NW, typename T>
__global__ void __launch_bounds__(32 * NW)
flash_fwd_kernel(const Params<T> p) {
  constexpr int THREADS = 32 * NW;
  constexpr int LD = DP + 4;
  constexpr int BQ = NW * 4 * RPT;
  constexpr int CG = DP / 32;           // float4 column groups of O per lane
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);
  float* sk = sq + BQ * LD;
  float* sv = sk + 2 * BK * LD;
  float* sp = sv + 2 * BK * LD;
  int* skseg = reinterpret_cast<int*>(sp + BQ * LDP);

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.KV);
  const int q0 = blockIdx.y * BQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tx = lane & 7, ty = lane >> 3;
  const int row0 = warp * 4 * RPT + ty;  // this lane's rows: row0 + 4 r

  const T* qb = p.q + b * p.q_sb + h * p.q_sh;
  const T* kb = p.k + b * p.k_sb + kvh * p.k_sh;
  const T* vb = p.v + b * p.v_sb + kvh * p.v_sh;
  const int* segb = p.seg ? p.seg + b * p.seg_sb : nullptr;
  const bool vec = p.vec;

  // Keys no query of this block can see: past the row's length, past the
  // causal diagonal of the block's last query, before the window of its
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
  const int ntiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  auto stage_tile = [&](int t) {
    const int kt = k_begin + t * BK, buf = t & 1, nv = min(BK, k_end - kt);
    stage_rows<DP, THREADS>(sk + buf * BK * LD, kb, p.k_ss, kt, BK, nv, p.D, vec);
    stage_rows<DP, THREADS>(sv + buf * BK * LD, vb, p.v_ss, kt, BK, nv, p.Dv, vec);
    if (segb)
      for (int c = threadIdx.x; c < BK; c += THREADS)
        cp_async4(skseg + buf * BK + c, c < nv ? segb + kt + c : segb, c < nv);
  };

  stage_rows<DP, THREADS>(sq, qb, p.q_ss, q0, BQ, min(BQ, p.Sq - q0), p.D, vec);
  if (ntiles) stage_tile(0);
  cp_async_commit();

  int qseg[RPT];
  float m[RPT], l[RPT], o[RPT][CG][4];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int qi = q0 + row0 + 4 * r;
    qseg[r] = (segb && qi < p.Sq) ? segb[qi] : -1;
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int g = 0; g < CG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[r][g][e] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    const int buf = t & 1, kt = k_begin + t * BK;
    cp_async_wait_all();                // tile t (and the q tile) landed ...
    __syncthreads();                    // ... for every lane; tile t-1 is consumed
    if (t + 1 < ntiles) stage_tile(t + 1);
    cp_async_commit();
    const float* K = sk + buf * BK * LD;
    const float* V = sv + buf * BK * LD;

    // S = q k^T on the lane's RPT x 8 micro-tile
    float s[RPT][8];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[r][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      float4 qv[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        qv[r] = *reinterpret_cast<const float4*>(sq + (row0 + 4 * r) * LD + d);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(K + (tx + 8 * j) * LD + d);
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          s[r][j] = fmaf(qv[r].x, kv.x, s[r][j]);
          s[r][j] = fmaf(qv[r].y, kv.y, s[r][j]);
          s[r][j] = fmaf(qv[r].z, kv.z, s[r][j]);
          s[r][j] = fmaf(qv[r].w, kv.w, s[r][j]);
        }
      }
    }

    // mask, online softmax; P to shared memory (this warp's rows only)
    __syncwarp();                       // the last tile's P is consumed
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int row = row0 + 4 * r, qi = q0 + row;
      const int qpos = p.q_offset + qi;
      unsigned valid = 0;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tx + 8 * j, kj = kt + c;
        bool ok = qi < p.Sq && kj < k_end;
        if (segb) {
          const int kid = skseg[buf * BK + c];
          ok = ok && kid == qseg[r] && kid >= 0;
        } else {
          if (p.causal) ok = ok && kj <= qpos;
          if (p.window > 0) ok = ok && qpos - kj < p.window;
        }
        s[r][j] = ok ? s[r][j] * p.scale : NEG_INF;
        valid |= static_cast<unsigned>(ok) << j;
        mx = fmaxf(mx, s[r][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[r], mx);
      const float corr = __expf(m[r] - m_new);
      m[r] = m_new;
      float ls = l[r] * corr;
#pragma unroll
      for (int g = 0; g < CG; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[r][g][e] *= corr;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float pr = (valid >> j) & 1u ? __expf(s[r][j] - m_new) : 0.f;  // re-masked
        ls += pr;
        sp[row * LDP + tx + 8 * j] = pr;
      }
      l[r] = ls;
    }
    __syncwarp();

    // O += P V on the lane's RPT x (4 CG) micro-tile: columns 4 tx + 32 g
#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float4 pv[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        pv[r] = *reinterpret_cast<const float4*>(sp + (row0 + 4 * r) * LDP + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int g = 0; g < CG; ++g) {
          const float4 vv = *reinterpret_cast<const float4*>(V + (c + cc) * LD + 4 * tx + 32 * g);
#pragma unroll
          for (int r = 0; r < RPT; ++r) {
            const float pr = cc == 0 ? pv[r].x : cc == 1 ? pv[r].y : cc == 2 ? pv[r].z : pv[r].w;
            o[r][g][0] = fmaf(pr, vv.x, o[r][g][0]);
            o[r][g][1] = fmaf(pr, vv.y, o[r][g][1]);
            o[r][g][2] = fmaf(pr, vv.z, o[r][g][2]);
            o[r][g][3] = fmaf(pr, vv.w, o[r][g][3]);
          }
        }
      }
    }
  }
  cp_async_wait_all();                  // nothing left in flight at exit

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    float ls = l[r];
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    ls += __shfl_xor_sync(0xffffffffu, ls, 2);
    ls += __shfl_xor_sync(0xffffffffu, ls, 4);
    const float den = fmaxf(ls, 1e-30f);
    const int qi = q0 + row0 + 4 * r;
    if (qi >= p.Sq) continue;
    T* orow = p.o + ((static_cast<long long>(b) * p.Sq + qi) * p.H + h) * p.Dv;
#pragma unroll
    for (int g = 0; g < CG; ++g) {
      const int col = 4 * tx + 32 * g;
      if (vec && col + 3 < p.Dv) {
        if constexpr (std::is_same_v<T, float>) {
          *reinterpret_cast<float4*>(orow + col) = make_float4(
              o[r][g][0] / den, o[r][g][1] / den, o[r][g][2] / den, o[r][g][3] / den);
        } else {                        // 4 elements, 8 bytes, rounded to nearest even
          T out[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) out[e] = from_f32<T>(o[r][g][e] / den);
          *reinterpret_cast<uint2*>(orow + col) = *reinterpret_cast<const uint2*>(out);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < p.Dv) orow[col + e] = from_f32<T>(o[r][g][e] / den);
      }
    }
  }
}

template <int DP, int RPT, int NW, typename T>
int launch(const Params<T>& p, cudaStream_t s) {
  constexpr int BQ = NW * 4 * RPT;
  constexpr int bytes = smem_bytes<DP, RPT, NW>();
  static_assert(bytes <= 232448, "shared memory of one block");
  static bool configured = false;       // the attribute is set once per variant
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<DP, RPT, NW, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid(p.B * p.H, (p.Sq + BQ - 1) / BQ);
  flash_fwd_kernel<DP, RPT, NW, T><<<grid, 32 * NW, bytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// the tile plans of kernels/flash_attention.py::plan_tiles: 16 and 64
// query rows on 4 warps, 128 on 8 (not at DP = 128: its tiles would need
// more shared memory than a block has)
template <int DP, typename T>
int launch_rows(const Params<T>& p, int block_q, cudaStream_t s) {
  switch (block_q) {
    case 16: return launch<DP, 1, 4>(p, s);
    case 64: return launch<DP, 4, 4>(p, s);
    case 128:
      if constexpr (DP < 128) return launch<DP, 4, 8>(p, s);
      return static_cast<int>(cudaErrorInvalidValue);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

template <typename T>
int run(const void* q, const void* k, const void* v, void* o,
        const void* kv_lengths, const void* segment_ids,
        int B, int Sq, int Sk, int H, int KV, int D, int Dv,
        long long q_sb, long long q_ss, long long q_sh,
        long long k_sb, long long k_ss, long long k_sh,
        long long v_sb, long long v_ss, long long v_sh,
        long long seg_sb, float scale, int causal, int window, int q_offset,
        int block_q, int head_pad, cudaStream_t s) {
  Params<T> p;
  p.q = static_cast<const T*>(q);
  p.k = static_cast<const T*>(k);
  p.v = static_cast<const T*>(v);
  p.o = static_cast<T*>(o);
  p.kv_lengths = static_cast<const int*>(kv_lengths);
  p.seg = static_cast<const int*>(segment_ids);
  p.B = B; p.Sq = Sq; p.Sk = Sk; p.H = H; p.KV = KV; p.D = D; p.Dv = Dv;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.seg_sb = seg_sb;
  p.scale = scale; p.causal = causal; p.window = window; p.q_offset = q_offset;
  // 16-byte copies need every row of q, k and v on a 16-byte boundary:
  // aligned bases, strides and widths in multiples of 16 bytes' elements
  constexpr long long n16 = 16 / sizeof(T);
  bool vec = D % n16 == 0 && Dv % n16 == 0 && aligned16(q) && aligned16(k) &&
             aligned16(v) && aligned16(o);
  for (long long st : {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh})
    vec = vec && st % n16 == 0;
  p.vec = vec;
  if (D > head_pad || Dv > head_pad) return static_cast<int>(cudaErrorInvalidValue);
  switch (head_pad) {
    case 32: return launch_rows<32>(p, block_q, s);
    case 64: return launch_rows<64>(p, block_q, s);
    case 128: return launch_rows<128>(p, block_q, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16 (q, k, v and the output alike)
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o,
    const void* kv_lengths, const void* segment_ids,
    int B, int Sq, int Sk, int H, int KV, int D, int Dv,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long seg_sb, float scale, int causal, int window, int q_offset,
    int block_q, int head_pad, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH_RUN(T)                                                   \
  run<T>(q, k, v, o, kv_lengths, segment_ids, B, Sq, Sk, H, KV, D, Dv, q_sb, \
         q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, seg_sb, scale,      \
         causal, window, q_offset, block_q, head_pad, s)
  switch (dtype) {
    case 0: return REPRO_FLASH_RUN(float);
    case 1: return REPRO_FLASH_RUN(__nv_bfloat16);
    case 2: return REPRO_FLASH_RUN(__half);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_FLASH_RUN
}
