// Flash-attention forward for Hopper (sm_90a): q, k and v in float32,
// bfloat16 or float16 (all three alike), float32 softmax and sums, the
// output in the inputs' type.
//
// Replaces repro/kernels/flash_attention.py::flash_attention (the Pallas
// TPU kernel) in all of its modes: kv_lengths key padding, segment_ids
// (a query sees a key iff the ids are equal and the key's id is >= 0),
// causal with q_offset = Sk - Sq, a sliding window, and GQA (query head h
// reads kv head h / (H / KV)). Rows whose keys are all masked output
// exactly 0: the mask is applied again after the exp and the output is
// acc / max(l, 1e-30), as in the Pallas body. Two kernels: float32 inputs
// take flash_fwd_kernel (FMA units), bf16 and fp16 inputs take
// flash_mma_kernel (tensor cores).
//
// What bounds it on this card. The path's shapes are small: EMSNet's
// per-event text encode (B=1, S=64, H=12, D=26 for TinyBERT, D=64 for
// BERT-base) moves well under a megabyte and does a few MFLOP, so one
// call is bound by its own latency chain (launch, global round trips,
// barriers), not by HBM (3.35 TB/s) or float32 (67 TFLOP/s at the H100
// SXM's 700 W limit). Batches (B=8, S=128, D=64: 403 MFLOP, 6 us at the
// float32 peak) are bound by operations. TF32 tensor cores are ruled out
// by float32 parity, so the float32 products run on the FFMA units, and
// what starves those units is shared memory: a kernel that reads two
// operands from shared memory per FMA runs at 1/8 of the float32 rate.
// The LLM zoo's bf16 prefill (B=1, S=512, H=32, KV=8, D=128, causal:
// 2.2 GFLOP, 10.5 MB) is bound by bytes on paper: 3.1 us at 3.35 TB/s
// against 2.2 us of bf16 tensor-core work at 989 TFLOP/s. In practice a
// grid of 256 blocks of 64 rows is one wave, and what bounds it is each
// block's chain of key tiles: a load, two products and a softmax each.
//
// What the design does about that, in float32.
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
//
// What the design does about that, in bf16 and fp16 (the LLM zoo's
// prefill through the reference's kernel="pallas" switch). The Pallas
// body casts q, k and v to float32 and sums in float32; products of two
// bf16 (or fp16) values are exact in float32, so tensor cores with
// float32 accumulators compute the same S up to the order of the sums.
// - Each warp owns 16 query rows; a block is 4 warps and 64 rows
//   (plan_tiles(..., dtype=...)): 256 blocks at Mistral's prefill, two
//   an SM. Key tiles hold 64 keys; head dims are padded to 32, 64 or 128.
// - S = q k^T as mma.sync.m16n8k16 with bf16 (f16) operands and float32
//   accumulators. q's A fragments are loaded once (ldmatrix) and stay in
//   registers; K's B fragments come from ldmatrix on the staged rows.
// - The softmax runs in float32 on the accumulator fragments: each lane
//   holds 2 rows x 16 keys of a tile and reduces a row's max and sum
//   with the 3 other lanes of that row (shfl_xor 1, 2). Each row's
//   visible keys are one range (length, causal diagonal, window), so a
//   tile that all 16 rows of the warp see whole skips the mask; other
//   tiles are masked per element, and again after the exp.
// - O += P V as mma with float32 accumulators. P goes from the S
//   accumulators straight into A fragments in registers, never through
//   shared memory; V's B fragments come from ldmatrix.trans. P is split
//   as P = P_hi + P_lo, each rounded to the input type, with one mma for
//   each. Rounding P once to bf16 puts the output 1.0 bf16 step of its
//   scale from the float32 result at Mistral's prefill shape, the whole
//   of the one step it is held to; the split leaves 0.25 (an emulation of
//   these rounding points, tests/test_torch_flash_attention.py). It
//   doubles the P V products; the kernel stays far below the tensor
//   cores' rate at these sizes all the same.
// - K/V tiles are copied raw (nothing converts on the way in) by
//   cp.async 16-byte copies into a ring of two stages, so the next tile
//   lands while this one is used. Rows are padded by 16 bytes, which puts
//   the 8 rows an ldmatrix reads in 8 distinct bank groups. Rows off a
//   16-byte boundary (D=26 views of a fused qkv buffer) are staged
//   element by element; out-of-range rows and the head-dim padding are
//   zero-filled.
// - Key tiles hidden from the whole block are never loaded, as above;
//   tiles hidden from one warp's 16 rows (above its causal diagonal,
//   before its window) are skipped by that warp. Causal q-tiles run
//   longest first (blockIdx.y reversed), so the long blocks start early.
// - The output is staged through shared memory (the warp's own q rows)
//   and written in 16-byte rows.
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
constexpr float LOG2E = 1.4426950408889634f;

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

// Rows r0 .. r0 + rows - 1 of a float32 (S, width) matrix with row stride
// ss into dst[rows][LD] by cp.async (the caller commits and waits), by the
// block's THREADS lanes; rows at or past r0 + nvalid and columns at or
// past width (up to DP) are zero-filled.
template <int DP, int THREADS>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           long long ss, int r0, int rows,
                                           int nvalid, int width, bool vec) {
  constexpr int LD = DP + 4;
  if (vec) {
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
template <int DP, int RPT, int NW>
__global__ void __launch_bounds__(32 * NW)
flash_fwd_kernel(const Params<float> p) {
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

  const float* qb = p.q + b * p.q_sb + h * p.q_sh;
  const float* kb = p.k + b * p.k_sb + kvh * p.k_sh;
  const float* vb = p.v + b * p.v_sb + kvh * p.v_sh;
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
    float* orow = p.o + ((static_cast<long long>(b) * p.Sq + qi) * p.H + h) * p.Dv;
#pragma unroll
    for (int g = 0; g < CG; ++g) {
      const int col = 4 * tx + 32 * g;
      if (vec && col + 3 < p.Dv) {
        *reinterpret_cast<float4*>(orow + col) = make_float4(
            o[r][g][0] / den, o[r][g][1] / den, o[r][g][2] / den, o[r][g][3] / den);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < p.Dv) orow[col + e] = o[r][g][e] / den;
      }
    }
  }
}

template <int DP, int RPT, int NW>
int launch(const Params<float>& p, cudaStream_t s) {
  constexpr int BQ = NW * 4 * RPT;
  constexpr int bytes = smem_bytes<DP, RPT, NW>();
  static_assert(bytes <= 232448, "shared memory of one block");
  static bool configured = false;       // the attribute is set once per variant
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<DP, RPT, NW>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid(p.B * p.H, (p.Sq + BQ - 1) / BQ);
  flash_fwd_kernel<DP, RPT, NW><<<grid, 32 * NW, bytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// the float32 tile plans of kernels/flash_attention.py::plan_tiles: 16
// and 64 query rows on 4 warps, 128 on 8 (not at DP = 128: its tiles
// would need more shared memory than a block has)
template <int DP>
int launch_rows(const Params<float>& p, int block_q, cudaStream_t s) {
  switch (block_q) {
    case 16: return launch<DP, 1, 4>(p, s);
    case 64: return launch<DP, 4, 4>(p, s);
    case 128:
      if constexpr (DP < 128) return launch<DP, 4, 8>(p, s);
      return static_cast<int>(cudaErrorInvalidValue);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ------------------------------------------------ bf16 / fp16: tensor cores

constexpr int MMA_PAD = 8;              // 16 bytes of padding a staged row
constexpr int MMA_WARPS = 4;            // 16 query rows each: 64 rows a block

template <typename T> struct Pair;      // two elements in one 32-bit register
template <> struct Pair<__nv_bfloat16> {
  using type = __nv_bfloat162;
  static __device__ __forceinline__ type pack(float a, float b) { return __floats2bfloat162_rn(a, b); }
  static __device__ __forceinline__ float2 unpack(type x) { return __bfloat1622float2(x); }
};
template <> struct Pair<__half> {
  using type = __half2;
  static __device__ __forceinline__ type pack(float a, float b) { return __floats2half2_rn(a, b); }
  static __device__ __forceinline__ float2 unpack(type x) { return __half22float2(x); }
};

template <typename T>
__device__ __forceinline__ uint32_t as_u32(typename Pair<T>::type x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

template <typename T>
__device__ __forceinline__ T zero_of() {
  if constexpr (std::is_same_v<T, __half>) return __float2half_rn(0.f);
  else return __float2bfloat16_rn(0.f);
}

// d += a b on one 16x8x16 tile: a 16x16 row-major (4 registers), b 16x8
// column-major (2 registers), float32 accumulators
template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// four 8x8 matrices of 16-bit elements from shared memory; lane l gives
// the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* ptr) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* ptr) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Rows r0 .. r0 + rows - 1 of a (S, width) matrix of 16-bit elements with
// row stride ss into dst[rows][DP + MMA_PAD] as they are: 16-byte cp.async
// copies (the caller commits and waits), or element by element for rows
// off a 16-byte boundary. Rows at or past r0 + nvalid and columns at or
// past width (up to DP) are zero-filled.
template <int DP, int THREADS, typename T>
__device__ __forceinline__ void stage_half(T* dst, const T* src, long long ss,
                                           int r0, int rows, int nvalid,
                                           int width, bool vec) {
  constexpr int LD = DP + MMA_PAD;
  if (vec) {
    constexpr int C = DP / 8;
    for (int e = threadIdx.x; e < rows * C; e += THREADS) {
      const int r = e / C, c = e % C;
      const bool in = r < nvalid && 8 * c < width;
      cp_async16(dst + r * LD + 8 * c, in ? src + (r0 + r) * ss + 8 * c : src, in);
    }
  } else {
    for (int e = threadIdx.x; e < rows * DP; e += THREADS) {
      const int r = e / DP, d = e % DP;
      dst[r * LD + d] = r < nvalid && d < width ? src[(r0 + r) * ss + d] : zero_of<T>();
    }
  }
}

template <int DP>
constexpr int mma_smem_bytes() {
  return 2 * ((MMA_WARPS * 16) * (DP + MMA_PAD) // q tile, later the output tile
              + 4 * BK * (DP + MMA_PAD))        // K and V, two stages each
         + 4 * 2 * BK;                          // key segment ids, two stages
}

template <int DP, typename T>
__global__ void __launch_bounds__(32 * MMA_WARPS)
flash_mma_kernel(const Params<T> p) {
  using P2 = Pair<T>;
  constexpr int THREADS = 32 * MMA_WARPS;
  constexpr int LD = DP + MMA_PAD;
  constexpr int BQ = 16 * MMA_WARPS;
  constexpr int KS = DP / 16;           // k-steps of S = q k^T
  constexpr int NT = BK / 8;            // 8-key column tiles of S
  constexpr int DT = DP / 8;            // 8-column tiles of O
  extern __shared__ float4 smem4[];
  T* sq = reinterpret_cast<T*>(smem4);
  T* sk = sq + BQ * LD;
  T* sv = sk + 2 * BK * LD;
  int* skseg = reinterpret_cast<int*>(sv + 2 * BK * LD);

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // the longest blocks first
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, c4 = lane & 3;  // fragment row g (and g + 8), columns 2 c4, 2 c4 + 1
  const int wq0 = q0 + warp * 16;          // the warp's first query row

  const T* qb = p.q + b * p.q_sb + h * p.q_sh;
  const T* kb = p.k + b * p.k_sb + kvh * p.k_sh;
  const T* vb = p.v + b * p.v_sb + kvh * p.v_sh;
  const int* segb = p.seg ? p.seg + b * p.seg_sb : nullptr;
  const bool vec = p.vec;

  // keys no query of the block can see are never loaded (as above)
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
    stage_half<DP, THREADS>(sk + buf * BK * LD, kb, p.k_ss, kt, BK, nv, p.D, vec);
    stage_half<DP, THREADS>(sv + buf * BK * LD, vb, p.v_ss, kt, BK, nv, p.Dv, vec);
    if (segb)
      for (int c = threadIdx.x; c < BK; c += THREADS)
        cp_async4(skseg + buf * BK + c, c < nv ? segb + kt + c : segb, c < nv);
  };

  stage_half<DP, THREADS>(sq, qb, p.q_ss, q0, BQ, min(BQ, p.Sq - q0), p.D, vec);
  if (ntiles) stage_tile(0);
  cp_async_commit();

  // the lane's two rows, g and g + 8: keys lo .. hi - 1 visible (none
  // past Sq), by length, causal diagonal and window; in segment mode the
  // ids decide within 0 .. k_end - 1
  int lo[2], hi[2], qseg[2];
  float m[2], l[2], o[DT][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = wq0 + g + 8 * r, qpos = p.q_offset + qi;
    lo[r] = 0;
    hi[r] = qi < p.Sq ? k_end : 0;
    if (!segb && p.causal) hi[r] = min(hi[r], qpos + 1);
    if (!segb && p.window > 0) lo[r] = qpos - p.window + 1;
    qseg[r] = (segb && qi < p.Sq) ? segb[qi] : -1;
    m[r] = NEG_INF;
    l[r] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  const float scale2 = p.scale * LOG2E;   // exp(scale x) = 2^(scale2 x)
  // the warp's rows as positions: a tile wholly above the diagonal of its
  // last row, or wholly before the window of its first, is skipped (m, l
  // and acc would come out unchanged)
  const int wlast = min(wq0 + 15, p.Sq - 1);
  const bool warp_live = wq0 < p.Sq;

  cp_async_wait_all();                  // the q tile (and tile 0) landed ...
  __syncthreads();                      // ... for every lane
  uint32_t qf[KS][4];                   // q's A fragments, for every tile
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    ldsm_x4(qf[ks], sq + (warp * 16 + (lane & 15)) * LD + 16 * ks + 8 * (lane >> 4));

  for (int t = 0; t < ntiles; ++t) {
    const int buf = t & 1, kt = k_begin + t * BK;
    if (t > 0) {
      cp_async_wait_all();              // tile t landed ...
      __syncthreads();                  // ... for every lane; tile t-1 is consumed
    }
    if (t + 1 < ntiles) stage_tile(t + 1);
    cp_async_commit();
    bool live = warp_live;
    if (!segb) {
      if (p.causal) live = live && kt <= p.q_offset + wlast;
      if (p.window > 0) live = live && kt + BK - 1 > p.q_offset + wq0 - p.window;
    }
    if (!live) continue;
    const T* K = sk + buf * BK * LD;
    const T* V = sv + buf * BK * LD;

    // S = q k^T: 16 rows x 64 keys a warp, 8 column tiles of 4 floats a lane
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t kf[4];                 // keys 16 jp .. 16 jp + 15, dims 16 ks ..
        ldsm_x4(kf, K + (16 * jp + (lane & 7) + 8 * (lane >> 4)) * LD
                        + 16 * ks + 8 * ((lane >> 3) & 1));
        mma16816<T>(s[2 * jp], qf[ks], kf[0], kf[1]);
        mma16816<T>(s[2 * jp + 1], qf[ks], kf[2], kf[3]);
      }
    }

    // mask and online softmax on the fragments: element (j, 2 r + e) is
    // row g + 8 r, key kt + 8 j + 2 c4 + e. A tile that every row of the
    // warp sees whole is not masked at all.
    const bool whole = __all_sync(
        0xffffffffu, !segb && lo[0] <= kt && lo[1] <= kt &&
                         hi[0] >= kt + BK && hi[1] >= kt + BK);
    unsigned valid[2] = {~0u, ~0u};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!whole) {
        valid[r] = 0u;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * j + 2 * c4 + e, kj = kt + c;
            bool ok = kj >= lo[r] && kj < hi[r];
            if (segb) {
              const int kid = skseg[buf * BK + c];
              ok = ok && kid == qseg[r] && kid >= 0;
            }
            float& x = s[j][2 * r + e];
            x = ok ? x * scale2 : NEG_INF;
            valid[r] |= static_cast<unsigned>(ok) << (2 * j + e);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          s[j][2 * r] *= scale2;
          s[j][2 * r + 1] *= scale2;
        }
      }
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < NT; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float corr = ex2(m[r] - m_new);
      m[r] = m_new;
      float ls = l[r] * corr;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        o[j][2 * r] *= corr;
        o[j][2 * r + 1] *= corr;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[j][2 * r + e];
          x = (valid[r] >> (2 * j + e)) & 1u ? ex2(x - m_new) : 0.f;   // re-masked
          ls += x;
        }
      }
      l[r] = ls;
    }

    // O += P V, 16 keys a step: P's A fragments straight from the S
    // accumulators, as hi + lo in the input type; V's B fragments by
    // ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t phi[4], plo[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {     // (row g, keys 2 c4 ..), (g + 8, ..), then + 8 keys
        const float* f = &s[2 * kk + (x >> 1)][2 * (x & 1)];
        const typename P2::type hi = P2::pack(f[0], f[1]);
        const float2 hf = P2::unpack(hi);
        phi[x] = as_u32<T>(hi);
        plo[x] = as_u32<T>(P2::pack(f[0] - hf.x, f[1] - hf.y));
      }
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t vf[4];                 // keys 16 kk .. + 15, dims 16 dp .. + 15
        ldsm_x4_trans(vf, V + (16 * kk + (lane & 15)) * LD + 16 * dp + 8 * (lane >> 4));
        mma16816<T>(o[2 * dp], phi, vf[0], vf[1]);
        mma16816<T>(o[2 * dp], plo, vf[0], vf[1]);
        mma16816<T>(o[2 * dp + 1], phi, vf[2], vf[3]);
        mma16816<T>(o[2 * dp + 1], plo, vf[2], vf[3]);
      }
    }
  }
  cp_async_wait_all();                  // nothing left in flight at exit

  // acc / max(l, 1e-30), rounded to the output type, into the warp's own
  // rows of the q tile, then out in 16-byte rows
  T* so = sq + warp * 16 * LD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float ls = l[r];
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    ls += __shfl_xor_sync(0xffffffffu, ls, 2);
    const float inv = 1.f / fmaxf(ls, 1e-30f);
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<typename P2::type*>(so + (g + 8 * r) * LD + 8 * j + 2 * c4) =
          P2::pack(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
  }
  __syncwarp();
  constexpr int C = DP / 8;
  for (int e = lane; e < 16 * C; e += 32) {
    const int r = e / C, c = e % C, q = wq0 + r;
    if (q >= p.Sq || 8 * c >= p.Dv) continue;
    T* orow = p.o + ((static_cast<long long>(b) * p.Sq + q) * p.H + h) * p.Dv + 8 * c;
    const T* src = so + r * LD + 8 * c;
    if (vec) {
      *reinterpret_cast<uint4*>(orow) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int x = 0; x < 8 && 8 * c + x < p.Dv; ++x) orow[x] = src[x];
    }
  }
}

// the bf16/fp16 tile plan of plan_tiles(..., dtype=...): 64 query rows
// on 4 warps
template <int DP, typename T>
int launch_mma(const Params<T>& p, int block_q, cudaStream_t s) {
  constexpr int BQ = 16 * MMA_WARPS;
  constexpr int bytes = mma_smem_bytes<DP>();
  static_assert(bytes <= 232448, "shared memory of one block");
  if (block_q != BQ) return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;       // the attribute is set once per variant
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_mma_kernel<DP, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid(p.B * p.H, (p.Sq + BQ - 1) / BQ);
  flash_mma_kernel<DP, T><<<grid, 32 * MMA_WARPS, bytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// float32 on the FMA kernel, bf16 and fp16 on the tensor-core one
template <int DP, typename T>
int launch_plan(const Params<T>& p, int block_q, cudaStream_t s) {
  if constexpr (std::is_same_v<T, float>) return launch_rows<DP>(p, block_q, s);
  else return launch_mma<DP>(p, block_q, s);
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
    case 32: return launch_plan<32>(p, block_q, s);
    case 64: return launch_plan<64>(p, block_q, s);
    case 128: return launch_plan<128>(p, block_q, s);
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
