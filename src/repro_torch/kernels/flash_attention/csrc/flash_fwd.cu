// Flash-attention forward for Hopper (sm_90a), behind a plain C entry point.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas
// (body _flash_kernel) and computes the function of its oracle,
// src/repro/kernels/flash_attention/ref.py::attention:
//
//   q [B,T,H,hd], k/v [B,S,K,hd], H % K == 0, head h reads KV head h / (H/K);
//   s = (q . k) * scale in fp32; query i sits at key position i + S - T;
//   causal: k_pos <= q_pos; window w: k_pos > q_pos - w;
//   online softmax with an fp32 running max, denominator and accumulator;
//   out = acc / max(l, 1e-30), cast to q's type.
//
// Two routes, chosen by the caller (ops.py::route) from the dtype alone:
//
// * mma (bf16, fp16): flash_fwd_mma_kernel, the FA2 pattern on tensor cores.
//   One block of 4 warps owns one (batch*head, 64-query tile); each warp owns
//   16 query rows, and their running max, denominator and output accumulator
//   stay in its registers (the m16n8 accumulator layout; a row's four lanes
//   reduce with two xor shuffles, so the softmax needs no shared memory and no
//   block barrier).  S = Q K^T is mma.sync.m16n8k16 with bf16/fp16 operands and
//   fp32 accumulation: Q's fragments come once from shared memory with
//   ldmatrix and stay in registers up to hd 128 (hd 112, kimi-k2: 7 k-steps
//   of 16 and 14 output tiles of 8, 28 fragment registers); at hd 256 they are read
//   again from shared memory at every k-step, as K's are (below); K's come
//   per tile.  exp(scale (s - m)) is one FFMA and one SFU
//   ex2.approx; it is rounded to the input type in registers (ref.py's
//   probs.astype(v.dtype)) and the accumulator fragment is
//   reused as the A operand of O += P V (the m16n8k16 register identity); V is
//   read with ldmatrix.trans.  K and V tiles arrive by 16-byte cp.async into a
//   two-stage ring, so tile j+1 loads while tile j computes, with one block
//   barrier per tile.  Rows are padded by 16 bytes (hd + 8 elements): a row
//   then starts 4 banks (hd 64, 96, 128, 256), 12 banks (hd 80) or 28 banks
//   (hd 112: 120 elements, 240 bytes, 60 words a row, so rows 0..7 start at
//   banks 0, 28, 24, 20, 16, 12, 8, 4) after the one before, so the 8 rows of
//   every ldmatrix phase, and the epilogue's staging, fall on 8 disjoint
//   groups of 4 banks: free of bank conflicts at every instantiated hd (64,
//   80, 96, 112, 128, 256); q/k/v pointers and row strides must be 16-byte
//   aligned (the wrapper checks; a row of one head at hd 112 is 224 bytes,
//   14 copies of 16).
//   hd 256 (gemma3-12b): the accumulator alone is 32 x 4 = 128 registers a
//   thread and the score tile 32 more, so Q's 64 fragment registers would
//   push a thread past 224 before addresses and spill under
//   __launch_bounds__(128); Q is re-read per k-step instead (one ldmatrix.x4
//   beside each k-step's four of K): ptxas (sm_90a, -O3) then gives it 251
//   registers and 0 spill bytes.  Its shared memory, 2 x 5 x 64 x 264 =
//   168,960 bytes, allows one block per SM.  The output is staged through the
//   warp's own rows of the Q buffer and written with 16-byte stores.
// * fma (fp32): flash_fwd_fma_kernel, the first version of this kernel,
//   unchanged: fp32 FMAs out of shared memory.  Tensor-core TF32 would break
//   the fp32 tolerance, and no caller of the main path sends fp32.  At hd 256
//   its layout is 53,632 floats (214,528 bytes), under the 227 KB opt-in.
//
// Both routes: one block loops over the 64-key tiles of its query tile (the
// TPU kernel's sequential k grid axis); tiles that the causal or window mask
// kills entirely are never loaded (the loop range is cut, as kernel.py skips
// dead blocks with pl.when); the mask is applied only on edge tiles; the
// ragged T and S edges are masked in the kernel (cp.async zero-fills rows
// past the end), so the wrapper makes no pad copies; [B,T,H,hd] is read
// through strides and GQA through the head index; blocks start with the
// longest causal rows; fully masked rows stay finite (-inf scores under a
// -1e30 running-max floor give p = 0).  The fma route orders its grid by
// gridDim.x - 1 - blockIdx.x.  The mma route ranks every (head, query tile)
// by its causal work: the first blocks, one per SM, take the longest, and
// the rest take the shortest first, so the two blocks of an SM pair a long
// tile with a short one (at T 512 the busiest SM runs 9 key tiles, not 12;
// at T 333, 7 and not 12).
//
// What bounds it.  At the serving shapes (T = S <= 512, hd 80, bf16, causal)
// the work is about 100 FLOP per byte of q/k/v/o, under the card's ~295
// FLOP/B ridge: the bound is the bytes (3.1 us at T 512), and a block's whole
// work is at most 64 x 512 causal pairs, so latency and load overlap matter
// more than the last factor of tensor-core rate.  That is why this route is
// mma.sync with cp.async and not wgmma with TMA; PyTorch's SDPA on this card
// is itself an mma.sync kernel.  The critical path is the longest causal
// query tile's sweep over its key tiles, hence the pairing of long and short
// tiles per SM below.  Giving each warp 32 query rows (FA2's layout, twice
// the work per K/V fragment) needs more than 255 registers at hd 80 and
// spills.  Next, if the mma route stays above half its bound: a
// warp-specialised wgmma/TMA version (a producer warp keeping TMA loads in
// flight, 64-row warpgroup products), and a persistent grid.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // queries per block (both routes)
constexpr int BK = 64;         // keys per tile (both routes)
constexpr int NTHREADS = 256;  // fma route: 16 x 16 threads, each a 4-row slice
constexpr int MMA_THREADS = 128;  // mma route: 4 warps of 16 query rows
constexpr float NEG = -1e30f;  // running-max floor, as _NEG in kernel.py

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __half from_f<__half>(float x) { return __float2half_rn(x); }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, T, S, H, KH;
  long long q_sb, q_st, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_st, o_sh;
  float scale;
  int causal;
  int window;   // <= 0: no sliding window
  int num_sms;  // mma route: the card's SM count, for the order of the query tiles
};

// ---- fma route (fp32) ---------------------------------------------------------

template <int HD>
struct Layout {
  static constexpr int QSTR = HD + 1;  // padded rows: no bank conflicts
  static constexpr int KSTR = HD + 1;
  static constexpr int PSTR = BK + 1;
  static constexpr int floats = BQ * QSTR + BK * KSTR + BK * HD + BQ * PSTR + 3 * BQ;
  static constexpr size_t bytes = sizeof(float) * floats;
};

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_fma_kernel(const Params p) {
  static_assert(HD % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int QSTR = Layout<HD>::QSTR;
  constexpr int KSTR = Layout<HD>::KSTR;
  constexpr int PSTR = Layout<HD>::PSTR;
  constexpr int NJ = HD / 16;  // output columns per thread

  extern __shared__ float smem[];
  float* sQ = smem;               // [BQ][QSTR]
  float* sK = sQ + BQ * QSTR;     // [BK][KSTR]
  float* sV = sK + BK * KSTR;     // [BK][HD]
  float* sP = sV + BK * HD;       // [BQ][PSTR] scores, then probabilities
  float* sM = sP + BQ * PSTR;     // [BQ] running max
  float* sL = sM + BQ;            // [BQ] running denominator
  float* sA = sL + BQ;            // [BQ] this tile's rescale factor

  const int tid = threadIdx.x;
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal rows start first
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int kh = h / (p.H / p.KH);
  const int q0 = qt * BQ;
  const int offset = p.S - p.T;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + kh * p.v_sh;
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int idx = tid; idx < BQ * HD; idx += NTHREADS) {
    const int r = idx / HD, d = idx % HD;
    const int t = q0 + r;
    sQ[r * QSTR + d] = t < p.T ? to_f(qg[t * p.q_st + d]) : 0.f;
  }
  if (tid < BQ) {
    sM[tid] = NEG;
    sL[tid] = 0.f;
  }

  // key range this query tile can see; whole dead tiles are never visited
  const int q_lo = q0 + offset;
  const int q_hi = min(q0 + BQ, p.T) - 1 + offset;
  int k_begin = 0, k_end = p.S;
  if (p.causal) k_end = min(k_end, q_hi + 1);
  if (p.window > 0) k_begin = max(0, q_lo - p.window + 1);
  const int kt_begin = k_begin / BK;
  const int kt_end = k_end > 0 ? (k_end + BK - 1) / BK : 0;

  const int ty = tid / 16, tx = tid % 16;  // S / O slice: rows ty*4+i, cols tx+16j
  const int srow = tid / 4, spart = tid % 4;  // softmax: 4 threads per row
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's sK/sV/sP are consumed
    for (int idx = tid; idx < BK * HD; idx += NTHREADS) {
      const int r = idx / HD, d = idx % HD;
      const int s = k0 + r;
      const bool ok = s < p.S;
      sK[r * KSTR + d] = ok ? to_f(kg[s * p.k_ss + d]) : 0.f;
      sV[r * HD + d] = ok ? to_f(vg[s * p.v_ss + d]) : 0.f;
    }
    __syncthreads();

    // scores for a 4 x 4 slice: S = Q K^T
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * QSTR + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * KSTR + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int q_pos = q0 + r + offset;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int k_pos = k0 + c;
        bool valid = k_pos < p.S;
        if (p.causal) valid = valid && k_pos <= q_pos;
        if (p.window > 0) valid = valid && k_pos > q_pos - p.window;
        sP[r * PSTR + c] = valid ? s[i][j] * p.scale : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax over this tile; masked entries are -inf and give p = 0
    {
      float* prow = sP + srow * PSTR;
      float m_tile = NEG;
      for (int c = spart; c < BK; c += 4) m_tile = fmaxf(m_tile, prow[c]);
      m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 1));
      m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 2));
      const float m_old = sM[srow];
      const float m_new = fmaxf(m_old, m_tile);
      float l_tile = 0.f;
      for (int c = spart; c < BK; c += 4) {
        const float e = expf(prow[c] - m_new);
        l_tile += e;
        prow[c] = to_f(from_f<T>(e));
      }
      l_tile += __shfl_xor_sync(0xffffffffu, l_tile, 1);
      l_tile += __shfl_xor_sync(0xffffffffu, l_tile, 2);
      if (spart == 0) {
        const float alpha = expf(m_old - m_new);
        sA[srow] = alpha;
        sM[srow] = m_new;
        sL[srow] = sL[srow] * alpha + l_tile;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = sA[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty * 4 + i) * PSTR + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = sV[c * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();  // sL is final (also when no tile was visited)

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int t = q0 + r;
    if (t >= p.T) continue;
    const float denom = fmaxf(sL[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) og[t * p.o_st + tx + 16 * j] = from_f<T>(acc[i][j] / denom);
  }
}

// ---- mma route (bf16, fp16) ---------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; with valid false the 16 bytes are zero-filled
// and nothing is read (src must still be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a b: m16n8k16, 16-bit operands, fp32 accumulation
template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(float (&d)[4], const uint32_t (&a)[4],
                                                        uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16816<__half>(float (&d)[4], const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to the 16-bit type, lo in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int HD>
struct MmaLayout {
  static constexpr int STR = HD + 8;     // row stride in elements: 16 bytes of pad
  static constexpr int TILE = BQ * STR;  // one 64-row tile (BQ == BK)
  // Q, then K and V in two stages each
  static constexpr size_t bytes = 2 * 5 * TILE;
};

// 2^x on the SFU; denormal results flush to 0 (probabilities under 1e-38)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
template <typename T, int HD>
__global__ void __launch_bounds__(MMA_THREADS) flash_fwd_mma_kernel(const Params p) {
  static_assert(HD % 16 == 0, "head_dim must be a multiple of 16");
  static_assert(BQ == 64 && BK == 64, "4 warps of 16 rows, 8 key tiles of 8");
  static_assert(sizeof(T) == 2, "16-bit operands");
  constexpr int STR = MmaLayout<HD>::STR;
  constexpr int TILE = MmaLayout<HD>::TILE;
  constexpr int KSTEPS = HD / 16;  // k-steps of Q K^T
  constexpr int DTILES = HD / 8;   // 8-column tiles of the output
  constexpr int CHUNKS = HD / 8;   // 16-byte chunks in a row
  // Q's fragments held in registers for the whole sweep, or re-read from
  // shared memory at every k-step (hd 256: see the note at the top)
  constexpr bool Q_IN_REGS = HD <= 128;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);  // [BQ][STR]; the output is staged here
  T* sK = sQ + TILE;                       // [2][BK][STR]
  T* sV = sK + 2 * TILE;                   // [2][BK][STR]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;  // accumulator row group and column pair
  // Query tiles ranked by causal work, longest first (rank r: tile
  // nq - 1 - r / (B*H)).  The first num_sms blocks take ranks 0, 1, ... and
  // the rest take them from the shortest end, so that the two blocks the
  // card places on one SM pair a long tile with a short one.
  const int bh_count = p.B * p.H;
  const int nb = gridDim.x;
  const int rank = blockIdx.x < p.num_sms ? blockIdx.x : nb - 1 - (blockIdx.x - p.num_sms);
  const int qt = nb / bh_count - 1 - rank / bh_count;
  const int b = (rank % bh_count) / p.H;
  const int h = rank % p.H;
  const int kh = h / (p.H / p.KH);
  const int q0 = qt * BQ;
  const int offset = p.S - p.T;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + kh * p.v_sh;
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  // 64 rows from row0 on; rows at or past `limit` are zero-filled
  auto load_rows = [&](T* dst, const T* src, long long stride, int row0, int limit) {
    for (int idx = tid; idx < 64 * CHUNKS; idx += MMA_THREADS) {
      const int r = idx / CHUNKS, c = idx % CHUNKS;
      const bool ok = row0 + r < limit;
      cp_async16(smem_addr(dst + r * STR + c * 8), src + (ok ? row0 + r : 0) * stride + c * 8, ok);
    }
  };

  // key range this query tile can see; whole dead tiles are never visited
  const int q_lo = q0 + offset;
  const int q_hi = min(q0 + BQ, p.T) - 1 + offset;
  int k_begin = 0, k_end = p.S;
  if (p.causal) k_end = min(k_end, q_hi + 1);
  if (p.window > 0) k_begin = max(0, q_lo - p.window + 1);
  const int kt_begin = k_begin / BK;
  const int kt_end = k_end > 0 ? (k_end + BK - 1) / BK : 0;

  load_rows(sQ, qg, p.q_st, q0, p.T);
  if (kt_begin < kt_end) {
    load_rows(sK, kg, p.k_ss, kt_begin * BK, p.S);
    load_rows(sV, vg, p.v_ss, kt_begin * BK, p.S);
  }
  cp_async_commit();

  // scores stay raw; exp(scale (s - m)) = exp2(s * c - m * c) with c = scale log2 e, one FFMA
  const float c = p.scale * 1.4426950408889634f;
  const int wpos_lo = q0 + warp * 16 + offset;  // key positions of this warp's first and last rows
  const int wpos_hi = wpos_lo + 15;
  const int qpos0 = wpos_lo + g, qpos1 = qpos0 + 8;  // rows g and g + 8
  float o[DTILES][4];
#pragma unroll
  for (int j = 0; j < DTILES; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = NEG, m1 = NEG;  // running max of rows g and g + 8
  float l0 = 0.f, l1 = 0.f;  // this lane's part of their denominators
  uint32_t qf[Q_IN_REGS ? KSTEPS : 1][4];
  const uint32_t q_addr = smem_addr(sQ + (warp * 16 + (lane & 15)) * STR + (lane >> 4) * 8);

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int stage = (kt - kt_begin) & 1;
    cp_async_wait_all();  // tile kt (and Q) landed for this thread
    __syncthreads();      // ... for every thread; tile kt - 1 is consumed
    if (kt + 1 < kt_end) {  // tile kt + 1 loads while tile kt computes
      load_rows(sK + (stage ^ 1) * TILE, kg, p.k_ss, (kt + 1) * BK, p.S);
      load_rows(sV + (stage ^ 1) * TILE, vg, p.v_ss, (kt + 1) * BK, p.S);
      cp_async_commit();
    }
    if (Q_IN_REGS && kt == kt_begin) {
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) ldmatrix_x4(qf[Q_IN_REGS ? ks : 0], q_addr + ks * 32);
    }
    const T* cK = sK + stage * TILE;
    const T* cV = sV + stage * TILE;
    const int k0 = kt * BK;

    // S = Q K^T: 16 rows x 64 keys per warp, 8 accumulator tiles
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const int qi = Q_IN_REGS ? ks : 0;
      if (!Q_IN_REGS) ldmatrix_x4(qf[qi], q_addr + ks * 32);  // 16 elements of 2 bytes
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {  // two key tiles per ldmatrix.x4
        uint32_t kb[4];
        ldmatrix_x4(kb, smem_addr(cK + (jj * 16 + (lane & 7) + ((lane >> 4) << 3)) * STR + ks * 16 +
                                  ((lane >> 3) & 1) * 8));
        mma16816<T>(s[2 * jj], qf[qi], kb[0], kb[1]);
        mma16816<T>(s[2 * jj + 1], qf[qi], kb[2], kb[3]);
      }
    }

    // mask in registers on the edge tiles only
    const bool edge = k0 + BK > p.S || (p.causal && k0 + BK - 1 > wpos_lo) ||
                      (p.window > 0 && k0 <= wpos_hi - p.window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + j * 8 + 2 * t4 + (e & 1);
          const int qpos = e < 2 ? qpos0 : qpos1;
          bool ok = kpos < p.S;
          if (p.causal) ok = ok && kpos <= qpos;
          if (p.window > 0) ok = ok && kpos > qpos - p.window;
          if (!ok) s[j][e] = -INFINITY;
        }
      }
    }

    // online softmax: the row max over the quad, then p = exp2(s c - m c)
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float alpha0 = ex2((m0 - mx0) * c), alpha1 = ex2((m1 - mx1) * c);
    m0 = mx0;
    m1 = mx1;
    const float nm0 = -mx0 * c, nm1 = -mx1 * c;
    uint32_t pf[4][4];  // P in the input type: the A operand of 4 k-steps of 16 keys
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = ex2(fmaf(s[j][0], c, nm0)), p1 = ex2(fmaf(s[j][1], c, nm0));
      const float p2 = ex2(fmaf(s[j][2], c, nm1)), p3 = ex2(fmaf(s[j][3], c, nm1));
      ls0 += p0 + p1;
      ls1 += p2 + p3;
      pf[j >> 1][(j & 1) * 2] = pack2<T>(p0, p1);      // rows g: a0 / a2
      pf[j >> 1][(j & 1) * 2 + 1] = pack2<T>(p2, p3);  // rows g + 8: a1 / a3
    }
    l0 = l0 * alpha0 + ls0;
    l1 = l1 * alpha1 + ls1;
#pragma unroll
    for (int j = 0; j < DTILES; ++j) {
      o[j][0] *= alpha0;
      o[j][1] *= alpha0;
      o[j][2] *= alpha1;
      o[j][3] *= alpha1;
    }

    // O += P V, V through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int dp = 0; dp < DTILES / 2; ++dp) {  // two output tiles per ldmatrix.x4
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, smem_addr(cV + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * STR +
                                        dp * 16 + (lane >> 4) * 8));
        mma16816<T>(o[2 * dp], pf[kk], vb[0], vb[1]);
        mma16816<T>(o[2 * dp + 1], pf[kk], vb[2], vb[3]);
      }
    }
  }

  // out = acc / max(l, 1e-30); stage the warp's 16 rows in its own rows of sQ
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  cp_async_wait_all();  // the Q copy is done even when no tile was visited
  __syncwarp();
  T* sO = sQ + warp * 16 * STR;
#pragma unroll
  for (int j = 0; j < DTILES; ++j) {
    *reinterpret_cast<uint32_t*>(sO + g * STR + j * 8 + 2 * t4) = pack2<T>(o[j][0] * inv0, o[j][1] * inv0);
    *reinterpret_cast<uint32_t*>(sO + (g + 8) * STR + j * 8 + 2 * t4) =
        pack2<T>(o[j][2] * inv1, o[j][3] * inv1);
  }
  __syncwarp();
  for (int idx = lane; idx < 16 * CHUNKS; idx += 32) {
    const int r = idx / CHUNKS, cc = idx % CHUNKS;
    const int t = q0 + warp * 16 + r;
    if (t < p.T)
      *reinterpret_cast<uint4*>(og + t * p.o_st + cc * 8) =
          *reinterpret_cast<const uint4*>(sO + r * STR + cc * 8);
  }
}

// ---- launch ------------------------------------------------------------------

template <typename T, int HD>
cudaError_t launch_fma(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = Layout<HD>::bytes;
  // once per kernel: the attribute stays set for later launches
  static const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_fma_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.T + BQ - 1) / BQ, p.B * p.H);
  flash_fwd_fma_kernel<T, HD><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_mma(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = MmaLayout<HD>::bytes;
  // once per kernel: the attribute stays set for later launches
  static const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((p.T + BQ - 1) / BQ) * p.B * p.H;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  flash_fwd_mma_kernel<T, HD><<<(unsigned)blocks, MMA_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

#define FLASH_HD_SWITCH(LAUNCH, T)                  \
  switch (hd) {                                     \
    case 64: return LAUNCH<T, 64>(p, stream);       \
    case 80: return LAUNCH<T, 80>(p, stream);       \
    case 96: return LAUNCH<T, 96>(p, stream);       \
    case 112: return LAUNCH<T, 112>(p, stream);     \
    case 128: return LAUNCH<T, 128>(p, stream);     \
    case 256: return LAUNCH<T, 256>(p, stream);     \
    default: return cudaErrorInvalidValue;          \
  }

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16; route: 0 fma (float32 only),
// 1 mma (float16 and bfloat16 only; 16-byte aligned pointers and row
// strides).  Strides are in elements; the head dimension is contiguous.
// Returns a cudaError_t (0 on success).
extern "C" int repro_flash_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int route, int hd,
    int B, int T, int S, int H, int KH,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_st, long long o_sh,
    float scale, int causal, int window, void* stream_) {
  int device = 0, num_sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&num_sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  Params p{q, k, v, o, B, T, S, H, KH,
           q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_st, o_sh,
           scale, causal, window, num_sms};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (route == 0 && dtype == 0) FLASH_HD_SWITCH(launch_fma, float)
  if (route == 1 && dtype == 1) FLASH_HD_SWITCH(launch_mma, __half)
  if (route == 1 && dtype == 2) FLASH_HD_SWITCH(launch_mma, __nv_bfloat16)
  return cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
