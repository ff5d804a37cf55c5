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
// Design for this card.  The TPU kernel carries m/l/acc in VMEM scratch
// across a sequential k grid axis.  CUDA blocks run in no order, so here one
// block owns one (batch*head, 64-query tile) and loops over the 64-key tiles
// itself: the running max and denominator live in shared memory, the
// accumulator in registers (a 4 x hd/16 slice per thread).  Tiles that the
// causal or window mask kills entirely are never loaded (the loop range is
// cut, as kernel.py skips dead blocks with pl.when), and the ragged T and S
// edges are masked in the kernel, so the wrapper makes no pad copies.  The
// [B,T,H,hd] layout is read through strides and GQA through the head index:
// no transpose and no repeated KV in device memory.
//
// What bounds it.  At the serving shapes (T = S <= 512, hd = 80, bf16) the
// work is about 100 FLOP per byte of q/k/v/o, under the card's ~295 FLOP/B
// ridge, so the lower bound is the bytes.  This first version computes both
// products with fp32 FMAs out of shared memory (every input type is widened
// to fp32 on load), so it is held back by the FMA issue rate and shared-memory
// bandwidth, not by device memory.  Moving the products to mma.sync / wgmma
// with TMA loads is the next step.
//
// P is rounded to the input type before P.V, as the reference does with
// probs.astype(v.dtype); for fp32 inputs that is a no-op.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;         // queries per block
constexpr int BK = 64;         // keys per tile
constexpr int NTHREADS = 256;  // 16 x 16 threads, each a 4-row slice
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
  int window;  // <= 0: no sliding window
};

template <int HD>
struct Layout {
  static constexpr int QSTR = HD + 1;  // padded rows: no bank conflicts
  static constexpr int KSTR = HD + 1;
  static constexpr int PSTR = BK + 1;
  static constexpr int floats = BQ * QSTR + BK * KSTR + BK * HD + BQ * PSTR + 3 * BQ;
  static constexpr size_t bytes = sizeof(float) * floats;
};

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_kernel(const Params p) {
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

template <typename T, int HD>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = Layout<HD>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.T + BQ - 1) / BQ, p.B * p.H);
  flash_fwd_kernel<T, HD><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const Params& p, cudaStream_t stream) {
  switch (hd) {
    case 64: return launch<T, 64>(p, stream);
    case 80: return launch<T, 80>(p, stream);
    case 96: return launch<T, 96>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16.  Strides are in elements; the
// head dimension is contiguous.  Returns a cudaError_t (0 on success).
extern "C" int repro_flash_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int hd,
    int B, int T, int S, int H, int KH,
    long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_st, long long o_sh,
    float scale, int causal, int window, void* stream) {
  Params p{q, k, v, o, B, T, S, H, KH,
           q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_st, o_sh,
           scale, causal, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_hd<float>(hd, p, st);
    case 1: return dispatch_hd<__half>(hd, p, st);
    case 2: return dispatch_hd<__nv_bfloat16>(hd, p, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
