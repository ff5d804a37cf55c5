// Mamba2 chunked SSD scan forward for Hopper (sm_90a), behind a plain C entry point.
//
// Replaces src/repro/kernels/ssd_scan/kernel.py::ssd_chunked_pallas (body
// _ssd_kernel) and computes the function of its oracle,
// src/repro_torch/kernels/ssd_scan/ref.py::ssd_chunked:
//
//   x [B,T,H,P], dt [B,T,H] fp32, A [H] fp32, B/C [B,T,N] (one group);
//   per chunk of Q steps, with cum = inclusive cumsum of dt*A over the chunk
//   and w = dt*x:
//     y   = ((C B^T) o tril(exp(cum_i - cum_j))) w + exp(cum) o (C h^T)
//     h  <- exp(cum_last) h + (w o exp(cum_last - cum))^T B
//   all math in fp32, y in x's type.
//
// Design for this card.  The TPU kernel walks a (batch, head, chunk) grid
// whose chunk axis runs in order, and carries the state h [P,N] in VMEM
// scratch from one chunk to the next.  CUDA blocks run in no order, so here
// one block owns one (batch, head) pair and loops over the chunks itself,
// with h in shared memory for the whole sweep.  Per chunk, warp 0 scans
// dt*A over Q (a shuffle scan) while the block loads B and C; then the
// block loads w = dt*x.  All three are widened to fp32 and read through
// strides, since in the model they are views of slices of the conv output.
// Then come three register-tiled products, each thread owning a strided
// 16 x 16 slice of the output:
//   S = (C B^T) o L   [Q,Q]  exp only where j <= i; above the diagonal S is
//                            set to 0 and exp is never taken, so no inf
//                            exists to meet a zero (the NaN of ref.py's note)
//   y = S w + exp(cum) o (C h^T)   [Q,P]  the S w loop stops at the
//                            thread's last row; chunk 0 skips C h^T (h = 0)
//   h = exp(cum_last) h + (w o exp(cum_last - cum))^T B   [P,N]
//
// Shared memory at mamba2-780m (P 64, N 128, Q 64, fp32): B, C and h with
// rows padded by one float (33 KB each), w 16 KB, S 16.6 KB, four [Q]
// vectors: 133 KB, above the 48 KB static limit, so the launch sets
// cudaFuncAttributeMaxDynamicSharedMemorySize.  Occupancy: one 256-thread
// block per SM (8 warps); at the training shape (B 4, H 48) the grid is
// 192 blocks on 132 SMs, so 60 SMs run a second block after the first.
//
// What bounds it.  At the training shape (per micro-batch B 4, T 1024,
// H 48, P 64, N 128, Q 64, x bf16) the function moves ~53 MB (x and y
// 25.2 MB each, dt 0.8 MB, B/C 2.1 MB) and needs ~9 GFLOP (the causal
// triangle of C B^T and of S w, plus C h^T and the state update, over 3,072
// (b, h, chunk) triples): 16 us of memory against 9 us at the bf16 tensor
// peak, so the bound is the bytes.  This first version computes every
// product with fp32 FMAs out of shared memory and overlaps no load with
// compute, so it is held back by the FMA issue rate and shared-memory
// bandwidth at low occupancy, not by device memory.  Moving the products
// to mma.sync / wgmma, double-buffering the chunk loads and splitting P
// across blocks to fill the card are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 256;  // 16 x 16 threads

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* b;
  const void* c;
  void* y;
  int T, H;
  long long x_sb, x_st, x_sh;
  long long dt_sb, dt_st, dt_sh;
  long long a_s;
  long long b_sb, b_st;
  long long c_sb, c_st;
  long long y_sb, y_st, y_sh;
};

template <int P, int N, int Q>
struct Layout {
  static constexpr int NS = N + 1;  // padded rows of B, C and h: no bank conflicts
  static constexpr int QS = Q + 1;  // padded rows of S
  static constexpr int floats = 2 * Q * NS + Q * P + P * NS + Q * QS + 4 * Q;
  static constexpr size_t bytes = sizeof(float) * floats;
};

template <typename TX, typename TB, int P, int N, int Q>
__global__ void __launch_bounds__(NT) ssd_fwd_kernel(const Params p) {
  static_assert(Q <= 64, "the dt*A scan holds at most two steps per lane");
  constexpr int NS = Layout<P, N, Q>::NS;
  constexpr int QS = Layout<P, N, Q>::QS;
  constexpr int QI = (Q + 15) / 16;  // rows of Q per thread
  constexpr int PJ = (P + 15) / 16;  // columns of P per thread
  constexpr int NJ = (N + 15) / 16;  // columns of N per thread
  constexpr int E = (Q + 31) / 32;   // scan steps per lane

  extern __shared__ float smem[];
  float* sB = smem;                // [Q][NS]
  float* sC = sB + Q * NS;         // [Q][NS]
  float* sW = sC + Q * NS;         // [Q][P]   w = dt * x
  float* sH = sW + Q * P;          // [P][NS]  the carried state
  float* sS = sH + P * NS;         // [Q][QS]  (C B^T) o L
  float* sCum = sS + Q * QS;       // [Q]
  float* sDt = sCum + Q;           // [Q]
  float* sExpCum = sDt + Q;        // [Q] exp(cum_i)
  float* sDecayIn = sExpCum + Q;   // [Q] exp(cum_last - cum_j)

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int lane = tid % 32, warp = tid / 32;
  const int b = blockIdx.x / p.H;
  const int h = blockIdx.x % p.H;
  const float a_h = p.A[h * p.a_s];

  const TX* xg = static_cast<const TX*>(p.x) + b * p.x_sb + h * p.x_sh;
  const float* dtg = p.dt + b * p.dt_sb + h * p.dt_sh;
  const TB* bg = static_cast<const TB*>(p.b) + b * p.b_sb;
  const TB* cg = static_cast<const TB*>(p.c) + b * p.c_sb;
  TX* yg = static_cast<TX*>(p.y) + b * p.y_sb + h * p.y_sh;

  for (int idx = tid; idx < P * NS; idx += NT) sH[idx] = 0.f;

  const int n_chunks = p.T / Q;
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const int t0 = chunk * Q;
    __syncthreads();  // the previous chunk's tiles and state update are done

    // warp 0: cum = inclusive scan of dt*A over the chunk
    if (warp == 0) {
      float d[E], v[E];
      float run = 0.f;
#pragma unroll
      for (int k = 0; k < E; ++k) {
        const int q = lane * E + k;
        d[k] = q < Q ? dtg[(t0 + q) * p.dt_st] : 0.f;
        run += d[k] * a_h;
        v[k] = run;  // inclusive within the lane
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const float up = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += up;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.f;
#pragma unroll
      for (int k = 0; k < E; ++k) {
        const int q = lane * E + k;
        if (q < Q) {
          sCum[q] = excl + v[k];
          sDt[q] = d[k];
        }
      }
      __syncwarp();
      const float last = sCum[Q - 1];
#pragma unroll
      for (int k = 0; k < E; ++k) {
        const int q = lane * E + k;
        if (q < Q) {
          sExpCum[q] = expf(sCum[q]);
          sDecayIn[q] = expf(last - sCum[q]);
        }
      }
    }
    // everyone: B and C of the chunk, widened to fp32
    for (int idx = tid; idx < Q * N; idx += NT) {
      const int q = idx / N, n = idx % N;
      sB[q * NS + n] = to_f(bg[(t0 + q) * p.b_st + n]);
      sC[q * NS + n] = to_f(cg[(t0 + q) * p.c_st + n]);
    }
    __syncthreads();  // sDt, sCum, sB, sC ready
    for (int idx = tid; idx < Q * P; idx += NT) {
      const int q = idx / P, pp = idx % P;
      sW[idx] = sDt[q] * to_f(xg[(t0 + q) * p.x_st + pp]);
    }

    // S = (C B^T) o L: rows ty + 16 i, columns tx + 16 j (clamped reads, guarded stores)
    {
      float s[QI][QI];
#pragma unroll
      for (int i = 0; i < QI; ++i)
#pragma unroll
        for (int j = 0; j < QI; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[QI], bv[QI];
#pragma unroll
        for (int i = 0; i < QI; ++i) cv[i] = sC[min(ty + 16 * i, Q - 1) * NS + n];
#pragma unroll
        for (int j = 0; j < QI; ++j) bv[j] = sB[min(tx + 16 * j, Q - 1) * NS + n];
#pragma unroll
        for (int i = 0; i < QI; ++i)
#pragma unroll
          for (int j = 0; j < QI; ++j) s[i][j] = fmaf(cv[i], bv[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < QI; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < QI; ++j) {
          const int c = tx + 16 * j;
          if (r < Q && c < Q) {
            // exp only on the causal triangle, where cum_r - cum_c <= 0
            sS[r * QS + c] = c <= r ? s[i][j] * expf(sCum[r] - sCum[c]) : 0.f;
          }
        }
      }
    }
    __syncthreads();  // sS and sW ready

    // y = S w + exp(cum) o (C h^T): rows ty + 16 i, columns tx + 16 j
    {
      float acc[QI][PJ];
#pragma unroll
      for (int i = 0; i < QI; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc[i][j] = 0.f;
      const int k_end = min(Q, ty + 16 * (QI - 1) + 1);  // S is 0 past the last row's diagonal
#pragma unroll 4
      for (int k = 0; k < k_end; ++k) {
        float sv[QI], wv[PJ];
#pragma unroll
        for (int i = 0; i < QI; ++i) sv[i] = sS[min(ty + 16 * i, Q - 1) * QS + k];
#pragma unroll
        for (int j = 0; j < PJ; ++j) wv[j] = sW[k * P + min(tx + 16 * j, P - 1)];
#pragma unroll
        for (int i = 0; i < QI; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) acc[i][j] = fmaf(sv[i], wv[j], acc[i][j]);
      }
      if (chunk > 0) {
        float inter[QI][PJ];
#pragma unroll
        for (int i = 0; i < QI; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) inter[i][j] = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float cv[QI], hv[PJ];
#pragma unroll
          for (int i = 0; i < QI; ++i) cv[i] = sC[min(ty + 16 * i, Q - 1) * NS + n];
#pragma unroll
          for (int j = 0; j < PJ; ++j) hv[j] = sH[min(tx + 16 * j, P - 1) * NS + n];
#pragma unroll
          for (int i = 0; i < QI; ++i)
#pragma unroll
            for (int j = 0; j < PJ; ++j) inter[i][j] = fmaf(cv[i], hv[j], inter[i][j]);
        }
#pragma unroll
        for (int i = 0; i < QI; ++i) {
          const float e = sExpCum[min(ty + 16 * i, Q - 1)];
#pragma unroll
          for (int j = 0; j < PJ; ++j) acc[i][j] += e * inter[i][j];
        }
      }
#pragma unroll
      for (int i = 0; i < QI; ++i) {
        const int r = ty + 16 * i;
        if (r >= Q) continue;
#pragma unroll
        for (int j = 0; j < PJ; ++j) {
          const int c = tx + 16 * j;
          if (c < P) yg[(t0 + r) * p.y_st + c] = from_f<TX>(acc[i][j]);
        }
      }
    }
    __syncthreads();  // every read of h for this chunk's y is done

    // h = exp(cum_last) h + (w o exp(cum_last - cum))^T B: rows p = ty + 16 i,
    // columns n = tx + 16 j
    {
      float acc[PJ][NJ];
#pragma unroll
      for (int i = 0; i < PJ; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int k = 0; k < Q; ++k) {
        const float dk = sDecayIn[k];
        float wv[PJ], bv[NJ];
#pragma unroll
        for (int i = 0; i < PJ; ++i) wv[i] = sW[k * P + min(ty + 16 * i, P - 1)] * dk;
#pragma unroll
        for (int j = 0; j < NJ; ++j) bv[j] = sB[k * NS + min(tx + 16 * j, N - 1)];
#pragma unroll
        for (int i = 0; i < PJ; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(wv[i], bv[j], acc[i][j]);
      }
      const float decay = sExpCum[Q - 1];
#pragma unroll
      for (int i = 0; i < PJ; ++i) {
        const int r = ty + 16 * i;
        if (r >= P) continue;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int c = tx + 16 * j;
          if (c < N) sH[r * NS + c] = decay * sH[r * NS + c] + acc[i][j];
        }
      }
    }
  }
}

template <typename TX, typename TB, int P, int N, int Q>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr size_t smem = Layout<P, N, Q>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd_kernel<TX, TB, P, N, Q>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ssd_fwd_kernel<TX, TB, P, N, Q><<<batch * p.H, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

// (P, N, Q): the rows of tests/test_kernels.py::SSD_CASES, mamba2-smoke and
// mamba2-780m.  Keep in step with ops.py::SHAPES.
template <typename TX, typename TB>
cudaError_t dispatch_shape(int P, int N, int Q, const Params& p, int batch, cudaStream_t st) {
#define SSD_CASE(PP, NN, QQ) \
  if (P == PP && N == NN && Q == QQ) return launch<TX, TB, PP, NN, QQ>(p, batch, st);
  SSD_CASE(64, 128, 64)  // mamba2-780m
  SSD_CASE(32, 32, 8)    // mamba2-smoke
  SSD_CASE(16, 8, 8)
  SSD_CASE(32, 16, 16)
  SSD_CASE(64, 128, 32)
  SSD_CASE(8, 4, 16)
#undef SSD_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// x_dtype, bc_dtype: 0 float32, 1 bfloat16.  dt and A are float32.  Strides
// are in elements; the P axis of x and y and the N axis of B and C are
// contiguous.  Returns a cudaError_t (0 on success).
extern "C" int repro_ssd_fwd(
    const void* x, const void* dt, const void* A, const void* b, const void* c, void* y,
    int x_dtype, int bc_dtype, int P, int N, int Q, int batch, int T, int H,
    long long x_sb, long long x_st, long long x_sh,
    long long dt_sb, long long dt_st, long long dt_sh, long long a_s,
    long long b_sb, long long b_st, long long c_sb, long long c_st,
    long long y_sb, long long y_st, long long y_sh, void* stream) {
  Params p{x, static_cast<const float*>(dt), static_cast<const float*>(A), b, c, y, T, H,
           x_sb, x_st, x_sh, dt_sb, dt_st, dt_sh, a_s, b_sb, b_st, c_sb, c_st,
           y_sb, y_st, y_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T % Q != 0) return cudaErrorInvalidValue;
  if (x_dtype == 0 && bc_dtype == 0) return dispatch_shape<float, float>(P, N, Q, p, batch, st);
  if (x_dtype == 0 && bc_dtype == 1) return dispatch_shape<float, __nv_bfloat16>(P, N, Q, p, batch, st);
  if (x_dtype == 1 && bc_dtype == 0) return dispatch_shape<__nv_bfloat16, float>(P, N, Q, p, batch, st);
  if (x_dtype == 1 && bc_dtype == 1)
    return dispatch_shape<__nv_bfloat16, __nv_bfloat16>(P, N, Q, p, batch, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* repro_ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
