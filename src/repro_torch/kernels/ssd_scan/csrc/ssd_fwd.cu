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
//   fp32 accumulation (the mma route rounds some operands to TF32, below),
//   y in x's type.
//
// Two routes, chosen by the caller (ops.py::route) from the dtypes and
// (P, N, Q) alone.
//
// mma route (x, B, C bf16; P, N, Q multiples of 16; mamba2-780m's main
// path): ssd_fwd_mma_kernel.  The TPU kernel walks a (batch, head, chunk)
// grid whose chunk axis runs in order and carries h [P,N] in VMEM scratch.
// Here a block owns one (batch, head, P slice of PS = 32 columns) and loops
// over the chunks itself: 384 blocks at the training shape in place of 192,
// two blocks of 8 warps per SM (~100 KB of shared memory each).  A warp
// owns one 16-row band of the chunk and half of the slice's columns of y,
// and a 16 x 32 share of the state slice.  Every warp scans dt*A itself
// (its own copy, so the scan needs no block barrier).  Per chunk:
//   C B^T   [Q,Q]  mma.sync m16n8k16 bf16 -> fp32 (products of bf16 values
//                  are exact in fp32); a band computes only the key tiles
//                  on or below its diagonal
//   S = (C B^T) o L  in registers; exp (on the SFU, ex2.approx) only where
//                  j <= i, so no inf exists
//   y = S w + exp(cum) o (C h^T)   mma.sync m16n8k8 TF32, w = dt x in fp32;
//                  C is bf16, so exact in TF32
//   h = exp(cum_last) h + (w o exp(cum_last - cum))^T B   TF32; the fp32
//                  state slice lives in registers and is copied to shared
//                  memory for the next chunk's C h^T
// The k index of the TF32 products is permuted (A column t is column 2t of
// the 8, column t + 4 is 2t + 1): then S's accumulator fragment is the A
// operand of S w as it stands, one 32-bit load gives a pair of C's A
// operand and one 64-bit load a pair of h's B operand, and ldmatrix.trans
// of the bf16 x and B tiles hands each lane the pairs (row 2t, row 2t + 1)
// that the B operand of S w and both operands of the state update need.  TF32 rounds S, w, h and w o exp(...) by 2^-11
// relative, under the bf16 output's own 2^-9; tests/test_torch_ssd_scan.py
// emulates this arithmetic on the CPU and bounds its error.  B, C, the x
// slice and dt of chunk c+1 arrive by cp.async (16 bytes; 4 for dt, whose
// time stride is H) into the other half of a two-stage ring while chunk c
// computes; two block barriers a chunk.  Row strides are padded (B/C N+8,
// x PS+8, h N+8) so that the ldmatrix phases and the fragment loads are
// free of bank conflicts.  x, B and C are read through strides, since in
// the model they are views of slices of the conv output; their pointers
// and row strides must be 16-byte aligned (the wrapper checks).
//
// fma route (every other case: fp32 x, where TF32 would break the fp32
// tolerance; mamba2-smoke's Q = 8; mixed types): ssd_fwd_fma_kernel, the
// first version, unchanged.  One 256-thread block owns one (batch, head)
// pair with h in shared memory; per chunk warp 0 scans dt*A while the block
// loads B and C, then the block loads w = dt*x, all widened to fp32; then
// three register-tiled fp32 FMA products, each thread owning a strided
// 16 x 16 slice of the output (the S w loop stops at the thread's last row;
// chunk 0 skips C h^T).  133 KB of shared memory at (64, 128, 64).
//
// What bounds it.  At the training shape (per micro-batch B 4, T 1024,
// H 48, P 64, N 128, Q 64, x bf16) the function moves ~53 MB (x and y
// 25.2 MB each, dt 0.8 MB, B/C 2.1 MB) and needs ~9 GFLOP (the causal
// triangle of C B^T and of S w, plus C h^T and the state update, over 3,072
// (b, h, chunk) triples): 16 us of memory against 9 us at the bf16 tensor
// peak, so the bound is the bytes.  The mma route issues ~1,800 mma.sync
// per (b, h, chunk) (C B^T twice per band, TF32 at half the bf16 rate);
// with its shared-memory fragment traffic it runs at several times the
// bound.  Next: C B^T once per (b, chunk) for all heads (B and C have one
// group), the state products on wgmma, and a backward kernel, whose plain
// recompute is the larger part of a training step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NT = 256;  // fma route: 16 x 16 threads

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

// ---- fma route ------------------------------------------------------------------

template <int P, int N, int Q>
struct Layout {
  static constexpr int NS = N + 1;  // padded rows of B, C and h: no bank conflicts
  static constexpr int QS = Q + 1;  // padded rows of S
  static constexpr int floats = 2 * Q * NS + Q * P + P * NS + Q * QS + 4 * Q;
  static constexpr size_t bytes = sizeof(float) * floats;
};

template <typename TX, typename TB, int P, int N, int Q>
__global__ void __launch_bounds__(NT) ssd_fwd_fma_kernel(const Params p) {
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

// ---- mma route (x, B, C bf16; P, N, Q multiples of 16) --------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// ldmatrix.trans of NM 8 x 8 b16 matrices (rows from lanes 8m .. 8m + 7): lane
// (g, t) gets rows 2t and 2t + 1 of column g of each, lo and hi
template <int NM>
__device__ __forceinline__ void ldmatrix_trans(uint32_t (&r)[NM], uint32_t addr);
template <>
__device__ __forceinline__ void ldmatrix_trans<1>(uint32_t (&r)[1], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x1.trans.shared.b16 {%0}, [%1];\n" : "=r"(r[0]) : "r"(addr) : "memory");
}
template <>
__device__ __forceinline__ void ldmatrix_trans<2>(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}
template <>
__device__ __forceinline__ void ldmatrix_trans<4>(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
// d += a b: m16n8k16, bf16 operands, fp32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d += a b: m16n8k8, TF32 operands, fp32 accumulation
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// fp32 rounded to TF32 (to nearest, ties away: 10 mantissa bits kept)
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// bf16 -> fp32 bits: exact, and already a TF32 value
__device__ __forceinline__ uint32_t bf16_lo(uint32_t pair) { return pair << 16; }
__device__ __forceinline__ uint32_t bf16_hi(uint32_t pair) { return pair & 0xffff0000u; }

// Warps of the mma route: 4 row bands of 16 (Q/16 of them busy) times
// WARPS/4 parts of the P slice; 8 where the state slice's 16 x 8 tiles split
// evenly over 8 warps within one 16-row band each, else 4.
template <int PS, int N>
struct MmaWarps {
  static constexpr int HT = (PS / 16) * (N / 8);  // 16 x 8 tiles of the state slice
  static constexpr int WARPS = HT % 8 == 0 && (N / 8) % (HT / 8) == 0 && (PS / 8) % 2 == 0 ? 8 : 4;
  static constexpr int THREADS = 32 * WARPS;
};

template <int PS, int N, int Q>
struct MmaLayout {
  static constexpr int BS = N + 8;   // bf16 row stride of B and C: ldmatrix phases conflict-free
  static constexpr int XS = PS + 8;  // bf16 row stride of the x slice
  static constexpr int HS = N + 8;   // fp32 row stride of the state slice
  // one stage of the ring: B, C, the x slice, dt
  static constexpr int stage_bytes = 2 * Q * BS * 2 + Q * XS * 2 + Q * 4;
  // two stages, the state slice h [PS][HS], and each warp's cum, exp(cum), exp(cum_last - cum)
  static constexpr size_t bytes = 2 * stage_bytes + PS * HS * 4 + MmaWarps<PS, N>::WARPS * 3 * Q * 4;
  static_assert(stage_bytes % 16 == 0 && (Q * BS * 2) % 16 == 0 && (Q * XS * 2) % 16 == 0,
                "cp.async destinations stay 16-byte aligned");
};

// e^x as 2^(x log2 e) on the SFU (a few ulp; denormal results flush to 0),
// where expf's accurate sequence was a tenth of the mma route's time
__device__ __forceinline__ float fexp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}
template <int P, int N, int Q, int PS>
__global__ void __launch_bounds__(MmaWarps<PS, N>::THREADS, 2) ssd_fwd_mma_kernel(const Params p) {
  static_assert(Q % 16 == 0 && Q <= 64, "Q/16 row warps; the dt*A scan holds two steps per lane");
  static_assert(N % 16 == 0 && PS % 16 == 0 && P % PS == 0, "16-wide tiles");
  using L = MmaLayout<PS, N, Q>;
  constexpr int BS = L::BS, XS = L::XS, HS = L::HS;
  constexpr int WARPS = MmaWarps<PS, N>::WARPS, NTH = MmaWarps<PS, N>::THREADS;
  constexpr int RW = Q / 16;        // row bands of 16 that hold rows of the chunk
  constexpr int QT = Q / 8;         // 8-column tiles of the chunk
  constexpr int PTW = PS / 8 / (WARPS / 4);  // 8-column tiles of y per warp
  constexpr int NTN = N / 8;        // 8-column tiles of N
  constexpr int HT = MmaWarps<PS, N>::HT;
  constexpr int HW = HT / WARPS;    // state tiles per warp, all in one 16-row band
  static_assert(HT % WARPS == 0 && NTN % HW == 0, "the state slice splits evenly over the warps");
  constexpr int NSL = P / PS;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sH = reinterpret_cast<float*>(smem_raw + 2 * L::stage_bytes);  // [PS][HS]
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int band = warp & 3, part = warp >> 2;  // rows 16*band.., y columns 8*PTW*part..
  const int g = lane >> 2, t4 = lane & 3;
  float* scan = reinterpret_cast<float*>(sH + PS * HS) + warp * 3 * Q;  // this warp's own copy

  const int slice = blockIdx.x % NSL;
  const int bh = blockIdx.x / NSL;
  const int b = bh / p.H, h = bh % p.H;
  const int p0 = slice * PS;
  const float a_h = p.A[h * p.a_s];
  const __nv_bfloat16* xg = static_cast<const __nv_bfloat16*>(p.x) + b * p.x_sb + h * p.x_sh + p0;
  const float* dtg = p.dt + b * p.dt_sb + h * p.dt_sh;
  const __nv_bfloat16* bg = static_cast<const __nv_bfloat16*>(p.b) + b * p.b_sb;
  const __nv_bfloat16* cg = static_cast<const __nv_bfloat16*>(p.c) + b * p.c_sb;
  __nv_bfloat16* yg = static_cast<__nv_bfloat16*>(p.y) + b * p.y_sb + h * p.y_sh + p0;

  auto stage_b = [&](int st) { return reinterpret_cast<__nv_bfloat16*>(smem_raw + st * L::stage_bytes); };
  auto load_chunk = [&](int chunk, int st) {
    __nv_bfloat16* dB = stage_b(st);
    __nv_bfloat16* dC = dB + Q * BS;
    __nv_bfloat16* dX = dC + Q * BS;
    float* dDt = reinterpret_cast<float*>(dX + Q * XS);
    const int t0 = chunk * Q;
    for (int idx = tid; idx < Q * (N / 8); idx += NTH) {
      const int r = idx / (N / 8), k = idx % (N / 8);
      cp_async16(smem_addr(dB + r * BS + k * 8), bg + (t0 + r) * p.b_st + k * 8);
      cp_async16(smem_addr(dC + r * BS + k * 8), cg + (t0 + r) * p.c_st + k * 8);
    }
    for (int idx = tid; idx < Q * (PS / 8); idx += NTH) {
      const int r = idx / (PS / 8), k = idx % (PS / 8);
      cp_async16(smem_addr(dX + r * XS + k * 8), xg + (t0 + r) * p.x_st + k * 8);
    }
    for (int idx = tid; idx < Q; idx += NTH) cp_async4(smem_addr(dDt + idx), dtg + (t0 + idx) * p.dt_st);
  };

  // this warp's share of the state slice: HW tiles of one 16-row band, in registers
  const int hband = (warp * HW) / NTN, hcol0 = (warp * HW) % NTN;
  float hr[HW][4];
#pragma unroll
  for (int i = 0; i < HW; ++i) hr[i][0] = hr[i][1] = hr[i][2] = hr[i][3] = 0.f;

  const int n_chunks = p.T / Q;
  load_chunk(0, 0);
  cp_async_commit();
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const int st = chunk & 1;
    const int t0 = chunk * Q;
    cp_async_wait_all();  // this chunk landed for this thread
    __syncthreads();      // ... for every thread; the previous chunk (and its h) is consumed
    if (chunk + 1 < n_chunks) {  // the next chunk loads while this one computes
      load_chunk(chunk + 1, st ^ 1);
      cp_async_commit();
    }
    const __nv_bfloat16* cB = stage_b(st);
    const __nv_bfloat16* cC = cB + Q * BS;
    const __nv_bfloat16* cX = cC + Q * BS;
    const float* cDt = reinterpret_cast<const float*>(cX + Q * XS);

    // every warp: cum = inclusive scan of dt*A over the chunk, two steps per lane
    {
      const int q = 2 * lane;
      const float d0 = q < Q ? cDt[q] : 0.f, d1 = q + 1 < Q ? cDt[q + 1] : 0.f;
      const float v0 = d0 * a_h, v1 = v0 + d1 * a_h;
      float incl = v1;
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const float up = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += up;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.f;
      const float c0 = excl + v0, c1 = excl + v1;
      const float last = __shfl_sync(0xffffffffu, c1, Q / 2 - 1);
      if (q < Q) {
        scan[q] = c0;
        scan[q + 1] = c1;
        scan[Q + q] = fexp(c0);
        scan[Q + q + 1] = fexp(c1);
        scan[2 * Q + q] = fexp(last - c0);
        scan[2 * Q + q + 1] = fexp(last - c1);
      }
      __syncwarp();
    }

    if (band < RW) {
      const int i0 = band * 16 + g, i1 = i0 + 8;  // this lane's two rows of the chunk

      // C B^T for the row band, causal tiles only (key tiles 0 .. 2*band + 1);
      // the warps of one band each compute it, so that S is in each one's registers
      float s[QT][4];
#pragma unroll
      for (int j = 0; j < QT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < N / 16; ++ks) {
        uint32_t ca[4];
        ldmatrix_x4(ca, smem_addr(cC + (band * 16 + (lane & 15)) * BS + ks * 16 + (lane >> 4) * 8));
#pragma unroll
        for (int jj = 0; jj < Q / 16; ++jj) {
          if (jj <= band) {
            uint32_t bb[4];
            ldmatrix_x4(bb, smem_addr(cB + (jj * 16 + (lane & 7) + ((lane >> 4) << 3)) * BS + ks * 16 +
                                      ((lane >> 3) & 1) * 8));
            mma_bf16(s[2 * jj], ca, bb[0], bb[1]);
            mma_bf16(s[2 * jj + 1], ca, bb[2], bb[3]);
          }
        }
      }
      // S = (C B^T) o L; exp only on the causal triangle, where cum_i - cum_j <= 0
      const float cum0 = scan[i0], cum1 = scan[i1];
#pragma unroll
      for (int j = 0; j < QT; ++j) {
        if (j <= 2 * band + 1) {
          const int c = j * 8 + 2 * t4;
          const float cc0 = scan[c], cc1 = scan[c + 1];
          s[j][0] = c <= i0 ? s[j][0] * fexp(cum0 - cc0) : 0.f;
          s[j][1] = c + 1 <= i0 ? s[j][1] * fexp(cum0 - cc1) : 0.f;
          s[j][2] = c <= i1 ? s[j][2] * fexp(cum1 - cc0) : 0.f;
          s[j][3] = c + 1 <= i1 ? s[j][3] * fexp(cum1 - cc1) : 0.f;
        }
      }

      // y = S w on TF32, w = dt x; with the k permutation S's accumulator
      // fragment is the A operand as it stands, and ldmatrix.trans of x gives
      // each lane the pair (x[2t][n], x[2t+1][n]) of the B operand
      float y[PTW][4];
#pragma unroll
      for (int j = 0; j < PTW; ++j) y[j][0] = y[j][1] = y[j][2] = y[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < QT; ++kk) {
        if (kk <= 2 * band + 1) {
          const uint32_t a[4] = {tf32(s[kk][0]), tf32(s[kk][2]), tf32(s[kk][1]), tf32(s[kk][3])};
          const float2 dt01 = *reinterpret_cast<const float2*>(cDt + kk * 8 + 2 * t4);
#pragma unroll
          for (int pp = 0; pp < PTW / 2; ++pp) {
            uint32_t xb[2];
            ldmatrix_trans<2>(xb, smem_addr(cX + (kk * 8 + (lane & 7)) * XS +
                                            (part * PTW + 2 * pp + ((lane >> 3) & 1)) * 8));
#pragma unroll
            for (int u = 0; u < 2; ++u)
              mma_tf32(y[2 * pp + u], a, tf32(dt01.x * __uint_as_float(bf16_lo(xb[u]))),
                       tf32(dt01.y * __uint_as_float(bf16_hi(xb[u]))));
          }
        }
      }

      // y += exp(cum) o (C h^T) on TF32 (chunk 0 has h = 0); with the same k
      // permutation a pair of C (bf16, so exact in TF32) and a pair of h are
      // one load each
      if (chunk > 0) {
        float inter[PTW][4];
#pragma unroll
        for (int j = 0; j < PTW; ++j) inter[j][0] = inter[j][1] = inter[j][2] = inter[j][3] = 0.f;
#pragma unroll 4
        for (int kk = 0; kk < NTN; ++kk) {
          const int n0 = kk * 8 + 2 * t4;
          const uint32_t c0 = *reinterpret_cast<const uint32_t*>(cC + i0 * BS + n0);
          const uint32_t c1 = *reinterpret_cast<const uint32_t*>(cC + i1 * BS + n0);
          const uint32_t a[4] = {bf16_lo(c0), bf16_lo(c1), bf16_hi(c0), bf16_hi(c1)};
#pragma unroll
          for (int pt = 0; pt < PTW; ++pt) {
            const float2 hv = *reinterpret_cast<const float2*>(sH + ((part * PTW + pt) * 8 + g) * HS + n0);
            mma_tf32(inter[pt], a, tf32(hv.x), tf32(hv.y));
          }
        }
        const float e0 = scan[Q + i0], e1 = scan[Q + i1];
#pragma unroll
        for (int pt = 0; pt < PTW; ++pt) {
          y[pt][0] += e0 * inter[pt][0];
          y[pt][1] += e0 * inter[pt][1];
          y[pt][2] += e1 * inter[pt][2];
          y[pt][3] += e1 * inter[pt][3];
        }
      }
#pragma unroll
      for (int pt = 0; pt < PTW; ++pt) {
        const int col = (part * PTW + pt) * 8 + 2 * t4;
        *reinterpret_cast<__nv_bfloat162*>(yg + (t0 + i0) * p.y_st + col) = __floats2bfloat162_rn(y[pt][0], y[pt][1]);
        *reinterpret_cast<__nv_bfloat162*>(yg + (t0 + i1) * p.y_st + col) = __floats2bfloat162_rn(y[pt][2], y[pt][3]);
      }
    }
    __syncthreads();  // every read of h for this chunk's y is done

    // h = exp(cum_last) h + (w o exp(cum_last - cum))^T B on TF32, A[p][j] =
    // w[j][p] exp(cum_last - cum_j), with the k permutation again: one
    // ldmatrix.trans of x gives the A pairs, one of B the B pairs of HW tiles
    {
      const float decay = scan[Q + Q - 1];
#pragma unroll
      for (int i = 0; i < HW; ++i) {
        hr[i][0] *= decay;
        hr[i][1] *= decay;
        hr[i][2] *= decay;
        hr[i][3] *= decay;
      }
      static_assert(HW == 1 || HW == 2 || HW % 4 == 0, "B pairs come in ldmatrix x1, x2 or x4");
#pragma unroll 2
      for (int kk = 0; kk < QT; ++kk) {
        const int j0 = kk * 8 + 2 * t4;
        const float2 dt01 = *reinterpret_cast<const float2*>(cDt + j0);
        const float2 in01 = *reinterpret_cast<const float2*>(scan + 2 * Q + j0);
        uint32_t xa[2];  // (x[j0][p], x[j0 + 1][p]) for p = row g and g + 8 of the band
        ldmatrix_trans<2>(xa, smem_addr(cX + (kk * 8 + (lane & 7)) * XS + hband * 16 + ((lane >> 3) & 1) * 8));
        const uint32_t a[4] = {
            tf32(dt01.x * __uint_as_float(bf16_lo(xa[0])) * in01.x),
            tf32(dt01.x * __uint_as_float(bf16_lo(xa[1])) * in01.x),
            tf32(dt01.y * __uint_as_float(bf16_hi(xa[0])) * in01.y),
            tf32(dt01.y * __uint_as_float(bf16_hi(xa[1])) * in01.y),
        };
#pragma unroll
        for (int i0 = 0; i0 < HW; i0 += (HW < 4 ? HW : 4)) {
          constexpr int NM = HW < 4 ? HW : 4;
          uint32_t bp[NM];  // (B[j0][n], B[j0 + 1][n]) for n = column g of tile i0 + m
          ldmatrix_trans<NM>(bp, smem_addr(cB + (kk * 8 + (lane & 7)) * BS + (hcol0 + i0 + ((lane >> 3) % NM)) * 8));
#pragma unroll
          for (int m = 0; m < NM; ++m) mma_tf32(hr[i0 + m], a, bf16_lo(bp[m]), bf16_hi(bp[m]));
        }
      }
      // the fp32 state, for the next chunk's C h^T
      const int pr0 = hband * 16 + g, pr1 = pr0 + 8;
#pragma unroll
      for (int i = 0; i < HW; ++i) {
        const int col = (hcol0 + i) * 8 + 2 * t4;
        *reinterpret_cast<float2*>(sH + pr0 * HS + col) = make_float2(hr[i][0], hr[i][1]);
        *reinterpret_cast<float2*>(sH + pr1 * HS + col) = make_float2(hr[i][2], hr[i][3]);
      }
    }
  }
}

// ---- launch ------------------------------------------------------------------

template <typename TX, typename TB, int P, int N, int Q>
cudaError_t launch_fma(const Params& p, int batch, cudaStream_t stream) {
  constexpr size_t smem = Layout<P, N, Q>::bytes;
  // once per kernel: the attribute stays set for later launches
  static const cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd_fma_kernel<TX, TB, P, N, Q>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ssd_fwd_fma_kernel<TX, TB, P, N, Q><<<batch * p.H, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int P, int N, int Q, int PS>
cudaError_t launch_mma(const Params& p, int batch, cudaStream_t stream) {
  constexpr size_t smem = MmaLayout<PS, N, Q>::bytes;
  // once per kernel: the attribute stays set for later launches
  static const cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd_mma_kernel<P, N, Q, PS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ssd_fwd_mma_kernel<P, N, Q, PS><<<batch * p.H * (P / PS), MmaWarps<PS, N>::THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// (P, N, Q): the rows of tests/test_kernels.py::SSD_CASES, mamba2-smoke,
// mamba2-780m and jamba-v0.1-52b.  Keep in step with ops.py::SHAPES.  bf16 x with bf16 B/C at
// the shapes whose P, N and Q are multiples of 16 takes the mma route.
template <typename TX, typename TB>
cudaError_t dispatch_fma(int P, int N, int Q, const Params& p, int batch, cudaStream_t st) {
#define SSD_CASE(PP, NN, QQ) \
  if (P == PP && N == NN && Q == QQ) return launch_fma<TX, TB, PP, NN, QQ>(p, batch, st);
  if constexpr (!(std::is_same<TX, __nv_bfloat16>::value && std::is_same<TB, __nv_bfloat16>::value)) {
    SSD_CASE(64, 128, 64)  // mamba2-780m
    SSD_CASE(64, 16, 64)   // jamba-v0.1-52b
    SSD_CASE(32, 16, 16)
    SSD_CASE(64, 128, 32)
  }
  SSD_CASE(32, 32, 8)    // mamba2-smoke
  SSD_CASE(16, 8, 8)
  SSD_CASE(8, 4, 16)
#undef SSD_CASE
  return cudaErrorInvalidValue;
}

// the SHAPES whose P, N and Q are multiples of 16, with their P slice
cudaError_t dispatch_mma(int P, int N, int Q, int ps, const Params& p, int batch, cudaStream_t st) {
#define SSD_CASE(PP, NN, QQ, SS) \
  if (P == PP && N == NN && Q == QQ && ps == SS) return launch_mma<PP, NN, QQ, SS>(p, batch, st);
  SSD_CASE(64, 128, 64, 32)  // mamba2-780m
  SSD_CASE(64, 16, 64, 32)   // jamba-v0.1-52b: 4 warps (MmaWarps<32, 16>), each a 16-row band
                             // of the chunk and one 16 x 8 tile of the 32 x 16 state slice
  SSD_CASE(32, 16, 16, 32)
  SSD_CASE(64, 128, 32, 32)
#undef SSD_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// x_dtype, bc_dtype: 0 float32, 1 bfloat16.  route: 0 fma (the cases the
// mma route does not take), 1 mma (x, B, C bfloat16; 16-byte aligned
// pointers and row strides),
// p_slice: the P columns one block of the mma route owns.  dt and A are
// float32.  Strides are in elements; the P axis of x and y and the N axis
// of B and C are contiguous.  Returns a cudaError_t (0 on success).
extern "C" int repro_ssd_fwd(
    const void* x, const void* dt, const void* A, const void* b, const void* c, void* y,
    int x_dtype, int bc_dtype, int route, int p_slice, int P, int N, int Q, int batch, int T, int H,
    long long x_sb, long long x_st, long long x_sh,
    long long dt_sb, long long dt_st, long long dt_sh, long long a_s,
    long long b_sb, long long b_st, long long c_sb, long long c_st,
    long long y_sb, long long y_st, long long y_sh, void* stream) {
  Params p{x, static_cast<const float*>(dt), static_cast<const float*>(A), b, c, y, T, H,
           x_sb, x_st, x_sh, dt_sb, dt_st, dt_sh, a_s, b_sb, b_st, c_sb, c_st,
           y_sb, y_st, y_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T % Q != 0) return cudaErrorInvalidValue;
  if (route == 1) {
    if (x_dtype != 1 || bc_dtype != 1) return cudaErrorInvalidValue;
    return dispatch_mma(P, N, Q, p_slice, p, batch, st);
  }
  if (route != 0) return cudaErrorInvalidValue;
  if (x_dtype == 0 && bc_dtype == 0) return dispatch_fma<float, float>(P, N, Q, p, batch, st);
  if (x_dtype == 0 && bc_dtype == 1) return dispatch_fma<float, __nv_bfloat16>(P, N, Q, p, batch, st);
  if (x_dtype == 1 && bc_dtype == 0) return dispatch_fma<__nv_bfloat16, float>(P, N, Q, p, batch, st);
  if (x_dtype == 1 && bc_dtype == 1) return dispatch_fma<__nv_bfloat16, __nv_bfloat16>(P, N, Q, p, batch, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* repro_ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
