// Mamba-2 SSD chunked scan for Hopper (sm_90a), CUDA cores, fp32 throughout.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd/kernel.py (_ssd_kernel,
// launched by ssd_fwd), and computes what repro/models/ssm.py::ssd_chunked
// computes: per (batch, head), over chunks of Q positions,
//   seg   = cumsum(dt * A)                               within the chunk
//   y_i   = sum_{j<=i} (C_i . B_j) exp(seg_i - seg_j) dt_j x_j
//         + exp(seg_i) C_i . state + D x_i
//   state = exp(seg_last) state + sum_j exp(seg_last - seg_j) dt_j x_j B_j^T
// It also returns the final state (the Pallas kernel returns only y; the
// model's prefill keeps the state as its decode cache) and starts from an
// optional initial state.
//
// What bounds it on the H100: at the Mamba2-1.3B prefill shape (x of
// (4, 2048, 64, 64) bf16, B and C of (4, 2048, 1, 128) bf16, dt fp32, chunk
// 256) the function reads x, dt, B, C once and writes y and the fp32 final
// state once: ~149 MB, ~44 us at 3.35 TB/s. Its operations, with C.B^T taken
// once per group and the causal triangle only, are ~26 GFLOP, ~26 us on the
// bf16 tensor cores: the card's bound is bytes. Computing C.B^T per head, as
// the Pallas kernel and this one do, makes it ~43 GFLOP (~44 us), level with
// the bytes. This kernel does its ~49 GFLOP of products (the diagonal tiles
// are computed whole) on the CUDA cores in fp32 (67 TFLOP/s peak), so its
// own floor is ~0.74 ms, over ten times the card's bound. Tensor cores
// (mma.sync / wgmma on bf16 tiles) and C.B^T shared across a group's heads
// are the next steps.
//
// Design: one block of 256 threads per (head, batch), which walks the
// chunks in order (the Pallas grid's sequential chunk axis) with the (N x P)
// fp32 state in shared memory. A chunk's (Q x Q) score tile does not fit an
// SM (256 KB at Q=256), so the chunk is cut into 64-row tiles: for each row
// tile, the inter-chunk term C_i . state, then for each column tile at or
// below it the 64x64 scores (C_i . B_j, the decay mask, dt_j) into shared
// memory and their product with x_j; tiles above the diagonal are skipped.
// Each thread owns a register patch of y (rows x 4 head dims) and 4x4 of the
// score tile. The state update follows the chunk's outputs. C and B tiles
// are kept transposed, (N x 64), so every inner loop reads 16-byte vectors.
// The chunk's cumsum is one warp's scan. B and C are read by group index
// (head h reads group h / (H/G)), not repeated per head. The ragged last
// chunk is masked in-kernel: positions past S load as zeros with dt = 0,
// which adds nothing to the state, and are not stored. Strides are taken
// for batch, sequence and head/group, so the model's views need no copy.
#include <math.h>

#include "common.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

constexpr int kThreads = 256;
constexpr int kT = 64;           // chunk positions per row / column tile
constexpr int kLd = kT + 4;      // row stride of the (N x kT) and score tiles

struct Strides {
  long long b, s, h;             // batch, sequence, head (or group)
};

// dst[n * kLd + i] = src[(s0 + r0 + i) * ss + n], zero past `rows`
template <typename T>
__device__ __forceinline__ void load_tile_nt(float* dst, const T* src, long long ss, int s0,
                                             int r0, int rows, int N) {
  for (int e = threadIdx.x; e < kT * N; e += kThreads) {
    const int i = e / N, n = e % N;
    const int r = r0 + i;
    dst[n * kLd + i] = r < rows ? to_f32(src[(long long)(s0 + r) * ss + n]) : 0.f;
  }
}

// dst[j * (P + 4) + p] = src[(s0 + r0 + j) * ss + p], zero past `rows`
template <typename T, int P>
__device__ __forceinline__ void load_tile_x(float* dst, const T* src, long long ss, int s0,
                                            int r0, int rows) {
  for (int e = threadIdx.x; e < kT * P; e += kThreads) {
    const int j = e / P, p = e % P;
    const int r = r0 + j;
    dst[j * (P + 4) + p] = r < rows ? to_f32(src[(long long)(s0 + r) * ss + p]) : 0.f;
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
           const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ D,
           const float* __restrict__ init_state, T* __restrict__ y,
           float* __restrict__ final_state, int S, int H, int G, int N, int Q,
           Strides xs, Strides dts, Strides bs, Strides cs) {
  constexpr int kLdx = P + 4;
  constexpr int PT = P / 4;              // threads along p, 4 head dims each
  constexpr int TM = kT * PT / kThreads; // rows of y per thread
  extern __shared__ __align__(16) float smem[];
  float* st = smem;                      // (N, P) state
  float* ct = st + N * P;                // (N, kLd) C of the row tile
  float* bt = ct + N * kLd;              // (N, kLd) B of the column tile
  float* xt = bt + N * kLd;              // (kT, kLdx) x of the column tile
  float* sc = xt + kT * kLdx;            // (kT, kLd) scores, [j][i]; update weights
  float* segs = sc + kT * kLd;           // (Q,) cumsum of dt * A
  float* dtc = segs + Q;                 // (Q,) dt

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const float a = A[h], dskip = D[h];
  const T* xb = x + b * xs.b + h * xs.h;
  const float* dtb = dt + b * dts.b + h * dts.h;
  const T* Bb = Bm + b * bs.b + g * bs.h;
  const T* Cb = Cm + b * cs.b + g * cs.h;
  T* yb = y + ((long long)b * S * H + h) * P;
  const long long y_ss = (long long)H * P;
  const long long state_off = ((long long)b * H + h) * P * N;

  const int tid = threadIdx.x;
  const int p0 = (tid % PT) * 4;         // y patch: rows r0.., dims p0..p0+3
  const int r0 = (tid / PT) * TM;
  const int si = (tid / 16) * 4;         // score patch: rows si.., cols sj..
  const int sj = (tid % 16) * 4;

  for (int e = tid; e < N * P; e += kThreads) {
    const int p = e / N, n = e % N;
    st[n * P + p] = init_state ? init_state[state_off + e] : 0.f;
  }

  const int nc = (S + Q - 1) / Q;
  for (int c = 0; c < nc; ++c) {
    const int s0 = c * Q;
    const int Qc = min(Q, S - s0);
    __syncthreads();  // the previous chunk's state update and seg readers are done
    for (int q = tid; q < Q; q += kThreads)
      dtc[q] = q < Qc ? dtb[(long long)(s0 + q) * dts.s] : 0.f;
    __syncthreads();
    if (tid < 32) {   // inclusive scan of dt * A: a run per lane, then shuffles
      const int per = (Q + 31) / 32;
      const int lo = min(tid * per, Q), hi = min(lo + per, Q);
      float run = 0.f;
      for (int q = lo; q < hi; ++q) {
        run += dtc[q] * a;
        segs[q] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += v;
      }
      const float excl = incl - run;
      for (int q = lo; q < hi; ++q) segs[q] += excl;
    }
    __syncthreads();
    const float total = segs[Qc - 1];
    const int nt = (Qc + kT - 1) / kT;

    for (int it = 0; it < nt; ++it) {
      const int i0 = it * kT;
      load_tile_nt(ct, Cb, cs.s, s0, i0, Qc, N);
      __syncthreads();
      // inter-chunk term: exp(seg_i) * C_i . state
      float acc[TM][4];
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[r][k] = 0.f;
      for (int n = 0; n < N; ++n) {
        const float4 sv = ld4(&st[n * P + p0]);
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          const float cv = ct[n * kLd + r0 + r];
          acc[r][0] = fmaf(cv, sv.x, acc[r][0]);
          acc[r][1] = fmaf(cv, sv.y, acc[r][1]);
          acc[r][2] = fmaf(cv, sv.z, acc[r][2]);
          acc[r][3] = fmaf(cv, sv.w, acc[r][3]);
        }
      }
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const int i = i0 + r0 + r;
        const float e = i < Qc ? expf(segs[i]) : 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[r][k] *= e;
      }

      // intra-chunk term over the column tiles at or below the diagonal
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kT;
        __syncthreads();  // the previous column tile's readers are done
        load_tile_nt(bt, Bb, bs.s, s0, j0, Qc, N);
        load_tile_x<T, P>(xt, xb, xs.s, s0, j0, Qc);
        __syncthreads();
        float s4[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k) s4[r][k] = 0.f;
        for (int n = 0; n < N; ++n) {
          const float4 cv = ld4(&ct[n * kLd + si]);
          const float4 bv = ld4(&bt[n * kLd + sj]);
          const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
          const float bc[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int k = 0; k < 4; ++k) s4[r][k] = fmaf(cr[r], bc[k], s4[r][k]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + si + r;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int j = j0 + sj + k;
            float v = 0.f;
            if (j <= i && i < Qc) v = s4[r][k] * expf(segs[i] - segs[j]) * dtc[j];
            sc[(sj + k) * kLd + si + r] = v;
          }
        }
        __syncthreads();
        for (int j = 0; j < kT; ++j) {
          const float4 xv = ld4(&xt[j * kLdx + p0]);
#pragma unroll
          for (int r = 0; r < TM; ++r) {
            const float sv = sc[j * kLd + r0 + r];
            acc[r][0] = fmaf(sv, xv.x, acc[r][0]);
            acc[r][1] = fmaf(sv, xv.y, acc[r][1]);
            acc[r][2] = fmaf(sv, xv.z, acc[r][2]);
            acc[r][3] = fmaf(sv, xv.w, acc[r][3]);
          }
        }
      }
      // xt holds the diagonal tile, rows i0..: add D x and store
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const int i = i0 + r0 + r;
        if (i < Qc) {
          const float4 xv = ld4(&xt[(r0 + r) * kLdx + p0]);
          T* yp = yb + (long long)(s0 + i) * y_ss + p0;
          yp[0] = from_f32<T>(fmaf(dskip, xv.x, acc[r][0]));
          yp[1] = from_f32<T>(fmaf(dskip, xv.y, acc[r][1]));
          yp[2] = from_f32<T>(fmaf(dskip, xv.z, acc[r][2]));
          yp[3] = from_f32<T>(fmaf(dskip, xv.w, acc[r][3]));
        }
      }
      __syncthreads();  // before the next row tile overwrites ct
    }

    // state = exp(total) state + sum_j exp(total - seg_j) dt_j x_j B_j^T
    const float decay = expf(total);
    for (int jt = 0; jt < nt; ++jt) {
      const int j0 = jt * kT;
      __syncthreads();
      load_tile_nt(bt, Bb, bs.s, s0, j0, Qc, N);
      load_tile_x<T, P>(xt, xb, xs.s, s0, j0, Qc);
      for (int j = tid; j < kT; j += kThreads) {
        const int q = j0 + j;
        sc[j] = q < Qc ? expf(total - segs[q]) * dtc[q] : 0.f;
      }
      __syncthreads();
      for (int e = tid; e < N * PT; e += kThreads) {
        const int n = e / PT, pp = (e % PT) * 4;
        float4 v = ld4(&st[n * P + pp]);
        if (jt == 0) {
          v.x *= decay; v.y *= decay; v.z *= decay; v.w *= decay;
        }
        for (int j = 0; j < kT; ++j) {
          const float wb = sc[j] * bt[n * kLd + j];
          const float4 xv = ld4(&xt[j * kLdx + pp]);
          v.x = fmaf(wb, xv.x, v.x);
          v.y = fmaf(wb, xv.y, v.y);
          v.z = fmaf(wb, xv.z, v.z);
          v.w = fmaf(wb, xv.w, v.w);
        }
        *reinterpret_cast<float4*>(&st[n * P + pp]) = v;
      }
    }
  }

  __syncthreads();
  for (int e = tid; e < N * P; e += kThreads) {
    const int p = e / N, n = e % N;
    final_state[state_off + e] = st[n * P + p];
  }
}

// repro_torch/kernels/ssd/ops.py::smem_bytes mirrors this layout
size_t smem_bytes(int P, int N, int Q) {
  return sizeof(float) * ((size_t)N * P + 2 * (size_t)N * kLd + (size_t)kT * (P + 4) +
                          (size_t)kT * kLd + 2 * (size_t)Q);
}

template <typename T, int P>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* B, const void* C,
                   const void* D, const void* init_state, void* y, void* final_state, int Bz,
                   int S, int H, int G, int N, int Q, const Strides* st, cudaStream_t stream) {
  const size_t smem = smem_bytes(P, N, Q);
  cudaError_t err = cudaFuncSetAttribute(ssd_kernel<T, P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(H, Bz);
  ssd_kernel<T, P><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(B), static_cast<const T*>(C), static_cast<const float*>(D),
      static_cast<const float*>(init_state), static_cast<T*>(y),
      static_cast<float*>(final_state), S, H, G, N, Q, st[0], st[1], st[2], st[3]);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_p(int P, const void* x, const void* dt, const void* A, const void* B,
                       const void* C, const void* D, const void* init_state, void* y,
                       void* final_state, int Bz, int S, int H, int G, int N, int Q,
                       const Strides* st, cudaStream_t stream) {
#define REPRO_SSD_P(PP)                                                                   \
  case PP:                                                                                \
    return launch<T, PP>(x, dt, A, B, C, D, init_state, y, final_state, Bz, S, H, G, N, Q, \
                         st, stream);
  switch (P) {
    REPRO_SSD_P(16)
    REPRO_SSD_P(32)
    REPRO_SSD_P(64)
    REPRO_SSD_P(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_SSD_P
}

}  // namespace

// x: (Bz, S, H, P) in `dtype`; dt: (Bz, S, H) fp32; A, D: (H,) fp32; B, C:
// (Bz, S, G, N) in `dtype`; each with unit stride on its last axis and the
// given (batch, seq, head/group) strides in elements. init_state: contiguous
// (Bz, H, P, N) fp32, or null for zeros. y: contiguous (Bz, S, H, P) in
// `dtype`; final_state: contiguous (Bz, H, P, N) fp32. Returns the CUDA error
// of the launch (0 on success).
extern "C" int ssd_fwd(const void* x, const void* dt, const void* A, const void* B,
                       const void* C, const void* D, const void* init_state, void* y,
                       void* final_state, int dtype, int Bz, int S, int H, int G, int P, int N,
                       int Q, long long x_sb, long long x_ss, long long x_sh, long long dt_sb,
                       long long dt_ss, long long dt_sh, long long b_sb, long long b_ss,
                       long long b_sg, long long c_sb, long long c_ss, long long c_sg,
                       void* stream) {
  if (G <= 0 || H % G != 0 || Q <= 0 || S <= 0) return cudaErrorInvalidValue;
  const Strides st[4] = {{x_sb, x_ss, x_sh}, {dt_sb, dt_ss, dt_sh}, {b_sb, b_ss, b_sg},
                         {c_sb, c_ss, c_sg}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kFloat32:
      return dispatch_p<float>(P, x, dt, A, B, C, D, init_state, y, final_state, Bz, S, H, G,
                               N, Q, st, s);
    case repro::kBFloat16:
      return dispatch_p<__nv_bfloat16>(P, x, dt, A, B, C, D, init_state, y, final_state, Bz,
                                       S, H, G, N, Q, st, s);
    default:
      return cudaErrorInvalidValue;
  }
}
