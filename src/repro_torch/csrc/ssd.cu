// Mamba-2 SSD chunked scan for Hopper (sm_90a).
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
// optional initial state. B and C are read by group index (head h reads
// group h / (H/G)), not repeated per head. The ragged last chunk is masked
// in-kernel: positions past S load as zeros with dt = 0, which adds nothing
// to the state, and are not stored. Strides are taken for batch, sequence
// and head/group, so the model's views need no copy.
//
// What bounds it on the H100: at the Mamba2-1.3B prefill shape (x of
// (4, 2048, 64, 64) bf16, B and C of (4, 2048, 1, 128) bf16, dt fp32, chunk
// 256) the function reads x, dt, B, C once and writes y and the fp32 final
// state once: ~149 MB, ~44 us at 3.35 TB/s. Its operations, with C.B^T taken
// once per group and the causal triangle only, are ~26 GFLOP, ~26 us on the
// bf16 tensor cores: the card's bound is bytes. Computed per head, as this
// kernel does, with the diagonal 16x16 tiles whole, the products are ~45
// GFLOP, ~45 us on the tensor cores at their peak.
//
// Two variants, chosen by the wrapper from dtype, shape and alignment before
// the launch (kernels/ssd/ops.py:_ssd_variant):
//
// "tc", bf16 x, B, C with 16-byte-aligned rows, N in {16, 32, 64, 128}: all
// four products on the tensor cores (mma.sync.m16n8k16, bf16 in, fp32
// accumulators), as in the flash kernel. One block of 8 warps per (head,
// batch) walks the chunks in order, so the chunk states never touch device
// memory: its bytes are the function's own. A chunk is cut into row tiles
// of 128 rows (16 per warp) and column tiles of 64 positions. For a row
// tile, each warp starts its y accumulators at exp(seg_i) C_i . state (the
// state from a bf16 copy in shared memory), then walks the column tiles up
// to its diagonal: the 16x16 score tiles C_i . B_j^T of a whole column tile
// at once (eight independent accumulator chains per k step), the decay and
// dt_j applied in fp32 registers as a row factor times a column factor
// (see intra), rounded to bf16 straight into the A fragments of the product
// with x_j. The fp32 state lives in the accumulators of the update product
// (x (.) w)^T . B, spread over the warps, one row group of it a warp: during
// the chunk's last row tile, which walks every column tile, each tile adds
// its share, with x (.) w read transposed by ldmatrix.trans and rounded to
// bf16. The state that is carried and written out is always the fp32 one;
// only C.state reads the bf16 copy. The cumsum (a block-wide scan), the
// exponents (ex2 on seg * log2 e), the mask, the decays and every sum stay
// fp32. x, B and C tiles arrive by 16-byte cp.async into XOR-swizzled shared
// memory (conflict-free ldmatrix), double buffered: the next step's tiles
// (and at a chunk's first step its dt, by 4-byte cp.async) are in flight
// while this step computes. y leaves through shared memory as 16-byte
// stores of whole rows. What holds it at ~7x its bound: one block of 8
// warps fits an SM (152 KB of shared memory, ~250 registers a thread), so
// the 256 (head, batch) blocks of the prefill run in two waves and each
// SM's tensor pipes wait on the latency of a warp's dependent ldmatrix ->
// mma -> decay -> mma chain with little else to switch to; each warp re-reads
// the B and x fragments of a tile from shared memory for its 16 rows alone;
// and every head re-reads its group's B and C tiles through L2 (about 425
// MB of L2 -> SM traffic at the prefill shape). A wgmma version of the
// three large products (a warpgroup per 64 rows, operands read from shared
// memory once per warpgroup) was built and was only a few percent faster:
// what remains is the loads, the barriers and the dependent chain around
// the products, so the next step is to overlap them (TMA loads, a deeper
// ring, warps specialised to load, multiply and decay).
//
// "simt", fp32 (which keeps its 5e-5 bound) and inputs the 16-byte copies
// cannot address: CUDA-core FMAs in fp32. One block of 256 threads per
// (head, batch) walks the chunks with the (N x P) fp32 state in shared
// memory; a chunk is cut into 64-row tiles: for each row tile, the
// inter-chunk term C_i . state, then for each column tile at or below it the
// 64x64 scores into shared memory and their product with x_j. Each thread
// owns a register patch of y (rows x 4 head dims) and 4x4 of the score tile;
// C and B tiles are kept transposed, (N x 64), so inner loops read 16-byte
// vectors. The chunk's cumsum is one warp's scan. Its ~49 GFLOP of fp32
// FMAs (67 TFLOP/s peak) floor it at ~0.74 ms at the prefill shape.
#include <math.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

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
size_t simt_smem_bytes(int P, int N, int Q) {
  return sizeof(float) * ((size_t)N * P + 2 * (size_t)N * kLd + (size_t)kT * (P + 4) +
                          (size_t)kT * kLd + 2 * (size_t)Q);
}

template <typename T, int P>
cudaError_t launch_simt(const void* x, const void* dt, const void* A, const void* B, const void* C,
                   const void* D, const void* init_state, void* y, void* final_state, int Bz,
                   int S, int H, int G, int N, int Q, const Strides* st, cudaStream_t stream) {
  const size_t smem = simt_smem_bytes(P, N, Q);
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

// -------------------------------------------------------------- tc variant
namespace tc {

using bf16 = __nv_bfloat16;
using repro::cp_async16;
using repro::cp_async4;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::ex2;
using repro::ldsm_x4;
using repro::ldsm_x4_trans;
using repro::mma16816;
using repro::mma16816_zero;
using repro::pack_bf16;
using repro::swz;
using repro::unpack_bf16;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;   // chunk rows per row tile, 16 per warp
constexpr int kCols = 64;            // chunk positions per column tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr size_t kMaxSmem = 232448;  // an H100 block's dynamic shared memory

// Shared memory of one block: C row tiles x 2, B and x column tiles x 2,
// the bf16 state copy (P x N), the warps' y staging (kRows x P bf16), per
// chunk position (Q rounded up to whole column tiles) the dt buffers x 2,
// seg * log2 e, the update weights and the scores' column factors, and the
// scan's warp totals (repro_torch/kernels/ssd/ops.py::smem_bytes mirrors
// this).
inline size_t smem_bytes(int P, int N, int Q) {
  const size_t Qt = (size_t)(Q + kCols - 1) / kCols * kCols;
  return 4 * (size_t)kRows * N + 4 * (size_t)kCols * N + 4 * (size_t)kCols * P +
         2 * (size_t)P * N + 2 * (size_t)kRows * P + 20 * Qt + 4 * kWarps;
}

// One step of a block's walk: chunk c, row tile s of the chunk, column tile
// jt. Each row tile walks the column tiles that reach its last row; the
// chunk's last row tile walks them all.
struct Step {
  int c, s, jt;
};

__device__ __forceinline__ bool next_step(Step& st, int S, int Q) {
  const int Qc = min(Q, S - st.c * Q);
  const int rows_end = min(Qc, (st.s + 1) * kRows);
  if ((st.jt + 1) * kCols < rows_end) {
    ++st.jt;
    return true;
  }
  if ((st.s + 1) * kRows < Qc) {
    ++st.s;
    st.jt = 0;
    return true;
  }
  if ((st.c + 1) * Q < S) {
    ++st.c;
    st.s = st.jt = 0;
    return true;
  }
  return false;
}

// The intra-chunk term of one column tile for a warp's 16 rows (C rows at
// cr0 of the C tile ct): the scores C_i . B_j^T of the tile's 16-column
// groups g0 .. g0 + NG - 1, all NG at once so that each k step feeds 2 NG
// independent products; then (C_i . B_j) exp(seg_i - seg_j) dt_j, rounded
// to bf16 as the A fragments of the product with x_j. Below the diagonal exp(seg_i - seg_j) dt_j = rowf_i colf_j with
// the group's last position c as pivot: rowf_i = 2^(seg2_i - seg2_c), two
// ex2 a group per thread, and colf_j = 2^(seg2_c - seg2_j) dt_j, per chunk
// in shared memory; seg falls along the chunk, so neither factor exceeds 1
// (or dt_j). With `diag` the last group holds the warp's own rows: there the
// mask j <= i applies and each factor is taken whole.
template <int P, int N, int NG>
__device__ __forceinline__ void intra(float (&acc)[P / 8][4], uint32_t ct, int cr0, uint32_t bt,
                                      uint32_t xt, int g0, const float* seg2,
                                      const float* colf, const float* dtc, float sg0, float sg1,
                                      int i0, int j0, int Qc, bool diag, int lane) {
  constexpr int KN = N / 16, KP = P / 16;
  const int t4 = lane % 4, i1 = i0 + 8;
  float sc[2 * NG][4];
#pragma unroll
  for (int kk = 0; kk < KN; ++kk) {
    uint32_t a[4];
    ldsm_x4(ct + swz<N>(cr0 + (lane % 8) + ((lane / 8) % 2) * 8, 2 * kk + lane / 16), a);
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      uint32_t f[4];
      ldsm_x4(bt + swz<N>(16 * (g0 + g) + (lane % 8) + (lane / 16) * 8, 2 * kk + (lane / 8) % 2),
              f);
      if (kk == 0) {
        mma16816_zero(sc[2 * g], a, f[0], f[1]);
        mma16816_zero(sc[2 * g + 1], a, f[2], f[3]);
      } else {
        mma16816(sc[2 * g], a, f[0], f[1]);
        mma16816(sc[2 * g + 1], a, f[2], f[3]);
      }
    }
  }
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    if (diag && g == NG - 1) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j0 + 16 * (g0 + g) + 8 * nt + 2 * t4 + (e & 1);
          const int i = e < 2 ? i0 : i1;
          const int jc = min(j, Qc - 1);
          sc[2 * g + nt][e] = j <= i ? sc[2 * g + nt][e] *
                                           ex2((e < 2 ? sg0 : sg1) - seg2[jc]) * dtc[jc]
                                     : 0.f;
        }
      }
    } else {
      const float pivot = seg2[min(j0 + 16 * (g0 + g) + 15, Qc - 1)];
      const float r0f = ex2(sg0 - pivot), r1f = ex2(sg1 - pivot);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float2 cf =
            *reinterpret_cast<const float2*>(colf + j0 + 16 * (g0 + g) + 8 * nt + 2 * t4);
        float(&v)[4] = sc[2 * g + nt];
        v[0] *= r0f * cf.x;
        v[1] *= r0f * cf.y;
        v[2] *= r1f * cf.x;
        v[3] *= r1f * cf.y;
      }
    }
    const uint32_t pa[4] = {pack_bf16(sc[2 * g][0], sc[2 * g][1]),
                            pack_bf16(sc[2 * g][2], sc[2 * g][3]),
                            pack_bf16(sc[2 * g + 1][0], sc[2 * g + 1][1]),
                            pack_bf16(sc[2 * g + 1][2], sc[2 * g + 1][3])};
#pragma unroll
    for (int dd = 0; dd < KP; ++dd) {
      uint32_t vf[4];
      ldsm_x4_trans(
          xt + swz<P>(16 * (g0 + g) + (lane % 8) + ((lane / 8) % 2) * 8, 2 * dd + lane / 16), vf);
      mma16816(acc[2 * dd], pa, vf[0], vf[1]);
      mma16816(acc[2 * dd + 1], pa, vf[2], vf[3]);
    }
  }
}

template <int P, int N>
__global__ void __launch_bounds__(kThreads, 1)
ssd_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ A, const bf16* __restrict__ Bm,
              const bf16* __restrict__ Cm, const float* __restrict__ D,
              const float* __restrict__ init_state, bf16* __restrict__ y,
              float* __restrict__ final_state, int S, int H, int G, int Q, Strides xs,
              Strides dts, Strides bs, Strides cs) {
  constexpr int KN = N / 16, KP = P / 16;
  constexpr int U = KP * KN;                      // 16x16 units of the state
  constexpr int UPW = (U + kWarps - 1) / kWarps;  // units per warp
  // a warp's units lie in one row group of the state, columns ng0 ..
  static_assert(KN % UPW == 0, "a warp's state units share one row group");
  constexpr uint32_t kCTile = kRows * N * 2, kBTile = kCols * N * 2, kXTile = kCols * P * 2;
  extern __shared__ __align__(128) uint8_t smem[];
  const int Qt = (Q + kCols - 1) / kCols * kCols;
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t c_sm = sbase, b_sm = c_sm + 2 * kCTile, x_sm = b_sm + 2 * kBTile,
                 st_sm = x_sm + 2 * kXTile, y_sm = st_sm + 2 * P * N;
  float* dtbuf = reinterpret_cast<float*>(smem + (y_sm - sbase) + 2 * kRows * P);
  float* seg2 = dtbuf + 2 * Qt;   // seg * log2 e of the chunk
  float* wgt = seg2 + Qt;         // exp(seg_last - seg_j) dt_j, the update's weights
  float* colf = wgt + Qt;         // the scores' column factors (see intra)
  float* wsum = colf + Qt;        // the scan's warp totals

  const int h = blockIdx.x, b = blockIdx.y, g = h / (H / G);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, t4 = lane % 4;   // fragment row group and column pair
  const float a = A[h], dskip = D[h];
  const bf16* xb = x + b * xs.b + h * xs.h;
  const float* dtb = dt + b * dts.b + h * dts.h;
  const bf16* Bb = Bm + b * bs.b + g * bs.h;
  const bf16* Cb = Cm + b * cs.b + g * cs.h;
  bf16* yb = y + ((long long)b * S * H + h) * P;
  const long long y_ss = (long long)H * P;
  const long long state_off = ((long long)b * H + h) * P * N;

  // the copies of step st: its column tile of B and x into ring slot `slot`;
  // at a row tile's first step its C rows into C slot `cslot`; at a chunk's
  // first step its dt into dt slot c % 2. Rows past the chunk are zeros.
  auto issue = [&](const Step& st, int slot, int cslot) {
    const int s0 = st.c * Q, Qc = min(Q, S - s0);
    if (st.s == 0 && st.jt == 0) {
      float* dst = dtbuf + (st.c & 1) * Qt;
      for (int q = tid; q < Q; q += kThreads)
        cp_async4(static_cast<uint32_t>(__cvta_generic_to_shared(dst + q)),
                  dtb + (long long)(s0 + min(q, Qc - 1)) * dts.s, q < Qc);
    }
    if (st.jt == 0) {
      const int r0 = st.s * kRows;
      for (int i = tid; i < kRows * (N / 8); i += kThreads) {
        const int r = i / (N / 8), c = i % (N / 8), q = r0 + r;
        const bool ok = q < Qc;
        cp_async16(c_sm + cslot * kCTile + swz<N>(r, c),
                   Cb + (long long)(s0 + (ok ? q : 0)) * cs.s + c * 8, ok);
      }
    }
    const int j0 = st.jt * kCols;
    for (int i = tid; i < kCols * (N / 8); i += kThreads) {
      const int r = i / (N / 8), c = i % (N / 8), q = j0 + r;
      const bool ok = q < Qc;
      cp_async16(b_sm + slot * kBTile + swz<N>(r, c),
                 Bb + (long long)(s0 + (ok ? q : 0)) * bs.s + c * 8, ok);
    }
    for (int i = tid; i < kCols * (P / 8); i += kThreads) {
      const int r = i / (P / 8), c = i % (P / 8), q = j0 + r;
      const bool ok = q < Qc;
      cp_async16(x_sm + slot * kXTile + swz<P>(r, c),
                 xb + (long long)(s0 + (ok ? q : 0)) * xs.s + c * 8, ok);
    }
  };

  // The fp32 state: this warp's units u = warp * UPW + k, unit u covering
  // rows p in [16 mg, +16) and columns n in [16 (ng0 + k), +16) in the
  // accumulator layout of two n8 tiles. Warps past U / UPW hold none.
  const bool owns = warp * UPW < U;
  const int mg = warp * UPW / KN, ng0 = warp * UPW % KN;
  float st[UPW][2][4];
#pragma unroll
  for (int k = 0; k < UPW; ++k) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int p = 16 * mg + gr, n = 16 * (ng0 + k) + 8 * nt + 2 * t4;
      float2 lo = make_float2(0.f, 0.f), hi = lo;
      if (init_state && owns) {
        lo = *reinterpret_cast<const float2*>(init_state + state_off + (long long)p * N + n);
        hi = *reinterpret_cast<const float2*>(init_state + state_off +
                                              (long long)(p + 8) * N + n);
      }
      st[k][nt][0] = lo.x;
      st[k][nt][1] = lo.y;
      st[k][nt][2] = hi.x;
      st[k][nt][3] = hi.y;
    }
  }

  float acc[P / 8][4];    // y of this warp's 16 rows, n8 tiles of P
  Step cur = {0, 0, 0};
  int slot = 0, cslot = 0;
  issue(cur, 0, 0);
  cp_async_commit();
  for (;;) {
    Step nxt = cur;
    const bool more = next_step(nxt, S, Q);
    const int nslot = slot ^ 1, ncslot = nxt.jt == 0 ? cslot ^ 1 : cslot;
    if (more) {
      issue(nxt, nslot, ncslot);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // step cur's copies have landed, for every thread

    const int s0 = cur.c * Q, Qc = min(Q, S - s0);
    const float* dtc = dtbuf + (cur.c & 1) * Qt;
    if (cur.s == 0 && cur.jt == 0) {
      // A new chunk. The bf16 copy of the state it starts from, for C.state
      // (every reader of the previous copy passed the barrier above).
      if (owns) {
#pragma unroll
        for (int k = 0; k < UPW; ++k) {
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int p = 16 * mg + gr, c = 2 * (ng0 + k) + nt;
            *reinterpret_cast<uint32_t*>(smem + (st_sm - sbase) + swz<N>(p, c) + 4 * t4) =
                pack_bf16(st[k][nt][0], st[k][nt][1]);
            *reinterpret_cast<uint32_t*>(smem + (st_sm - sbase) + swz<N>(p + 8, c) + 4 * t4) =
                pack_bf16(st[k][nt][2], st[k][nt][3]);
          }
        }
      }
      // the chunk's cumsum of dt * A: a run of positions per thread, then a
      // scan of the runs over the block
      const int per = (Qc + kThreads - 1) / kThreads;
      const int lo = min(tid * per, Qc), hi = min(lo + per, Qc);
      float run = 0.f;
      for (int q = lo; q < hi; ++q) run += dtc[q] * a;
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      if (lane == 31) wsum[warp] = incl;
      __syncthreads();
      float pre = incl - run;
      for (int w = 0; w < warp; ++w) pre += wsum[w];
      for (int q = lo; q < hi; ++q) {
        pre += dtc[q] * a;
        seg2[q] = pre * kLog2e;
      }
      __syncthreads();
      const float last = seg2[Qc - 1];
      for (int q = tid; q < Qt; q += kThreads) {
        const bool in = q < Qc;
        wgt[q] = in ? ex2(last - seg2[q]) * dtc[q] : 0.f;
        colf[q] = in ? ex2(seg2[min(q | 15, Qc - 1)] - seg2[q]) * dtc[q] : 0.f;
      }
      __syncthreads();
      // the state's decay over the chunk, before the update adds to it
      const float decay = ex2(seg2[Qc - 1]);
#pragma unroll
      for (int k = 0; k < UPW; ++k)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[k][nt][e] *= decay;
    }

    const uint32_t bt = b_sm + slot * kBTile, xt = x_sm + slot * kXTile;
    const int r0 = cur.s * kRows + warp * 16;   // this warp's first row in the chunk
    const int j0 = cur.jt * kCols;
    const int i0 = r0 + gr, i1 = i0 + 8;
    if (r0 < Qc) {
      const float sg0 = seg2[min(i0, Qc - 1)], sg1 = seg2[min(i1, Qc - 1)];
      const uint32_t ct = c_sm + cslot * kCTile;
      if (cur.jt == 0) {
        // the inter-chunk term exp(seg_i) C_i . state
#pragma unroll
        for (int kk = 0; kk < KN; ++kk) {
          uint32_t a[4];
          ldsm_x4(ct + swz<N>(warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8, 2 * kk + lane / 16),
                  a);
#pragma unroll
          for (int jp = 0; jp < KP; ++jp) {
            uint32_t f[4];
            ldsm_x4(st_sm + swz<N>(16 * jp + (lane % 8) + (lane / 16) * 8, 2 * kk + (lane / 8) % 2),
                    f);
            if (kk == 0) {
              mma16816_zero(acc[2 * jp], a, f[0], f[1]);
              mma16816_zero(acc[2 * jp + 1], a, f[2], f[3]);
            } else {
              mma16816(acc[2 * jp], a, f[0], f[1]);
              mma16816(acc[2 * jp + 1], a, f[2], f[3]);
            }
          }
        }
        const float e0 = ex2(sg0), e1 = ex2(sg1);
#pragma unroll
        for (int n = 0; n < P / 8; ++n) {
          acc[n][0] *= e0;
          acc[n][1] *= e0;
          acc[n][2] *= e1;
          acc[n][3] *= e1;
        }
      }

      // the intra-chunk term over this column tile's 16-column groups at or
      // below the warp's last row: a whole tile in one pass, the rest of the
      // diagonal tile's groups in passes of two and one
      const bool diag = cur.jt == r0 / kCols;
      const int ncg = max(0, min(kCols / 16, (min(r0 + 16, Qc) - j0 + 15) / 16));
      for (int g0 = 0; g0 < ncg;) {
        if (ncg - g0 >= 4) {
          intra<P, N, 4>(acc, ct, warp * 16, bt, xt, g0, seg2, colf, dtc, sg0, sg1, i0, j0, Qc,
                         diag && g0 + 4 == ncg, lane);
          g0 += 4;
        } else if (ncg - g0 >= 2) {
          intra<P, N, 2>(acc, ct, warp * 16, bt, xt, g0, seg2, colf, dtc, sg0, sg1, i0, j0, Qc,
                         diag && g0 + 2 == ncg, lane);
          g0 += 2;
        } else {
          intra<P, N, 1>(acc, ct, warp * 16, bt, xt, g0, seg2, colf, dtc, sg0, sg1, i0, j0, Qc,
                         diag && g0 + 1 == ncg, lane);
          ++g0;
        }
      }

      if (diag) {   // the tile that holds the warp's rows: D x_i
        const int lr = r0 - j0 + gr;
#pragma unroll
        for (int n = 0; n < P / 8; ++n) {
          const float2 xa = unpack_bf16(*reinterpret_cast<const uint32_t*>(
              smem + (xt - sbase) + swz<P>(lr, n) + 4 * t4));
          const float2 xc = unpack_bf16(*reinterpret_cast<const uint32_t*>(
              smem + (xt - sbase) + swz<P>(lr + 8, n) + 4 * t4));
          acc[n][0] = fmaf(dskip, xa.x, acc[n][0]);
          acc[n][1] = fmaf(dskip, xa.y, acc[n][1]);
          acc[n][2] = fmaf(dskip, xc.x, acc[n][2]);
          acc[n][3] = fmaf(dskip, xc.y, acc[n][3]);
        }
      }

      if ((cur.jt + 1) * kCols >= min(Qc, (cur.s + 1) * kRows)) {
        // the row tile's last step: y through this warp's staging rows, out
        // as 16-byte stores of whole rows
        uint8_t* ys = smem + (y_sm - sbase) + warp * 16 * P * 2;
#pragma unroll
        for (int n = 0; n < P / 8; ++n) {
          *reinterpret_cast<uint32_t*>(ys + swz<P>(gr, n) + 4 * t4) =
              pack_bf16(acc[n][0], acc[n][1]);
          *reinterpret_cast<uint32_t*>(ys + swz<P>(gr + 8, n) + 4 * t4) =
              pack_bf16(acc[n][2], acc[n][3]);
        }
        __syncwarp();
#pragma unroll
        for (int i = lane; i < 16 * (P / 8); i += 32) {
          const int r = i / (P / 8), c = i % (P / 8);
          if (r0 + r < Qc)
            *reinterpret_cast<uint4*>(yb + (long long)(s0 + r0 + r) * y_ss + 8 * c) =
                *reinterpret_cast<const uint4*>(ys + swz<P>(r, c));
        }
        __syncwarp();
      }
    }

    if ((cur.s + 1) * kRows >= Qc && owns) {
      // the chunk's last row tile walks every column tile: the state update
      // state += (x (.) w)^T . B over this tile's positions
#pragma unroll
      for (int kc = 0; kc < kCols / 16; ++kc) {
        const int jb = j0 + 16 * kc;
        if (jb < Qc) {
          const float2 wlo = *reinterpret_cast<const float2*>(wgt + jb + 2 * t4);
          const float2 whi = *reinterpret_cast<const float2*>(wgt + jb + 8 + 2 * t4);
          // (x (.) w)^T: rows p, columns j, rounded to bf16; registers 0, 1
          // hold positions 2t, 2t+1 and 2, 3 positions 2t+8, 2t+9
          uint32_t af[4];
          ldsm_x4_trans(xt + swz<P>(16 * kc + (lane % 8) + (lane / 16) * 8, 2 * mg + (lane / 8) % 2),
                        af);
          float2 v = unpack_bf16(af[0]);
          af[0] = pack_bf16(v.x * wlo.x, v.y * wlo.y);
          v = unpack_bf16(af[1]);
          af[1] = pack_bf16(v.x * wlo.x, v.y * wlo.y);
          v = unpack_bf16(af[2]);
          af[2] = pack_bf16(v.x * whi.x, v.y * whi.y);
          v = unpack_bf16(af[3]);
          af[3] = pack_bf16(v.x * whi.x, v.y * whi.y);
#pragma unroll
          for (int k = 0; k < UPW; ++k) {
            uint32_t f[4];
            ldsm_x4_trans(
                bt + swz<N>(16 * kc + (lane % 8) + ((lane / 8) % 2) * 8, 2 * (ng0 + k) + lane / 16),
                f);
            mma16816(st[k][0], af, f[0], f[1]);
            mma16816(st[k][1], af, f[2], f[3]);
          }
        }
      }
    }

    if (!more) break;
    __syncthreads();   // every warp is done with this step's slots before they are refilled
    cur = nxt;
    slot = nslot;
    cslot = ncslot;
  }

#pragma unroll
  for (int k = 0; k < UPW; ++k) {
    if (owns) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int p = 16 * mg + gr, n = 16 * (ng0 + k) + 8 * nt + 2 * t4;
        *reinterpret_cast<float2*>(final_state + state_off + (long long)p * N + n) =
            make_float2(st[k][nt][0], st[k][nt][1]);
        *reinterpret_cast<float2*>(final_state + state_off + (long long)(p + 8) * N + n) =
            make_float2(st[k][nt][2], st[k][nt][3]);
      }
    }
  }
}

template <int P, int N>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* B, const void* C,
                   const void* D, const void* init_state, void* y, void* final_state, int Bz,
                   int S, int H, int G, int Q, const Strides* st, cudaStream_t stream) {
  const size_t smem = smem_bytes(P, N, Q);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  // the shared-memory limit is raised once per device
  static bool attr[repro::kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = repro::current_device(&dev);
  if (err != cudaSuccess) return err;
  if (!attr[dev]) {
    err = cudaFuncSetAttribute(ssd_tc_kernel<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kMaxSmem);
    if (err != cudaSuccess) return err;
    attr[dev] = true;
  }
  ssd_tc_kernel<P, N><<<dim3(H, Bz), kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const bf16*>(B), static_cast<const bf16*>(C), static_cast<const float*>(D),
      static_cast<const float*>(init_state), static_cast<bf16*>(y),
      static_cast<float*>(final_state), S, H, G, Q, st[0], st[1], st[2], st[3]);
  return cudaGetLastError();
}

template <int P>
cudaError_t dispatch_n(int N, const void* x, const void* dt, const void* A, const void* B,
                       const void* C, const void* D, const void* init_state, void* y,
                       void* final_state, int Bz, int S, int H, int G, int Q,
                       const Strides* st, cudaStream_t stream) {
#define REPRO_SSD_TC_N(NN)                                                                \
  case NN:                                                                                \
    return launch<P, NN>(x, dt, A, B, C, D, init_state, y, final_state, Bz, S, H, G, Q, st, \
                         stream);
  switch (N) {
    REPRO_SSD_TC_N(16)
    REPRO_SSD_TC_N(32)
    REPRO_SSD_TC_N(64)
    REPRO_SSD_TC_N(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_SSD_TC_N
}

}  // namespace tc

// variant 0: the CUDA-core kernel for T; variant 1: the tensor-core kernel (bf16)
template <typename T>
cudaError_t dispatch_p(int variant, int P, const void* x, const void* dt, const void* A,
                       const void* B, const void* C, const void* D, const void* init_state,
                       void* y, void* final_state, int Bz, int S, int H, int G, int N, int Q,
                       const Strides* st, cudaStream_t stream) {
#define REPRO_SSD_P(PP)                                                                     \
  case PP:                                                                                  \
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {                                  \
      if (variant == 1)                                                                     \
        return tc::dispatch_n<PP>(N, x, dt, A, B, C, D, init_state, y, final_state, Bz, S, \
                                  H, G, Q, st, stream);                                     \
    }                                                                                       \
    return launch_simt<T, PP>(x, dt, A, B, C, D, init_state, y, final_state, Bz, S, H, G, \
                              N, Q, st, stream);
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
// `dtype`; final_state: contiguous (Bz, H, P, N) fp32. variant 0 runs the
// CUDA-core kernel (float32 or bfloat16); variant 1 the tensor-core kernel,
// which takes bfloat16 with N in {16, 32, 64, 128}, x, B and C strides that
// are multiples of 8 and 16-byte-aligned pointers, and refuses anything else
// (the caller chooses; nothing falls back). Returns the CUDA error of the
// launch (0 on success).
extern "C" int ssd_fwd(const void* x, const void* dt, const void* A, const void* B,
                       const void* C, const void* D, const void* init_state, void* y,
                       void* final_state, int dtype, int variant, int Bz, int S, int H, int G,
                       int P, int N, int Q, long long x_sb, long long x_ss, long long x_sh,
                       long long dt_sb, long long dt_ss, long long dt_sh, long long b_sb,
                       long long b_ss, long long b_sg, long long c_sb, long long c_ss,
                       long long c_sg, void* stream) {
  if (G <= 0 || H % G != 0 || Q <= 0 || S <= 0 || (variant != 0 && variant != 1))
    return cudaErrorInvalidValue;
  const Strides st[4] = {{x_sb, x_ss, x_sh}, {dt_sb, dt_ss, dt_sh}, {b_sb, b_ss, b_sg},
                         {c_sb, c_ss, c_sg}};
  if (variant == 1) {
    bool ok = dtype == repro::kBFloat16 && N % 16 == 0;
    for (int i : {0, 2, 3}) ok = ok && st[i].b % 8 == 0 && st[i].s % 8 == 0 && st[i].h % 8 == 0;
    for (const void* p : {x, B, C, static_cast<const void*>(y)})
      ok = ok && reinterpret_cast<uintptr_t>(p) % 16 == 0;
    if (!ok) return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kFloat32:
      if (variant == 1) return cudaErrorInvalidValue;
      return dispatch_p<float>(variant, P, x, dt, A, B, C, D, init_state, y, final_state, Bz,
                               S, H, G, N, Q, st, s);
    case repro::kBFloat16:
      return dispatch_p<__nv_bfloat16>(variant, P, x, dt, A, B, C, D, init_state, y,
                                       final_state, Bz, S, H, G, N, Q, st, s);
    default:
      return cudaErrorInvalidValue;
  }
}
