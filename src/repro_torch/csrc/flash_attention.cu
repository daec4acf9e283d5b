// Flash-attention forward for Hopper (sm_90a), fp32 online softmax.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention/kernel.py
// (_fwd_kernel, launched by flash_attention_fwd). It computes the same
// function: out = softmax(mask(softcap(scale*q.k^T))) v per (batch, head),
// with causal and sliding-window masks from absolute positions, GQA by
// head index (kv head = h / (Hq/Hkv)), and an online softmax whose running
// max, sum and accumulator stay in fp32 registers.
//
// What bounds it on the H100: at the Mirage agent's shape (S=144, D=32,
// 640 sequences x 8 heads) q, k, v and o move ~189 MB once, ~56 us at
// 3.35 TB/s, while the ~14 GFLOP of q.k^T and p.v take ~14 us on the bf16
// tensor cores: the bound is bytes, at ~72 FLOP/byte, a quarter of the card's balance point. So the
// design moves each byte once, at full width, and keeps the arithmetic on
// the tensor cores so that it never sets the pace.
//
// Two variants, chosen by the wrapper from dtype and alignment before the
// launch (kernels/flash_attention/ops.py:_flash_variant):
//
// "tc", bf16 with 16-byte-aligned rows: the FlashAttention-2 layout. A
// warp owns 16 q rows; S = Q.K^T and O += P.V run on mma.sync.m16n8k16
// (bf16 in, fp32 accumulators), over K and V tiles of 64 rows held in shared
// memory as bf16, copied with 16-byte cp.async.cg (rows past Skv
// zero-filled). Tiles are XOR-swizzled in 16-byte chunks, so the ldmatrix
// reads of q, k (plain) and v (transposed) are free of bank conflicts. The
// q rows are read into registers once. Softcap and the masks are applied
// to the fp32 S fragment, each tested once per tile outside the loops over
// elements (an option that is off issues nothing); the row max is taken on
// the raw scores and the scale folded into one multiply-add per exponent
// (ex2.approx); the row max and sum are reduced over the 4 lanes that
// share a row. P goes from the S accumulators straight into the A
// registers of the second product, rounded to bf16 (<= 2^-9 relative per
// weight, inside the 2e-2 bf16 tolerance; the reference keeps p in fp32).
// A tile's 16-column groups past Skv are skipped, their count a template
// argument, so S=144 costs 144 columns, not 192, and no predicated-off
// work. Two forms, chosen from the shapes:
//  - short sequences whose q, K and V fit in 48 KB of shared memory at once
//    (the agent's S=144 at D=32: 27 KB): one block per (head, batch) loads
//    all of them with one wait, and its warps (at most 4, the 16-row groups
//    spread evenly: 3 warps of 3 groups at S=144) walk their row groups over
//    the resident tiles with no further barrier. A (head, batch) is only
//    36 KB of traffic, so what a block pays is its load's latency: one
//    exposed wait instead of one per kv tile, and no idle fourth warp;
//  - longer sequences: one block per (64-row q tile, head, batch), 4 warps;
//    K and V tiles double-buffered, so the next tile's copy overlaps this
//    tile's products; warps whose 16 rows lie past Sq skip their products
//    but keep to the block's barriers.
//
// "simt", fp32 (TF32 would break the 3e-5 fp32 bound) and unaligned views:
// the CUDA-core kernel. One thread block per (64-row q tile, head, batch);
// TPR = D/32 adjacent threads share a q row, each owning 32 head dims of q
// and of the accumulator in registers (D=16 uses one thread of 16 dims);
// partial dot products are summed with warp shuffles. K/V tiles are staged
// through shared memory as fp32; scores are processed 16 columns at a time.
//
// Both variants apply the masks in registers with no padded copies of q, k
// or v, skip the kv tiles that the causal or window mask empties for the
// whole block, and take strides for batch, sequence and head, so the
// model's (B, S, H, D) views need no copy. Under a window a block's first
// tiles may hold no visible column for its last rows; their exponents are
// zero in "tc" (a zero offset while the row max is still the mask value)
// and cancelled in "simt" (its exp(s - max) is finite, and the correction
// factor of the first visible column is 0).
//
// Training: with a non-null lse pointer each row's log-sum-exp of its
// masked logits, lse = max + ln(sum), is written as fp32 (B, Hq, Sq), the
// residual flash_attention_bwd.cu recomputes the probabilities from. Both
// terms are already in the registers when the row is stored, so it costs
// one 4-byte store per row; serving passes null and writes nothing. (A
// recomputing pass in the backward would read q and K once more and redo
// q.k^T for every row.)
#include <math.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "common.cuh"

namespace {


using repro::from_f32;
using repro::to_f32;

constexpr int kBlockQ = 64;      // query rows per thread block
constexpr int kChunk = 16;       // kv columns per online-softmax update
constexpr float kNegInf = -1e30f;

template <typename T, int D>
__global__ void __launch_bounds__(kBlockQ * (D > 32 ? D / 32 : 1))
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                 int Hq, int group, int Sq, int Skv,
                 long long q_sb, long long q_ss, long long q_sh,
                 long long k_sb, long long k_ss, long long k_sh,
                 long long v_sb, long long v_ss, long long v_sh,
                 int causal, int window, float softcap, float scale) {
  constexpr int DPT = D > 32 ? 32 : D;      // head dims per thread
  constexpr int TPR = D / DPT;              // threads per query row
  constexpr int NT = kBlockQ * TPR;
  constexpr int BKV = D == 128 ? 32 : 64;   // kv rows per shared tile
  __shared__ __align__(16) float ks[BKV][D];
  __shared__ __align__(16) float vs[BKV][D];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int hk = h / group;
  const int q_start = blockIdx.x * kBlockQ;
  const int tid = threadIdx.x;
  const int qpos = q_start + tid / TPR;
  const int d0 = (tid % TPR) * DPT;

  float qr[DPT], acc[DPT];
  {
    // rows past Sq read the last row (in bounds) and never store
    const T* qp = q + b * q_sb + (long long)min(qpos, Sq - 1) * q_ss + h * q_sh + d0;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      qr[i] = to_f32(qp[i]) * scale;
      acc[i] = 0.f;
    }
  }
  float m = kNegInf, l = 0.f;

  // kv tiles that hold an unmasked column for some row of this block:
  // causal keeps columns <= the block's last row, a window keeps columns
  // > the first row's position - window
  int kv_end = Skv;
  if (causal) kv_end = min(kv_end, q_start + kBlockQ);
  const int kv_begin = window ? max(0, q_start - window + 1) : 0;
  const int t_begin = kv_begin / BKV;
  const int t_end = (kv_end + BKV - 1) / BKV;

  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;
  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BKV;
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = tid; idx < BKV * D; idx += NT) {
      const int j = idx / D, dd = idx % D;
      const int kp = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (kp < Skv) {
        kx = to_f32(kb[(long long)kp * k_ss + dd]);
        vx = to_f32(vb[(long long)kp * v_ss + dd]);
      }
      ks[j][dd] = kx;
      vs[j][dd] = vx;
    }
    __syncthreads();

#pragma unroll 1
    for (int c0 = 0; c0 < BKV; c0 += kChunk) {
      float s[kChunk];
      float cmax = kNegInf;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float* kr = &ks[c0 + j][d0];
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < DPT; ++i) dot = fmaf(qr[i], kr[i], dot);
#pragma unroll
        for (int off = TPR / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        if (softcap != 0.f) dot = tanhf(dot / softcap) * softcap;
        const int kp = k0 + c0 + j;
        bool ok = kp < Skv;
        if (causal) ok = ok && kp <= qpos;
        if (window) ok = ok && qpos - kp < window;
        s[j] = ok ? dot : kNegInf;
        cmax = fmaxf(cmax, s[j]);
      }
      const float m_new = fmaxf(m, cmax);
      const float corr = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        s[j] = expf(s[j] - m_new);
        psum += s[j];
      }
      l = l * corr + psum;
      m = m_new;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] *= corr;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float* vr = &vs[c0 + j][d0];
#pragma unroll
        for (int i = 0; i < DPT; ++i) acc[i] = fmaf(s[j], vr[i], acc[i]);
      }
    }
  }

  if (qpos < Sq) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* op = o + (((long long)b * Sq + qpos) * Hq + h) * D + d0;
#pragma unroll
    for (int i = 0; i < DPT; ++i) op[i] = from_f32<T>(acc[i] * inv);
    if (lse != nullptr && tid % TPR == 0)
      lse[((long long)b * Hq + h) * Sq + qpos] = m + logf(fmaxf(l, 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch_simt(const void* q, const void* k, const void* v, void* o, float* lse,
                        int B, int Hq, int Hkv, int Sq, int Skv,
                        const long long* qs, const long long* ks_, const long long* vs_,
                        int causal, int window, float softcap, float scale,
                        cudaStream_t stream) {
  constexpr int TPR = D > 32 ? D / 32 : 1;
  dim3 grid((Sq + kBlockQ - 1) / kBlockQ, Hq, B);
  flash_fwd_kernel<T, D><<<grid, kBlockQ * TPR, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, Hq, Hq / Hkv, Sq, Skv, qs[0], qs[1], qs[2],
      ks_[0], ks_[1], ks_[2], vs_[0], vs_[1], vs_[2], causal, window, softcap, scale);
  return cudaGetLastError();
}

// -------------------------------------------------------------- tc variant
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64, BKV = 64;   // q rows per block (4 warps x 16), kv rows per tile
constexpr int THREADS = 128;
constexpr float kLog2e = 1.4426950408889634f;

using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::ex2;
using repro::ldsm_x4;
using repro::ldsm_x4_trans;
using repro::mma16816;
using repro::mma16816_zero;
using repro::pack_bf16;
using repro::swz;

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
constexpr int smem_bytes() { return (BQ + 4 * BKV) * D * 2; }   // q, then K and V x 2 buffers

// the short form runs where q, K and V fit without opting in to more than
// the default 48 KB of dynamic shared memory
constexpr long long kShortSmem = 48 * 1024;
constexpr int kShortWarps = 4;   // at most, per block of the short form
// blocks per SM the register budget is held to at D <= 32 (short rows:
// more warps in flight, at the cost of a few spilled words)
constexpr int kMinBlocks32 = 5;

// The online softmax of one warp's 16 q rows: this thread holds rows g and
// g + 8 of the group (g = lane / 4) in the mma fragment layouts.
template <int D>
struct Rows {
  uint32_t qf[D / 16][4];   // q, A fragments of the k16 slices of D
  float acc[D / 8][4];      // o, n8 tiles of D
  float m0, m1, l0, l1;     // running max of the raw scores, running sums
};

struct Scores {
  int Skv, causal, window;
  float softcap, cap_in;    // x = tanh(s * cap_in) * softcap with a softcap
  float mul;                // p = 2^((x - max) * mul)
};

template <int D>
__device__ __forceinline__ void start_rows(Rows<D>& st, uint32_t sq, int r0, int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldsm_x4(sq + swz<D>(r0 + (lane % 8) + ((lane / 8) % 2) * 8, 2 * kk + lane / 16), st.qf[kk]);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) st.acc[n][0] = st.acc[n][1] = st.acc[n][2] = st.acc[n][3] = 0.f;
  st.m0 = st.m1 = kNegInf;
  st.l0 = st.l1 = 0.f;
}

// One kv tile (BKV rows at kt, vt in shared memory, starting at position
// k0) into the rows' softmax, of which the first NG 16-column groups hold a
// column < Skv (the rest are skipped); qp0, qp1 are the positions of this
// thread's rows.
template <int D, int NG>
__device__ __forceinline__ void attend_groups(Rows<D>& st, uint32_t kt, uint32_t vt, int k0,
                                              int qp0, int qp1, const Scores& sc, int lane) {
  constexpr int NS = 2 * NG;       // n8 tiles of S
  const int t4 = lane % 4;

  float s[NS][4];
#pragma unroll
  for (int j = 0; j < NG; ++j) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t kf[4];
      ldsm_x4(kt + swz<D>(16 * j + (lane % 8) + (lane / 16) * 8, 2 * kk + (lane / 8) % 2), kf);
      if (kk == 0) {
        mma16816_zero(s[2 * j], st.qf[kk], kf[0], kf[1]);
        mma16816_zero(s[2 * j + 1], st.qf[kk], kf[2], kf[3]);
      } else {
        mma16816(s[2 * j], st.qf[kk], kf[0], kf[1]);
        mma16816(s[2 * j + 1], st.qf[kk], kf[2], kf[3]);
      }
    }
  }

  // softcap in fp32, masks from positions; the max is taken on the raw
  // scores and the scale folded into the exponent's multiply-add. Each
  // option is tested once per tile, outside the loops over elements, so
  // an option that is off costs no predicated instructions.
  if (sc.softcap != 0.f) {
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = tanhf(s[j][e] * sc.cap_in) * sc.softcap;
  }
  if (sc.causal || sc.window || k0 + 16 * NG > sc.Skv) {
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + 8 * j + 2 * t4 + (e & 1);
        const int qp = e < 2 ? qp0 : qp1;
        bool ok = kp < sc.Skv;
        if (sc.causal) ok = ok && kp <= qp;
        if (sc.window) ok = ok && qp - kp < sc.window;
        if (!ok) s[j][e] = kNegInf;
      }
    }
  }
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
    mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
  }
  const float mn0 = fmaxf(st.m0, quad_max(mx0)), mn1 = fmaxf(st.m1, quad_max(mx1));
  const float c0 = ex2((st.m0 - mn0) * sc.mul), c1 = ex2((st.m1 - mn1) * sc.mul);
  st.m0 = mn0;
  st.m1 = mn1;
  // A row that has seen only masked columns so far (a window's first
  // tiles) keeps the max kNegInf: its exponents must come out 0, and
  // fmaf(kNegInf, mul, -round(kNegInf * mul)) is the product's rounding
  // error, ~1e22 of either sign, whose ex2 may be inf (then inf * 0 = NaN
  // once a visible column arrives). A zero offset sends them to ex2(-huge).
  const float b0 = mn0 == kNegInf ? 0.f : mn0 * sc.mul;
  const float b1 = mn1 == kNegInf ? 0.f : mn1 * sc.mul;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    s[j][0] = ex2(fmaf(s[j][0], sc.mul, -b0));
    s[j][1] = ex2(fmaf(s[j][1], sc.mul, -b0));
    s[j][2] = ex2(fmaf(s[j][2], sc.mul, -b1));
    s[j][3] = ex2(fmaf(s[j][3], sc.mul, -b1));
    ps0 += s[j][0] + s[j][1];
    ps1 += s[j][2] + s[j][3];
  }
  st.l0 = st.l0 * c0 + ps0;
  st.l1 = st.l1 * c1 + ps1;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    st.acc[n][0] *= c0;
    st.acc[n][1] *= c0;
    st.acc[n][2] *= c1;
    st.acc[n][3] *= c1;
  }

  // O += P.V: the S fragment of columns [16j, 16j+16) is the A fragment of
  // the k16 step j
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                            pack_bf16(s[2 * j][2], s[2 * j][3]),
                            pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                            pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
    for (int dd = 0; dd < D / 16; ++dd) {
      uint32_t vf[4];
      ldsm_x4_trans(vt + swz<D>(16 * j + (lane % 8) + ((lane / 8) % 2) * 8, 2 * dd + lane / 16),
                    vf);
      mma16816(st.acc[2 * dd], pa, vf[0], vf[1]);
      mma16816(st.acc[2 * dd + 1], pa, vf[2], vf[3]);
    }
  }
}

// One kv tile, its 16-column groups past Skv skipped: the group count is
// a template argument, so a short last tile issues no predicated-off work.
template <int D>
__device__ __forceinline__ void attend(Rows<D>& st, uint32_t kt, uint32_t vt, int k0, int qp0,
                                       int qp1, const Scores& sc, int lane) {
  static_assert(BKV == 64, "four 16-column groups per kv tile");
  switch ((min(BKV, sc.Skv - k0) + 15) / 16) {
    case 1:
      attend_groups<D, 1>(st, kt, vt, k0, qp0, qp1, sc, lane);
      break;
    case 2:
      attend_groups<D, 2>(st, kt, vt, k0, qp0, qp1, sc, lane);
      break;
    case 3:
      attend_groups<D, 3>(st, kt, vt, k0, qp0, qp1, sc, lane);
      break;
    default:
      attend_groups<D, 4>(st, kt, vt, k0, qp0, qp1, sc, lane);
  }
}

// Normalise the rows and write them: staged in rows [r0, r0 + 16) of the
// q tile at smem (rows only this warp reads), then 16-byte chunks to o for
// positions p0 + r < Sq; with lse, also each row's max * lse_mul + ln(sum)
// (lse_mul turns the raw max into logits: the scale, or 1 under softcap).
template <int D>
__device__ __forceinline__ void store_rows(const Rows<D>& st, uint8_t* smem, int r0, bf16* o,
                                           float* lse, float lse_mul, int b, int h, int Hq,
                                           int Sq, int p0, int lane) {
  constexpr int CPR = D / 8;
  const int g = lane / 4, t4 = lane % 4;
  const float l0 = fmaxf(quad_sum(st.l0), 1e-30f), l1 = fmaxf(quad_sum(st.l1), 1e-30f);
  const float i0 = 1.f / l0, i1 = 1.f / l1;
  if (lse != nullptr && t4 == 0) {
    float* lp = lse + ((long long)b * Hq + h) * Sq;
    if (p0 + g < Sq) lp[p0 + g] = st.m0 * lse_mul + logf(l0);
    if (p0 + g + 8 < Sq) lp[p0 + g + 8] = st.m1 * lse_mul + logf(l1);
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<uint32_t*>(smem + swz<D>(r0 + g, n) + 4 * t4) =
        pack_bf16(st.acc[n][0] * i0, st.acc[n][1] * i0);
    *reinterpret_cast<uint32_t*>(smem + swz<D>(r0 + g + 8, n) + 4 * t4) =
        pack_bf16(st.acc[n][2] * i1, st.acc[n][3] * i1);
  }
  __syncwarp();
  for (int i = lane; i < 16 * CPR; i += 32) {
    const int r = i / CPR, c = i % CPR, p = p0 + r;
    if (p < Sq)
      *reinterpret_cast<uint4*>(o + (((long long)b * Sq + p) * Hq + h) * D + c * 8) =
          *reinterpret_cast<const uint4*>(smem + swz<D>(r0 + r, c));
  }
}

__device__ __forceinline__ Scores make_scores(int Skv, int causal, int window, float softcap,
                                              float scale) {
  return {Skv, causal, window, softcap, softcap != 0.f ? scale / softcap : 0.f,
          (softcap != 0.f ? 1.f : scale) * kLog2e};
}

// Streaming form: one block per (64-row q tile, head, batch), 4 warps of 16
// rows; K and V stream through two buffers of BKV rows.
template <int D>
__global__ void __launch_bounds__(THREADS, D <= 32 ? kMinBlocks32 : 1)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                    int Hq, int group, int Sq, int Skv,
                    long long q_sb, long long q_ss, long long q_sh,
                    long long k_sb, long long k_ss, long long k_sh,
                    long long v_sb, long long v_ss, long long v_sh,
                    int causal, int window, float softcap, float scale) {
  constexpr int CPR = D / 8;       // 16-byte chunks per row
  constexpr int TILE = BKV * D * 2;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t sq = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t sk = sq + BQ * D * 2, sv = sk + 2 * TILE;

  const int b = blockIdx.z, h = blockIdx.y, hk = h / group;
  const int q_start = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // kv tiles that hold an unmasked column for some row of this block
  int kv_end = Skv;
  if (causal) kv_end = min(kv_end, q_start + BQ);
  const int kv_begin = window ? max(0, q_start - window + 1) : 0;
  const int t_begin = kv_begin / BKV;
  const int t_end = (kv_end + BKV - 1) / BKV;

  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * k_sb + hk * k_sh;
  const bf16* vb = v + b * v_sb + hk * v_sh;
  for (int i = tid; i < BQ * CPR; i += THREADS) {
    const int r = i / CPR, c = i % CPR, p = q_start + r;
    cp_async16(sq + swz<D>(r, c), qb + (long long)(p < Sq ? p : 0) * q_ss + c * 8, p < Sq);
  }
  auto load_kv = [&](int t, int buf) {
    for (int i = tid; i < BKV * CPR; i += THREADS) {
      const int r = i / CPR, c = i % CPR, p = t * BKV + r;
      const bool ok = p < Skv;
      const uint32_t off = buf * TILE + swz<D>(r, c);
      cp_async16(sk + off, kb + (long long)(ok ? p : 0) * k_ss + c * 8, ok);
      cp_async16(sv + off, vb + (long long)(ok ? p : 0) * v_ss + c * 8, ok);
    }
  };
  if (t_begin < t_end) load_kv(t_begin, 0);
  cp_async_commit();

  const int r0 = warp * 16, p0 = q_start + r0;   // this warp's rows and their first position
  const bool active = p0 < Sq;
  const int g = lane / 4;
  const Scores sc = make_scores(Skv, causal, window, softcap, scale);
  Rows<D> st;
  st.l0 = st.l1 = 0.f;
  for (int t = t_begin; t < t_end; ++t) {
    const int buf = (t - t_begin) & 1;
    if (t + 1 < t_end) {
      load_kv(t + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // tile t (and, the first time, the q tile) has landed
    if (active) {
      if (t == t_begin) start_rows(st, sq, r0, lane);
      attend(st, sk + buf * TILE, sv + buf * TILE, t * BKV, p0 + g, p0 + g + 8, sc, lane);
    }
    __syncthreads();   // every warp is done with buffer buf before it is refilled
  }

  // with no kv tile the q copies may still be in flight
  cp_async_wait<0>();
  __syncthreads();
  if (active) {
    if (t_begin >= t_end) start_rows(st, sq, r0, lane);
    store_rows(st, smem, r0, o, lse, softcap != 0.f ? 1.f : scale, b, h, Hq, Sq, p0, lane);
  }
}

// Short form, for sequences whose q, K and V fit in shared memory at once
// (the agent's S=144): one block per (head, batch) loads all of them with
// one wait, and each warp then walks its 16-row groups over the resident
// tiles with no further barrier.
template <int D>
__global__ void __launch_bounds__(32 * kShortWarps, D <= 32 ? kMinBlocks32 : 1)
flash_fwd_tc_short_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          float* __restrict__ lse,
                          int Hq, int group, int Sq, int Skv,
                          long long q_sb, long long q_ss, long long q_sh,
                          long long k_sb, long long k_ss, long long k_sh,
                          long long v_sb, long long v_ss, long long v_sh,
                          int causal, int window, float softcap, float scale) {
  constexpr int CPR = D / 8;
  constexpr int TILE = BKV * D * 2;
  // a tile reads only its 16-row groups that hold a row < Skv, so K and V
  // are copied (rows past Skv as zeros) up to the last such group
  const int sq16 = (Sq + 15) / 16 * 16, skv16 = (Skv + 15) / 16 * 16;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t sq = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t sk = sq + sq16 * D * 2, sv = sk + skv16 * D * 2;

  const int b = blockIdx.z, h = blockIdx.y, hk = h / group;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, warps = blockDim.x / 32;
  // each thread copies one 16-byte chunk c of every (blockDim / CPR)-th row
  const int c = tid % CPR, rstep = blockDim.x / CPR;
  const bf16* qp = q + b * q_sb + h * q_sh + c * 8 + tid / CPR * q_ss;
  for (int r = tid / CPR; r < sq16; r += rstep, qp += rstep * q_ss)
    cp_async16(sq + swz<D>(r, c), r < Sq ? qp : q, r < Sq);
  const bf16* kp = k + b * k_sb + hk * k_sh + c * 8 + tid / CPR * k_ss;
  const bf16* vp = v + b * v_sb + hk * v_sh + c * 8 + tid / CPR * v_ss;
  for (int r = tid / CPR; r < skv16; r += rstep, kp += rstep * k_ss, vp += rstep * v_ss) {
    cp_async16(sk + swz<D>(r, c), r < Skv ? kp : k, r < Skv);
    cp_async16(sv + swz<D>(r, c), r < Skv ? vp : v, r < Skv);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int g = lane / 4;
  const Scores sc = make_scores(Skv, causal, window, softcap, scale);
  for (int r0 = warp * 16; r0 < sq16; r0 += warps * 16) {
    // kv tiles that hold an unmasked column for some row of the group
    const int kv_end = causal ? min(Skv, r0 + 16) : Skv;
    const int kv_begin = window ? max(0, r0 - window + 1) : 0;
    Rows<D> st;
    start_rows(st, sq, r0, lane);
    for (int t = kv_begin / BKV; t < (kv_end + BKV - 1) / BKV; ++t)
      attend(st, sk + t * TILE, sv + t * TILE, t * BKV, r0 + g, r0 + g + 8, sc, lane);
    store_rows(st, smem, r0, o, lse, softcap != 0.f ? 1.f : scale, b, h, Hq, Sq, r0, lane);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   int B, int Hq, int Hkv, int Sq, int Skv,
                   const long long* qs, const long long* ks_, const long long* vs_,
                   int causal, int window, float softcap, float scale, cudaStream_t stream) {
  const bf16 *qp = static_cast<const bf16*>(q), *kp = static_cast<const bf16*>(k),
             *vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
  const long long sq16 = (Sq + 15) / 16 * 16, skv16 = (Skv + 15) / 16 * 16;
  const long long short_bytes = (sq16 + 2 * skv16) * D * 2;
  if (sq16 <= 16 * 16 && short_bytes <= kShortSmem) {
    // 16-row groups spread evenly over at most 4 warps
    const int groups = (int)(sq16 / 16), per = (groups + kShortWarps - 1) / kShortWarps;
    flash_fwd_tc_short_kernel<D><<<dim3(1, Hq, B), 32 * ((groups + per - 1) / per),
                                   (int)short_bytes, stream>>>(
        qp, kp, vp, op, lse, Hq, Hq / Hkv, Sq, Skv, qs[0], qs[1], qs[2], ks_[0], ks_[1], ks_[2],
        vs_[0], vs_[1], vs_[2], causal, window, softcap, scale);
    return cudaGetLastError();
  }
  constexpr int bytes = smem_bytes<D>();
  if (bytes > 48 * 1024) {
    // the shared-memory limit is raised once per device
    static bool attr[repro::kMaxDevices] = {};
    int dev = 0;
    cudaError_t err = repro::current_device(&dev);
    if (err != cudaSuccess) return err;
    if (!attr[dev]) {
      err = cudaFuncSetAttribute(flash_fwd_tc_kernel<D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err != cudaSuccess) return err;
      attr[dev] = true;
    }
  }
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_fwd_tc_kernel<D><<<grid, THREADS, bytes, stream>>>(
      qp, kp, vp, op, lse, Hq, Hq / Hkv, Sq, Skv, qs[0], qs[1], qs[2], ks_[0], ks_[1], ks_[2],
      vs_[0], vs_[1], vs_[2], causal, window, softcap, scale);
  return cudaGetLastError();
}

}  // namespace tc

// variant 0: the CUDA-core kernel for T; variant 1: the tensor-core kernel (bf16)
template <typename T>
cudaError_t dispatch_d(int variant, int D, const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int Hq, int Hkv, int Sq, int Skv,
                       const long long* qs, const long long* ks_, const long long* vs_,
                       int causal, int window, float softcap, float scale,
                       cudaStream_t stream) {
#define REPRO_FLASH_D(DD)                                                                 \
  case DD:                                                                                \
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {                                \
      if (variant == 1)                                                                   \
        return tc::launch<DD>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, qs, ks_, vs_, causal,      \
                              window, softcap, scale, stream);                            \
    }                                                                                     \
    return launch_simt<T, DD>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, qs, ks_, vs_, causal,      \
                              window, softcap, scale, stream);
  switch (D) {
    REPRO_FLASH_D(16)
    REPRO_FLASH_D(32)
    REPRO_FLASH_D(64)
    REPRO_FLASH_D(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_FLASH_D
}

}  // namespace

// q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D), each with unit stride on D and
// the given (batch, seq, head) strides in elements. o: contiguous
// (B, Sq, Hq, D). lse: null, or fp32 (B, Hq, Sq) for each row's log-sum-exp
// (the backward's residual). variant 0 runs the CUDA-core kernel (float32 or
// bfloat16); variant 1 the tensor-core kernel, which takes bfloat16 with
// strides that are multiples of 8 and 16-byte-aligned pointers and refuses
// anything else (the caller chooses; nothing falls back). Returns the CUDA
// error of the launch (0 on success).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse, int dtype, int variant,
    int B, int Hq, int Hkv, int Sq, int Skv, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    int causal, int window, float softcap, float scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || (variant != 0 && variant != 1)) return cudaErrorInvalidValue;
  const long long qs[3] = {q_sb, q_ss, q_sh};
  const long long kst[3] = {k_sb, k_ss, k_sh};
  const long long vst[3] = {v_sb, v_ss, v_sh};
  if (variant == 1) {
    bool ok = dtype == repro::kBFloat16;
    for (int i = 0; i < 3; ++i) ok = ok && qs[i] % 8 == 0 && kst[i] % 8 == 0 && vst[i] % 8 == 0;
    for (const void* p : {q, k, v, static_cast<const void*>(o)})
      ok = ok && reinterpret_cast<uintptr_t>(p) % 16 == 0;
    if (!ok) return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kFloat32:
      return dispatch_d<float>(variant, D, q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, qs, kst, vst,
                               causal, window, softcap, scale, s);
    case repro::kBFloat16:
      return dispatch_d<__nv_bfloat16>(variant, D, q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, qs, kst,
                                       vst, causal, window, softcap, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
