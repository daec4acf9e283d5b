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
// "tc", bf16 with 16-byte-aligned rows, D a multiple of 16 up to 128 (the
// Pallas kernel takes any D over its whole-row tiles; past 128 the wrapper
// raises): the FlashAttention-2 layout. A
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
// work. Three forms, chosen by the C entry from the shapes (launch_tc;
// mirrored by ops.py's fwd_form; its last argument can name one):
//  - short sequences whose q, K and V fit in 48 KB of shared memory at once
//    (the agent's S=144 at D=32: 27 KB): one block per (head, batch) loads
//    all of them with one wait, and its warps (at most 4, the 16-row groups
//    spread evenly: 3 warps of 3 groups at S=144) walk their row groups over
//    the resident tiles with no further barrier. A (head, batch) is only
//    36 KB of traffic, so what a block pays is its load's latency: one
//    exposed wait instead of one per kv tile, and no idle fourth warp;
//  - longer sequences at D = 16 and 32 (the mma.sync streaming form, which
//    also runs every other D when named, as the short form does): one
//    block per (64-row q tile, head, batch), 4 warps; K and V tiles
//    double-buffered, so the next tile's copy overlaps this tile's
//    products; warps whose 16 rows lie past Sq skip their products but
//    keep to the block's barriers;
//  - longer sequences at D from 48, every LM layer the port runs (the
//    Hopper streaming form, namespace wg below): wgmma fed by TMA rings,
//    warp-specialised, compiled at D = 64 and 128 only. D = 48 runs on the
//    D = 64 kernel and 80, 96 and 112 (HuBERT X-Large's 80, Zamba2-7B's
//    112) on the D = 128 one: the tensor maps name the true D, so TMA reads
//    the columns past it as zeros (their products add nothing) and clips
//    them on the store; the kernel itself is unchanged, at 1.14-1.6x the
//    products the head needs. At the LM prefill shapes the bound is the
//    tensor cores' (4 x 2048 causal, Command-R's 64 q heads of 128: 275
//    GFLOP, 0.278 ms at 989 TFLOP/s, against 0.302 GB of q, k, v and o,
//    0.090 ms), and mma.sync reaches at most about half of wgmma's rate
//    on this card: the mma.sync form ran at 23% of that bound, 2.48x
//    SDPA's time (PERF.md).
//
// "simt", fp32 (TF32 would break the 3e-5 fp32 bound) and unaligned views:
// the CUDA-core kernel. One thread block per (64-row q tile, head, batch);
// TPR = D/32 adjacent threads share a q row, each owning 32 head dims of q
// and of the accumulator in registers (D=16 uses one thread of 16 dims);
// partial dot products are summed with warp shuffles. K/V tiles are staged
// through shared memory as fp32; scores are processed 16 columns at a time.
// It is compiled at D = 16, 32, 64 and 128 and takes the true D as its last
// argument: any D up to 128 (bf16 too, where the tensor cores do not take
// it) runs on the next of those, its loads and stores masked at the true D.
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
#include "hopper.cuh"

namespace {


using repro::from_f32;
using repro::to_f32;

constexpr int kBlockQ = 64;      // query rows per thread block
constexpr int kChunk = 16;       // kv columns per online-softmax update
constexpr float kNegInf = -1e30f;

// The CUDA-core kernel at D in {16, 32, 64, 128}, the next of those at or
// above the true head dim dt (its last parameter): columns dt..D-1 are read
// as zeros and never stored (a thread past dt computes on zeros).
template <typename T, int D>
__global__ void __launch_bounds__(kBlockQ * (D > 32 ? D / 32 : 1))
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                 int Hq, int group, int Sq, int Skv,
                 long long q_sb, long long q_ss, long long q_sh,
                 long long k_sb, long long k_ss, long long k_sh,
                 long long v_sb, long long v_ss, long long v_sh,
                 int causal, int window, float softcap, float scale, int dt) {
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
      qr[i] = d0 + i < dt ? to_f32(qp[i]) * scale : 0.f;
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
      if (kp < Skv && dd < dt) {
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
    T* op = o + (((long long)b * Sq + qpos) * Hq + h) * dt + d0;
#pragma unroll
    for (int i = 0; i < DPT; ++i)
      if (d0 + i < dt) op[i] = from_f32<T>(acc[i] * inv);
    if (lse != nullptr && tid % TPR == 0)
      lse[((long long)b * Hq + h) * Sq + qpos] = m + logf(fmaxf(l, 1e-30f));
  }
}

// the CUDA-core kernel at the true head dim dt: D itself where dt is one of
// 16, 32, 64, 128, else the next of those with the columns past dt masked
template <typename T, int D>
cudaError_t launch_simt(const void* q, const void* k, const void* v, void* o, float* lse,
                        int B, int Hq, int Hkv, int Sq, int Skv,
                        const long long* qs, const long long* ks_, const long long* vs_,
                        int causal, int window, float softcap, float scale,
                        cudaStream_t stream, int dt) {
  constexpr int TPR = D > 32 ? D / 32 : 1;
  dim3 grid((Sq + kBlockQ - 1) / kBlockQ, Hq, B);
  flash_fwd_kernel<T, D><<<grid, kBlockQ * TPR, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, Hq, Hq / Hkv, Sq, Skv, qs[0], qs[1], qs[2],
      ks_[0], ks_[1], ks_[2], vs_[0], vs_[1], vs_[2], causal, window, softcap, scale, dt);
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

// the short form takes the input: at most 16 row groups of q, whose q, K
// and V fit kShortSmem
inline bool short_fits(int Sq, int Skv, int D) {
  const long long sq16 = (Sq + 15) / 16 * 16, skv16 = (Skv + 15) / 16 * 16;
  return sq16 <= 16 * 16 && (sq16 + 2 * skv16) * D * 2 <= kShortSmem;
}

// the short form (short_form) or the mma.sync streaming form
template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   int B, int Hq, int Hkv, int Sq, int Skv,
                   const long long* qs, const long long* ks_, const long long* vs_,
                   int causal, int window, float softcap, float scale, bool short_form,
                   cudaStream_t stream) {
  const bf16 *qp = static_cast<const bf16*>(q), *kp = static_cast<const bf16*>(k),
             *vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
  const long long sq16 = (Sq + 15) / 16 * 16, skv16 = (Skv + 15) / 16 * 16;
  const long long short_bytes = (sq16 + 2 * skv16) * D * 2;
  if (short_form) {
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

// ------------------------------------------- tc, the Hopper streaming form
// One block per (128-row q tile, q head, batch), blockIdx.x the q head so
// that the q heads of a kv head run side by side and share its K/V tiles
// through L2, the q tiles longest causal rows first. Three warpgroups: one
// producer, whose one thread issues TMA loads (Q once, then K and V tiles
// of 128 rows into a ring of STAGES mbarrier-guarded stages; K and V each
// complete on a barrier of their own, so S = Q.K^T starts before V lands),
// and two consumers of 64 q rows each. A consumer runs S = Q.K^T on wgmma
// (both operands from shared memory, K-major), the online softmax on the
// fp32 fragment as the mma.sync form does (softcap and masks tested once
// per tile, the row max on raw scores, ex2 with the folded scale), then
// O += P.V on wgmma with P rounded to bf16 from the S fragment (the
// register A operand) and V read through the transpose bit. Two overlaps
// hide the softmax behind the tensor cores: a consumer issues tile t's
// S = Q.K^T together with tile t - 1's O += P.V and runs tile t's softmax
// while they run (then rescales O, frees stage t - 1 and rounds P; P's
// registers are never written while a product reads them), and the two
// consumers issue their products in turns (hopper.cuh's Turns), so that
// one's softmax runs while the other's products do (each shortened the LM
// prefill layers on an H100; PERF.md gives the form's times). setmaxnreg
// moves the producer's registers to the consumers (24 and 240 a thread).
// Tiles that the causal mask or the window empty for the whole block are
// not loaded; a tile that one consumer's rows do not see costs it a masked
// product. The epilogue stages each consumer's normalised rows as bf16 in
// its rows of the Q tile (the 128-byte swizzle its TMA store map names)
// and stores them with TMA, which clips rows past Sq.
namespace wg {

using bf16 = __nv_bfloat16;
using repro::pack_bf16;
using repro::ex2;
using namespace repro::hopper;

constexpr int BQ = 128, BKV = 128;            // q rows a block, kv rows a tile
constexpr int CONSUMERS = 2, THREADS = (CONSUMERS + 1) * 128;
constexpr int BOX_ROW = 128;                  // bytes of a box row: 64 bf16

template <int D>
struct Fwd {
  static constexpr int BOXES = D / 64;        // 64-column boxes across a row
  static constexpr int Q_BOX = BQ * BOX_ROW;  // one box of the q tile
  static constexpr int T_BOX = BKV * BOX_ROW; // one box of a K or V tile
  static constexpr int Q_BYTES = BOXES * Q_BOX;
  static constexpr int T_BYTES = BOXES * T_BOX;
  // a consumer holds two tiles' stages at once (tile t's K, tile t - 1's
  // V), so a third lets the producer load ahead: 225 KB at D = 128
  static constexpr int STAGES = D == 128 ? 3 : 4;
  static constexpr int SMEM = Q_BYTES + STAGES * 2 * T_BYTES + (1 + 3 * STAGES) * 8 + 1024;
  static_assert(SMEM <= 232448, "an H100 block's shared memory");
};

// the running max of the raw scores and the partial sums of this thread's
// two rows
struct Rows {
  float m0, m1, l0, l1;
};

// The online softmax of one tile's scores in the fragment sf (columns from
// k0) for this thread's rows p0 and p0 + 8 of a warpgroup's rows from r0:
// softcap, the masks where the tile meets the diagonal, the window's lower
// edge or the end of the keys, the new row max, the exponents in place of
// the scores, the sums updated, and the factors (c0, c1) that O's earlier
// columns take. It writes no register but sf's and its own scalars, so it
// can run while a product that reads P's registers is in flight.
__device__ __forceinline__ void softmax_tile(float (&sf)[BKV / 2], Rows& st, float& c0,
                                             float& c1, int k0, int r0, int p0, int t4,
                                             const tc::Scores& sc) {
  if (sc.softcap != 0.f) {
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) sf[i] = tanhf(sf[i] * sc.cap_in) * sc.softcap;
  }
  if ((sc.causal && k0 + BKV - 1 > r0) || (sc.window && r0 + 63 - k0 >= sc.window) ||
      k0 + BKV > sc.Skv) {
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) {
      const int kp = k0 + 8 * (i / 4) + 2 * t4 + (i & 1), qp = p0 + 8 * ((i / 2) & 1);
      bool ok = kp < sc.Skv;
      if (sc.causal) ok = ok && kp <= qp;
      if (sc.window) ok = ok && qp - kp < sc.window;
      if (!ok) sf[i] = kNegInf;
    }
  }
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int j = 0; j < BKV / 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(sf[4 * j], sf[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(sf[4 * j + 2], sf[4 * j + 3]));
  }
  const float mn0 = fmaxf(st.m0, tc::quad_max(mx0)), mn1 = fmaxf(st.m1, tc::quad_max(mx1));
  c0 = ex2((st.m0 - mn0) * sc.mul);
  c1 = ex2((st.m1 - mn1) * sc.mul);
  st.m0 = mn0;
  st.m1 = mn1;
  // a row that has seen only masked columns keeps the max kNegInf: a zero
  // offset sends its exponents to ex2(-huge) = 0 (tc::attend_groups)
  const float b0 = mn0 == kNegInf ? 0.f : mn0 * sc.mul;
  const float b1 = mn1 == kNegInf ? 0.f : mn1 * sc.mul;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int j = 0; j < BKV / 8; ++j) {
    sf[4 * j] = ex2(fmaf(sf[4 * j], sc.mul, -b0));
    sf[4 * j + 1] = ex2(fmaf(sf[4 * j + 1], sc.mul, -b0));
    sf[4 * j + 2] = ex2(fmaf(sf[4 * j + 2], sc.mul, -b1));
    sf[4 * j + 3] = ex2(fmaf(sf[4 * j + 3], sc.mul, -b1));
    ps0 += sf[4 * j] + sf[4 * j + 1];
    ps1 += sf[4 * j + 2] + sf[4 * j + 3];
  }
  st.l0 = st.l0 * c0 + ps0;
  st.l1 = st.l1 * c1 + ps1;
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wg_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap omap, float* __restrict__ lse, int Hq,
                    int group, int Sq, int Skv, int causal, int window, float softcap,
                    float scale) {
  using F = Fwd<D>;
  constexpr int STAGES = F::STAGES;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle repeats every 1024 bytes: tiles start on that boundary
  const uint32_t base = (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) & ~1023u;
  const uint32_t s_q = base, s_kv = base + F::Q_BYTES;
  const uint32_t q_full = s_kv + STAGES * 2 * F::T_BYTES;
  const uint32_t k_full0 = q_full + 8, v_full0 = k_full0 + 8 * STAGES;
  const uint32_t empty0 = v_full0 + 8 * STAGES;

  const int h = blockIdx.x, b = blockIdx.y, hk = h / group;
  const int n_qt = (Sq + BQ - 1) / BQ;
  const int q0 = (causal ? n_qt - 1 - (int)blockIdx.z : (int)blockIdx.z) * BQ;
  // kv tiles that hold an unmasked column for some row of the block
  const int kv_end = causal ? min(Skv, q0 + BQ) : Skv;
  const int t_begin = window ? max(0, q0 - window + 1) / BKV : 0;
  const int n_t = max(0, (kv_end + BKV - 1) / BKV - t_begin);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full0 + 8 * s, 1);
      mbar_init(v_full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS * 4);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMERS * 4) {
    setmaxnreg_dec<24>();
    if (warp == CONSUMERS * 4 && lane == 0) {
      mbar_expect_tx(q_full, F::Q_BYTES);
      for (int bx = 0; bx < F::BOXES; ++bx)
        tma_load(s_q + bx * F::Q_BOX, &qmap, q_full, 64 * bx, h, q0, b);
      for (int it = 0; it < n_t; ++it) {
        const int s = it % STAGES, k0 = (t_begin + it) * BKV;
        if (it >= STAGES) mbar_wait(empty0 + 8 * s, (it / STAGES - 1) & 1);
        const uint32_t kt = s_kv + s * 2 * F::T_BYTES, vt = kt + F::T_BYTES;
        mbar_expect_tx(k_full0 + 8 * s, F::T_BYTES);
        for (int bx = 0; bx < F::BOXES; ++bx)
          tma_load(kt + bx * F::T_BOX, &kmap, k_full0 + 8 * s, 64 * bx, hk, k0, b);
        mbar_expect_tx(v_full0 + 8 * s, F::T_BYTES);
        for (int bx = 0; bx < F::BOXES; ++bx)
          tma_load(vt + bx * F::T_BOX, &vmap, v_full0 + 8 * s, 64 * bx, hk, k0, b);
      }
    }
    return;
  }
  setmaxnreg_inc<240>();

  // consumer wg owns q rows [r0, r0 + 64); this thread rows p0 and p0 + 8
  const int wg = warp / 4, wi = warp % 4, g = lane / 4, t4 = lane % 4;
  const int r0 = q0 + 64 * wg, p0 = r0 + 16 * wi + g;
  const tc::Scores sc = tc::make_scores(Skv, causal, window, softcap, scale);
  const uint32_t qa = s_q + wg * 64 * BOX_ROW;   // the warpgroup's rows of box 0
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  Rows st = {kNegInf, kNegInf, 0.f, 0.f};
  uint32_t pa[BKV / 16][4];
  // S = Q.K^T from the K tile at kt into sf; O += P.V from the V tile at vt
  auto scores = [&](float (&sf)[BKV / 2], uint32_t kt) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(sf, sw128_desc(qa + (kk / 4) * F::Q_BOX + (kk % 4) * 32, 16, 1024),
               sw128_desc(kt + (kk / 4) * F::T_BOX + (kk % 4) * 32, 16, 1024), kk > 0);
    wgmma_commit();
  };
  auto pv = [&](uint32_t vt) {
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      wgmma_rs(o, pa[kk], sw128_desc(vt + kk * 16 * BOX_ROW, F::T_BOX, 1024));
    wgmma_commit();
  };
  auto stage = [&](int it) { return s_kv + it % STAGES * 2 * F::T_BYTES; };
  auto phase = [&](int it) { return (it / STAGES) & 1; };
  // the consumers issue in turns, n_t + 1 each: the first tile's scores,
  // then each tile's with the previous one's O += P.V, then the last P.V
  Turns turns = {wg, n_t + 1, 0};

  auto pack_p = [&](const float (&sf)[BKV / 2]) {
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
      pa[j / 2][2 * (j % 2)] = pack_bf16(sf[4 * j], sf[4 * j + 1]);
      pa[j / 2][2 * (j % 2) + 1] = pack_bf16(sf[4 * j + 2], sf[4 * j + 3]);
    }
  };

  // Tile it's scores are issued with tile it - 1's O += P.V, so that its
  // softmax runs while the tensor cores take that product; then stage
  // it - 1 is freed, O rescaled and P rounded into the A registers (never
  // while a product that reads them is in flight).
  mbar_wait(q_full, 0);
  if (n_t > 0) {
    float sf[BKV / 2], c0, c1;
    mbar_wait(k_full0, 0);
    turns.begin();
    wgmma_fence();
    scores(sf, stage(0));
    turns.end();
    wgmma_wait<0>();
    softmax_tile(sf, st, c0, c1, t_begin * BKV, r0, p0, t4, sc);
    pack_p(sf);
  }
  for (int it = 1; it < n_t; ++it) {
    float sf[BKV / 2], c0, c1;
    mbar_wait(k_full0 + 8 * (it % STAGES), phase(it));
    mbar_wait(v_full0 + 8 * ((it - 1) % STAGES), phase(it - 1));
    turns.begin();
    wgmma_fence();
    scores(sf, stage(it));
    pv(stage(it - 1) + F::T_BYTES);
    turns.end();
    wgmma_wait<1>();
    softmax_tile(sf, st, c0, c1, (t_begin + it) * BKV, r0, p0, t4, sc);
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(empty0 + 8 * ((it - 1) % STAGES));
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= c0;
      o[4 * j + 1] *= c0;
      o[4 * j + 2] *= c1;
      o[4 * j + 3] *= c1;
    }
    pack_p(sf);
  }
  if (n_t > 0) {   // the last tile's O += P.V
    mbar_wait(v_full0 + 8 * ((n_t - 1) % STAGES), phase(n_t - 1));
    turns.begin();
    wgmma_fence();
    pv(stage(n_t - 1) + F::T_BYTES);
    turns.end();
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(empty0 + 8 * ((n_t - 1) % STAGES));
  }

  // normalise; lse; the rows as bf16 into this warpgroup's rows of the q
  // tile, then one TMA store per 64-column box
  const float L0 = fmaxf(tc::quad_sum(st.l0), 1e-30f), L1 = fmaxf(tc::quad_sum(st.l1), 1e-30f);
  const float i0 = 1.f / L0, i1 = 1.f / L1;
  if (lse != nullptr && t4 == 0) {
    const float lse_mul = softcap != 0.f ? 1.f : scale;
    float* lp = lse + ((long long)b * Hq + h) * Sq;
    if (p0 < Sq) lp[p0] = st.m0 * lse_mul + logf(L0);
    if (p0 + 8 < Sq) lp[p0 + 8] = st.m1 * lse_mul + logf(L1);
  }
  named_sync(1 + wg, 128);   // every warp of the warpgroup is done reading its q rows
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = 16 * wi + g + 8 * hr;
      const uint32_t addr = qa + (j / 8) * F::Q_BOX + row * BOX_ROW +
                            (((j % 8) ^ (row % 8)) << 4) + t4 * 4;
      const float inv = hr ? i1 : i0;
      const uint32_t v = pack_bf16(o[4 * j + 2 * hr] * inv, o[4 * j + 2 * hr + 1] * inv);
      asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
    }
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  named_sync(1 + wg, 128);
  if (threadIdx.x % 128 == 0 && r0 < Sq) {
    for (int bx = 0; bx < F::BOXES; ++bx) tma_store(&omap, qa + bx * F::Q_BOX, 64 * bx, h, r0, b);
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
}

// The kernel at D (64 or 128) for a true head dim dt <= D: the maps name
// dt, so TMA reads columns dt..D-1 as zeros (their products add nothing)
// and the store clips them, as it clips rows past Sq. At dt = 48, 80, 96
// and 112 the padded columns cost 1.33x, 1.6x, 1.33x and 1.14x the
// products the head needs (wgmma at n48..n112 would not).
template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int Hq, int Hkv, int Sq, int Skv, const long long* qs, const long long* ks_,
                   const long long* vs_, int causal, int window, float softcap, float scale,
                   cudaStream_t stream, int dt) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return cudaErrorNotSupported;
  const long long os[3] = {(long long)Sq * Hq * dt, (long long)Hq * dt, dt};
  CUtensorMap qm, km, vm, om;
  if (!make_bshd_map(enc, &qm, q, B, Sq, Hq, dt, qs, BQ) ||
      !make_bshd_map(enc, &km, k, B, Skv, Hkv, dt, ks_, BKV) ||
      !make_bshd_map(enc, &vm, v, B, Skv, Hkv, dt, vs_, BKV) ||
      !make_bshd_map(enc, &om, o, B, Sq, Hq, dt, os, 64))
    return cudaErrorInvalidValue;
  // the shared-memory limit is raised once per device
  static bool attr[repro::kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = repro::current_device(&dev);
  if (err != cudaSuccess) return err;
  if (!attr[dev]) {
    err = cudaFuncSetAttribute(flash_fwd_wg_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Fwd<D>::SMEM);
    if (err != cudaSuccess) return err;
    attr[dev] = true;
  }
  flash_fwd_wg_kernel<D><<<dim3(Hq, B, (Sq + BQ - 1) / BQ), THREADS, Fwd<D>::SMEM, stream>>>(
      qm, km, vm, om, lse, Hq, Hq / Hkv, Sq, Skv, causal, window, softcap, scale);
  return cudaGetLastError();
}

}  // namespace wg

// form codes shared with kernels/_build.py (FORM_CODES): the entry's own
// choice, or the one named
constexpr int kFormAuto = 0, kFormShort = 1, kFormStream = 2, kFormWg = 3;

// The tensor-core variant in the form asked for; kFormAuto picks the short
// form where it fits, else the Hopper streaming form at D >= 48 (D = 48 on
// its D = 64 kernel, 80, 96 and 112 on its D = 128 one), else the mma.sync
// streaming form (mirrored by ops.py's fwd_form). A form the input does not
// fit is refused.
template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                      int Hq, int Hkv, int Sq, int Skv, const long long* qs,
                      const long long* ks_, const long long* vs_, int causal, int window,
                      float softcap, float scale, int form, cudaStream_t stream) {
  const bool fits = tc::short_fits(Sq, Skv, D);
  if (form == kFormAuto) form = fits ? kFormShort : D >= 48 ? kFormWg : kFormStream;
  if (form == kFormWg) {
    if constexpr (D >= 48)
      return wg::launch<D <= 64 ? 64 : 128>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, qs, ks_, vs_,
                                            causal, window, softcap, scale, stream, D);
    return cudaErrorInvalidValue;
  }
  if ((form == kFormShort && !fits) || (form != kFormShort && form != kFormStream))
    return cudaErrorInvalidValue;
  return tc::launch<D>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, qs, ks_, vs_, causal, window,
                       softcap, scale, form == kFormShort, stream);
}

// variant 1: the tensor-core kernel (bf16) at D a multiple of 16 up to 128;
// variant 0: the CUDA-core kernel for T at any D from 1 to 128
template <typename T>
cudaError_t dispatch_d(int variant, int D, const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int Hq, int Hkv, int Sq, int Skv,
                       const long long* qs, const long long* ks_, const long long* vs_,
                       int causal, int window, float softcap, float scale, int form,
                       cudaStream_t stream) {
  if (variant == 1) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      switch (D) {
#define REPRO_FLASH_D(DD)                                                                   \
  case DD:                                                                                  \
    return launch_tc<DD>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, qs, ks_, vs_, causal, window, \
                         softcap, scale, form, stream);
        REPRO_FLASH_D(16)
        REPRO_FLASH_D(32)
        REPRO_FLASH_D(48)
        REPRO_FLASH_D(64)
        REPRO_FLASH_D(80)
        REPRO_FLASH_D(96)
        REPRO_FLASH_D(112)
        REPRO_FLASH_D(128)
#undef REPRO_FLASH_D
      }
    }
    return cudaErrorInvalidValue;
  }
  if (D < 1 || D > 128) return cudaErrorInvalidValue;
  if (D <= 16)
    return launch_simt<T, 16>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, qs, ks_, vs_, causal, window,
                              softcap, scale, stream, D);
  if (D <= 32)
    return launch_simt<T, 32>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, qs, ks_, vs_, causal, window,
                              softcap, scale, stream, D);
  if (D <= 64)
    return launch_simt<T, 64>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, qs, ks_, vs_, causal, window,
                              softcap, scale, stream, D);
  return launch_simt<T, 128>(q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, qs, ks_, vs_, causal, window,
                             softcap, scale, stream, D);
}

}  // namespace

// q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D), each with unit stride on D and
// the given (batch, seq, head) strides in elements. o: contiguous
// (B, Sq, Hq, D). lse: null, or fp32 (B, Hq, Sq) for each row's log-sum-exp
// (the backward's residual). variant 0 runs the CUDA-core kernel (float32 or
// bfloat16, D from 1 to 128); variant 1 the tensor-core kernel, which takes
// bfloat16 with D a multiple of 16 up to 128, strides that are multiples of
// 8 and 16-byte-aligned pointers and refuses anything else (the caller
// chooses; nothing falls back). Returns the CUDA error of the launch (0 on
// success).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse, int dtype, int variant,
    int B, int Hq, int Hkv, int Sq, int Skv, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    int causal, int window, float softcap, float scale, void* stream, int form) {
  if (Hkv <= 0 || Hq % Hkv != 0 || (variant != 0 && variant != 1) ||
      (variant == 0 && form != kFormAuto))
    return cudaErrorInvalidValue;
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
                               causal, window, softcap, scale, form, s);
    case repro::kBFloat16:
      return dispatch_d<__nv_bfloat16>(variant, D, q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, qs, kst,
                                       vst, causal, window, softcap, scale, form, s);
    default:
      return cudaErrorInvalidValue;
  }
}
