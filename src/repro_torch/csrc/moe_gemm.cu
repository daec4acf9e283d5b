// Grouped GEMM for Hopper (sm_90a): out[e] = x[e] @ w[e], fp32 accumulation.
//
// Replaces the Pallas TPU kernel repro/kernels/moe_gemm/kernel.py
// (_gemm_kernel, launched by grouped_gemm): x (E, C, d) times w (E, d, f)
// into out (E, C, f) in x's dtype, the products accumulated in fp32.
//
// What bounds it on the H100: at the Mirage MoE trunk's shapes (E=10,
// C=9216, d->f of 256->256, 256->1024, 1024->256) one layer's six
// projections do ~145 GFLOP (0.147 ms on the bf16 tensor cores) and move
// ~865 MB of x, w and out once (0.258 ms at 3.35 TB/s): 127-200 FLOP/byte,
// under the card's ~295 FLOP/byte balance point, so the bound is bytes.
// Once the products run on the tensor cores the kernel's job is to move
// each byte once, at full width, with the output as large a share of the
// traffic as the inputs (d is 256 for five of the six projections, so the
// K loop is only 4 steps and the epilogue weighs as much as the mainloop).
//
// Two variants, chosen by the wrapper from dtype, shape and alignment
// before the launch (kernels/moe_gemm/ops.py:_gemm_variant):
//
// "tc", bf16 with d and f multiples of 8, 16-byte-aligned bases and leading
// strides (TMA's rules). A persistent grid, one block per SM, walks the
// 128x256 output tiles of all experts in the order (expert, row band,
// column tile), so the blocks in flight share their x row bands through L2
// and each row band's w panel is read from L2 once per 256 columns. In a
// block, two consumer warpgroups (64 rows each) issue wgmma.m64n256k16
// (bf16 in, fp32 accumulators in registers), and one producer warp keeps a
// ring of 3 stages of 128x64 x tiles and 64x256 w tiles filled by TMA
// (cp.async.bulk.tensor, mbarrier completion); the ring runs on across
// tiles, so the next tile's loads overlap this tile's epilogue. The tensor
// maps are 3-D over (E, C, d), (E, d, f) and (E, C, f) with the caller's
// strides, their two outer axes in stride order (the trunk's activations
// keep the expert axis inside their rows), so strided views need no copy;
// TMA zero-fills what lies past C, d or f, so ragged edges need no padded
// copies. x is K-major (d contiguous); w is MN-major (f contiguous), read by
// wgmma with the transpose bit. Both are loaded with 128-byte swizzle, the
// layout the wgmma descriptors name. The epilogue packs the accumulators to
// bf16 in shared memory with the same swizzle and writes them with TMA
// stores, which clip the ragged edge: every byte of out is written once, in
// full 128-byte lines. f <= 256 is covered by one column tile, so x is read
// once.
//
// The backward (grouped_gemm_bwd; no TPU counterpart, JAX differentiates
// the reference einsum): both products of a projection, dX = dY.W^T and
// dW = X^T.dY, in one persistent launch of the same building blocks. At
// the trunk's shapes it moves x, w and dY once and dX and dW once (~144 MB
// a 256->256 projection, 43 us at 3.35 TB/s; bytes bound it, as the
// forward). Both operands that the earlier backward copied are read in
// place: X through MN-major boxes (wgmma's transpose bit), W as K-major B
// (W^T's columns are W's rows). dW's contraction runs over C = 9216 into
// only E * 2 * 1 = 20 output tiles at 256->256, so it is split along C into
// units that fill the SMs, reduced in a fixed order (no float atomics) so
// that dW is the same bit for bit from run to run; the short dX tiles fill
// the blocks that finish their unit first (see the fused backward below).
//
// "simt", everything else (fp32, ragged f such as 53, misaligned views): the
// CUDA-core kernel. A block of 256 threads computes a 64x64 tile, each
// thread a 4x4 patch in fp32 registers; the contraction runs in steps of 16
// through shared memory, with x kept transposed. Ragged C, d and f are
// masked on load and on store, and x and w may be strided on their two
// leading axes.
#include <cuda.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

// ------------------------------------------------------------ simt variant
constexpr int kBM = 64, kBN = 64, kBK = 16;
constexpr int kTM = 4, kTN = 4;
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);   // 256
constexpr int kPad = 4;                               // keeps float4 alignment

template <typename T>
__global__ void __launch_bounds__(kThreads)
grouped_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
                    int C, int d, int f, long long x_se, long long x_sc,
                    long long w_se, long long w_sk) {
  __shared__ __align__(16) float xs[kBK][kBM + kPad];   // x tile, transposed
  __shared__ __align__(16) float ws[kBK][kBN + kPad];

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const T* xe = x + e * x_se;
  const T* we = w + e * w_se;
  T* oe = out + (long long)e * C * f;

  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);
  const int ty = tid / (kBN / kTN);

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kBK) {
#pragma unroll
    for (int r = 0; r < kBM * kBK / kThreads; ++r) {
      const int idx = tid + r * kThreads;
      const int mm = idx / kBK, kk = idx % kBK;
      const int gm = m0 + mm, gk = k0 + kk;
      xs[kk][mm] = (gm < C && gk < d) ? to_f32(xe[gm * x_sc + gk]) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kBK * kBN / kThreads; ++r) {
      const int idx = tid + r * kThreads;
      const int kk = idx / kBN, nn = idx % kBN;
      const int gk = k0 + kk, gn = n0 + nn;
      ws[kk][nn] = (gk < d && gn < f) ? to_f32(we[gk * w_sk + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * kTM]);
      const float4 bv = *reinterpret_cast<const float4*>(&ws[kk][tx * kTN]);
      const float av[kTM] = {a.x, a.y, a.z, a.w};
      const float bw[kTN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gm = m0 + ty * kTM + i;
    if (gm >= C) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gn = n0 + tx * kTN + j;
      if (gn < f) oe[(long long)gm * f + gn] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
cudaError_t launch_simt(const void* x, const void* w, void* out, int E, int C, int d, int f,
                        long long x_se, long long x_sc, long long w_se, long long w_sk,
                        cudaStream_t stream) {
  dim3 grid((f + kBN - 1) / kBN, (C + kBM - 1) / kBM, E);
  grouped_gemm_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), C, d, f,
      x_se, x_sc, w_se, w_sk);
  return cudaGetLastError();
}

// -------------------------------------------------------------- tc variant
namespace tc {

constexpr int BM = 128, BN = 256, BK = 64, STAGES = 3;
constexpr int HALF = 64;                          // columns of one 128-byte swizzle box
constexpr int BOXES = BN / HALF;                  // boxes across a tile's columns
constexpr int BOX_BYTES = BK * HALF * 2;          // 8 KB: 64 rows of 128 bytes
constexpr int CONSUMERS = 2;                      // warpgroups, 64 rows of the tile each
constexpr int THREADS = CONSUMERS * 128 + 32;     // and one producer warp
constexpr int A_BYTES = BM * BK * 2;              // x tile: 128 rows of 64 bf16
constexpr int B_BYTES = BOXES * BOX_BYTES;        // w tile: BOXES 64x64 boxes
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int EPI_BYTES = BM * BN * 2;            // the bf16 out tile
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + EPI_BYTES + 2 * STAGES * 8 + 1024;

using repro::hopper::encode_tiled;
using repro::hopper::EncodeTiled;
using repro::hopper::mbar_arrive;
using repro::hopper::mbar_expect_tx;
using repro::hopper::mbar_init;
using repro::hopper::mbar_wait;
using repro::hopper::named_sync;
using repro::hopper::sw128_desc;
using repro::hopper::tma_load;
using repro::hopper::tma_store;

// d (64x256 fp32, wgmma's fragment layout) += a (64x16, K-major, or
// MN-major with TA) . b (16x256, MN-major with TB, else K-major)
template <int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// The consumers' main loop over nks k-steps of the ring, stage `it` on:
// warpgroup wg adds its 64 rows of A (stage's A tile) times B into acc.
// A is K-major, rows of 128 bytes (64 k), 8-row groups 1024 bytes apart, a
// k16 step 32 bytes along the (swizzled) row; with TA it is MN-major, k
// rows of 128 bytes (the warpgroup's 64 M columns, one 8 KB box each), a
// k16 step 16 rows. B is MN-major with TB, k rows of 128 bytes (64 N
// columns), the next 64 columns one box on, a k16 step 16 rows; else
// K-major, N rows of 128 bytes (64 k), a k16 step 32 bytes along the row.
template <int TA, int TB>
__device__ __forceinline__ void mma_steps(float (&acc)[BN / 2], uint32_t base, uint32_t full0,
                                          uint32_t empty0, int wg, int nks, int& it) {
  for (int ks = 0; ks < nks; ++ks, ++it) {
    const int s = it % STAGES;
    mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
    const uint32_t a = base + s * STAGE_BYTES + wg * 64 * 128, b = base + s * STAGE_BYTES + A_BYTES;
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma<TA, TB>(acc,
                    TA ? sw128_desc(a + kk * 16 * 128, BOX_BYTES, 1024)
                       : sw128_desc(a + kk * 32, 16, 1024),
                    TB ? sw128_desc(b + kk * 16 * 128, BOX_BYTES, 1024)
                       : sw128_desc(b + kk * 32, 16, 1024));
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    if (threadIdx.x % 32 == 0) mbar_arrive(empty0 + 8 * s);
  }
}

// Epilogue of one warpgroup: its 64 accumulator rows as bf16 into its rows
// of the out tile at ep (64x64 boxes in the out map's 128-byte swizzle),
// once the previous tile's TMA store has read them; then one TMA store per
// box that starts inside the out's N columns, for rows row0.. inside M (TMA
// clips the ragged edge).
__device__ __forceinline__ void store_tile(const float (&acc)[BN / 2], const CUtensorMap* map,
                                           uint32_t ep, int wg, int n0, int row0, int M, int N,
                                           int e) {
  const int wi = threadIdx.x / 32 % 4, g = threadIdx.x % 32 / 4, t4 = threadIdx.x % 4;
  const bool leader = threadIdx.x % 128 == 0;
  if (leader) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  named_sync(1 + wg, 128);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = wi * 16 + g + hr * 8;
      const uint32_t addr = ep + (j / 8) * (64 * 128) + row * 128 +
                            (((j % 8) ^ (row % 8)) << 4) + t4 * 4;
      __nv_bfloat162 v = __floats2bfloat162_rn(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]);
      asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(*reinterpret_cast<uint32_t*>(&v))
                   : "memory");
    }
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  named_sync(1 + wg, 128);
  if (leader && row0 < M) {
    for (int bx = 0; bx < BOXES && n0 + bx * HALF < N; ++bx)
      tma_store(map, ep + bx * (64 * 128), n0 + bx * HALF, row0, e);
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  }
}

// Persistent: block b computes tiles b, b + gridDim.x, ... in the order
// (expert, row band, column tile), column tiles fastest, so the blocks in
// flight share their x row bands through L2. The ring runs on across tiles:
// the producer loads the next tile while the consumers store this one.
// With TA the A operand is x's transpose: x is (E, d, C), read as 64x64
// boxes of its rows (MN-major, C contiguous), one box per warpgroup, and
// wgmma transposes it, as it does w; C and d keep their roles (out rows,
// contraction), so the rest of the kernel is the same.
template <int TA>
__global__ void __launch_bounds__(THREADS, 1)
grouped_gemm_tc_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap wmap,
                       const __grid_constant__ CUtensorMap omap, int E, int C, int d, int f,
                       int x_swap, int w_swap) {
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle repeats every 1024 bytes: tiles start on that boundary
  const uint32_t base = (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) & ~1023u;
  const uint32_t epi = base + STAGES * STAGE_BYTES;
  const uint32_t full0 = epi + EPI_BYTES, empty0 = full0 + STAGES * 8;

  const int n_tiles = (f + BN - 1) / BN, m_tiles = (C + BM - 1) / BM;
  const int tiles = E * m_tiles * n_tiles, nk = (d + BK - 1) / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS * 4);    // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS * 4) {
    // producer: one thread keeps the ring full
    if (lane == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int n0 = tile % n_tiles * BN, m0 = tile / n_tiles % m_tiles * BM;
        const int e = tile / (n_tiles * m_tiles);
        const int boxes = min(BOXES, (f - n0 + HALF - 1) / HALF);   // boxes inside f
        for (int ks = 0; ks < nk; ++ks, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(empty0 + 8 * s, (it / STAGES - 1) & 1);
          const uint32_t a = base + s * STAGE_BYTES, b = a + A_BYTES, bar = full0 + 8 * s;
          // a map's two outer axes are in stride order (see launch)
          if (TA) {
            const int a_boxes = min(CONSUMERS, (C - m0 + HALF - 1) / HALF);  // boxes inside C
            mbar_expect_tx(bar, (a_boxes + boxes) * BOX_BYTES);
            for (int bx = 0; bx < a_boxes; ++bx)
              tma_load(a + bx * BOX_BYTES, &xmap, bar, m0 + bx * HALF, x_swap ? e : ks * BK,
                       x_swap ? ks * BK : e);
          } else {
            mbar_expect_tx(bar, A_BYTES + boxes * BOX_BYTES);
            tma_load(a, &xmap, bar, ks * BK, x_swap ? e : m0, x_swap ? m0 : e);
          }
          for (int bx = 0; bx < boxes; ++bx)
            tma_load(b + bx * BOX_BYTES, &wmap, bar, n0 + bx * HALF, w_swap ? e : ks * BK,
                     w_swap ? ks * BK : e);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of each tile
  const int wg = warp / 4;
  const bool leader = threadIdx.x % 128 == 0;
  const uint32_t ep = epi + wg * (64 * BN * 2);      // this warpgroup's rows of the out tile
  float acc[BN / 2];
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n0 = tile % n_tiles * BN, m0 = tile / n_tiles % m_tiles * BM;
    const int e = tile / (n_tiles * m_tiles);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    mma_steps<TA, 1>(acc, base, full0, empty0, wg, nk, it);
    store_tile(acc, &omap, ep, wg, n0, m0 + wg * 64, C, f, e);
  }
  if (leader) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// ---------------------------------------------------- the fused backward
// One persistent launch computes both products of a projection's backward:
// dW = X^T.dY (E, d, f) and dX = dY.W^T (E, C, d). Its work list holds
// dW's split-K units first (each 128x256 dW tile's contraction over C cut
// into `splits` ranges of whole 64-row k-steps), then dX's 128x256 tiles
// (a contraction of f, a few k-steps each). Block b takes item b first and
// then the next free item from an atomic counter, so the long dW units
// start at once and the short dX tiles fill the tail.
//
// dW: A is X read in place as its transpose (64x64 boxes of X's rows,
// MN-major, transposed by wgmma), B is dY's rows (64x64 boxes, MN-major).
// dX: A is dY's rows (K-major, as the forward's x), B is W read in place:
// W^T's columns are W's rows, so the B tile is one 256-row box of W's rows,
// 64 f columns wide, K-major, and wgmma reads it without the transpose bit.
//
// With splits > 1 each unit writes its fp32 partial (128x256, in the
// accumulators' fragment order, so every store is a full 16-byte vector)
// to the workspace and counts itself in on its tile's counter; once all
// `splits` units of the tile are in, each sums its 1/splits of the tile's
// partials in split order (0, 1, ..., splits-1: dW is the same bit for bit
// from run to run) and stores them as bf16. A unit waits for the others of
// its tile, so all units must run at once: the caller keeps them to one per
// SM, they are the first items, which the blocks take before any other, and
// the launch is cooperative, so every block is resident from the start.
constexpr int TSLOTS = 4;                 // ring of item ids, producer -> consumers
constexpr int PART_VEC = BM * BN / 4;       // float4s of one unit's partial
constexpr int BWD_SMEM_BYTES = STAGES * STAGE_BYTES + EPI_BYTES + 2 * STAGES * 8 +
                               2 * TSLOTS * 8 + TSLOTS * 4 + 1024;

struct BwdShape {
  int E, C, d, f, splits;
  int dw_tiles, dw_units, dx_tiles;  // 0 for a product not asked for
  int x_swap, dy_swap, w_swap;
  float* part;                       // dw_tiles x splits x 128 x 256 fp32 (splits > 1)
  __nv_bfloat16* dw;                 // (E, d, f), the split units' direct stores
  unsigned* counters;                // [0] next item, [1] producers done, [2 + tile] units in
};

struct Item {
  bool dw;
  int e, m0, n0, k0, k1, tile, split;
};

// item i of the work list: its product, expert, out tile and k-step range
__device__ __forceinline__ Item decode(const BwdShape& a, int i) {
  Item t;
  if (i < a.dw_units) {
    const int mt = (a.d + BM - 1) / BM, nt = (a.f + BN - 1) / BN, nk = (a.C + BK - 1) / BK;
    t.dw = true;
    t.tile = i % a.dw_tiles;
    t.split = i / a.dw_tiles;
    t.e = t.tile / (mt * nt);
    t.m0 = t.tile / nt % mt * BM;
    t.n0 = t.tile % nt * BN;
    t.k0 = (int)((long long)nk * t.split / a.splits);
    t.k1 = (int)((long long)nk * (t.split + 1) / a.splits);
  } else {
    const int j = i - a.dw_units, mt = (a.C + BM - 1) / BM, nt = (a.d + BN - 1) / BN;
    t.dw = false;
    t.tile = j;
    t.split = 0;
    t.e = j / (mt * nt);
    t.m0 = j / nt % mt * BM;
    t.n0 = j % nt * BN;
    t.k0 = 0;
    t.k1 = (a.f + BK - 1) / BK;
  }
  return t;
}

__device__ __forceinline__ void st_shared(uint32_t addr, int v) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ int ld_shared(uint32_t addr) {
  int v;
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// One unit's share of its tile's split-K reduction, by the 256 consumer
// threads: float4s [lo, hi) of the tile's partials (fragment order: the
// warpgroup, the accumulator quad j, the thread), each summed over the
// splits in order and stored as two bf16 pairs (rows r and r + 8).
__device__ __forceinline__ void reduce_slice(const BwdShape& a, const Item& t, const float4* part,
                                             int lo, int hi) {
  for (int q = lo + (int)threadIdx.x; q < hi; q += CONSUMERS * 128) {
    float4 v = __ldcg(part + q);
    for (int s = 1; s < a.splits; ++s) {
      const float4 u = __ldcg(part + (size_t)s * PART_VEC + q);
      v.x += u.x, v.y += u.y, v.z += u.z, v.w += u.w;
    }
    const int wg = q / (PART_VEC / CONSUMERS), j = q / 128 % (BN / 8), c = q % 128;
    const int row = t.m0 + wg * 64 + c / 32 * 16 + c % 32 / 4, col = t.n0 + 8 * j + 2 * (c % 4);
    if (col >= a.f) continue;
    __nv_bfloat16* out = a.dw + ((size_t)t.e * a.d + row) * a.f + col;
    if (row < a.d)
      *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(v.x, v.y);
    if (row + 8 < a.d)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * a.f) = __floats2bfloat162_rn(v.z, v.w);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
grouped_gemm_bwd_kernel(const __grid_constant__ CUtensorMap xmap,    // X, dW's A
                        const __grid_constant__ CUtensorMap dybmap,  // dY, dW's B
                        const __grid_constant__ CUtensorMap dyamap,  // dY, dX's A
                        const __grid_constant__ CUtensorMap wmap,    // W, dX's B
                        const __grid_constant__ CUtensorMap dxmap,
                        const __grid_constant__ CUtensorMap dwmap, const BwdShape a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) & ~1023u;
  const uint32_t epi = base + STAGES * STAGE_BYTES;
  const uint32_t full0 = epi + EPI_BYTES, empty0 = full0 + STAGES * 8;
  const uint32_t tfull0 = empty0 + STAGES * 8, tempty0 = tfull0 + TSLOTS * 8;
  const uint32_t ids = tempty0 + TSLOTS * 8;
  const int items = a.dw_units + a.dx_tiles;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS * 4);
    }
    for (int s = 0; s < TSLOTS; ++s) {
      mbar_init(tfull0 + 8 * s, 1);
      mbar_init(tempty0 + 8 * s, CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS * 4) {
    // producer: takes the next item, hands its id to the consumers through
    // the id ring, and keeps the stage ring full with its tiles
    if (lane == 0) {
      int it = 0;
      for (int n = 0;; ++n) {
        int i = n ? (int)gridDim.x + (int)atomicAdd(a.counters, 1u) : (int)blockIdx.x;
        if (i >= items) i = -1;
        const int slot = n % TSLOTS;
        if (n >= TSLOTS) mbar_wait(tempty0 + 8 * slot, (n / TSLOTS - 1) & 1);
        st_shared(ids + 4 * slot, i);
        mbar_arrive(tfull0 + 8 * slot);
        if (i < 0) break;
        const Item t = decode(a, i);
        for (int ks = t.k0; ks < t.k1; ++ks, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(empty0 + 8 * s, (it / STAGES - 1) & 1);
          const uint32_t sa = base + s * STAGE_BYTES, sb = sa + A_BYTES, bar = full0 + 8 * s;
          const int k = ks * BK;
          if (t.dw) {
            const int a_boxes = min(CONSUMERS, (a.d - t.m0 + HALF - 1) / HALF);
            const int b_boxes = min(BOXES, (a.f - t.n0 + HALF - 1) / HALF);
            mbar_expect_tx(bar, (a_boxes + b_boxes) * BOX_BYTES);
            for (int bx = 0; bx < a_boxes; ++bx)
              tma_load(sa + bx * BOX_BYTES, &xmap, bar, t.m0 + bx * HALF, a.x_swap ? t.e : k,
                       a.x_swap ? k : t.e);
            for (int bx = 0; bx < b_boxes; ++bx)
              tma_load(sb + bx * BOX_BYTES, &dybmap, bar, t.n0 + bx * HALF, a.dy_swap ? t.e : k,
                       a.dy_swap ? k : t.e);
          } else {
            mbar_expect_tx(bar, A_BYTES + B_BYTES);
            tma_load(sa, &dyamap, bar, k, a.dy_swap ? t.e : t.m0, a.dy_swap ? t.m0 : t.e);
            tma_load(sb, &wmap, bar, k, a.w_swap ? t.e : t.n0, a.w_swap ? t.n0 : t.e);
          }
        }
      }
      // every producer has taken its last id before it counts itself
      // done: the last one resets the item counters for the next launch
      __threadfence();
      if (atomicAdd(a.counters + 1, 1u) == gridDim.x - 1) {
        atomicExch(a.counters, 0u);
        atomicExch(a.counters + 1, 0u);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of each tile
  const int wg = warp / 4, ctid = threadIdx.x % 128;
  const bool leader = ctid == 0;
  const uint32_t ep = epi + wg * (64 * BN * 2);
  float acc[BN / 2];
  int it = 0;
  for (int n = 0;; ++n) {
    const int slot = n % TSLOTS;
    mbar_wait(tfull0 + 8 * slot, (n / TSLOTS) & 1);
    const int i = ld_shared(ids + 4 * slot);
    __syncwarp();
    if (lane == 0) mbar_arrive(tempty0 + 8 * slot);
    if (i < 0) break;
    const Item t = decode(a, i);
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
    const int row0 = t.m0 + wg * 64;
    if (!t.dw) {
      mma_steps<0, 0>(acc, base, full0, empty0, wg, t.k1 - t.k0, it);
      store_tile(acc, &dxmap, ep, wg, t.n0, row0, a.C, a.d, t.e);
      continue;
    }
    mma_steps<1, 1>(acc, base, full0, empty0, wg, t.k1 - t.k0, it);
    if (a.splits > 1) {
      float4* part = reinterpret_cast<float4*>(a.part) + (size_t)t.tile * a.splits * PART_VEC;
      float4* mine = part + (size_t)t.split * PART_VEC + wg * (PART_VEC / CONSUMERS) + ctid;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        __stcg(mine + j * 128,
               make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]));
      __threadfence();
      named_sync(3, CONSUMERS * 128);
      if (threadIdx.x == 0) {
        // in, then wait for the tile's other units; a second round of
        // arrivals, each after its wait, lets the last reset the counter
        unsigned* cnt = a.counters + 2 + t.tile;
        atomicAdd(cnt, 1u);
        while (ld_acquire(cnt) < (unsigned)a.splits) __nanosleep(64);
        if (atomicAdd(cnt, 1u) == 2u * a.splits - 1) atomicExch(cnt, 0u);
      }
      named_sync(3, CONSUMERS * 128);
      __threadfence();
      reduce_slice(a, t, part, PART_VEC * t.split / a.splits, PART_VEC * (t.split + 1) / a.splits);
      continue;
    }
    store_tile(acc, &dwmap, ep, wg, t.n0, row0, a.d, a.f, t.e);
  }
  if (leader) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// a 3-D bf16 map over (n2, n1, n0) elements, n0 contiguous, strides in
// elements; with swap the two outer axes are given in the other order, so
// the map's strides grow outward (an operand whose expert axis lies inside
// its rows, as the trunk's activations do)
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, long long n0, long long n1,
              long long n2, long long s1, long long s2, int box0, int box1, bool swap) {
  const cuuint64_t dims[3] = {(cuuint64_t)n0, (cuuint64_t)(swap ? n2 : n1),
                              (cuuint64_t)(swap ? n1 : n2)};
  const cuuint64_t strides[2] = {(cuuint64_t)(swap ? s2 : s1) * 2,
                                 (cuuint64_t)(swap ? s1 : s2) * 2};
  const cuuint32_t box[3] = {(cuuint32_t)box0, (cuuint32_t)(swap ? 1 : box1),
                             (cuuint32_t)(swap ? box1 : 1)};
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The current device's SM count; on first use on a device it also raises
// the kernels' shared-memory limits there (the attribute and the count
// belong to one device).
cudaError_t device_sms(int* out) {
  static int sms[repro::kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = repro::current_device(&dev);
  if (err != cudaSuccess) return err;
  if (!sms[dev]) {
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(grouped_gemm_tc_kernel<0>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(grouped_gemm_tc_kernel<1>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(grouped_gemm_bwd_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, BWD_SMEM_BYTES);
    if (err != cudaSuccess) return err;
    sms[dev] = n;
  }
  *out = sms[dev];
  return cudaSuccess;
}

template <int TA>
cudaError_t launch(const void* x, const void* w, void* out, int E, int C, int d, int f,
                   long long x_se, long long x_sc, long long w_se, long long w_sk,
                   cudaStream_t stream) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return cudaErrorNotSupported;
  CUtensorMap xm, wm, om;
  const bool x_swap = x_se < x_sc, w_swap = w_se < w_sk;
  // x is (E, C, d), or (E, d, C) with TA; x_sc is the stride of its rows
  const bool x_ok = TA ? make_map(enc, &xm, x, C, d, E, x_sc, x_se, HALF, BK, x_swap)
                       : make_map(enc, &xm, x, d, C, E, x_sc, x_se, BK, BM, x_swap);
  if (!x_ok ||
      !make_map(enc, &wm, w, f, d, E, w_sk, w_se, HALF, BK, w_swap) ||
      !make_map(enc, &om, out, f, C, E, f, (long long)C * f, HALF, 64, false))
    return cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t err = device_sms(&sms);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)E * ((C + BM - 1) / BM) * ((f + BN - 1) / BN);
  grouped_gemm_tc_kernel<TA><<<(int)(tiles < sms ? tiles : sms), THREADS, SMEM_BYTES, stream>>>(
      xm, wm, om, E, C, d, f, x_swap, w_swap);
  return cudaGetLastError();
}

// Both products of the backward (dX if dx, dW if dw) in one launch: six
// tensor maps (each operand in the box and order its product reads), the
// work list's sizes, and a grid of one block per SM or per item.
cudaError_t launch_bwd(const void* x, const void* w, const void* dy, void* dx, void* dw,
                       float* part, unsigned* counters, int E, int C, int d, int f, int splits,
                       long long x_se, long long x_sc, long long w_se, long long w_sk,
                       long long dy_se, long long dy_sc, cudaStream_t stream) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return cudaErrorNotSupported;
  BwdShape a;
  a.E = E, a.C = C, a.d = d, a.f = f, a.splits = splits;
  a.dw_tiles = dw ? E * ((d + BM - 1) / BM) * ((f + BN - 1) / BN) : 0;
  a.dw_units = a.dw_tiles * splits;
  a.dx_tiles = dx ? E * ((C + BM - 1) / BM) * ((d + BN - 1) / BN) : 0;
  a.x_swap = x_se < x_sc, a.dy_swap = dy_se < dy_sc, a.w_swap = w_se < w_sk;
  a.part = part, a.counters = counters, a.dw = static_cast<__nv_bfloat16*>(dw);
  // the maps of a product not asked for stay zero: no item reads them
  CUtensorMap xm = {}, dybm = {}, dyam = {}, wm = {}, dxm = {}, dwm = {};
  bool ok = true;
  if (dw)
    ok = make_map(enc, &xm, x, d, C, E, x_sc, x_se, HALF, BK, a.x_swap) &&
         make_map(enc, &dybm, dy, f, C, E, dy_sc, dy_se, HALF, BK, a.dy_swap) &&
         make_map(enc, &dwm, dw, f, d, E, f, (long long)d * f, HALF, 64, false);
  if (ok && dx)
    ok = make_map(enc, &dyam, dy, f, C, E, dy_sc, dy_se, BK, BM, a.dy_swap) &&
         make_map(enc, &wm, w, f, d, E, w_sk, w_se, BK, BN, a.w_swap) &&
         make_map(enc, &dxm, dx, d, C, E, d, (long long)C * d, HALF, 64, false);
  if (!ok) return cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t err = device_sms(&sms);
  if (err != cudaSuccess) return err;
  // split units wait for each other: each needs an SM of its own
  if (splits > 1 && a.dw_units > sms) return cudaErrorInvalidValue;
  // a cooperative launch: all blocks resident at once, or no launch
  const int items = a.dw_units + a.dx_tiles;
  void* args[] = {&xm, &dybm, &dyam, &wm, &dxm, &dwm, &a};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(grouped_gemm_bwd_kernel),
                                     dim3(items < sms ? items : sms), dim3(THREADS), args,
                                     BWD_SMEM_BYTES, stream);
}

}  // namespace tc

}  // namespace

// x: (E, C, d) with strides (x_se, x_sc, 1), or with trans_x (E, d, C)
// with strides (x_se, x_sc, 1), read as its transpose (the backward's
// dW = X^T.dY without a transposed copy); w: (E, d, f) with strides
// (w_se, w_sk, 1); out: contiguous (E, C, f). variant 0 runs the CUDA-core
// kernel (float32 or bfloat16, any strides, no trans_x); variant 1 the
// tensor-core kernel, which takes bfloat16 with x's row length (d, or C
// with trans_x, which also needs d > 0), f, x_se, x_sc, w_se and w_sk
// multiples of 8 and 16-byte-aligned pointers, and refuses anything else
// (the caller chooses; nothing falls back). Returns the CUDA error of the
// launch (0 on success).
extern "C" int grouped_gemm(const void* x, const void* w, void* out, int dtype, int variant,
                            int trans_x, int E, int C, int d, int f, long long x_se,
                            long long x_sc, long long w_se, long long w_sk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    const bool ok = dtype == repro::kBFloat16 && (trans_x ? C % 8 == 0 && d > 0 : d % 8 == 0) &&
                    f % 8 == 0 && x_se % 8 == 0 && x_sc % 8 == 0 && w_se % 8 == 0 &&
                    w_sk % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
    if (!ok) return cudaErrorInvalidValue;
    return trans_x ? tc::launch<1>(x, w, out, E, C, d, f, x_se, x_sc, w_se, w_sk, s)
                   : tc::launch<0>(x, w, out, E, C, d, f, x_se, x_sc, w_se, w_sk, s);
  }
  if (variant != 0 || trans_x) return cudaErrorInvalidValue;
  switch (dtype) {
    case repro::kFloat32:
      return launch_simt<float>(x, w, out, E, C, d, f, x_se, x_sc, w_se, w_sk, s);
    case repro::kBFloat16:
      return launch_simt<__nv_bfloat16>(x, w, out, E, C, d, f, x_se, x_sc, w_se, w_sk, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// Both products of the grouped GEMM's backward, bfloat16 on the tensor
// cores, in one launch: dx = dy.w^T (E, C, d) and dw = x^T.dy (E, d, f),
// each skipped where its pointer is null (both null: nothing to do). x:
// (E, C, d) with strides (x_se, x_sc, 1); w: (E, d, f) with (w_se, w_sk, 1);
// dy: (E, C, f) with (dy_se, dy_sc, 1); dx, dw contiguous. dW's contraction
// over C is cut into `splits` ranges of whole 64-row steps (1 <= splits <=
// ceil(C / 64), and with splits > 1 at most one unit, E * ceil(d/128) *
// ceil(f/256) * splits, per SM); with splits > 1, part is an fp32 workspace
// of E * ceil(d/128) * ceil(f/256) * splits * 128 * 256 floats. counters:
// 2 + E * ceil(d/128) * ceil(f/256) unsigned ints, zero before the launch
// and zero again after it (the kernel resets them; launches that share
// them must run one after another, as on one stream). Takes d, f, the
// strides multiples of 8, C > 0 and 16-byte-aligned pointers, and refuses
// anything else. Returns the CUDA error of the launch (0 on success).
extern "C" int grouped_gemm_bwd(const void* x, const void* w, const void* dy, void* dx, void* dw,
                                void* part, void* counters, int E, int C, int d, int f,
                                int splits, long long x_se, long long x_sc, long long w_se,
                                long long w_sk, long long dy_se, long long dy_sc, void* stream) {
  if (!dx && !dw) return cudaSuccess;
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool ok = E > 0 && C > 0 && d > 0 && f > 0 && d % 8 == 0 && f % 8 == 0 &&
                  x_se % 8 == 0 && x_sc % 8 == 0 && w_se % 8 == 0 && w_sk % 8 == 0 &&
                  dy_se % 8 == 0 && dy_sc % 8 == 0 && aligned(x) && aligned(w) &&
                  aligned(dy) && aligned(dx) && aligned(dw) && aligned(part) && counters &&
                  splits >= 1 && splits <= (C + tc::BK - 1) / tc::BK && (splits == 1 || part);
  if (!ok) return cudaErrorInvalidValue;
  return tc::launch_bwd(x, w, dy, dx, dw, static_cast<float*>(part),
                        static_cast<unsigned*>(counters), E, C, d, f, splits, x_se, x_sc, w_se,
                        w_sk, dy_se, dy_sc, static_cast<cudaStream_t>(stream));
}
