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
// "simt", everything else (fp32, ragged f such as 53, misaligned views): the
// CUDA-core kernel. A block of 256 threads computes a 64x64 tile, each
// thread a 4x4 patch in fp32 registers; the contraction runs in steps of 16
// through shared memory, with x kept transposed. Ragged C, d and f are
// masked on load and on store, and x and w may be strided on their two
// leading axes.
#include <cuda.h>
#include <stdint.h>

#include "common.cuh"

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

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// returns once the barrier's phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// d (64x256 fp32, wgmma's fragment layout) += a (64x16, K-major, or
// MN-major with TA) . b (16x256, MN-major)
template <int TA>
__device__ __forceinline__ void wgmma(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA));
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
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
  const int wg = warp / 4, wi = warp % 4, g = lane / 4, t4 = lane % 4;
  const bool leader = threadIdx.x % 128 == 0;
  const uint32_t ep = epi + wg * (64 * BN * 2);      // this warpgroup's rows of the out tile
  float acc[BN / 2];
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n0 = tile % n_tiles * BN, m0 = tile / n_tiles % m_tiles * BM;
    const int e = tile / (n_tiles * m_tiles);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int ks = 0; ks < nk; ++ks, ++it) {
      const int s = it % STAGES;
      mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
      const uint32_t a = base + s * STAGE_BYTES + wg * 64 * 128, b = base + s * STAGE_BYTES + A_BYTES;
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // A: rows of 128 bytes, 8-row groups 1024 bytes apart; a k16 step is
        // 32 bytes along the (swizzled) row (with TA: k rows of 128 bytes,
        // the 64 C rows of this warpgroup's box, a k16 step 16 rows, as B).
        // B: k rows of 128 bytes (64 f columns), 8-row groups 1024 bytes
        // apart, the next 64 columns one box (8 KB) on; a k16 step is 16 rows.
        wgmma<TA>(acc,
                  TA ? sw128_desc(a + kk * 16 * 128, BOX_BYTES, 1024)
                     : sw128_desc(a + kk * 32, 16, 1024),
                  sw128_desc(b + kk * 16 * 128, BOX_BYTES, 1024));
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
    }

    // epilogue: bf16 into this warpgroup's rows of the out tile, as 64x64
    // boxes in the 128-byte swizzle of the out map, once the previous
    // tile's TMA store has read them; then one TMA store per box
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
        asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr),
                     "r"(*reinterpret_cast<uint32_t*>(&v))
                     : "memory");
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    named_sync(1 + wg, 128);
    if (leader && m0 + wg * 64 < C) {
      for (int bx = 0; bx < BOXES && n0 + bx * HALF < f; ++bx)
        tma_store(&omap, ep + bx * (64 * 128), n0 + bx * HALF, m0 + wg * 64, e);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
  }
  if (leader) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// cuTensorMapEncodeTiled, looked up at run time through the runtime's
// entry-point query, so the library links without libcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
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
  // per device: its SM count, 0 until the kernel's shared-memory limit is
  // raised there (the attribute and the count belong to one device)
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
    if (err != cudaSuccess) return err;
    sms[dev] = n;
  }
  const long long tiles = (long long)E * ((C + BM - 1) / BM) * ((f + BN - 1) / BN);
  grouped_gemm_tc_kernel<TA><<<(int)(tiles < sms[dev] ? tiles : sms[dev]), THREADS, SMEM_BYTES,
                               stream>>>(
      xm, wm, om, E, C, d, f, x_swap, w_swap);
  return cudaGetLastError();
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
