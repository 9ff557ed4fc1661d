// The TF32 mma.sync GEMM core of the float32 mapping network K5 and of
// the float32 feed-forward block's wide route (geglu_f32.cu's
// ffn_f32_up_kernel and ffn_f32_down_kernel: K4 at d past 512, h through
// device memory). The float32 forwards K1 and K4 (d up to 512) and the
// backwards K6 and K10 run on gemm_tf32_wg.cuh's TF32 wgmma core.
//
// Why mma.sync here: wgmma takes TF32 B operands K-major only, and these
// products read their weights MN-major (C = A B, W read along its rows) as
// the model holds them, with no rounded transposed copy. So every product
// here is a warp-level mma.sync m16n8k8 (tf32 x tf32 -> f32; operands
// rounded by cvt.rna, 10 mantissa bits), whose fragments are gathered from
// f32 tiles in shared memory one 32-bit load each.
//
// A block is 8 warps and owns a 128-row output tile and NT accumulator
// sets of 64 columns; warp w owns rows [16 w, 16 w + 16) of every set
// (acc[j][n]: the 16 x 8 block n, 32 registers a set). A thread thus holds
// rows g and g + 8 (g = lane / 4) at columns 8 n + 2 t and 8 n + 2 t + 1
// (t = lane % 4) of each set: a 64-column panel's every column of a row
// lies in one quad of lanes. Why 128 rows: a step's tiles come from L2 or
// device memory, and a 64 x 64 f32 output tile does 16 FLOP a byte of
// them, where eight warps sharing each B tile do 21 (NT = 1) or 32 (NT =
// 2).
//
// The depth streams in steps of 32 through a ring of two stages filled by
// 16-byte cp.async, one commit group a step, step s + 1's copies in flight
// while step s's products run; a stage holds the A tile and the NT B tiles
// of one step. (A third stage, or 64-deep steps, ran slower on an H100:
// more shared memory a block, fewer blocks an SM.) A tile keeps its rows
// as they lie in memory, padded so that every fragment load is
// conflict-free:
// - A, K-major (128 rows of A's M index, 32 depth columns), row stride 36
//   floats (4 mod 32): fragment element (row g, depth t) at bank 4 g + t;
// - B, MN-major (32 depth rows, 64 columns of B's N index), row stride 72
//   floats (8 mod 32): element (depth t, column g) at bank 8 t + g.
// That is C = A B with A K-major and B MN-major. Rows of A past its M
// extent, and depth rows of B past the depth's end, are zero-filled by the
// copy's source size; A's depth is a multiple of 32 everywhere here (d,
// d_ff with d, d_ff multiples of 64).
#pragma once

#include <cstdint>

#include "gemm.cuh"

namespace kdt {
namespace tg {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 16 * WARPS;  // rows of a block's output tile, A's M
constexpr int BK = 32;            // depth of a ring step
constexpr int STAGES = 2;
constexpr int LDK = BK + 4;       // row stride of the K-major A tile
constexpr int LDB = 64 + 8;       // row stride of an MN-major B tile
constexpr int A_TILE = ROWS * LDK;
constexpr int B_TILE = BK * LDB;

// Shared memory of a core loop with NT sets: its ring.
template <int NT>
constexpr size_t RING_BYTES = STAGES * (A_TILE + NT * B_TILE) * sizeof(float);

// Row tiles of `tokens` rows an image: ROWS rows, the last one ragged.
__host__ __device__ inline int tiles(int tokens) { return (tokens + ROWS - 1) / ROWS; }

// Rows of one image in ROWS-row tiles: block x of the grid is tile `tile`
// of image `img`, `valid` rows from row0 of the (images * tokens, ...)
// operand. A tile never spans two images, so it takes one norm scale.
struct RowTile {
  long row0;
  int valid, img, tile;
};
__device__ __forceinline__ RowTile row_tile(int tokens) {
  const int n = tiles(tokens), img = blockIdx.x / n, tile = blockIdx.x % n;
  const int valid = tokens - tile * ROWS < ROWS ? tokens - tile * ROWS : ROWS;
  return {static_cast<long>(img) * tokens + static_cast<long>(tile) * ROWS, valid, img, tile};
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// d += a b: m16n8k8, TF32 operands, f32 accumulators.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][8][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[j][n][0] = acc[j][n][1] = acc[j][n][2] = acc[j][n][3] = 0.f;
}

__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }
// The tile row of a thread's accumulator element h (0: row g, 1: row g + 8).
__device__ __forceinline__ int acc_row(int h) { return 16 * (threadIdx.x / 32) + lane_g() + 8 * h; }

// Starts the copy of the K-major A tile: rows [r0, r0 + ROWS) of a (row
// stride ld; rows at or past r_end zero), depth columns [k0, k0 + 32).
__device__ __forceinline__ void load_a(float* tile, const float* a, long ld, long r0, long r_end,
                                       int k0) {
  const uint32_t dst = wg::smem_u32(tile);
  for (int i = threadIdx.x; i < ROWS * 8; i += THREADS) {
    const int r = i >> 3, c = (i & 7) * 4;
    const bool ok = r0 + r < r_end;
    wg::cp_async16(dst + (r * LDK + c) * 4, a + (ok ? r0 + r : r0) * ld + k0 + c, ok);
  }
}

// Starts the copy of an MN-major B tile: depth rows [k0, k0 + 32) of b (row
// stride ld; rows at or past k_end zero), columns [c0, c0 + 64).
__device__ __forceinline__ void load_b(float* tile, const float* b, long ld, long k0, long k_end,
                                       int c0) {
  const uint32_t dst = wg::smem_u32(tile);
  for (int i = threadIdx.x; i < BK * 16; i += THREADS) {
    const int r = i / 16, c = (i % 16) * 4;
    const bool ok = k0 + r < k_end;
    wg::cp_async16(dst + (r * LDB + c) * 4, b + (ok ? k0 + r : k0) * ld + c0 + c, ok);
  }
}

// The identity on an A element: a product's A taken as it is.
struct Plain {
  __device__ float operator()(float v, int, int) const { return v; }
};

// The AdaRMSNorm of a normalised product's A, x (rows, d), folded into the
// product: R = xn W = r ((x nscale) W), r = 1 / sqrt(mean(x^2) + eps) per
// row. Each A element x at depth k enters as x nscale[k] (the image's
// scale, staged in shared memory by load_scale), and its square joins the
// sum of its row (h: the thread's row g or g + 8), so that row_norms gives
// r after the loop: a thread quad sees every column of its rows once. No
// pass over the x tile before the products, and no second read of it.
struct Normed {
  const float* s_ns;
  float ss[2] = {0.f, 0.f};
  __device__ float operator()(float v, int k, int h) {
    ss[h] += v * v;
    return v * s_ns[k];
  }
};

// acc[j] += A B_j over the depth [k_begin, k_end): A rows [a0, a0 + ROWS)
// of `a` (row stride lda; those at or past a_end zero), B_j the columns
// [b0[j], b0[j] + 64) of `b` (row stride ldb). `f(v, k, h)` maps each A
// element at depth k in the thread's row h before its TF32 rounding
// (Normed: the norm folded into the product). Ends with the ring drained
// and every thread past it, so that the caller may reuse the ring.
template <int NT, class F>
__device__ __forceinline__ void mainloop(float (&acc)[NT][8][4], float* ring, const float* a,
                                         long lda, long a0, long a_end, const float* b, long ldb,
                                         const int (&b0)[NT], long k_begin, long k_end, F&& f) {
  const int steps = static_cast<int>((k_end - k_begin + BK - 1) / BK);
  constexpr int STAGE = A_TILE + NT * B_TILE;
  auto load = [&](int s, int st) {
    float* stage = ring + st * STAGE;
    const long k0 = k_begin + static_cast<long>(s) * BK;
    load_a(stage, a, lda, a0, a_end, static_cast<int>(k0));
#pragma unroll
    for (int j = 0; j < NT; ++j) load_b(stage + A_TILE + j * B_TILE, b, ldb, k0, k_end, b0[j]);
  };
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s, s);
    wg::cp_async_commit();
  }
  const int g = lane_g(), t = lane_t(), m0 = 16 * (threadIdx.x / 32);
  for (int s = 0; s < steps; ++s) {
    wg::cp_async_wait<STAGES - 2>();
    __syncthreads();  // step s has landed everywhere; every warp is done with step s - 1
    if (s + STAGES - 1 < steps) load(s + STAGES - 1, (s + STAGES - 1) % STAGES);
    wg::cp_async_commit();
    const float* sa = ring + (s % STAGES) * STAGE;
    const int k0 = static_cast<int>(k_begin) + s * BK;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t fa[4];
      const float* p = sa + (m0 + g) * LDK + kk + t;
      fa[0] = to_tf32(f(p[0], k0 + kk + t, 0));
      fa[1] = to_tf32(f(p[8 * LDK], k0 + kk + t, 1));
      fa[2] = to_tf32(f(p[4], k0 + kk + t + 4, 0));
      fa[3] = to_tf32(f(p[8 * LDK + 4], k0 + kk + t + 4, 1));
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float* sb = sa + A_TILE + j * B_TILE;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float* q = sb + (kk + t) * LDB + 8 * n + g;
          mma(acc[j][n], fa, to_tf32(q[0]), to_tf32(q[4 * LDB]));
        }
      }
    }
  }
  wg::cp_async_wait<0>();
  __syncthreads();
}

// Stages the image's norm scale (d,) f32 in shared memory for Normed; the
// core loop's first barrier orders it before any product reads it.
__device__ __forceinline__ void load_scale(const float* __restrict__ ns_row, int d, float* s_ns) {
  for (int c = 4 * threadIdx.x; c < d; c += 4 * THREADS)
    *reinterpret_cast<float4*>(s_ns + c) = *reinterpret_cast<const float4*>(ns_row + c);
}

// r of the thread's two rows once a Normed loop has run: the quad's sums
// of squares over every column (rows past the tile's end are zero-filled,
// r of a zero row).
__device__ __forceinline__ void row_norms(const Normed& f, int d, float eps, float (&r)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) r[h] = rsqrtf(gemm::quad_sum(f.ss[h]) / d + eps);
}

// Shared memory of a kernel with a normalised product: s_ns (d), ROWS
// floats, then the ring, 16-byte aligned (d is a multiple of 64).
template <int NT>
inline size_t normed_smem(int d) {
  return (d + ROWS) * sizeof(float) + RING_BYTES<NT>;
}

}  // namespace tg
}  // namespace kdt
