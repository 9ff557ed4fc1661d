// The pipelined wgmma GEMM core of the attention prologue (K1 forward, K6
// backward: fused_qkv.cu) and of the feed-forward block (K4 forward, K10
// backward: geglu.cu), on wgmma.cuh's building blocks. Each of the four
// first kernels (qkv_fwd_kernel, ffn_fwd_kernel, qkv_dr_kernel,
// ffn_dup_kernel) normalises its x row tile once into resident tiles
// (load_x_tiles, norm_tiles) and streams weight tiles through the ring; the
// forwards finish in their epilogues, the backwards with the two kernels
// below.
//
// Both backwards end the same way: a cotangent dR (rows, K) of a projection
// R = AdaRMSNorm(x, nscale) @ W with W (d, K) becomes
// - dW = xn^T dR, reduced over every row (up to 32 * 4096 at the flagship's
//   level 0), and
// - dx and d(nscale) through dxn = dR @ W^T and the RMS-norm VJP.
// Each backward's first kernel (its own file) recomputes R on this core and
// forms dR in its epilogue; the two kernels here finish both.
//
// Operands are (64, 64) bf16 tiles in the 128-byte swizzle (wg::swizzle<64>,
// wg::desc<64>), copied through a ring of S stages: by cp.async in the
// backwards, by the Tensor Memory Accelerator in the forwards (below). A
// tile is
// read K-major for a product over its columns and MN-major (the transpose
// bit) for a product over its rows, which gives the three forms:
// - C = A B, B a row-major (K, N) weight: A K-major, B MN-major;
// - C = A B^T, B a row-major (N, K) weight: both K-major;
// - C = A^T B over rows (dW): both MN-major.
// Every product here is a wgmma m64n64k16 with both operands in shared
// memory (wgmma_ss) and f32 accumulators in registers (K4's down product
// with one warpgroup takes its A operand from registers, wgmma_rs); a
// warpgroup owns a 64-row output tile with one to six accumulator sets of
// 64 columns (32 registers a thread each), and a block is one warpgroup or
// two that share each weight tile. Each k step's copies are issued ahead,
// so copies overlap the products; one step's products stay in flight while
// the next step's are issued. Outputs are staged through a finished stage
// of the ring for 16-byte stores.
//
// Row reductions (dW, d(nscale), d(attn_scale)) are per-block f32 partials
// summed by reduce_kernel in a fixed order, never atomics: a rerun gives
// bit-equal gradients. A row tile never spans two images (RowTile), so the
// d(nscale) partials need no segmenting.
//
// The RMS-norm VJP without a row exchange. dx = r g1 - x (r^3 / d) sum(g1
// x) with g1 = dxn * nscale needs a sum over the whole row of dxn, whose
// columns lie in several blocks. But sum_c dxn_c xn_c = sum_k dR_k R_k
// (dxn = dR W^T, R = xn W), and xn = x * nscale * r up to its bf16
// rounding, so sum(g1 x) = sum_k dR_k R_k / r: the first kernel, which
// holds R and dR in registers, sums dR_k R_k over its columns into
// per-row partials, and the dxn kernel's epilogue is then row-local. The
// sum differs from the Pallas kernel's by the bf16 rounding of xn, a
// relative 2^-8 of a term that is itself small against r g1.
#pragma once

#include <cuda.h>

#include <cstdint>

#include "wgmma.cuh"

namespace kdt {
namespace gemm {

using namespace wg;

constexpr int THREADS = 128;  // one warpgroup
constexpr int T = TILE<64>;   // elements of one (64, 64) tile
constexpr int S = STAGES;     // stages of the ring

// Rows of one image in 64-row tiles: row tile `index` (by default block x
// of the grid) is tile `tile` of image `img`.
struct RowTile {
  long row0;
  int valid, img, tile;
};

__device__ __forceinline__ RowTile row_tile(int tokens, int index) {
  const int tiles = (tokens + ROWS - 1) / ROWS;
  const int img = index / tiles, tile = index % tiles;
  const int valid = tokens - tile * ROWS < ROWS ? tokens - tile * ROWS : ROWS;
  return {static_cast<long>(img) * tokens + static_cast<long>(tile) * ROWS, valid, img, tile};
}
__device__ __forceinline__ RowTile row_tile(int tokens) { return row_tile(tokens, blockIdx.x); }

// The thread's accumulator coordinates in wgmma's m64n64 layout: element
// 4 i + 2 h + e of a set lies at row acc_row(h), column 8 i + acc_col() + e.
__device__ __forceinline__ int acc_row(int h) {
  return (threadIdx.x / 32 % 4) * 16 + (threadIdx.x & 31) / 4 + 8 * h;
}
__device__ __forceinline__ int acc_col() { return 2 * (threadIdx.x & 3); }

// The pair of bf16 at row r, columns c and c + 1 (c even) of a swizzled tile.
__device__ __forceinline__ float2 read_pair(const bf16* tile, int r, int c) {
  const unsigned char* base = reinterpret_cast<const unsigned char*>(tile);
  return __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(base + swizzle<64>(r, c >> 3) + 2 * (c & 7)));
}

// Sum over the four lanes of a quad: a row's columns in one accumulator set.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Sum over the eight quads of a warp: a column's 16 rows.
__device__ __forceinline__ float column_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][32]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
}

// Keeps the compiler from reading the accumulators before the wgmma wait
// just above (fence_regs of every set).
template <int NT>
__device__ __forceinline__ void fence_acc(float (&acc)[NT][32]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) fence_regs(acc[j]);
}

// acc[j] (+)= A B_j over one 64-deep slab: A a (64, 64) tile, B_j the NT
// tiles from `b` on; TA / TB as wgmma_ss; `add` 0 overwrites acc (an output
// tile's first slab), so that no instruction but wgmma writes the
// accumulators inside a k loop. Issued, not committed.
template <int TA, int TB, int NT>
__device__ __forceinline__ void product(float (&acc)[NT][32], const bf16* a, const bf16* b,
                                        int add) {
  constexpr uint64_t step_a = TA ? ROW_STEP<64> : K_STEP, step_b = TB ? ROW_STEP<64> : K_STEP;
  const uint64_t da = desc<64>(a);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const uint64_t db = desc<64>(b + j * T);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<TA, TB>(acc[j], da + kk * step_a, db + kk * step_b, kk > 0 || add);
  }
}

// The ring: step k's tiles live in stage k % S. `load(k, stage)` starts the
// copies of step k's tiles; every step commits one group.
template <class Load>
__device__ __forceinline__ void ring_start(int steps, const Load& load) {
  for (int k = 0; k < S - 1; ++k) {
    if (k < steps) load(k, k);
    cp_async_commit();
  }
}

// Waits for step k's tiles, in every thread.
__device__ __forceinline__ void ring_arrive() {
  cp_async_wait<S - 2>();
  __syncthreads();
}

// After step k's products are issued and all but them are done: the stage
// of step k - 1 is free for step k + S - 1.
template <class Load>
__device__ __forceinline__ void ring_refill(int k, int steps, const Load& load) {
  __syncthreads();
  if (k + S - 1 < steps) load(k + S - 1, (k + S - 1) % S);
  cp_async_commit();
}

// The forwards' ring (K1, K4): weight tiles by the Tensor Memory
// Accelerator, S stages, one __syncthreads a step. Thread 0 starts each
// (64, 64) tile's copy (tma_tile: the copy engine computes the addresses
// and applies the 128-byte swizzle of wg::swizzle<64>) and counts its bytes
// on the stage's mbarrier, which completes a phase when they have landed;
// every thread waits on it (tma_step). Step s's barrier follows every
// thread's wgmma_wait<1> of step s - 1, so the products of step s - 2 are
// done in every warpgroup and their stage takes the copies of step s + S -
// 2 at once, before step s's products are issued: the copies overlap the
// products still in flight. tma_start issues steps 0 to S - 3; stages S - 2
// and S - 1 stay free until steps 0 and 1 refill them. The copies take no
// thread's registers or issue slots but thread 0's few.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}

// A (64, 64) bf16 tile at (col, row) of the row-major matrix of `map` into
// the swizzled tile at dst, its 8192 bytes counted on `bar`.
__device__ __forceinline__ void tma_tile(bf16* dst, const CUtensorMap* map, int col, int row,
                                         uint64_t* bar) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], 8192;\n" ::"r"(smem_u32(bar))
               : "memory");
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, "
      "{%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(smem_u32(bar))
      : "memory");
}

// Thread 0's arrival on `bar` once a step's tiles are started.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Waits for the phase of `bar` with the given parity to complete. A copy
// that never lands (a fault in the ring's bookkeeping) traps after some
// seconds instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  for (int i = 0;; ++i) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (i == 1 << 24) __trap();
  }
}

// Initialises the S stage barriers; every thread of the block calls it.
__device__ __forceinline__ void tma_init(uint64_t (&full)[S]) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < S; ++st) mbar_init(&full[st]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// `load(s, stage)`, called by thread 0, starts step s's tiles with
// tma_tile on full[stage] and arrives on it.
template <class Load>
__device__ __forceinline__ void tma_start(int steps, const Load& load) {
  if (threadIdx.x != 0) return;
  for (int k = 0; k < S - 2 && k < steps; ++k) load(k, k);
}

// Waits for step s's tiles in every thread and starts the copies of step s
// + S - 2. The caller then issues step s's products and waits for step s -
// 1's (wgmma_wait<1>).
template <class Load>
__device__ __forceinline__ void tma_step(int s, int steps, uint64_t (&full)[S], const Load& load) {
  mbar_wait(&full[s % S], (s / S) & 1);
  __syncthreads();
  if (threadIdx.x == 0 && s + S - 2 < steps) {
    // earlier plain reads and writes of the stage come before the copy's
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    load(s + S - 2, (s + S - 2) % S);
  }
}

// cuTensorMapEncodeTiled, which is looked up at run time: the libraries
// link the CUDA runtime only.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
inline cudaError_t encode_tiled(EncodeTiled* out) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess) return cudaErrorSymbolNotFound;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  *out = encode;
  return cudaSuccess;
}

// The tensor map of a row-major (rows, cols) matrix of `type` whose rows
// lie row_bytes apart, for (box_rows, box_cols) tiles in the 128-byte
// swizzle (box_cols elements are at most 128 bytes). A box past the
// matrix's edge reads zeros.
inline cudaError_t tensor_map(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                              long rows, long cols, long row_bytes, int box_cols, int box_rows) {
  EncodeTiled encode;
  const cudaError_t err = encode_tiled(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The tensor map of a row-major (rows, cols) bf16 matrix for (64, 64) tiles
// in the 128-byte swizzle (wg::swizzle<64>).
inline cudaError_t tile_map(CUtensorMap* map, const void* base, int rows, int cols) {
  return tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, rows, cols,
                    static_cast<long>(cols) * sizeof(bf16), 64, 64);
}

// The k loop of one output tile into acc: `mma(stage, k)` issues step k's
// products.
template <int NT, class Load, class Mma>
__device__ __forceinline__ void mainloop(float (&acc)[NT][32], int steps, const Load& load,
                                         const Mma& mma) {
  ring_start(steps, load);
  for (int k = 0; k < steps; ++k) {
    ring_arrive();
    wgmma_fence();
    mma(k % S, k);
    wgmma_commit();
    wgmma_wait<1>();
    ring_refill(k, steps, load);
  }
  wgmma_wait<0>();
  fence_acc(acc);
}

// The AdaRMSNorm prologue of a row tile of x (rows, d) bf16, in two
// halves. load_x_tiles starts the copy of the tile into d / 64 swizzled
// tiles from `tiles` on (rows past valid zero), to join the ring's first
// group; once that group has arrived (ring_arrive), norm_tiles takes each
// row's r = 1 / sqrt(mean(x^2) + eps) into s_r, two threads a row, and
// normalises the tiles in place with the row's image's nscale (d,) bf16:
// xn = bf16(x * bf16(nscale * r)), the JAX package's rounding point. Each x
// tile is normalised once. With xn_out and r_out, xn and r also go to
// device memory. The work goes to `nthreads` threads, this one number `tid`
// (the block, or one warpgroup normalising its own tile while the others
// normalise theirs); every thread of the block calls it, for its
// __syncthreads. A __syncthreads must follow before the tiles are read.
__device__ __forceinline__ void load_x_tiles(const bf16* x, const RowTile& t, int d,
                                             bf16* tiles) {
  const int r0 = static_cast<int>(t.row0);
  for (int k = 0; k < d / 64; ++k)
    load_tile_async<64>(tiles + k * T, x + 64 * k, d, r0, r0 + t.valid);
}

__device__ inline void norm_tiles(const RowTile& t, int d, const bf16* ns, float eps, bf16* tiles,
                                  float* s_r, bf16* xn_out, float* r_out, int tid, int nthreads) {
  unsigned char* base = reinterpret_cast<unsigned char*>(tiles);
  auto chunk = [&](int row, int c) {  // 16-byte chunk c of a row of the tile
    return reinterpret_cast<uint4*>(base + (c / 8) * T * sizeof(bf16) + swizzle<64>(row, c % 8));
  };
  const int chunks = d / 8;
  if (tid < 2 * ROWS) {
    const int row = tid / 2, half = tid & 1;
    float ss = 0.f;
    for (int c = half * chunks / 2; c < (half + 1) * chunks / 2; ++c) {
      const uint4 v = *chunk(row, c);
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(p[e]);
        ss += f.x * f.x + f.y * f.y;
      }
    }
    ss += __shfl_xor_sync(0xffffffffu, ss, 1);
    if (half == 0) s_r[row] = rsqrtf(ss / d + eps);
  }
  __syncthreads();
  for (int i = tid; i < ROWS * chunks; i += nthreads) {
    const int row = i / chunks, c = i % chunks;
    if (row >= t.valid) continue;  // zero already
    uint4 v = *chunk(row, c);
    const uint4 sv = *reinterpret_cast<const uint4*>(ns + c * 8);
    bf16* ve = reinterpret_cast<bf16*>(&v);
    const bf16* se = reinterpret_cast<const bf16*>(&sv);
    const float r = s_r[row];
#pragma unroll
    for (int e = 0; e < 8; ++e) ve[e] = to_bf(to_f(ve[e]) * bf_round(to_f(se[e]) * r));
    *chunk(row, c) = v;
    if (xn_out != nullptr) *reinterpret_cast<uint4*>(xn_out + (t.row0 + row) * d + c * 8) = v;
  }
  if (r_out != nullptr && tid < t.valid) r_out[t.row0 + tid] = s_r[tid];
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the tiles feed wgmma
}

// Stages a pair of output values at row r, columns c and c + 1 (c even) of
// a swizzled tile, for store_tile.
__device__ __forceinline__ void stage_pair(bf16* tile, int r, int c, __nv_bfloat162 v) {
  unsigned char* base = reinterpret_cast<unsigned char*>(tile);
  *reinterpret_cast<__nv_bfloat162*>(base + swizzle<64>(r, c >> 3) + 2 * (c & 7)) = v;
}

// A (rows, K) bf16 operand held in two parts by columns: columns [0, split)
// at p0 (row stride ld0), the rest at p1 (row stride ld1). K6's dR is (dq,
// dk) in its own buffer and gv as the model gave it.
struct Split {
  const bf16* p0;
  long ld0;
  int split;
  const bf16* p1;
  long ld1;
  __device__ const bf16* col(int c) const { return c < split ? p0 + c : p1 + (c - split); }
  __device__ long ld(int c) const { return c < split ? ld0 : ld1; }
};

// dxn = dR W^T (dR (rows, K) a Split, W (d, K) row-major) for one row tile
// and NT 64-column panels of d, and the RMS-norm VJP in the epilogue, per
// row with r from the first kernel and s, the fixed-order sum over its
// `groups` partials dot_part (groups, rows) (the note above):
//   dx = r dxn nscale - x (r^2 / d) s  (+ res, the block's own residual)
// and the tile's d(nscale) partial, the sum over its rows of dxn x r, into
// dns_part (images * tiles, d). Grid (images * tiles, d / (64 NT)).
template <int NT>
__global__ void __launch_bounds__(THREADS)
norm_vjp_kernel(Split dr, const bf16* __restrict__ w, const bf16* __restrict__ x,
                const bf16* __restrict__ nscale, const bf16* __restrict__ res,
                const float* __restrict__ r_rows, const float* __restrict__ dot_part, int groups,
                bf16* __restrict__ dx, float* __restrict__ dns_part, long n_rows, int tokens,
                int d, int k_dim) {
  extern __shared__ unsigned char smem_raw[];
  bf16* s_x = reinterpret_cast<bf16*>(aligned_smem(smem_raw));  // NT tiles of x, then of res
  bf16* s_ring = s_x + 2 * NT * T;  // stage st: the dR tile, then NT W tiles
  float* s_red = reinterpret_cast<float*>(s_ring + S * (1 + NT) * T);  // 4 warps x 64 NT

  const RowTile t = row_tile(tokens);
  const int n0 = blockIdx.y * 64 * NT, r0 = static_cast<int>(t.row0);
  const int end = r0 + t.valid;
  // x and res join the first step's group
  for (int j = 0; j < NT; ++j) {
    load_tile_async<64>(s_x + j * T, x + n0 + 64 * j, d, r0, end);
    if (res != nullptr) load_tile_async<64>(s_x + (NT + j) * T, res + n0 + 64 * j, d, r0, end);
  }
  auto load = [&](int k, int st) {
    bf16* stage = s_ring + st * (1 + NT) * T;
    const int k0 = 64 * k;
    load_tile_async<64>(stage, dr.col(k0), dr.ld(k0), r0, end);
    for (int j = 0; j < NT; ++j)
      load_tile_async<64>(stage + (1 + j) * T, w + k0, k_dim, n0 + 64 * j, d);
  };
  float acc[NT][32];
  zero(acc);
  mainloop(acc, k_dim / 64, load, [&](int st, int k) {
    const bf16* stage = s_ring + st * (1 + NT) * T;
    product<0, 0>(acc, stage, stage + T, k);
  });

  float r[2], coef[2];
  bool ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    ok[h] = acc_row(h) < t.valid;
    const long row = t.row0 + (ok[h] ? acc_row(h) : 0);
    float s = 0.f;
    for (int g = 0; g < groups; ++g) s += dot_part[g * n_rows + row];
    r[h] = r_rows[row];
    coef[h] = r[h] * r[h] * s / d;
  }
  const bf16* ns = nscale + static_cast<long>(t.img) * d + n0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = 64 * j + 8 * i + acc_col();
      const float2 nv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(ns + col));
      float p0 = 0.f, p1 = 0.f;  // this column pair's d(nscale) terms
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = acc_row(h);
        const float d0 = acc[j][4 * i + 2 * h], d1 = acc[j][4 * i + 2 * h + 1];
        const float2 xv = read_pair(s_x + j * T, row, col - 64 * j);
        float v0 = r[h] * d0 * nv.x - xv.x * coef[h], v1 = r[h] * d1 * nv.y - xv.y * coef[h];
        if (res != nullptr) {
          const float2 rv = read_pair(s_x + (NT + j) * T, row, col - 64 * j);
          v0 += rv.x;
          v1 += rv.y;
        }
        stage_pair(s_ring + j * T, row, col - 64 * j, __floats2bfloat162_rn(v0, v1));
        if (ok[h]) {
          p0 += d0 * xv.x * r[h];
          p1 += d1 * xv.y * r[h];
        }
      }
      p0 = column_sum(p0);
      p1 = column_sum(p1);
      if (lane < 4) {
        s_red[warp * 64 * NT + col] = p0;
        s_red[warp * 64 * NT + col + 1] = p1;
      }
    }
  __syncthreads();
  for (int j = 0; j < NT; ++j)
    store_tile<64>(s_ring + j * T, dx + t.row0 * d + n0 + 64 * j, d, t.valid);
  for (int c = threadIdx.x; c < 64 * NT; c += blockDim.x)
    dns_part[static_cast<long>(blockIdx.x) * d + n0 + c] =
        s_red[c] + s_red[64 * NT + c] + s_red[2 * 64 * NT + c] + s_red[3 * 64 * NT + c];
}

// dW partials: part[chunk] (m, n) = A[rows of chunk]^T B[rows of chunk]
// for A (rows, m) bf16 (row stride lda) and B (rows, n) a Split, f32
// accumulation. Grid (m / 64, n / (64 NT), chunks): a block owns a 64 x
// 64 NT output tile and walks its chunk's rows in 64-row steps, both
// operands read MN-major.
template <int NT>
__global__ void __launch_bounds__(THREADS)
atb_kernel(const bf16* __restrict__ a, long lda, Split b, float* __restrict__ part, int rows,
           int m, int n, int chunk_rows) {
  extern __shared__ unsigned char smem_raw[];
  bf16* s_ring = reinterpret_cast<bf16*>(aligned_smem(smem_raw));  // stage: A, then NT B tiles
  const int m0 = blockIdx.x * 64, n0 = blockIdx.y * 64 * NT;
  const int begin = blockIdx.z * chunk_rows;
  const int end = begin + chunk_rows < rows ? begin + chunk_rows : rows;
  auto load = [&](int k, int st) {
    bf16* stage = s_ring + st * (1 + NT) * T;
    const int k0 = begin + 64 * k;
    load_tile_async<64>(stage, a + m0, lda, k0, end);
    for (int j = 0; j < NT; ++j)
      load_tile_async<64>(stage + (1 + j) * T, b.col(n0 + 64 * j), b.ld(n0 + 64 * j), k0, end);
  };
  float acc[NT][32];
  zero(acc);
  mainloop(acc, (end - begin + 63) / 64, load, [&](int st, int k) {
    const bf16* stage = s_ring + st * (1 + NT) * T;
    product<1, 1>(acc, stage, stage + T, k);
  });
  float* out = part + (static_cast<long>(blockIdx.z) * m + m0) * n + n0;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(out + static_cast<long>(acc_row(h)) * n + 64 * j + 8 * i +
                                   acc_col()) =
            make_float2(acc[j][4 * i + 2 * h], acc[j][4 * i + 2 * h + 1]);
}

// out (outer, m) = sum over c < n of in (outer, n, m), c ascending.
__global__ void reduce_kernel(const float* __restrict__ in, float* __restrict__ out, int outer,
                              int n, long m) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= outer * m) return;
  const long o = i / m, col = i % m;
  const float* src = in + o * n * m + col;
  float s = 0.f;
  for (int c = 0; c < n; ++c) s += src[c * m];
  out[i] = s;
}

// The same sum where the outputs are few and n is long (K6's d(attn_scale),
// 2 heads' sums over thousands of row tiles): a block per output, its
// threads' strided partial sums added in a fixed tree. Grid (m, outer).
__global__ void reduce_few_kernel(const float* __restrict__ in, float* __restrict__ out, int n,
                                  long m) {
  __shared__ float s[256];
  const float* src = in + blockIdx.y * n * m + blockIdx.x;
  float v = 0.f;
  for (int c = threadIdx.x; c < n; c += 256) v += src[c * m];
  s[threadIdx.x] = v;
  __syncthreads();
  for (int w = 128; w > 0; w >>= 1) {
    if (static_cast<int>(threadIdx.x) < w) s[threadIdx.x] += s[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.y * m + blockIdx.x] = s[0];
}

inline cudaError_t launch_reduce(const float* in, float* out, int outer, int n, long m,
                                 cudaStream_t st) {
  const long total = outer * m;
  if (total < 1024 && n > 256)
    reduce_few_kernel<<<dim3(static_cast<unsigned>(m), outer), 256, 0, st>>>(in, out, n, m);
  else
    reduce_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, st>>>(in, out, outer, n,
                                                                               m);
  return cudaGetLastError();
}

// Allows `smem` bytes of dynamic shared memory for `kernel` and asks for the
// largest shared-memory carveout, so that as many blocks share an SM as
// their shared memory allows.
template <class Kernel>
inline cudaError_t allow_shared(Kernel kernel, size_t smem) {
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// Shared memory of each kernel: its tiles and the slack to align them.
template <int NT>
constexpr size_t NORM_VJP_SMEM =
    (2 * NT + S * (1 + NT)) * T * sizeof(bf16) + 4 * 64 * NT * sizeof(float) + 1024;
template <int NT>
constexpr size_t ATB_SMEM = S * (1 + NT) * T * sizeof(bf16) + 1024;

template <int NT>
cudaError_t launch_norm_vjp_nt(const Split& dr, const bf16* w, const bf16* x, const bf16* nscale,
                               const bf16* res, const float* r, const float* dot_part,
                               int groups, bf16* dx, float* dns_part, int images, int tokens,
                               int d, int k_dim, cudaStream_t st) {
  const cudaError_t attr = allow_shared(norm_vjp_kernel<NT>, NORM_VJP_SMEM<NT>);
  if (attr != cudaSuccess) return attr;
  const int tiles = (tokens + ROWS - 1) / ROWS;
  norm_vjp_kernel<NT><<<dim3(images * tiles, d / (64 * NT)), THREADS, NORM_VJP_SMEM<NT>, st>>>(
      dr, w, x, nscale, res, r, dot_part, groups, dx, dns_part,
      static_cast<long>(images) * tokens, tokens, d, k_dim);
  return cudaGetLastError();
}

// Launches norm_vjp_kernel and the reduction of its partials into dns
// (images, d) f32; dns_part holds images * ceil(tokens / 64) * d floats.
inline cudaError_t launch_norm_vjp(const Split& dr, const bf16* w, const bf16* x,
                                   const bf16* nscale, const bf16* res, const float* r,
                                   const float* dot_part, int groups, bf16* dx, float* dns_part,
                                   float* dns, int images, int tokens, int d, int k_dim,
                                   cudaStream_t st) {
  const cudaError_t err =
      d % 128 == 0 ? launch_norm_vjp_nt<2>(dr, w, x, nscale, res, r, dot_part, groups, dx,
                                           dns_part, images, tokens, d, k_dim, st)
                   : launch_norm_vjp_nt<1>(dr, w, x, nscale, res, r, dot_part, groups, dx,
                                           dns_part, images, tokens, d, k_dim, st);
  if (err != cudaSuccess) return err;
  return launch_reduce(dns_part, dns, images, (tokens + ROWS - 1) / ROWS, d, st);
}

template <int NT>
cudaError_t launch_atb_nt(const bf16* a, long lda, const Split& b, float* part, int rows, int m,
                          int n, int chunk_rows, int chunks, cudaStream_t st) {
  const cudaError_t attr = allow_shared(atb_kernel<NT>, ATB_SMEM<NT>);
  if (attr != cudaSuccess) return attr;
  atb_kernel<NT><<<dim3(m / 64, n / (64 * NT), chunks), THREADS, ATB_SMEM<NT>, st>>>(
      a, lda, b, part, rows, m, n, chunk_rows);
  return cudaGetLastError();
}

// Launches the dW partials of A^T B over chunks of chunk_rows rows and
// their reduction into dw (m, n) f32; part holds ceil(rows / chunk_rows) *
// m * n floats.
inline cudaError_t launch_atb(const bf16* a, long lda, const Split& b, float* part, float* dw,
                              int rows, int m, int n, int chunk_rows, cudaStream_t st) {
  const int chunks = (rows + chunk_rows - 1) / chunk_rows;
  const cudaError_t err =
      n % 128 == 0 ? launch_atb_nt<2>(a, lda, b, part, rows, m, n, chunk_rows, chunks, st)
                   : launch_atb_nt<1>(a, lda, b, part, rows, m, n, chunk_rows, chunks, st);
  if (err != cudaSuccess) return err;
  return launch_reduce(part, dw, 1, chunks, static_cast<long>(m) * n, st);
}

}  // namespace gemm
}  // namespace kdt
