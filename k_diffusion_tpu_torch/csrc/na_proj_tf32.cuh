// K15 in float32: 2-D neighborhood attention with the out-projection and
// the residual fused into its epilogue, out = NA(q, k, v) @ w_out + skip,
// on channel-packed (b, h, w, c) f32 maps, w_out (c, c) f32, head dim E 32
// or 64, c <= 512 and c % 128 == 0 (K15's contract). The attention output
// O / l stays in f32 until the projection reads it (the JAX f32 body's
// rounding point), the residual is added in f32 and the result is written
// once in f32. Each query attends to its clamped ks x ks window, ks <= 7
// (na2d.cuh).
//
// Replaces: k_diffusion_tpu/ops/pallas/na2d.py:_na_packed_proj_kernel (the
// forward of na2d_packed_proj) as it runs on f32 operands: f32 dots with
// f32 accumulation. Here every product runs on the TF32 tensor cores
// (cvt.rna operands, f32 accumulators); the softmax stays in f32.
//
// What bounds it on the H100: per query 4 x 49 x c FLOP of attention and
// 2 c^2 of projection against q, k, v, skip read and out written once in
// f32 (20 c bytes) and w_out: at the flagship's 8 x 64 x 64 x 128 level 10
// + 13 FLOP per byte, far below the 148 at which the TF32 tensor cores
// become the limit, so it is bound by memory: 84 MB, 25 us at 3.35 TB/s.
//
// Design: na_proj.cuh's cluster layout on attn_tf32.cuh's TF32 forward. A
// thread block cluster per (8 x 8 query tile, image), one rank per 64
// channels; the grid is ((h / 8) (w / 8), c / 64, b), clusters of c / 64
// blocks (2, 4, 6 or 8, portable sizes) along y. Each block is one
// warpgroup, two blocks an SM (97.5 KB of shared memory at E = 64, 74.5 KB
// at 32).
// 1. Attention. Rank r runs attn_tf32.cuh's fwd_attend over NaQueries (S^T
//    = K Q^T and O^T += V^T P^T on TF32 wgmma, the tiles copied by TMA) for
//    the head (E = 64) or the two heads (E = 32, one after the other on the
//    same ring) in channels [64 r, 64 r + 64), and writes O / l in f32, as
//    the forward K2-f32 computes it, to its O tile: (64, 64) padded to 68
//    floats a row, over the attention's tiles at E = 64 (free once its
//    products are done), past them at 32 (the first head's O waits there
//    while the second's runs).
// 2. The first w_out tile is copied (cp.async) into the ring, free once the
//    attention is done; a cluster barrier: every rank's O is in place.
// 3. Projection. Rank r computes output columns [64 r, 64 r + 64) of the
//    tile's 64 rows, sum over steps s of O_r' w_out[64 r' : 64 r' + 64,
//    64 r : 64 r + 64) with r' = (r + s) mod R, its own O first: mma.sync
//    m16n8k8 TF32 with the A fragments read from the peer's O tile over
//    distributed shared memory (32-bit loads, as from its own) and the B
//    fragments from w_out's f32 tiles, two stages by cp.async one step
//    ahead, padded to 72 floats a row so that the MN-major B loads stay
//    conflict-free (72 mod 32 = 8). This projection is the last mma.sync
//    body of the float32 attention kernels.
// 4. A cluster barrier arrived at once the last peer's O is read, the
//    epilogue (skip added in f32 from device memory, f32 stores), and the
//    wait at the end: no rank leaves while a peer reads its O.
// No partials, no atomics: a rerun gives bit-equal output. With w_out = I
// and skip = 0 the output is K2-f32's (E = 64) or K11-f32's (E = 32) O
// rounded once to TF32 (the product with 1 and the sums of zeros are
// exact): within 2^-11 of it, element by element.
#pragma once

#include <cooperative_groups.h>

#include "attn_tf32.cuh"
#include "na2d.cuh"

namespace kdt {
namespace na_proj_tf32 {

constexpr int LDO = 68;                      // f32 row stride of the O tile
constexpr int LDW = 72;                      // f32 row stride of a w_out tile
constexpr int O_BYTES = 64 * LDO * 4;        // the O tile
constexpr int W_BYTES = 2 * 64 * LDW * 4;    // the w_out ring's two stages
// where the O tile and the w_out ring lie at head dim E, and the bytes of
// shared memory the block takes
template <int E>
constexpr int O_OFF = E == 32 ? tf32::FWD_BYTES<32> : 0;
template <int E>
constexpr int W_OFF = E == 32 ? 0 : O_BYTES;
template <int E>
constexpr int BYTES = tf32::FWD_BYTES<E> > O_OFF<E> + O_BYTES ? tf32::FWD_BYTES<E>
                                                                : O_OFF<E> + O_BYTES;
template <int E>
constexpr size_t SMEM = BYTES<E> + 1024;
static_assert(W_OFF<32> + W_BYTES <= O_OFF<32> && W_OFF<64> + W_BYTES <= BYTES<64>,
              "the w_out ring fits beside the O tile");

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// d += a b: m16n8k8, a row-major (16 x 8), b column-major (8 x 8), TF32
// operands, f32 accumulators (the projection's product).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The rounded A fragment of rows [m0, m0 + 16), columns [k0, k0 + 8) of an
// O tile (its own or a peer's): a[i] = X[row g (+8)][k0 + t (+4)].
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const float* tile, int m0, int k0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* p = tile + (m0 + g) * LDO + k0 + t;
  a[0] = tw::to_tf32(p[0]);
  a[1] = tw::to_tf32(p[8 * LDO]);
  a[2] = tw::to_tf32(p[4]);
  a[3] = tw::to_tf32(p[8 * LDO + 4]);
}

// acc[n] (16 x 8 block n of 16 x 64) += X W over 64: X rows [m0, m0 + 16)
// of an O tile, W a (64, 64) tile padded to LDW.
__device__ __forceinline__ void mma_xw(float (&acc)[8][4], const float* x_tile, int m0,
                                       const float* w_tile) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    uint32_t a[4];
    frag_a(a, x_tile, m0, 8 * kk);
    const float* p = w_tile + (8 * kk + t) * LDW + g;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      mma(acc[n], a, tw::to_tf32(p[8 * n]), tw::to_tf32(p[4 * LDW + 8 * n]));
  }
}

// a.q, a.k, a.v, a.out through a.sq (= sk = sv = io), the packed (b, h, w,
// c) strides; a.lse null; m the maps of q, k and v (attn_tf32.cuh's
// fwd_maps). Rank r of a cluster is block y = r of the grid.
template <int E>
__global__ void __launch_bounds__(128, 2)
    na_proj_tf32_kernel(const tf32::Args a, const __grid_constant__ tf32::Maps m,
                        const float* __restrict__ skip, const float* __restrict__ w_out, int h,
                        int w, int ks) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* s = wg::aligned_smem(smem_raw);
  uint64_t* bar = tf32::init_bars<tf32::FWD_BARS>(smem_raw, s, BYTES<E>);
  float* s_o = reinterpret_cast<float*>(s + O_OFF<E>);
  float* s_w = reinterpret_cast<float*>(s + W_OFF<E>);
  const int rank = blockIdx.y, ranks = gridDim.y, img = blockIdx.z;
  const long c = 64L * ranks;
  const int warp = threadIdx.x / 32, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const NaQueries geo(blockIdx.x, h, w, ks);

  // 1. the attention of the rank's channels, O / l to its O tile (head hd's
  // columns [hd E, hd E + E)); at E = 32 two heads, one after the other
#pragma unroll 1
  for (int hd = 0; hd < 64 / E; ++hd) {
    if (hd > 0) __syncthreads();  // the first head's tiles are free
    float acc_o[1][32], inv[16];
    tf32::fwd_attend<E>(a, m, geo, rank * (64 / E) + hd, img, s, bar, hd, acc_o, inv);
    // O^T's element 4 i + 2 hh + e: e row 16 warp + g + 8 hh, query 8 i + 2
    // t + e
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = 16 * warp + g + 8 * hh;
        if (row >= E) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          s_o[(8 * i + 2 * t + e) * LDO + hd * E + row] =
              acc_o[0][4 * i + 2 * hh + e] * inv[2 * i + e];
      }
  }

  // 2. w_out's tile of step 0 (every product of the attention is done:
  // fwd_attend ends past a barrier), then every rank's O in place
  const float* w_col = w_out + 64 * rank;
  const auto load_w = [&](int step, float* tile) {
    const long k0 = 64L * ((rank + step) % ranks);
    const uint32_t dst = wg::smem_u32(tile);
    for (int i = threadIdx.x; i < 64 * 16; i += blockDim.x) {
      const int r = i / 16, ch = i % 16;
      wg::cp_async16(dst + (r * LDW + ch * 4) * 4, w_col + (k0 + r) * c + ch * 4, true);
    }
    wg::cp_async_commit();
  };
  load_w(0, s_w);
  cluster_arrive();  // this rank's O is in place
  cluster_wait();

  // 3. the projection: step s multiplies O_r' (r' = rank + s; its own at s
  // = 0) by w_out's tile (r', rank)
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int step = 0; step < ranks; ++step) {
    if (step + 1 < ranks) {
      load_w(step + 1, s_w + ((step + 1) & 1) * 64 * LDW);
      wg::cp_async_wait<1>();
    } else {
      wg::cp_async_wait<0>();
    }
    __syncthreads();
    const float* o = cluster.map_shared_rank(s_o, (rank + step) % ranks);
    mma_xw(acc, o, 16 * warp, s_w + (step & 1) * 64 * LDW);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cluster_arrive();  // this rank is done reading its peers' O

  // 4. + skip in f32, stored: the thread's accumulator holds rows 16 warp +
  // g (+ 8), columns 8 n + 2 t (+ 1) of the rank's 64
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const wg::Pos p = geo.own(16 * warp + g + 8 * hh);
    const long at = a.io.at(img, p.y, p.x, rank, 64) + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 res = *reinterpret_cast<const float2*>(skip + at + 8 * n);
      *reinterpret_cast<float2*>(a.out + at + 8 * n) =
          make_float2(acc[n][2 * hh] + res.x, acc[n][2 * hh + 1] + res.y);
    }
  }

  // no rank leaves while a peer may still read its O
  cluster_wait();
}

// Launches K15-f32 on (b, h, w, c) f32 maps, c = 64 ranks; needs h % 8 == w
// % 8 == 0 and 1 <= ks <= min(7, h, w). Encodes the maps of q, k and v.
// Returns the CUDA error code.
template <int E>
int launch(const tf32::Args& a, const float* skip, const float* w_out, int b, int h, int w,
           int ks, int ranks, cudaStream_t st) {
  tf32::Maps m;
  cudaError_t err = tf32::fwd_maps<E>(a, b, h, w, TQ, TQ, SLOTS, BANDS, false, m);
  if (err == cudaSuccess) err = allow_smem(na_proj_tf32_kernel<E>, SMEM<E>);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = ranks;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((h / TQ) * (w / TQ), ranks, b);
  cfg.blockDim = dim3(128);
  cfg.dynamicSmemBytes = SMEM<E>;
  cfg.stream = st;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  return static_cast<int>(
      cudaLaunchKernelEx(&cfg, na_proj_tf32_kernel<E>, a, m, skip, w_out, h, w, ks));
}

}  // namespace na_proj_tf32
}  // namespace kdt
