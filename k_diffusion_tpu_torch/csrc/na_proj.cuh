// K15: 2-D neighborhood attention with the out-projection and the residual
// fused into its epilogue, out = NA(q, k, v) @ w_out + skip, on
// channel-packed (b, h, w, c) bf16 maps, w_out (c, c) bf16, head dim E 32
// or 64, c <= 512 and c % 128 == 0 (the JAX dispatcher's test). The
// attention output is rounded to bf16 before the projection (the Pallas
// body's rounding point), the residual is added in f32 and the result is
// written once in bf16. Each query attends to its clamped ks x ks window,
// ks <= 7 (na2d.cuh).
//
// Replaces: k_diffusion_tpu/ops/pallas/na2d.py:_na_packed_proj_kernel (the
// forward of na2d_packed_proj).
//
// What bounds it on the H100: per query 4 x 49 x c FLOP of attention and
// 2 c^2 of projection against q, k, v, skip read and out written once (10 c
// bytes) and w_out: at the flagship's 8 x 64 x 64 x 128 level 20 + 26 FLOP
// per byte, far below the 295 at which the tensor cores become the limit,
// so it is bound by memory: 42 MB, 12.5 us at 3.35 TB/s. The composition it
// stands for (K2, a matmul, an add) also writes the attention output and
// the projection's output to device memory and reads them back.
//
// Design: a thread block cluster per (8 x 8 query tile, image), one rank per
// 64 channels; the grid is K2's, ((h / 8) (w / 8), c / 64, b), with clusters
// of c / 64 blocks (2, 4, 6 or 8, portable sizes) along y. Each block is
// one warpgroup with 6 (64, 64) tiles of shared memory, K2's 49 KB: four
// blocks an SM.
// 1. Attention. Rank r runs attn_fwd.cuh's attend() over NaQueries for the
//    head (E = 64) or the two heads (E = 32, one after the other on the
//    same ring) in channels [64 r, 64 r + 64), and rounds O / l to bf16
//    pairs that are already the register A operand of a wgmma product over
//    those channels (as P is for P V: wgmma.cuh's rows_product), its A
//    fragments. It writes them to the ring's last tile, fragment-major:
//    k16 slice kk of thread t at 16-byte word kk * 128 + t.
// 2. Cluster barrier; meanwhile the skip tile and the first two w_out
//    tiles are copied (cp.async).
// 3. Projection. Rank r computes output columns [64 r, 64 r + 64) of the
//    tile's 64 rows, sum over steps s of A_r' w_out[64 r' : 64 r' + 64,
//    64 r : 64 r + 64) with r' = (r + s) mod R: its own fragments first,
//    and at each step every rank reads a different peer. wgmma does not
//    read distributed shared memory, but its A operand may come from
//    registers: thread t reads its fragments of peer r' with four 16-byte
//    loads of the peer's shared memory, one step ahead, and no A tile is
//    copied or swizzled. w_out's tiles, the B operand (MN-major, in the
//    128-byte swizzle), come by cp.async two steps ahead through three
//    stages.
// 4. Epilogue: skip added in f32 to the accumulator's registers, the bf16
//    sum written in place of the skip tile and stored as 16-byte rows.
// 5. A second cluster barrier, arrived at once the last peer's fragments
//    are read and waited for at the end: no rank leaves while a peer reads
//    its fragments.
// No partials, no atomics: a rerun gives bit-equal output. With w_out = I
// and skip = 0 the output is K2's bit for bit (the product and the add are
// exact and round to the same bf16).
#pragma once

#include <cooperative_groups.h>

#include "attn_fwd.cuh"
#include "na2d.cuh"

namespace kdt {
namespace na_proj {

using namespace wg;

constexpr int T = TILE<64>;                  // elements of a (64, 64) tile
constexpr size_t SMEM = attn_fwd::SMEM<64>;  // 6 tiles and the alignment slack
// the ring's tiles after the attention: w_out's in tiles 0-2 (three
// stages), skip and then the output in 3, this rank's A fragments in 5
constexpr int W_STAGES = 3, SKIP_TILE = 3, A_TILE = 5;

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// a.q, a.k, a.v, a.out through a.sq (= sk = sv = so), the packed (b, h, w,
// c) strides; a.lse null. Rank r of a cluster is block y = r of the grid.
template <int E>
__global__ void __launch_bounds__(128, 4)
    na_proj_kernel(const attn_fwd::Args a, const bf16* __restrict__ skip,
                   const bf16* __restrict__ w_out, int h, int w, int ks) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ unsigned char smem_raw[];
  bf16* s = reinterpret_cast<bf16*>(aligned_smem(smem_raw));
  bf16* s_out = s + SKIP_TILE * T;
  // this rank's A operand as each thread's register fragments: k16 slice
  // kk of thread t at uint4 kk * 128 + t, so that a peer's thread t reads
  // its fragments with four 16-byte loads
  uint4* frag = reinterpret_cast<uint4*>(s + A_TILE * T);
  const int rank = blockIdx.y, ranks = gridDim.y, img = blockIdx.z;
  const long c = 64L * ranks;
  const NaQueries geo(blockIdx.x, h, w, ks);
  const auto own = [&](int i) { return geo.own(i); };

  // 1. the attention of the rank's channels, O / l rounded to bf16 as the
  // A fragments of a product over them (head g's columns are k16 slices
  // [g E / 16, (g + 1) E / 16)); at E = 32 two heads, on the same ring
  uint32_t a_frag[4][4];
#pragma unroll
  for (int g = 0; g < 64 / E; ++g) {
    float acc_o[E / 2];
    attn_fwd::attend<E, 1, false>(a, geo, rank * (64 / E) + g, img, s, acc_o);
#pragma unroll
    for (int kk = 0; kk < E / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        a_frag[g * E / 16 + kk][j] = pack_bf16(acc_o[8 * kk + 2 * j], acc_o[8 * kk + 2 * j + 1]);
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    frag[kk * 128 + threadIdx.x] = make_uint4(a_frag[kk][0], a_frag[kk][1], a_frag[kk][2],
                                              a_frag[kk][3]);

  // 2. starts the skip tile and the w_out tiles of steps 0 and 1, then
  // waits for every rank's A fragments
  const bf16* w_col = w_out + 64 * rank;
  const auto load_w = [&](int step) {  // one commit group a step, maybe empty
    if (step < ranks) {
      const long k0 = 64L * ((rank + step) % ranks);
      load_tile_async<64>(s + (step % W_STAGES) * T, w_col + k0 * c, c, 0, ROWS);
    }
    cp_async_commit();
  };
  cluster_arrive();  // this rank's A fragments are in place
  load_rows_async<64>(s_out, skip, a.so, img, rank, own);
  load_w(0);
  load_w(1);
  cluster_wait();

  // 3. the projection: step s multiplies A_r' (r' = rank + s; the own
  // fragments at s = 0) by w_out's tile (r', rank), read MN-major; the
  // next step's fragments are read from the peer meanwhile
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  for (int step = 0; step < ranks; ++step) {
    uint32_t next[4][4];
    if (step + 1 < ranks) {
      const uint4* src = cluster.map_shared_rank(static_cast<const uint4*>(frag),
                                                 (rank + step + 1) % ranks);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint4 v = src[kk * 128 + threadIdx.x];
        next[kk][0] = v.x;
        next[kk][1] = v.y;
        next[kk][2] = v.z;
        next[kk][3] = v.w;
      }
    }
    cp_async_wait<1>();  // this thread's copies of the step, visible to wgmma
    __syncthreads();     // and every thread's; step - 1's products are done
    rows_product<64>(acc, a_frag, s + (step % W_STAGES) * T);
    load_w(step + 2);    // into the stage step - 1 read
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(a_frag);
    if (step + 1 < ranks) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) a_frag[kk][j] = next[kk][j];
    }
  }
  cluster_arrive();  // this rank is done reading its peers' A fragments

  // 4. + skip in f32, rounded to bf16 in place of the skip tile, stored:
  // the thread's accumulator holds rows r and r + 8, columns 8 i + c (+1)
  const int lane = threadIdx.x & 31;
  const int r = (threadIdx.x / 32) * 16 + lane / 4, c2 = 4 * (lane & 3);
  unsigned char* base = reinterpret_cast<unsigned char*>(s_out);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      auto* pair = reinterpret_cast<__nv_bfloat162*>(base + swizzle<64>(r + 8 * hh, i) + c2);
      const float2 res = __bfloat1622float2(*pair);
      *pair = __floats2bfloat162_rn(acc[4 * i + 2 * hh] + res.x, acc[4 * i + 2 * hh + 1] + res.y);
    }
  __syncthreads();
  store_rows<64>(s_out, a.out, a.so, img, rank, own);

  // 5. no rank leaves while a peer may still read its A fragments
  cluster_wait();
}

// Launches K15 on (b, h, w, c) maps, c = 64 ranks; needs h % 8 == w % 8 == 0
// and 1 <= ks <= min(7, h, w). Returns the CUDA error code.
template <int E>
int launch(const attn_fwd::Args& a, const bf16* skip, const bf16* w_out, int b, int h, int w,
           int ks, int ranks, cudaStream_t st) {
  const cudaError_t attr = allow_smem(na_proj_kernel<E>, SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = ranks;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((h / TQ) * (w / TQ), ranks, b);
  cfg.blockDim = dim3(128);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = st;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, na_proj_kernel<E>, a, skip, w_out, h, w, ks));
}

}  // namespace na_proj
}  // namespace kdt
