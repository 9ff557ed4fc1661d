// The backward of 2-D neighborhood attention on Hopper (K7 on
// channel-packed maps, K12 on per-head maps at head dims 32, 64 and 128): dq,
// dk and dv written once in bf16 by two wgmma kernels, attn_bwd.cuh's two
// bodies run over the neighborhood geometry. Each query attends to exactly
// ks x ks keys, its window start clamp(i - (ks - 1) / 2, 0, n - ks) on each
// axis (NATTEN's contract), ks <= 7.
//
// Replaces: k_diffusion_tpu/ops/pallas/na2d.py:_na_packed_dqkv_kernel (K7,
// the backward of na2d_packed: dq and per-tile dk/dv halo partials) and
// :_overlap_add_kernel (the overlap-add of those partials into dk and dv),
// which this design folds into its second kernel; and :_na_dq_kernel,
// :_na_dkv_kernel (K12, the backward of na2d, _na_bwd), whose delta =
// rowsum(out * dout) the JAX package forms outside the kernels and this
// design's dq kernel forms from tiles it already holds. The overlap-add
// kernel K8 stays in na2d.cu, held against its plain version on its own op
// path.
//
// What bounds it on the H100: the function reads q, k, v, out and dout
// (bf16) and the lse (f32) and writes dq, dk and dv (bf16): at the
// flagship's 8 x 64 x 64 x 128 (2 heads) that is 8 x 8.39 MB + 0.26 MB =
// 67.4 MB, 20 us at 3.35 TB/s, against 5 products of 2 x 49 x 64 FLOP per
// query and head, 2.06 GFLOP, 2 us at 989 TFLOP/s: bound by memory.
//
// Design: a block is one warpgroup, its 64 own rows an 8 x 8 tile, wgmma's
// M, of one head of one image; the grid is (tiles, heads, batch).
// - na_dq_kernel: the own rows are a query tile (na2d.cuh's NaQueries, as
//   in the forward, na_fwd.cuh). The clamped union of its queries' windows,
//   the halo, streams past as 64-row tiles of K and V, 4 halo rows of 16
//   key slots each: 4 tiles at ks = 7.
// - na_dkv_kernel: the own rows are a key tile (NaKeys). The queries whose
//   clamped windows reach it form a slab of at most 14 x 14 (Reach); they
//   stream past with their lse and delta, 4 slab rows of 16 query slots a
//   tile.
// A pair attends where the key lies in the query's window, tested on the
// accumulator's coordinates in registers; the slot layout makes a column's
// key (or query) row and column a shift and a mask of its index.
//
// The four limits of the design this replaces (one wmma block a query
// tile writing f32 halo partials, K8 summing them):
// 1. Occupancy: a block holds 8 (64, 64) bf16 tiles and statistics, 66.5
//    KB (attn_bwd.cuh's SMEM), not 193.5 KB: three blocks an SM, not one.
// 2. The logits and dP stay in wgmma's f32 accumulators; p and ds are
//    formed there and rounded to bf16 pairs that are already the next
//    product's register A operand. No shared-memory strips, no scalar loop
//    over them.
// 3. Products run over 64-key (or 64-query) tiles of the halo (slab) only:
//    dq = ds k over 4 tiles, not over the 208 halo keys of every query's
//    row; dk and dv are register accumulators of the key tile, not 104
//    wmma fragments summed over warps from shared memory.
// 4. No partials: dk and dv of a key tile are summed in registers over the
//    slab in a fixed order and written once in bf16 (no atomics: reruns are
//    bit-equal). The 2 x 218 MB of f32 partials a launch at batch 32,
//    written and read back, are gone.
// Geometry not taken: two tiles of 7 halo rows (98 keys). The dq product
// over keys needs a depth that is a multiple of 16 (112), and S and dP of
// 112 columns take 56 accumulator registers each where 64 take 32.
//
// The kernels are written over MapStrides and the head dim E (wgmma.cuh's
// tiles take 32, 64 and 128). K7 runs them at E = 64 on channel-packed
// maps, one stride set for q, k and v; K12 (na2d_heads.cu) at E = 32, 64
// and 128 with OWN_V, q, k and v each through its own strides (in the
// unfused training step v is a strided third of the qkv projection, its
// row stride 3 c). At E = 128 (attn_bwd.cuh's PARK and dkv_pairs_body)
// the dq kernel parks Q and dO in its ring's last stage and reads out for
// delta from device memory, two blocks an SM; the dk/dv block is two
// warpgroups taking alternate query tiles, each with dk and dv over all
// 128 columns in its registers, their partials summed at the end, one
// block an SM. Tried first and slower at both of the NA-128 flagship's
// levels: each warpgroup owning 64 of the columns and forming every
// tile's S^T and dP^T itself, the work of S^T and dP^T done twice.
// Each head's row of E bf16 is contiguous and its strides are multiples of
// 8 elements, so every 16-byte cp.async stays aligned.
#pragma once

#include "attn_bwd.cuh"
#include "na2d.cuh"

namespace kdt {
namespace na_bwd {

// OWN_V: k and v read through their own strides (K12), else through q's.
template <int E, bool OWN_V>
__global__ void __launch_bounds__(128) na_dq_kernel(const attn_bwd::Args a, int h, int w,
                                                    int ks) {
  attn_bwd::dq_body<E, OWN_V>(a, NaQueries(blockIdx.x, h, w, ks));
}

// At most 168 registers a thread, so that three blocks fit on an SM; at E =
// 128 a block of two warpgroups taking alternate query tiles
// (dkv_pairs_body), one an SM.
template <int E, bool OWN_V>
__global__ void __launch_bounds__(128 * attn_bwd::DKV_WG<E>, E == 128 ? 1 : 3)
    na_dkv_kernel(const attn_bwd::Args a, int h, int w, int ks) {
  if constexpr (E == 128) attn_bwd::dkv_pairs_body<E, OWN_V>(a, NaKeys(blockIdx.x, h, w, ks));
  else attn_bwd::dkv_body<E, OWN_V>(a, NaKeys(blockIdx.x, h, w, ks));
}

// Launches the dq kernel, then the dk/dv kernel, on (b, h, w, heads, E)
// maps: q, k, v read through a.in (or a.sk, a.sv with OWN_V), out and dout
// through a.io; writes delta (b, heads, h, w) f32 and dq, dk, dv through
// a.io, bf16. Needs h % 8 == w % 8 == 0 and 1 <= ks <= min(7, h, w).
// Returns the CUDA error code.
template <int E, bool OWN_V>
int launch(const attn_bwd::Args& a, int b, int h, int w, int ks, cudaStream_t st) {
  constexpr size_t dq_smem = attn_bwd::DQ_SMEM<E>, smem = attn_bwd::DKV_SMEM<E>;
  const dim3 grid((h / TQ) * (w / TQ), a.n_heads, b);
  cudaError_t attr = allow_smem(na_dq_kernel<E, OWN_V>, dq_smem);
  na_dq_kernel<E, OWN_V><<<grid, 128, dq_smem, st>>>(a, h, w, ks);
  const int status = launch_status(attr);
  if (status != 0) return status;
  attr = allow_smem(na_dkv_kernel<E, OWN_V>, smem);
  na_dkv_kernel<E, OWN_V><<<grid, 128 * attn_bwd::DKV_WG<E>, smem, st>>>(a, h, w, ks);
  return launch_status(attr);
}

}  // namespace na_bwd
}  // namespace kdt
