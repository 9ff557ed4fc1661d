// 2-D neighborhood attention in float32 on Hopper, the kernels of
// --mixed-precision no for the HDiT's neighborhood levels: the forward
// with its logsumexp (K2 in f32 on channel-packed maps, na2d.cu; K11 in
// f32 on per-head maps at head dims 32, 64 and 128, na2d_heads.cu) and the
// two-kernel backward (K7 and K12 in f32). attn_tf32.cuh's forward body
// and attn_tf32_bwd.cuh's backward bodies (TF32 wgmma, tiles copied by TMA)
// run over na2d.cuh's neighborhood geometry, as na_fwd.cuh and na_bwd.cuh
// run the bf16 bodies. Each query attends to exactly ks x ks keys, its
// window start clamp(i - (ks - 1) / 2, 0, n - ks) on each axis (NATTEN's
// contract), ks <= 7.
//
// Replaces: k_diffusion_tpu/ops/pallas/na2d.py:_na_packed_fwd_kernel (K2)
// and :_na_fwd_kernel (K11), :_na_packed_dqkv_kernel (K7) and
// :_na_dq_kernel, :_na_dkv_kernel (K12), as they run on f32 operands (the
// JAX model built with dtype=float32): f32 dots with f32 accumulation.
// Here every product runs on the TF32 tensor cores (cvt.rna operands, f32
// accumulators); the softmax, lse and delta stay in f32.
//
// What bounds it on the H100: the forward does 2 products of 2 x 49 x e
// FLOP per query and head against q, k, v read and out written once in f32
// (16 e bytes per query and head, and the lse): 12 FLOP per byte, far below
// the 494.7 TFLOP/s / 3.35 TB/s = 148 at which the TF32 tensor cores
// become the limit. At the flagship's 8 x 64 x 64 x 128 (2 heads) that is
// 67 MB, 20 us: bound by memory. The backward reads q, k, v, out, dout and
// the lse and writes dq, dk, dv: 8 f32 maps, bound by memory too.
//
// Design: a block is one warpgroup (two at E = 128: attn_tf32.cuh's and
// attn_tf32_bwd.cuh's split bodies); its 64 own rows an 8 x 8 tile of one
// head of one image; the grid is (tiles, heads, batch).
// - na_tf32_wg_fwd_kernel and na_tf32_wg_dq_kernel: the own rows are a query
//   tile (NaQueries). The clamped union of its queries' windows, the halo,
//   streams past as 64-row f32 tiles of K and V, 4 halo rows of 16 key
//   slots each: 4 tiles at ks = 7, 2 at ks = 1.
// - na_tf32_wg_dkv_kernel: the own rows are a key tile (NaKeys). The
//   queries whose clamped windows reach it form a slab of at most 14 x 14
//   (Reach); they stream past with their lse and delta, 4 slab rows of 16
//   query slots a tile.
// A pair attends where the key lies in the query's window, tested on the
// logits' accumulator coordinates in registers before p becomes an
// operand; the TMA boxes zero-fill the slots past the map and carry the
// data of those past the halo or the slab, which the geometry rejects, not
// their values (their lse and delta are 0). A query that has no key in a
// tile keeps its running max at -inf and adds nothing (the forward's
// guard). The dq kernel forms delta = rowsum(out * dout); no atomics, so a
// rerun is bit-equal, and K2 / K11 (K7 / K12) on the same maps are bit for
// bit the same kernel.
//
// The forward's blocks are one warpgroup, two an SM, at E = 32 and 64
// (Q, two stages each of K and V and the P^T tile: 97.5 KB at 64) and two
// warpgroups, one an SM, at E = 128 (177.5 KB): attn_tf32.cuh's sizes. The
// backward's are one warpgroup, two an SM, at E = 32 and 64 (97.5 KB for
// dq, 113 KB for dk/dv at 64) and two warpgroups, one an SM, at E = 128
// (209.5 KB and 225 KB): attn_tf32_bwd.cuh's sizes. The copies are TMA
// boxes: an own tile is 8 x 8 positions, a streamed tile 4 halo (slab)
// rows of 16 slots.
//
// The kernels are written over MapStrides and the head dim E (32, 64 or
// 128), q, k and v each read through its own strides: K2 and K7 run them at
// E = 64 on channel-packed maps (the three stride sets equal), K11 and K12
// at 32, 64 and 128 on per-head maps (in the unfused prologue v is a
// strided third of the qkv projection, its row stride 3 c). Each head's row
// of E floats is contiguous and its strides are multiples of 4 elements,
// so every stride of a TMA box's map is a multiple of 16 bytes.
#pragma once

#include "attn_tf32.cuh"
#include "attn_tf32_bwd.cuh"
#include "na2d.cuh"

namespace kdt {
namespace na_tf32 {

template <int E>
__global__ void __launch_bounds__(tf32::FWD_THREADS<E>, tf32::FWD_BLOCKS<E>)
    na_tf32_wg_fwd_kernel(const tf32::Args a, const __grid_constant__ tf32::Maps m, int h, int w,
                          int ks) {
  tf32::wg_fwd_body<E>(a, m, NaQueries(blockIdx.x, h, w, ks));
}

template <int E>
__global__ void __launch_bounds__(tf32::BWD_THREADS<E>, tf32::BWD_BLOCKS<E>)
    na_tf32_wg_dq_kernel(const tf32::Args a, const __grid_constant__ tf32::Maps m, int h, int w,
                         int ks) {
  tf32::wg_dq_body<E>(a, m, NaQueries(blockIdx.x, h, w, ks));
}

template <int E>
__global__ void __launch_bounds__(tf32::BWD_THREADS<E>, tf32::BWD_BLOCKS<E>)
    na_tf32_wg_dkv_kernel(const tf32::Args a, const __grid_constant__ tf32::Maps m, int h, int w,
                          int ks) {
  tf32::wg_dkv_body<E>(a, m, NaKeys(blockIdx.x, h, w, ks));
}

// Launches the forward on (b, h, w, heads, E) f32 maps read and written
// through a's strides; lse (b, heads, h, w) f32 when a.lse is not null.
// Needs h % 8 == w % 8 == 0 and 1 <= ks <= min(7, h, w). Returns the CUDA
// error code.
template <int E>
int launch_fwd(const tf32::Args& a, int b, int h, int w, int ks, cudaStream_t st) {
  tf32::Maps m;
  const cudaError_t err = tf32::fwd_maps<E>(a, b, h, w, TQ, TQ, SLOTS, BANDS, true, m);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr size_t smem = tf32::FWD_SMEM<E>;
  const cudaError_t attr = allow_smem(na_tf32_wg_fwd_kernel<E>, smem);
  const dim3 grid((h / TQ) * (w / TQ), a.n_heads, b);
  na_tf32_wg_fwd_kernel<E><<<grid, tf32::FWD_THREADS<E>, smem, st>>>(a, m, h, w, ks);
  return launch_status(attr);
}

// Launches the dq kernel (which writes delta (b, heads, h, w) f32), then
// the dk/dv kernel, on (b, h, w, heads, E) f32 maps: q, k, v read through
// a.sq, a.sk, a.sv, out, dout, dq, dk, dv through a.io. h, w and ks as for
// the forward. Returns the CUDA error code.
template <int E>
int launch_bwd(const tf32::Args& a, int b, int h, int w, int ks, cudaStream_t st) {
  tf32::Maps dq, dkv;
  const cudaError_t err = tf32::bwd_maps<E>(a, b, h, w, TQ, TQ, SLOTS, BANDS, dq, dkv);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((h / TQ) * (w / TQ), a.n_heads, b);
  return tf32::launch_pair<E>(na_tf32_wg_dq_kernel<E>, na_tf32_wg_dkv_kernel<E>, grid, a, dq, dkv,
                              st, h, w, ks);
}

}  // namespace na_tf32
}  // namespace kdt
