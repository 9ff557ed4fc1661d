// The forward of 2-D neighborhood attention on Hopper, shared by K2
// (na2d.cu, channel-packed (b, h, w, heads * 64) maps) and K11
// (na2d_heads.cu, (b, h, w, heads, e) maps read through their strides, e
// 32, 64 or 128): attn_fwd.cuh's wgmma body run over the neighborhood
// geometry.
// Each query attends to exactly ks x ks keys, its window start clamp(i -
// (ks - 1) / 2, 0, n - ks) on each axis (NATTEN's contract), ks <= 7.
//
// Replaces: k_diffusion_tpu/ops/pallas/na2d.py:_na_packed_fwd_kernel (K2,
// the forward of na2d_packed) and :_na_fwd_kernel (K11, the forward of
// na2d). Both write out and, when a backward follows, each query's lse =
// max + log(sum) in f32, (b, heads, h, w).
//
// What bounds it on the H100: 2 products of 2 x 49 x e FLOP per query and
// head against q, k, v read and out written once (8 e bytes per query and
// head, and the lse): 24.5 FLOP per byte, far below the 295 at which the
// tensor cores become the limit. At the flagship's 8 x 64 x 64 x 128 (2
// heads) that is 33.5 MB, 10 us at 3.35 TB/s: bound by memory.
//
// Design: a block is one warpgroup, its 64 own rows an 8 x 8 query tile
// (na2d.cuh's NaQueries), of one head of one image; the grid is (tiles,
// heads, batch). The clamped union of the tile's windows, the halo,
// streams past as 64-row tiles of K and V, 4 halo rows of 16 key slots
// each, through attn_fwd.cuh's 3-stage cp.async ring: 4 tiles at ks = 7,
// 2 at ks = 1. The logits, the online softmax and the output stay in
// wgmma's f32 accumulators; each pair is masked to the query's window on
// the accumulator's coordinates in registers, every column of every tile
// (zero-filled slots past the halo or the map would give a logit of 0);
// a row that has no key in a tile keeps its running max at -inf and adds
// nothing (attn_fwd.cuh's guard).
//
// The three limits of the design this replaces (a wmma kernel over the 112
// halo keys a warp's queries can reach, K11's at e = 128 until wgmma.cuh's
// tiles took 128: 0.1490 and 0.0664 ms at the NA-128 flagship's 64^2 x 1
// and 32^2 x 2 heads, batch 8, behind masked SDPA's 0.0331 at 32^2):
// 1. Its logits went to f32 strips in shared memory, the softmax was a
//    scalar loop over them, the probabilities came back as bf16 for the
//    P V product and the output took a second trip through the strip.
//    Here p is rounded to bf16 pairs that are already the register A
//    operand of O += P V.
// 2. It fetched the whole 208-row K and V halo and then computed, with
//    nothing in flight; here two tiles are in flight while wgmma runs.
// 3. A block took 96.5 KB (two blocks an SM; 160.5 KB at e = 128, one);
//    here 6 tiles, 49 KB at e = 64, and at most 128 registers: four blocks
//    an SM. At e = 128 the 6 tiles take 97 KB (each two 128-byte-swizzled
//    column halves, wgmma.cuh) and a thread holds 64 accumulators of O
//    beside the 32 logits and Q's 32 fragment registers: two blocks an SM.
#pragma once

#include "attn_fwd.cuh"
#include "na2d.cuh"

namespace kdt {
namespace na_fwd {

// OWN_V: v read through its own strides (K11), else from k's offsets. At
// most 128 registers a thread, four blocks an SM; at E = 128 two (6 tiles
// of 16 KB, and 64 accumulators of O a thread beside the logits).
template <int E, bool OWN_V>
__global__ void __launch_bounds__(128, E == 128 ? 2 : 4)
    na_fwd_kernel(const attn_fwd::Args a, int h, int w, int ks) {
  attn_fwd::body<E, 1, OWN_V>(a, NaQueries(blockIdx.x, h, w, ks));
}

// Launches the forward on (b, h, w, heads, E) maps read and written through
// a's strides; lse (b, heads, h, w) f32 when a.lse is not null. Needs h % 8
// == w % 8 == 0 and 1 <= ks <= min(7, h, w). Returns the CUDA error code.
template <int E, bool OWN_V>
int launch(const attn_fwd::Args& a, int b, int h, int w, int ks, cudaStream_t st) {
  constexpr size_t smem = attn_fwd::SMEM<E>;
  const cudaError_t attr = allow_smem(na_fwd_kernel<E, OWN_V>, smem);
  const dim3 grid((h / TQ) * (w / TQ), a.n_heads, b);
  na_fwd_kernel<E, OWN_V><<<grid, 128, smem, st>>>(a, h, w, ks);
  return launch_status(attr);
}

}  // namespace na_fwd
}  // namespace kdt
