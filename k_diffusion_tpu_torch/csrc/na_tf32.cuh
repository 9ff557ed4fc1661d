// 2-D neighborhood attention in float32 on Hopper, the kernels of
// --mixed-precision no for the HDiT's neighborhood levels: the forward
// with its logsumexp (K2 in f32 on channel-packed maps, na2d.cu; K11 in
// f32 on per-head maps at head dims 32, 64 and 128, na2d_heads.cu) and the
// two-kernel backward (K7 and K12 in f32). attn_tf32.cuh's bodies run over
// na2d.cuh's neighborhood geometry, as na_fwd.cuh and na_bwd.cuh run the
// bf16 bodies. Each query attends to exactly ks x ks keys, its window start
// clamp(i - (ks - 1) / 2, 0, n - ks) on each axis (NATTEN's contract),
// ks <= 7.
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
// Design: a block is 4 warps (8 at E = 128, below), its 64 own rows an 8 x
// 8 tile of one head of one image; the grid is (tiles, heads, batch).
// - na_tf32_fwd_kernel and na_tf32_dq_kernel: the own rows are a query
//   tile (NaQueries). The clamped union of its queries' windows, the halo,
//   streams past as 64-row f32 tiles of K and V, 4 halo rows of 16 key
//   slots each: 4 tiles at ks = 7, 2 at ks = 1.
// - na_tf32_dkv_kernel: the own rows are a key tile (NaKeys). The queries
//   whose clamped windows reach it form a slab of at most 14 x 14 (Reach);
//   they stream past with their lse and delta, 4 slab rows of 16 query
//   slots a tile.
// A pair attends where the key lies in the query's window, tested on the
// logits' accumulator coordinates in registers before p becomes the P V
// (or dS K, P^T dO, dS^T Q) A operand; slots past the halo, the slab or
// the map are zero-filled by the copy and rejected by the geometry, not by
// their values (their logit, lse and delta are 0). A row that has no key
// in a tile keeps its running max at -inf and adds nothing (the forward's
// guard). The dq kernel forms delta = rowsum(out * dout); no atomics, so a
// rerun is bit-equal, and K2 / K11 (K7 / K12) on the same maps are bit for
// bit the same kernel.
//
// At E = 64 the forward holds 5 padded f32 tiles (85 KB) and each backward
// kernel 6 (102 KB): two blocks an SM, as the dense TF32 kernels. At E =
// 128 (K11 and K12 at head dim 128) the forward's tiles take 165 KB
// (168,960 bytes) and each backward kernel's 198.5 KB (203,264 bytes with
// its lse and delta rows), under the 227 KB a block may take: one block an
// SM, of two warpgroups (attn_tf32.cuh's WG<128>): a warp keeps its 16
// rows' accumulators over 64 of the 128 output columns (64 registers for
// the dk/dv kernel's dk and dv, 32 for the forward's O), and each
// warpgroup forms its rows' logits and dP over all 128 columns itself.
// wgmma's tf32 form reads K-major operands only, and the P V, dS K, P^T dO
// and dS^T Q products read their B operand MN-major: mma.sync m16n8k8 reads
// either from the padded tiles; at 132 floats a row (132 mod 32 = 4, as 68)
// the fragment loads stay conflict-free.
//
// The kernels are written over MapStrides and the head dim E (32, 64 or
// 128), q, k and v each read through its own strides: K2 and K7 run them at
// E = 64 on channel-packed maps (the three stride sets equal), K11 and K12
// at 32, 64 and 128 on per-head maps (in the unfused prologue v is a
// strided third of the qkv projection, its row stride 3 c). Each head's row
// of E floats is contiguous and its strides are multiples of 4 elements,
// so every 16-byte cp.async stays aligned.
#pragma once

#include "attn_tf32.cuh"
#include "na2d.cuh"

namespace kdt {
namespace na_tf32 {

template <int E>
__global__ void __launch_bounds__(tf32::BLOCK<E>)
    na_tf32_fwd_kernel(const tf32::Args a, int h, int w, int ks) {
  tf32::fwd_body<E>(a, NaQueries(blockIdx.x, h, w, ks));
}

template <int E>
__global__ void __launch_bounds__(tf32::BLOCK<E>)
    na_tf32_dq_kernel(const tf32::Args a, int h, int w, int ks) {
  tf32::dq_body<E>(a, NaQueries(blockIdx.x, h, w, ks));
}

template <int E>
__global__ void __launch_bounds__(tf32::BLOCK<E>)
    na_tf32_dkv_kernel(const tf32::Args a, int h, int w, int ks) {
  tf32::dkv_body<E>(a, NaKeys(blockIdx.x, h, w, ks));
}

// Launches the forward on (b, h, w, heads, E) f32 maps read and written
// through a's strides; lse (b, heads, h, w) f32 when a.lse is not null.
// Needs h % 8 == w % 8 == 0 and 1 <= ks <= min(7, h, w). Returns the CUDA
// error code.
template <int E>
int launch_fwd(const tf32::Args& a, int b, int h, int w, int ks, cudaStream_t st) {
  constexpr size_t smem = tf32::FWD_SMEM<E>;
  const cudaError_t attr = allow_smem(na_tf32_fwd_kernel<E>, smem);
  const dim3 grid((h / TQ) * (w / TQ), a.n_heads, b);
  na_tf32_fwd_kernel<E><<<grid, tf32::BLOCK<E>, smem, st>>>(a, h, w, ks);
  return launch_status(attr);
}

// Launches the dq kernel (which writes delta (b, heads, h, w) f32), then
// the dk/dv kernel, on (b, h, w, heads, E) f32 maps: q, k, v read through
// a.sq, a.sk, a.sv, out, dout, dq, dk, dv through a.io. h, w and ks as for
// the forward. Returns the CUDA error code.
template <int E>
int launch_bwd(const tf32::Args& a, int b, int h, int w, int ks, cudaStream_t st) {
  constexpr size_t smem = tf32::BWD_SMEM<E>;
  const dim3 grid((h / TQ) * (w / TQ), a.n_heads, b);
  cudaError_t attr = allow_smem(na_tf32_dq_kernel<E>, smem);
  na_tf32_dq_kernel<E><<<grid, tf32::BLOCK<E>, smem, st>>>(a, h, w, ks);
  const int status = launch_status(attr);
  if (status != 0) return status;
  attr = allow_smem(na_tf32_dkv_kernel<E>, smem);
  na_tf32_dkv_kernel<E><<<grid, tf32::BLOCK<E>, smem, st>>>(a, h, w, ks);
  return launch_status(attr);
}

}  // namespace na_tf32
}  // namespace kdt
