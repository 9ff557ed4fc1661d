// The forward of exact global softmax attention on Hopper, shared by K3
// (global_packed.cu, channel-packed (b, s, heads * 64) maps) and K13
// (flash.cu, (b, s, heads, e) q, k, v read through their strides).
//
// Replaces: k_diffusion_tpu/ops/pallas/global_packed.py:_fwd_kernel (K3)
// and k_diffusion_tpu/ops/pallas/flash.py:_fwd_kernel (K13). Both compute
// softmax(q k^T scale) v per head with the row max subtracted, the output in
// the input's dtype and, in training, lse = max + log(sum) in f32. The
// packed map of K3 is K13's strided layout with stride_b = s * heads * 64,
// stride_s = heads * 64 and the head at column head * 64, so both run this
// kernel.
//
// What bounds it on the H100: 2 products of 2 s^2 e FLOP per image and head
// (the logits, then p v) against q, k, v read and out written once, 8 s e
// bytes: s / 2 FLOP per byte, 128 at the main path's s = 256, far below the
// 295 at which the tensor cores become the limit. So it is bound by memory:
// by the K and V tiles that every query block of a head reads again from
// L2, and, at a few hundred blocks, by the latency of each block's chain of
// tiles.
//
// Design: FlashAttention-2's forward, every product a wgmma m64nNk16 with
// f32 accumulators in registers (wgmma.cuh). A warpgroup (128 threads) owns
// 64 queries of one head of one image; a block is WG warpgroups that share
// each K and V tile, two where s > 64 (half the L2 reads of K and V), one
// otherwise (a second would idle); the grid is (query blocks, heads,
// batch). Q is loaded once, by cp.async into the ring's last stage, and
// kept as register A fragments (ldmatrix) for the whole loop; 64-key tiles
// of K and V stream through the 3-stage ring, one commit group per (K, V)
// pair, so that two pairs are in flight while wgmma runs on the current
// one. Per tile: S = Q K^T (A from registers, K K-major), logits scaled by
// scale log2 e with keys at or past s set to -inf; each row's running max is
// reduced over the quad of threads that hold it (shuffles 1 and 2), p = 2^(s
// - m) and the running output is rescaled by alpha = 2^(m_old - m) in
// registers; p, rounded to bf16 pairs, is already the register A operand of
// O += P V, with V read MN-major (the transpose bit). Each thread sums its
// own p; the row sum l is reduced over the quad once, at the end. The
// epilogue stages O / l through shared memory for 16-byte stores (rows < s)
// and writes lse = (m + log2 l) ln 2, one thread per row. Nothing of the
// logits or the output leaves registers before the end.
//
// At E = 64 a block holds 6 tiles, 49 KB, and at most 128 registers a
// thread: four warpgroups share an SM. Running the P V product of one tile
// while the next tile's softmax is formed (FlashAttention-3's overlap)
// gained nothing at four warpgroups an SM, which already overlap each
// other's phases.
#pragma once

#include <cstdint>

#include "wgmma.cuh"

namespace kdt {
namespace attn_fwd {

using namespace wg;

constexpr float LN2 = 0.6931471805599453f;

// STAGES pairs of K and V tiles (Q, up to two tiles, waits in the last stage
// until it is in registers) and the slack to align the start to 1024 bytes.
template <int E>
constexpr size_t SMEM = 2 * STAGES * TILE<E> * sizeof(bf16) + 1024;

template <int E, int WG>
__global__ void __launch_bounds__(128 * WG, 4 / WG)
attn_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ out, float* __restrict__ lse,
                int s, int n_heads, Rows in, float scale) {
  static_assert(WG == 1 || WG == 2, "a block is one or two warpgroups");
  extern __shared__ unsigned char smem_raw[];
  // stage st: K at s_kv + 2 st TILE, V after it
  bf16* s_kv = reinterpret_cast<bf16*>(aligned_smem(smem_raw));
  bf16* s_q = s_kv + 2 * (STAGES - 1) * TILE<E>;

  // warp w of the block holds rows 16 w to 16 w + 15 of its WG * 64 queries
  // (wgmma.cuh's helpers index rows by threadIdx.x / 32, so warpgroup g's
  // tiles are the g-th 64 rows of the staged Q and output)
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * ROWS * WG, head = blockIdx.y;
  const long ld = static_cast<long>(n_heads) * E;  // out's row stride
  const long packed = static_cast<long>(blockIdx.z) * s * ld + head * E;
  const long src = static_cast<long>(blockIdx.z) * in.batch + head * E;
  const int n_tiles = (s + ROWS - 1) / ROWS;
  const bf16 *k_h = k + src, *v_h = v + src;

  // Q waits in the ring's last stage, which no tile needs before Q is in
  // registers; it arrives with the first group
#pragma unroll
  for (int g = 0; g < WG; ++g)
    load_tile_async<E>(s_q + g * TILE<E>, q + src, in.seq, q0 + g * ROWS, s);
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_tiles) {
      load_tile_async<E>(s_kv + 2 * st * TILE<E>, k_h, in.seq, st * ROWS, s);
      load_tile_async<E>(s_kv + (2 * st + 1) * TILE<E>, v_h, in.seq, st * ROWS, s);
    }
    cp_async_commit();
  }
  cp_async_wait<STAGES - 2>();
  __syncthreads();
  uint32_t a_q[E / 16][4];
  load_a<E>(s_q, a_q);
  __syncthreads();  // every thread has its Q fragments: the last stage is free
  // 0, unknown to the compiler: see the copy of a_q below
  const uint32_t zero = static_cast<uint32_t>(s) >> 31;

  // this thread's accumulator rows r and r + 8 of the query block, columns
  // 8i + c (+1); the running max m in base-2 units, l this thread's share
  // of the row sum
  const int r = warp * 16 + lane / 4, c = 2 * (lane & 3);
  const float scale2 = scale * LOG2E;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float acc_o[E / 2];
#pragma unroll
  for (int i = 0; i < E / 2; ++i) acc_o[i] = 0.f;
  float acc_s[32];
  uint32_t a_p[4][4];
  for (int j = 0, st = 0; j < n_tiles; ++j, st = st + 1 == STAGES ? 0 : st + 1) {
    const bf16* s_k = s_kv + 2 * st * TILE<E>;
    const bf16* s_v = s_k + TILE<E>;
    // the K and V tiles STAGES - 1 ahead go to the stage that iteration
    // j - 1 (or, for j = 0, Q) finished with; tile 0 has arrived
    if (j + STAGES - 1 < n_tiles) {
      bf16* ahead = s_kv + 2 * ((st + STAGES - 1) % STAGES) * TILE<E>;
      load_tile_async<E>(ahead, k_h, in.seq, (j + STAGES - 1) * ROWS, s);
      load_tile_async<E>(ahead + TILE<E>, v_h, in.seq, (j + STAGES - 1) * ROWS, s);
    }
    cp_async_commit();
    if (j > 0) {
      cp_async_wait<STAGES - 1>();
      __syncthreads();
    }
    // S reads a copy of the Q fragments made in this iteration: read by
    // wgmma straight from the loop-invariant a_q, ptxas (CUDA 12.8) gave
    // a_q's registers to the P fragments at head dim 64 and the second
    // tile's S read P
    uint32_t a_s[E / 16][4];
#pragma unroll
    for (int kk = 0; kk < E / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) a_s[kk][i] = a_q[kk][i] ^ (zero * j);
    fence_regs(a_s);
    wgmma_fence();
    chain_rs<E>(acc_s, a_s, s_k);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_s);
    // row r + 8h, key j * 64 + 8i + c (+1): acc_s[4i + 2h (+1)]; a
    // zero-filled key row past s gives logit 0, so it is masked to -inf
    const bool ragged = (j + 1) * ROWS > s;
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = acc_s[4 * i + e] * scale2;
        if (ragged && j * ROWS + 8 * i + c + (e & 1) >= s) x = -INFINITY;
        acc_s[4 * i + e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    // key 0 is in the first tile, so m is finite from there on and alpha
    // of the first tile is 2^-inf = 0
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = exp2_approx(m_run[h] - mx[h]);
      m_run[h] = mx[h];
      l_run[h] *= alpha[h];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = exp2_approx(acc_s[i] - mx[(i / 2) & 1]);
      acc_s[i] = p;
      l_run[(i / 2) & 1] += p;
    }
#pragma unroll
    for (int i = 0; i < E / 2; ++i) acc_o[i] *= alpha[(i / 2) & 1];
    pack_a(acc_s, a_p);
    rows_product<E>(acc_o, a_p, s_v);
    wgmma_wait<0>();
    fence_regs(acc_o);
    fence_regs(a_p);
    __syncthreads();  // every thread is done with this stage before it refills
  }

  const long row0 = (static_cast<long>(blockIdx.z) * n_heads + head) * s;
  float inv_l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv_l[h] = 1.f / l;
    const int row = q0 + r + 8 * h;
    if (lse != nullptr && (lane & 3) == 0 && row < s)
      lse[row0 + row] = (m_run[h] + log2f(l)) * LN2;
  }
#pragma unroll
  for (int i = 0; i < E / 2; ++i) acc_o[i] *= inv_l[(i / 2) & 1];
  stage_acc<E>(acc_o, 1.f, s_kv);
  __syncthreads();
#pragma unroll
  for (int g = 0; g < WG; ++g)
    store_tile<E>(s_kv + g * TILE<E>, out + packed + (q0 + g * ROWS) * ld, ld,
                  s - q0 - g * ROWS);
}

template <int E, int WG>
int launch_wg(const void* q, const void* k, const void* v, void* out, void* lse, int b, int s,
              int n_heads, Rows in, float scale, cudaStream_t st) {
  const cudaError_t attr = allow_smem(attn_fwd_kernel<E, WG>, SMEM<E>);
  const dim3 grid((s + ROWS * WG - 1) / (ROWS * WG), n_heads, b);
  attn_fwd_kernel<E, WG><<<grid, 128 * WG, SMEM<E>, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), static_cast<float*>(lse), s, n_heads, in, scale);
  return launch_status(attr);
}

// Launches the forward on q, k, v read through `in` (head h at column h *
// E); writes out (b, s, heads, E) bf16 contiguous and, when lse is not
// null, lse (b, heads, s) f32 (natural log). Any s >= 1. Returns the CUDA
// error code.
template <int E>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, int b, int s,
           int n_heads, Rows in, float scale, cudaStream_t st) {
  return s > ROWS ? launch_wg<E, 2>(q, k, v, out, lse, b, s, n_heads, in, scale, st)
                  : launch_wg<E, 1>(q, k, v, out, lse, b, s, n_heads, in, scale, st);
}

}  // namespace attn_fwd
}  // namespace kdt
