// The forward of exact softmax attention on Hopper, shared by K3
// (global_packed.cu, channel-packed (b, s, heads * 64) maps), K13
// (flash.cu, (b, s, heads, e) q, k, v read through their strides), K2
// and K11 (na_fwd.cuh, 2-D neighborhood attention on channel-packed and on
// per-head strided maps), and K15 (na_proj.cuh, which runs attend() and
// keeps O / l as the A operand of its out-projection in place of body()'s
// store).
//
// Replaces: k_diffusion_tpu/ops/pallas/global_packed.py:_fwd_kernel (K3)
// and k_diffusion_tpu/ops/pallas/flash.py:_fwd_kernel (K13); na_fwd.cuh
// says what K2 and K11 replace. Each computes softmax(q k^T scale) v per
// head with the row max subtracted, the output in the input's dtype and, in
// training, lse = max + log(sum) in f32. The packed map of K3 is K13's
// strided layout with stride_b = s * heads * 64, stride_s = heads * 64 and
// the head at column head * 64, so both run this kernel.
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
// 64 rows of one head of one image; a block is WG warpgroups that share
// each K and V tile (global attention: two where s > 64, half the L2 reads
// of K and V, one otherwise; neighborhood attention: one); the grid is
// (row blocks, heads, batch). Q is loaded once, by cp.async into the ring's
// last stage, and kept as register A fragments (ldmatrix) for the whole
// loop; 64-row tiles of K and V stream through the 3-stage ring, one commit
// group per (K, V) pair, so that two pairs are in flight while wgmma runs
// on the current one. Per tile: S = Q K^T (A from registers, K K-major),
// logits scaled by scale log2 e, set to -inf where the pair does not
// attend; each row's running max is reduced over the quad of threads that
// hold it (shuffles 1 and 2), p = 2^(s - m) and the running output is
// rescaled by alpha = 2^(m_old - m) in registers; p, rounded to bf16 pairs,
// is already the register A operand of O += P V, with V read MN-major (the
// transpose bit). Each thread sums its own p; the row sum l is reduced over
// the quad once, at the end. The epilogue stages O / l through shared
// memory for 16-byte stores and writes lse = (m + log2 l) ln 2, one thread
// per row. Nothing of the logits or the output leaves registers before the
// end.
//
// Which rows a block owns, which tiles stream past them and which pairs
// attend is the geometry, a template policy G of the body, as for the
// backward (attn_bwd.cuh): wgmma.cuh's Seq for global attention, whose
// comment lists the members, and na2d.cuh's NaQueries for neighborhood
// attention. Rows are gathered one by one from their map positions through
// each tensor's MapStrides. q, k and v share one stride set, and K and V
// one row offset, unless the body's OWN_V gives v its own (K11's v is a
// strided third of a projection): a stride set more in the copies of every
// tile cost the backward's shared bodies 5-7%.
//
// At E = 64 a block of one warpgroup holds 6 tiles, 49 KB, and at most 128
// registers a thread: four warpgroups share an SM (at E = 128, K11's, 97 KB
// and two). Running the P V product
// of one tile while the next tile's softmax is formed (FlashAttention-3's
// overlap) gained nothing at four warpgroups an SM, which already overlap
// each other's phases.
#pragma once

#include <cstdint>

#include "wgmma.cuh"

namespace kdt {
namespace attn_fwd {

using namespace wg;

constexpr float LN2 = 0.6931471805599453f;

// The operands of a forward launch: q, k and v are read through sq, sk and
// sk (or sv, where the body's OWN_V is set), head h at column h * E; out is
// written through so; lse is (b, heads, positions) f32, or null.
struct Args {
  const bf16 *q, *k, *v;
  bf16* out;
  float* lse;
  MapStrides sq, sk, sv, so;
  int n_heads;
  float scale;
};

// STAGES pairs of K and V tiles (Q, up to two tiles, waits in the last stage
// until it is in registers) and the slack to align the start to 1024 bytes.
template <int E>
constexpr size_t SMEM = 2 * STAGES * TILE<E> * sizeof(bf16) + 1024;

// The attention of the block's own rows for head `head` of image `img`,
// through the ring at s_kv (STAGES pairs of (64, E) tiles, 1024-aligned):
// leaves each thread's part of O / l in acc_o (wgmma's accumulator layout),
// writes lse where a.lse is not null, and returns with every thread done
// with the ring. body() ends it with the store of the output; K15
// (na_proj.cuh) stages acc_o as a product's A operand instead.
template <int E, int WG, bool OWN_V, class G>
__device__ __forceinline__ void attend(const Args& a, const G& geo, int head, int img,
                                       bf16* s_kv, float (&acc_o)[E / 2]) {
  static_assert(WG == 1 || WG == 2, "a block is one or two warpgroups");
  // stage st: K at s_kv + 2 st TILE, V after it
  bf16* s_q = s_kv + 2 * (STAGES - 1) * TILE<E>;

  // warp w of the block holds own rows 16 w to 16 w + 15 (wgmma.cuh's
  // helpers index rows by threadIdx.x / 32, so warpgroup g's tiles are the
  // g-th 64 rows of the staged Q and output)
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int n_tiles = geo.tiles;

  // starts the copy of streamed tile j's K and V rows into stage `kv`
  auto load_kv = [&](int j, bf16* kv) {
    const auto row = [&](int i) { return geo.stream(j, i); };
    if constexpr (OWN_V) {
      load_rows_async<E>(kv, a.k, a.sk, img, head, row);
      load_rows_async<E>(kv + TILE<E>, a.v, a.sv, img, head, row);
    } else {
      load_rows_async<E>(kv, a.k, a.sk, img, head, row, kv + TILE<E>, a.v);
    }
  };
  // Q waits in the ring's last stage, which no tile needs before Q is in
  // registers; it arrives with the first group
#pragma unroll
  for (int g = 0; g < WG; ++g)
    load_rows_async<E>(s_q + g * TILE<E>, a.q, a.sq, img, head,
                       [&](int i) { return geo.own(g * ROWS + i); });
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_tiles) load_kv(st, s_kv + 2 * st * TILE<E>);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 2>();
  __syncthreads();
  uint32_t a_q[E / 16][4];
  load_a<E>(s_q, a_q);
  __syncthreads();  // every thread has its Q fragments: the last stage is free
  // 0, unknown to the compiler: see the copy of a_q below
  const uint32_t zero = static_cast<uint32_t>(n_tiles) >> 31;

  // this thread's accumulator rows r and r + 8 of the own rows, columns
  // 8i + c (+1); the running max m in base-2 units, l this thread's share
  // of the row sum
  const int r = warp * 16 + lane / 4, c = 2 * (lane & 3);
  typename G::Info info[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) info[h] = geo.own_info(r + 8 * h);
  const float scale2 = a.scale * LOG2E;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < E / 2; ++i) acc_o[i] = 0.f;
  float acc_s[32];
  uint32_t a_p[4][4];
  for (int j = 0, st = 0; j < n_tiles; ++j, st = st + 1 == STAGES ? 0 : st + 1) {
    const bf16* s_k = s_kv + 2 * st * TILE<E>;
    const bf16* s_v = s_k + TILE<E>;
    // the K and V tiles STAGES - 1 ahead go to the stage that iteration
    // j - 1 (or, for j = 0, Q) finished with; tile 0 has arrived
    if (j + STAGES - 1 < n_tiles)
      load_kv(j + STAGES - 1, s_kv + 2 * ((st + STAGES - 1) % STAGES) * TILE<E>);
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
    // row r + 8h, column 8i + c (+1) of the tile: acc_s[4i + 2h (+1)]; a
    // pair that does not attend, zero-filled slots included (their logit
    // is 0), is set to -inf
    const bool whole = geo.whole(j);
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = acc_s[4 * i + e] * scale2;
        if (!whole && !geo.mask(j, 8 * i + c + (e & 1), info[e / 2])) x = -INFINITY;
        acc_s[4 * i + e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    // A row none of whose keys has streamed past yet keeps m = -inf (in
    // neighborhood attention a query tile's first halo tile misses the
    // windows of its lower rows, the last one those of its upper rows):
    // such a row takes 0 as its reference, so that p and alpha are 2^-inf
    // = 0 and not 2^(-inf + inf), NaN
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float ref = mx[h] == -INFINITY ? 0.f : mx[h];
      alpha[h] = exp2_approx(m_run[h] - ref);
      m_run[h] = mx[h];
      mx[h] = ref;
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

  const long stat0 = (static_cast<long>(img) * a.n_heads + head) * geo.positions;
  float inv_l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv_l[h] = 1.f / l;
    if (a.lse != nullptr && (lane & 3) == 0) {
      const Pos p = geo.own(r + 8 * h);
      if (p.ok) a.lse[stat0 + geo.index(p)] = (m_run[h] + log2f(l)) * LN2;
    }
  }
#pragma unroll
  for (int i = 0; i < E / 2; ++i) acc_o[i] *= inv_l[(i / 2) & 1];
}

// The forward of block (blockIdx.x, head blockIdx.y, image blockIdx.z):
// the attention, then O / l staged through the ring for 16-byte stores.
template <int E, int WG, bool OWN_V, class G>
__device__ __forceinline__ void body(const Args& a, const G& geo) {
  extern __shared__ unsigned char smem_raw[];
  bf16* s_kv = reinterpret_cast<bf16*>(aligned_smem(smem_raw));
  const int head = blockIdx.y, img = blockIdx.z;
  float acc_o[E / 2];
  attend<E, WG, OWN_V>(a, geo, head, img, s_kv, acc_o);
  stage_acc<E>(acc_o, 1.f, s_kv);
  __syncthreads();
#pragma unroll
  for (int g = 0; g < WG; ++g)
    store_rows<E>(s_kv + g * TILE<E>, a.out, a.so, img, head,
                  [&](int i) { return geo.own(g * ROWS + i); });
}

template <int E, int WG>
__global__ void __launch_bounds__(128 * WG, 4 / WG) attn_fwd_kernel(const Args a, int s) {
  body<E, WG, false>(a, Seq(blockIdx.x * WG, s));
}

template <int E, int WG>
int launch_wg(const Args& a, int b, int s, cudaStream_t st) {
  const cudaError_t attr = allow_smem(attn_fwd_kernel<E, WG>, SMEM<E>);
  const dim3 grid((s + ROWS * WG - 1) / (ROWS * WG), a.n_heads, b);
  attn_fwd_kernel<E, WG><<<grid, 128 * WG, SMEM<E>, st>>>(a, s);
  return launch_status(attr);
}

// Launches the forward on q, k, v read through `in` (head h at column h *
// E); writes out (b, s, heads, E) bf16 contiguous and, when lse is not
// null, lse (b, heads, s) f32 (natural log). Any s >= 1. Returns the CUDA
// error code.
template <int E>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, int b, int s,
           int n_heads, Rows in, float scale, cudaStream_t st) {
  const long ld = static_cast<long>(n_heads) * E;
  const MapStrides seq{in.batch, in.seq, 0}, io{s * ld, ld, 0};
  const Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
               static_cast<const bf16*>(v), static_cast<bf16*>(out), static_cast<float*>(lse),
               seq, seq, seq, io, n_heads, scale};
  return s > ROWS ? launch_wg<E, 2>(a, b, s, st) : launch_wg<E, 1>(a, b, s, st);
}

}  // namespace attn_fwd
}  // namespace kdt
