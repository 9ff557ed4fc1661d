// The backward of softmax attention on Hopper, shared by K9
// (global_packed.cu, channel-packed (b, s, heads * 64) maps), K14
// (flash.cu, (b, s, heads, e) q, k, v read through their strides), K7
// (na_bwd.cuh, 2-D neighborhood attention on channel-packed maps) and K12
// (na_bwd.cuh, the same on per-head maps, q, k and v each read through its
// own strides).
//
// Replaces: k_diffusion_tpu/ops/pallas/global_packed.py:_bwd_kernel (K9)
// and k_diffusion_tpu/ops/pallas/flash.py:_dq_kernel, :_dkv_kernel (K14);
// na_bwd.cuh says what K7 and K12 replace. The packed map of K9 is K14's strided
// layout with stride_b = s * heads * 64, stride_s = heads * 64 and the head
// at column head * 64, so both run the same two kernels.
//
// What bounds it on the H100: 5 products of 2 s^2 e FLOP per image and head
// (the logits recomputed, dp, dv, dk, dq) against q, k, v, out, dout read
// and dq, dk, dv written. At the main path's shapes (s <= 256, e = 64) that
// is 64 FLOP per byte, far below the 295 at which the tensor cores become
// the limit: bound by memory, and at a few hundred blocks by latency.
//
// Design: FlashAttention-2's two-kernel backward, p recomputed from the
// forward's lse, no atomics (bit-equal reruns). A block is one warpgroup
// (128 threads) and owns 64 rows of one head of one image; the grid is
// (row tiles, heads, batch). Every product is a wgmma m64nNk16 with f32
// accumulators in registers, and p and ds never leave registers: each
// thread forms them for its own accumulator elements (masked) and rounds
// them to bf16 pairs, which in wgmma's accumulator layout are already the
// register A operand of the next product.
// - dq_body: 64 queries. Q and dO are loaded once, kept as register A
//   fragments (ldmatrix), lse and delta in registers; 64-key tiles of K and
//   V stream through the ring. Per tile S = Q K^T and dP = dO V^T (B from
//   shared memory), p = 2^(s scale log2 e - lse log2 e), ds = p (dp -
//   delta), then dQ += dS K with K read MN-major. Its first tile's step also
//   computes delta = rowsum(out * dout) from the dO tile and the out tile
//   (parked in the ring's last stage until then) and writes it for the
//   second kernel.
// - dkv_body: 64 keys. K and V stay resident in shared memory; 64-query
//   tiles of Q and dO, with their lse and delta, stream through the ring.
//   S^T = K Q^T and dP^T = V dO^T - delta (the accumulator starts at
//   -delta), P^T and dS^T in registers, then dV += P^T dO and dK += dS^T Q
//   with Q and dO read MN-major. dK and dV accumulate in registers over the
//   whole query loop, in a fixed order. At most 168 registers, so three
//   blocks fit on an SM.
// Both stage their bf16 output tile through shared memory and store whole
// 16-byte chunks.
//
// Which rows a block owns, which tiles stream past them and which pairs
// attend is the geometry, a template policy G of the two bodies (wgmma.cuh's
// Seq for global attention, whose comment lists the members; na2d.cuh's
// NaQueries and NaKeys for neighborhood attention). The bodies' OWN_V
// gives k and v their own stride sets (K12); K7, K9 and K14 leave it
// false, and their copies are as they were.
// The __global__ kernels are thin: each builds its geometry from blockIdx.x
// and runs a body.
//
// The tiles, the 3-stage cp.async ring, the descriptors and the register
// operands are wgmma.cuh's, which the forward (attn_fwd.cuh) shares. At
// e = 64 a block holds 8 tiles, 66.5 KB: three blocks share an SM. At e =
// 128 (K12 only) the dq kernel parks Q and dO in the ring (PARK) and the
// dk/dv block is two warpgroups taking alternate tiles (dkv_pairs_body).
#pragma once

#include <cstdint>

#include "wgmma.cuh"

namespace kdt {
namespace attn_bwd {

using namespace wg;

// The operands of a backward launch. q, k, v are read through the strides
// `in` (head h at column h * E), or k through sk and v through sv where the
// body's OWN_V is set; out, dout, dq, dk and dv share the contiguous
// strides io; lse and delta are (b, heads, positions) f32.
struct Args {
  const bf16 *q, *k, *v, *out, *dout;
  const float* lse;
  float* delta;
  bf16 *dq, *dk, *dv;
  MapStrides in, io;
  int n_heads;
  float scale;
  MapStrides sk, sv;
};

// Starts the copy of the K and V rows pos(r) into tiles k_tile and v_tile:
// with OWN_V each through its own strides (K12's v is a strided third of a
// projection), else both through `in`, from one row offset (a stride set
// more in the copies of every tile cost K9 and K14 5-7%).
template <int E, bool OWN_V, class RowPos>
__device__ __forceinline__ void load_kv_async(bf16* k_tile, bf16* v_tile, const Args& a, int img,
                                              int head, const RowPos& pos) {
  if constexpr (OWN_V) {
    load_rows_async<E>(k_tile, a.k, a.sk, img, head, pos);
    load_rows_async<E>(v_tile, a.v, a.sv, img, head, pos);
  } else {
    load_rows_async<E>(k_tile, a.k, a.in, img, head, pos, v_tile, a.v);
  }
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0));
}

// Starts the copy of the lse (off 0) or delta (off 2) of streamed tile j's
// rows, from `src` (the image and head's row), into the tile's statistics:
// row i goes to float 4 (i / 2) + off + i % 2, so that one 16-byte read
// gives the lse and delta of a pair of columns. Rows that are not ok are
// zero-filled. Threads [first, first + 64) take part.
template <class G>
__device__ __forceinline__ void load_stats_async(float* dst, const float* src, const G& geo,
                                                 int j, int first, int off) {
  const int i = static_cast<int>(threadIdx.x) - first;
  if (i >= 0 && i < ROWS) {
    const Pos p = geo.stream(j, i);
    cp_async4(smem_u32(dst + 4 * (i / 2) + off + i % 2), p.ok ? src + geo.index(p) : src, p.ok);
  }
}

// Starts d = X Y^T over E for (64, E) tiles X and Y, both K-major in shared
// memory, as a chain of E / 16 wgmma, not committed; adds to d when `first`
// is 1.
template <int E>
__device__ __forceinline__ void chain_ss(float (&d)[32], const bf16* x, const bf16* y,
                                         int first) {
  const uint64_t dx = desc<E>(x), dy = desc<E>(y);
#pragma unroll
  for (int kk = 0; kk < E / 16; ++kk)
    wgmma_ss<0, 0>(d, dx + k_slice<E>(kk), dy + k_slice<E>(kk), kk > 0 || first);
}

// The bf16 A operands of P and dS = P (dP - delta) from a thread's p and
// dp - delta (see pack_a), a pair at a time.
__device__ __forceinline__ void pack_p_ds(const float (&p)[32], const float (&dpd)[32],
                                          uint32_t (&a_p)[4][4], uint32_t (&a_ds)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = 8 * kk + 2 * j;
      a_p[kk][j] = pack_bf16(p[i], p[i + 1]);
      a_ds[kk][j] = pack_bf16(p[i] * dpd[i], p[i + 1] * dpd[i + 1]);
    }
}

// Two resident tiles, STAGES pairs of streamed ones, STAGES statistics
// blocks of 2 x 64 floats (the dq kernel uses one for delta), and the
// slack to align the start to 1024 bytes.
template <int E>
constexpr size_t SMEM =
    (2 + 2 * STAGES) * TILE<E> * sizeof(bf16) + STAGES * 2 * ROWS * sizeof(float) + 1024;

// At E = 128 the dq kernel parks Q and dO in the ring's last stage, which
// no tile needs before they are in registers (as the forward parks Q), and
// reads out for delta from device memory: 6 tiles and delta, 97.3 KB, two
// blocks an SM, where SMEM's 8 tiles (130.5 KB) would leave one.
template <int E>
constexpr bool PARK = E == 128;
template <int E>
constexpr size_t DQ_SMEM =
    PARK<E> ? 2 * STAGES * TILE<E> * sizeof(bf16) + ROWS * sizeof(float) + 1024 : SMEM<E>;
// Warpgroups of a dk/dv block: at E = 128 two (dkv_pairs_body), else one.
template <int E>
constexpr int DKV_WG = E == 128 ? 2 : 1;
// Pair stages of dkv_pairs_body's ring, each the Q and dO tiles and the
// statistics of two streamed tiles.
constexpr int PAIRS = 2;
// The dk/dv kernel's shared memory: SMEM's, or at E = 128 the resident K
// and V, PAIRS stages of 4 tiles and their statistics (163 KB, one block
// an SM, as its registers allow anyway).
template <int E>
constexpr size_t DKV_SMEM =
    E == 128 ? (2 + 4 * PAIRS) * TILE<E> * sizeof(bf16) + PAIRS * 4 * ROWS * sizeof(float) + 1024
             : SMEM<E>;

template <int E, bool OWN_V = false, class G>
__device__ __forceinline__ void dq_body(const Args& a, const G& geo) {
  extern __shared__ unsigned char smem_raw[];
  bf16* base = reinterpret_cast<bf16*>(aligned_smem(smem_raw));
  // stage st: K at s_kv + 2 st TILE, V after it; Q and dO in tiles of
  // their own before the ring, or with PARK in its last stage
  bf16* s_kv = PARK<E> ? base : base + 2 * TILE<E>;
  bf16* s_q = PARK<E> ? s_kv + 2 * (STAGES - 1) * TILE<E> : base;
  bf16* s_do = s_q + TILE<E>;
  float* s_delta = reinterpret_cast<float*>(s_kv + 2 * STAGES * TILE<E>);

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int head = blockIdx.y, img = blockIdx.z;
  const long stat0 = (static_cast<long>(img) * a.n_heads + head) * geo.positions;
  const int n_tiles = geo.tiles;
  const auto own_row = [&](int i) { return geo.own(i); };

  // this thread's accumulator rows r and r + 8 of the query tile; lse in
  // base-2 units
  const int r = warp * 16 + lane / 4, c = 2 * (lane & 3);
  float lse_r[2], delta_r[2];
  typename G::Info info[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const Pos p = geo.own(r + 8 * h);
    lse_r[h] = p.ok ? a.lse[stat0 + geo.index(p)] * LOG2E : 0.f;
    info[h] = geo.own_info(r + 8 * h);
  }

  // starts the copy of streamed tile j's K and V rows into stage `kv`
  auto load_kv = [&](int j, bf16* kv) {
    load_kv_async<E, OWN_V>(kv, kv + TILE<E>, a, img, head,
                            [&](int i) { return geo.stream(j, i); });
  };
  // out waits in the ring's last stage, which no tile needs before delta
  // has been computed (with PARK it is read from device memory)
  bf16* s_out = s_kv + 2 * (STAGES - 1) * TILE<E>;
  load_rows_async<E>(s_q, a.q, a.in, img, head, own_row);
  load_rows_async<E>(s_do, a.dout, a.io, img, head, own_row);
  if constexpr (!PARK<E>) load_rows_async<E>(s_out, a.out, a.io, img, head, own_row);
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_tiles) load_kv(st, s_kv + 2 * st * TILE<E>);
    cp_async_commit();
  }
  // starts the copy of the K and V tiles STAGES - 1 ahead of tile j (in
  // stage st) and commits it, an empty group past the last tile
  auto load_ahead = [&](int j, int st) {
    if (j + STAGES - 1 < n_tiles)
      load_kv(j + STAGES - 1, s_kv + 2 * ((st + STAGES - 1) % STAGES) * TILE<E>);
    cp_async_commit();
  };

  // delta = rowsum(out * dout) in f32 from the first group's out and dO
  // tiles: two threads per row, each half a row in 16-byte chunks. With
  // PARK a thread's chunks of out come from device memory, read before the
  // wait so that they arrive with the tiles.
  const int row = threadIdx.x / 2;
  uint4 o_park[PARK<E> ? E / 16 : 1];
  if constexpr (PARK<E>) {
    const Pos p = geo.own(row);
    const bf16* o_row = a.out + a.io.at(img, p.y, p.x, head, E);
#pragma unroll
    for (int i = 0; i < E / 16; ++i)
      o_park[i] = p.ok ? *reinterpret_cast<const uint4*>(
                             o_row + ((threadIdx.x & 1) * (E / 16) + i) * 8)
                       : make_uint4(0u, 0u, 0u, 0u);
  }
  cp_async_wait<STAGES - 2>();
  __syncthreads();
  {
    const unsigned char* o_t = reinterpret_cast<const unsigned char*>(s_out);
    const unsigned char* g_t = reinterpret_cast<const unsigned char*>(s_do);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < E / 16; ++i) {
      const int ch = (threadIdx.x & 1) * (E / 16) + i;
      uint4 ov;
      if constexpr (PARK<E>) ov = o_park[i];
      else ov = *reinterpret_cast<const uint4*>(o_t + swizzle<E>(row, ch));
      const uint4 gv = *reinterpret_cast<const uint4*>(g_t + swizzle<E>(row, ch));
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float2 x = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(&ov)[w]);
        const float2 y = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(&gv)[w]);
        sum += x.x * y.x + x.y * y.y;
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if ((threadIdx.x & 1) == 0) {
      s_delta[row] = sum;
      const Pos p = geo.own(row);
      if (p.ok) a.delta[stat0 + geo.index(p)] = sum;
    }
  }
  __syncthreads();  // s_delta written, out's stage free
#pragma unroll
  for (int h = 0; h < 2; ++h) delta_r[h] = s_delta[r + 8 * h];
  // Q and dO stay in registers as A fragments
  uint32_t a_q[E / 16][4], a_do[E / 16][4];
  load_a<E>(s_q, a_q);
  load_a<E>(s_do, a_do);
  if constexpr (PARK<E>) __syncthreads();  // the last stage is free for tile STAGES - 1

  const float scale2 = a.scale * LOG2E;
  float acc_dq[E / 2];
#pragma unroll
  for (int i = 0; i < E / 2; ++i) acc_dq[i] = 0.f;
  float acc_s[32], acc_dp[32];
  uint32_t a_ds[4][4];
  for (int j = 0, st = 0; j < n_tiles; ++j, st = st + 1 == STAGES ? 0 : st + 1) {
    const bf16* s_k = s_kv + 2 * st * TILE<E>;
    const bf16* s_v = s_k + TILE<E>;
    // the K and V tiles STAGES - 1 ahead go to the stage that iteration
    // j - 1 (or, for j = 0, delta) finished with; tile 0 has arrived
    load_ahead(j, st);
    if (j > 0) {
      cp_async_wait<STAGES - 1>();
      __syncthreads();
    }
    // S, then dP, each its own group
    fence_regs(a_q);
    fence_regs(a_do);
    wgmma_fence();
    chain_rs<E>(acc_s, a_q, s_k);
    wgmma_commit();
    chain_rs<E>(acc_dp, a_do, s_v);
    wgmma_commit();
    // row r (+8), column 8i + c (+1) of the key tile: x[4i + 2h (+1)]
    wgmma_wait<1>();
    fence_regs(acc_s);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc_s[4 * i + e] = geo.mask(j, 8 * i + c + (e & 1), info[e / 2])
                               ? exp2_approx(acc_s[4 * i + e] * scale2 - lse_r[e / 2])
                               : 0.f;
    wgmma_wait<0>();
    fence_regs(acc_dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_dp[i] = acc_s[i] * (acc_dp[i] - delta_r[(i / 2) & 1]);
    pack_a(acc_dp, a_ds);
    rows_product<E>(acc_dq, a_ds, s_k);
    wgmma_wait<0>();
    fence_regs(acc_dq);
    fence_regs(a_ds);
    __syncthreads();  // every thread is done with this stage before it refills
  }
  stage_acc<E>(acc_dq, a.scale, s_kv);
  __syncthreads();
  store_rows<E>(s_kv, a.dq, a.io, img, head, own_row);
}

// One streamed tile j's step of the dk/dv bodies, for the warpgroup's 64
// keys (rows r and r + 8 of this thread, their Info in `info`): S^T = K
// Q^T and dP^T = V dO^T - delta (the accumulator starts at -delta), P^T and
// dS^T in registers, then dV += P^T dO and dK += dS^T Q with Q and dO read
// MN-major. Column 8i + c (+1) is row 8i + c (+1) of tile j, whose lse and
// delta are the float4 4i + c / 2 of `stats` (read again where the lse is
// used: 16 registers fewer across the products). Returns with the products
// done.
template <int E, class G>
__device__ __forceinline__ void dkv_step(const G& geo, int j, const bf16* s_k, const bf16* s_v,
                                         const bf16* s_q, const bf16* s_do, const float4* stats,
                                         const typename G::Info (&info)[2], int c, float scale2,
                                         float (&acc_dk)[E / 2], float (&acc_dv)[E / 2]) {
  float acc_s[32], acc_dp[32];
  uint32_t a_p[4][4], a_ds[4][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float4 t = stats[4 * i + c / 2];
    acc_dp[4 * i] = acc_dp[4 * i + 2] = -t.z;
    acc_dp[4 * i + 1] = acc_dp[4 * i + 3] = -t.w;
  }
  // S^T, then dP^T - delta, each its own group
  wgmma_fence();
  chain_ss<E>(acc_s, s_k, s_q, 0);
  wgmma_commit();
  chain_ss<E>(acc_dp, s_v, s_do, 1);
  wgmma_commit();
  wgmma_wait<1>();
  fence_regs(acc_s);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float4 t = stats[4 * i + c / 2];
    const float lse2[2] = {t.x * LOG2E, t.y * LOG2E};  // base 2
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc_s[4 * i + e] = geo.mask(j, 8 * i + c + (e & 1), info[e / 2])
                             ? exp2_approx(acc_s[4 * i + e] * scale2 - lse2[e & 1])
                             : 0.f;
  }
  wgmma_wait<0>();
  fence_regs(acc_dp);
  pack_p_ds(acc_s, acc_dp, a_p, a_ds);
  rows_product<E>(acc_dv, a_p, s_do);
  rows_product<E>(acc_dk, a_ds, s_q);
  wgmma_wait<0>();
  fence_regs(acc_dv);
  fence_regs(acc_dk);
  fence_regs(a_p);
  fence_regs(a_ds);
}

template <int E, bool OWN_V = false, class G>
__device__ __forceinline__ void dkv_body(const Args& a, const G& geo) {
  extern __shared__ unsigned char smem_raw[];
  bf16* s_k = reinterpret_cast<bf16*>(aligned_smem(smem_raw));
  bf16* s_v = s_k + TILE<E>;
  bf16* s_qd = s_v + TILE<E>;  // stage st: Q at s_qd + 2 st TILE, dO after it
  float* s_stats = reinterpret_cast<float*>(s_qd + 2 * STAGES * TILE<E>);  // 2 x 64 a stage

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int head = blockIdx.y, img = blockIdx.z;
  const long stat0 = (static_cast<long>(img) * a.n_heads + head) * geo.positions;
  const int n_tiles = geo.tiles;
  const auto own_row = [&](int i) { return geo.own(i); };

  auto load_stage = [&](int j, int st) {
    bf16* tile = s_qd + 2 * st * TILE<E>;
    float* stats = s_stats + 2 * ROWS * st;
    const auto row = [&](int i) { return geo.stream(j, i); };
    load_rows_async<E>(tile, a.q, a.in, img, head, row);
    load_rows_async<E>(tile + TILE<E>, a.dout, a.io, img, head, row);
    load_stats_async(stats, a.lse + stat0, geo, j, 0, 0);
    load_stats_async(stats, a.delta + stat0, geo, j, ROWS, 2);
  };
  load_kv_async<E, OWN_V>(s_k, s_v, a, img, head, own_row);
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_tiles) load_stage(st, st);
    cp_async_commit();
  }

  // this thread's accumulator rows r and r + 8: keys
  const int r = warp * 16 + lane / 4, c = 2 * (lane & 3);
  typename G::Info info[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) info[h] = geo.own_info(r + 8 * h);
  const float scale2 = a.scale * LOG2E;
  float acc_dk[E / 2], acc_dv[E / 2];
#pragma unroll
  for (int i = 0; i < E / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;
  for (int j = 0, st = 0; j < n_tiles; ++j, st = st + 1 == STAGES ? 0 : st + 1) {
    const bf16* s_q = s_qd + 2 * st * TILE<E>;
    if (j + STAGES - 1 < n_tiles) load_stage(j + STAGES - 1, (st + STAGES - 1) % STAGES);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    dkv_step<E>(geo, j, s_k, s_v, s_q, s_q + TILE<E>,
                reinterpret_cast<const float4*>(s_stats + 2 * ROWS * st), info, c, scale2,
                acc_dk, acc_dv);
    __syncthreads();  // every thread is done with this stage before it refills
  }
  stage_acc<E>(acc_dk, a.scale, s_qd);
  stage_acc<E>(acc_dv, 1.f, s_qd + TILE<E>);
  __syncthreads();
  store_rows<E>(s_qd, a.dk, a.io, img, head, own_row);
  store_rows<E>(s_qd + TILE<E>, a.dv, a.io, img, head, own_row);
}

// dkv_body at E = 128: a block of two warpgroups over one key tile, each
// taking every other streamed tile (warpgroup g tiles g, g + 2, ...) with
// dK and dV over all 128 columns in its registers; the two partial sums
// meet in shared memory at the end, warpgroup 0 finishing dK and 1 dV, each
// adding the other's partial to its own (a fixed order: reruns are
// bit-equal). Tiles stream in pairs through PAIRS stages; S^T and dP^T of
// a tile are formed once, by the warpgroup that takes it.
template <int E, bool OWN_V = false, class G>
__device__ __forceinline__ void dkv_pairs_body(const Args& a, const G& geo) {
  static_assert(E == 128, "the paired dk/dv body is E = 128's");
  extern __shared__ unsigned char smem_raw[];
  bf16* s_k = reinterpret_cast<bf16*>(aligned_smem(smem_raw));
  bf16* s_v = s_k + TILE<E>;
  // pair stage p, slot g (the tile of warpgroup g): Q at s_ring + (4 p + 2 g)
  // TILE, dO after it; its statistics 2 x 64 floats at s_stats + 128 (2 p + g)
  bf16* s_ring = s_v + TILE<E>;
  float* s_stats = reinterpret_cast<float*>(s_ring + 4 * PAIRS * TILE<E>);

  // this thread's warpgroup, its index in it and its warp in it
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int warp = t / 32, lane = threadIdx.x & 31;
  const int head = blockIdx.y, img = blockIdx.z;
  const long stat0 = (static_cast<long>(img) * a.n_heads + head) * geo.positions;
  const int n_tiles = geo.tiles, rounds = (n_tiles + 1) / 2;
  const auto own_row = [&](int i) { return geo.own(i); };

  // starts the copy of tiles 2 u and 2 u + 1 (those there are) into pair
  // stage p and commits it, an empty group past the last tile
  auto load_pair = [&](int u, int p) {
    for (int g = 0; g < 2; ++g) {
      const int j = 2 * u + g;
      if (j >= n_tiles) break;
      bf16* tile = s_ring + (4 * p + 2 * g) * TILE<E>;
      float* stats = s_stats + 2 * ROWS * (2 * p + g);
      const auto row = [&](int i) { return geo.stream(j, i); };
      load_rows_async<E>(tile, a.q, a.in, img, head, row);
      load_rows_async<E>(tile + TILE<E>, a.dout, a.io, img, head, row);
      load_stats_async(stats, a.lse + stat0, geo, j, 0, 0);
      load_stats_async(stats, a.delta + stat0, geo, j, ROWS, 2);
    }
    cp_async_commit();
  };
  load_kv_async<E, OWN_V>(s_k, s_v, a, img, head, own_row);
  for (int p = 0; p < PAIRS; ++p) load_pair(p, p);

  // this thread's accumulator rows r and r + 8: keys
  const int r = warp * 16 + lane / 4, c = 2 * (lane & 3);
  typename G::Info info[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) info[h] = geo.own_info(r + 8 * h);
  const float scale2 = a.scale * LOG2E;
  float acc_dk[E / 2], acc_dv[E / 2];
#pragma unroll
  for (int i = 0; i < E / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;
  for (int u = 0; u < rounds; ++u) {
    const int p = u % PAIRS, j = 2 * u + wg;
    cp_async_wait<PAIRS - 1>();
    __syncthreads();
    if (j < n_tiles) {  // uniform over the warpgroup
      const bf16* s_q = s_ring + (4 * p + 2 * wg) * TILE<E>;
      dkv_step<E>(geo, j, s_k, s_v, s_q, s_q + TILE<E>,
                  reinterpret_cast<const float4*>(s_stats + 2 * ROWS * (2 * p + wg)), info, c,
                  scale2, acc_dk, acc_dv);
    }
    __syncthreads();  // both warpgroups are done with pair stage p before it refills
    if (u + PAIRS < rounds) load_pair(u + PAIRS, p);
    else cp_async_commit();
  }

  // the partials meet where the ring was: warpgroup 1's dK and 0's dV, each
  // (E / 2) x 128 floats in thread order; then the bf16 dK and dV stages
  float* s_pk = reinterpret_cast<float*>(s_ring);
  float* s_pv = s_pk + (E / 2) * 128;
  bf16* s_out = reinterpret_cast<bf16*>(s_pv + (E / 2) * 128);
  if (wg == 0) {
#pragma unroll
    for (int i = 0; i < E / 2; ++i) s_pv[i * 128 + t] = acc_dv[i];
  } else {
#pragma unroll
    for (int i = 0; i < E / 2; ++i) s_pk[i * 128 + t] = acc_dk[i];
  }
  __syncthreads();
  if (wg == 0) {
#pragma unroll
    for (int i = 0; i < E / 2; ++i) acc_dk[i] += s_pk[i * 128 + t];
    stage_acc<E>(acc_dk, a.scale, s_out);
  } else {
#pragma unroll
    for (int i = 0; i < E / 2; ++i) acc_dv[i] += s_pv[i * 128 + t];
    // stage_acc takes rows by threadIdx.x / 32: warpgroup 1's rows are
    // 64-127, which a tile 64 rows (8 KB, half an E = 128 tile) before dV's
    // stage puts at dV's rows 0-63
    stage_acc<E>(acc_dv, 1.f, s_out + TILE<E> - TILE<64>);
  }
  __syncthreads();
  store_rows<E>(s_out, a.dk, a.io, img, head, own_row);
  store_rows<E>(s_out + TILE<E>, a.dv, a.io, img, head, own_row);
}

template <int E>
__global__ void __launch_bounds__(128) attn_dq_kernel(const Args a, int s) {
  dq_body<E>(a, Seq(blockIdx.x, s));
}

// At most 168 registers a thread, so that three blocks fit on an SM.
template <int E>
__global__ void __launch_bounds__(128, 3) attn_dkv_kernel(const Args a, int s) {
  dkv_body<E>(a, Seq(blockIdx.x, s));
}

// Launches the dq kernel, then the dk/dv kernel, on q, k, v read through
// `in` (head h at column h * E) and out, dout (b, s, heads, E) contiguous;
// writes delta (b, heads, s) f32 and dq, dk, dv (b, s, heads, E) bf16,
// contiguous. Returns the CUDA error code.
template <int E>
int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           const void* lse, void* delta, void* dq, void* dk, void* dv, int b, int s,
           int n_heads, Rows in, float scale, cudaStream_t st) {
  const long ld = static_cast<long>(n_heads) * E;
  const MapStrides seq{in.batch, in.seq, 0}, io{s * ld, ld, 0};
  const Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
               static_cast<const bf16*>(v), static_cast<const bf16*>(out),
               static_cast<const bf16*>(dout), static_cast<const float*>(lse),
               static_cast<float*>(delta), static_cast<bf16*>(dq), static_cast<bf16*>(dk),
               static_cast<bf16*>(dv), seq, io, n_heads, scale};
  const dim3 grid((s + ROWS - 1) / ROWS, n_heads, b);
  cudaError_t attr = allow_smem(attn_dq_kernel<E>, SMEM<E>);
  attn_dq_kernel<E><<<grid, 128, SMEM<E>, st>>>(a, s);
  const int status = launch_status(attr);
  if (status != 0) return status;
  attr = allow_smem(attn_dkv_kernel<E>, SMEM<E>);
  attn_dkv_kernel<E><<<grid, 128, SMEM<E>, st>>>(a, s);
  return launch_status(attr);
}

}  // namespace attn_bwd
}  // namespace kdt
