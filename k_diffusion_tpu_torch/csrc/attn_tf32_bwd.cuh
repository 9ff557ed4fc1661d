// The backward of exact softmax attention in float32 (--mixed-precision
// no) on the TF32 wgmma tensor cores: the dq kernel (which also forms delta
// = rowsum(out * dout)) and the dk/dv kernel, as bodies over a geometry
// policy (attn_tf32.cuh's Args, the policies of wgmma.cuh and na2d.cuh).
// Over wg::Seq they are K14 in f32 (flash.cu) and K9 in f32
// (global_packed.cu), the dense kernels below; over na2d.cuh's NaQueries
// and NaKeys they are K7 in f32 (na2d.cu) and K12 in f32 (na2d_heads.cu,
// head dims 32, 64 and 128), na_tf32.cuh's kernels. The forward stays on
// attn_tf32.cuh's mma.sync bodies.
//
// Replaces: k_diffusion_tpu/ops/pallas/flash.py:_dq_kernel, :_dkv_kernel,
// global_packed.py:_bwd_kernel, na2d.py:_na_packed_dqkv_kernel,
// :_na_dq_kernel and :_na_dkv_kernel, as they run on f32 operands (the JAX
// model built with dtype=float32): f32 dots with f32 accumulation. Here
// every product runs on the TF32 tensor cores, its operands rounded to
// nearest (cvt.rna, 10 mantissa bits), f32 accumulators; p, ds, lse and
// delta stay in f32 until they become an operand.
//
// What bounds it on the H100: 5 products of 2 s^2 e FLOP per image and
// head against q, k, v, out, dout read and dq, dk, dv written in f32 (the
// cifar10 U-Net at batch 64, s = 256, 4 heads, e = 64: 10.7 GFLOP, 22 us
// at TF32's 494.7 TFLOP/s, against 134 MB, 40 us at 3.35 TB/s: bound by
// the bytes; the neighborhood forms do 5.2x the pair work of their
// windows). A block streams only a few tiles, so what holds it back is
// latency: the copies of its first tiles and the chain of products,
// exponentials and barriers a tile.
//
// What wgmma asks, and the design's answer. Its .tf32 form takes B from
// shared memory K-major only, and A from registers (the RS form) in either
// layout. Of the five products two per kernel reduce over e, which the
// tiles hold contiguously, and three reduce over a streamed tile's rows.
// So every product is written with the streamed tile as its A operand,
// read into registers and rounded as read, and the block's own tiles (or
// p and ds, written by the threads that form them) as its K-major B:
// - dq kernel, own queries Q and dO, streamed keys K and V:
//   S^T = K Q^T and dP^T = V dO^T (reductions over e), dS^T = P^T (dP^T -
//   delta), then dQ^T += K^T dS^T over the tile's keys, dS written to
//   shared memory as the B operand;
// - dk/dv kernel, own keys K and V, streamed queries Q and dO: S = Q K^T
//   and dP = dO V^T, P and dS = P (dP - delta), then dV^T += dO^T P and
//   dK^T += Q^T dS over the tile's queries, P^T and dS^T written to shared
//   memory as the B operands.
// The own tiles are rounded once in shared memory when they land; a
// streamed tile lands as the copy leaves it and is only read through
// registers, so no pass over it rounds it (a pass that rounds each
// streamed tile once, for products reading A from shared memory, made
// the e = 64 kernels slower). The accumulators come out transposed (e by
// rows); they are staged in shared memory as the output tiles and stored
// by the copy engine. A product over a tile's rows reads its A fragment
// down the tile's columns; its depth runs over the rows in a permuted
// order (depth t is row 2 t, depth t + 4 row 2 t + 1 of each 8), which its
// B operand's writers follow (depth_pos), so that both the fragment reads
// and the transposed writes fall in 32 banks.
//
// Copies. One thread starts every tile's copy by the Tensor Memory
// Accelerator: 32-column boxes of a 5-D (e, head, x, y, image) view of
// each tensor through its strides (Maps, encoded on the host each call),
// which land in wgmma's 128-byte swizzle and zero-fill what lies past the
// map; an mbarrier a stage counts the bytes. A box is the geometry's tile
// of rows (own_box, stream_box): 64 sequence rows, an 8 x 8 neighborhood
// tile, or a halo (slab) band of 4 rows of 16 slots, whose slots past the
// halo (slab) but inside the map hold data the geometry's mask rejects.
// Streamed tiles go through a ring of two stages. The dk/dv kernel reads
// each streamed row's lse and delta into registers a tile ahead.
//
// Blocks. At e = 32 and 64 a block is one warpgroup that runs every
// product of a tile in turn (serial bodies), and two blocks share an SM,
// so that one's copies and waits overlap the other's products: the dk/dv
// kernel writes P^T and then dS^T into one exchange tile, and a block of
// either kernel takes 113 KB (115,712 bytes, the most two blocks may take).
// At e = 128 the registers do not allow that: a block is two warpgroups
// that split the products, not the rows, so that no product runs twice and
// no accumulator is summed from partials (split bodies):
// - dq kernel: warpgroup 0 forms S^T and P^T and hands P^T over in shared
//   memory, warpgroup 1 forms dP^T and dS; then each forms 64 rows of dQ^T;
// - dk/dv kernel: warpgroup 0 forms S, P and P^T, warpgroup 1 dP and dS^T,
//   and then 0 accumulates dK^T and 1 dV^T, two m64 blocks each.
// One block an SM (dq 209.5 KB, dk/dv 225 KB). Each output element is
// summed by one thread over the streamed tiles in order, and there are no
// atomics: a rerun is bit-equal, and K9 = K14 and K7 = K12 on the same
// maps bit for bit. At e = 32 the products over the tile's rows run m64
// with their upper 32 rows zero.
#pragma once

#include <cuda.h>

#include <cstdint>

#include "attn_tf32.cuh"
#include "gemm.cuh"
#include "wgmma_tf32.cuh"

namespace kdt {
namespace tf32 {

// warpgroups of a backward block at head dim E, and its threads
template <int E>
constexpr int BWD_WGS = E == 128 ? 2 : 1;
template <int E>
constexpr int BWD_THREADS = 128 * BWD_WGS<E>;
// blocks an SM at head dim E (the launch bounds)
template <int E>
constexpr int BWD_BLOCKS = E == 128 ? 1 : 2;
// stages of the streamed ring
constexpr int RING = 2;
// bytes of a (64, E) f32 tile, E / 32 panels of 8 KB
template <int E>
constexpr int TILE_BYTES = ROWS * E * 4;
// bytes of a 64 x 64 f32 exchange tile (P^T, dS, dS^T)
constexpr int X_BYTES = ROWS * ROWS * 4;
// m64 blocks of an accumulator over e rows (e = 32 pads to one)
template <int E>
constexpr int MB = E == 128 ? 2 : 1;

// Byte offset of element (r, c) of a (64, E) f32 tile: panel c / 32, row r
// of 128 bytes, the 16-byte chunk XORed with r mod 8 (the copy engine's
// 128-byte swizzle on a tile aligned to 1024 bytes).
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c >> 5) * (ROWS * 128) + r * 128 + ((((c >> 2) & 7) ^ (r & 7)) << 4) + ((c & 3) << 2);
}

// The depth position, in a product over a tile's rows, of the tile's row r:
// rows 2 t and 2 t + 1 of each 8 are depths t and t + 4.
__device__ __forceinline__ int depth_pos(int r) {
  return (r & ~7) | ((r & 1) << 2) | ((r & 7) >> 1);
}

__device__ __forceinline__ float lds(const unsigned char* p) {
  return *reinterpret_cast<const float*>(p);
}

// Generic-proxy accesses to shared memory ordered with the async proxy's
// (wgmma's reads, the copy engine's writes); a barrier must follow before
// another thread's wgmma or copy.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Named barriers between the two warpgroups of a split block: arrive
// (producer) and sync (consumer, or all `n` threads).
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// ---- copies ----------------------------------------------------------------

// The tensor maps of a backward launch: its own tiles' (dq kernel: Q, dO
// and out; dk/dv kernel: K and V), its streamed tiles' (dq: K and V;
// dk/dv: Q and dO) and its outputs' (dq; dk and dv).
struct Maps {
  CUtensorMap own[3], stream[2], out[2];
};

// The block's mbarriers (the own tiles', then each ring stage's),
// initialised, in the 1024 bytes of alignment slack: before the tiles
// where the slack there holds them, else after the tiles' `bytes`.
__device__ __forceinline__ uint64_t* init_bars(unsigned char* raw, unsigned char* tiles,
                                               int bytes) {
  constexpr int N = 1 + RING;
  uint64_t* bar = reinterpret_cast<uint64_t*>(tiles - raw >= 8 * N ? raw : tiles + bytes);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) gemm::mbar_init(&bar[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return bar;
}

// The arrival of the copying thread on `bar`, which then expects `bytes`.
__device__ __forceinline__ void expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   wg::smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Starts the copy of the (64, E) tile of head `head` of image `img` whose
// row 0 lies at map position `at` into the tile at dst: E / 32 boxes, one
// a panel, their bytes counted on bar.
template <int E>
__device__ __forceinline__ void copy_tile(unsigned char* dst, const CUtensorMap* map, int head,
                                          wg::Pos at, int img, uint64_t* bar) {
#pragma unroll
  for (int p = 0; p < E / 32; ++p)
    asm volatile(
        "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, "
        "{%2, %3, %4, %5, %6}], [%7];\n" ::"r"(wg::smem_u32(dst + p * ROWS * 128)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(32 * p), "r"(head), "r"(at.x), "r"(at.y),
        "r"(img), "r"(wg::smem_u32(bar))
        : "memory");
}

// Starts the copy of streamed tile j's two tiles (map.stream[0] and [1])
// into the ring stage at dst, counted on bar; the copying thread calls it
// once the block is done with the stage.
template <int E, class G>
__device__ __forceinline__ void copy_stage(unsigned char* dst, const Maps& m, const G& geo, int j,
                                           int head, int img, uint64_t* bar) {
  fence_async_smem();  // the block's plain reads of the stage come first
  expect(bar, 2 * TILE_BYTES<E>);
  copy_tile<E>(dst, &m.stream[0], head, geo.stream_box(j), img, bar);
  copy_tile<E>(dst + TILE_BYTES<E>, &m.stream[1], head, geo.stream_box(j), img, bar);
}

// Rounds a landed (64, E) tile to TF32 in place (the order of its elements
// does not matter), the block's THREADS threads taking part.
template <int E, int THREADS>
__device__ __forceinline__ void round_tile(unsigned char* tile) {
  for (int i = threadIdx.x; i < ROWS * E / 4; i += THREADS) {
    float4* p = reinterpret_cast<float4*>(tile + 16 * i);
    const float4 v = *p;
    *p = make_float4(tw::round_tf32(v.x), tw::round_tf32(v.y), tw::round_tf32(v.z),
                     tw::round_tf32(v.w));
  }
}

// ---- products ----------------------------------------------------------------

// The rounded A fragment of k8 slice kk of a product over e whose A rows
// are the tile's rows: A (m, k) = tile[m][k], m = 16 w + g (+ 8), k = 8 kk
// + t (+ 4).
__device__ __forceinline__ void frag_rows(uint32_t (&a)[4], const unsigned char* tile, int kk) {
  const int lane = threadIdx.x & 31;
  const int m = 16 * ((threadIdx.x / 32) & 3) + (lane >> 2), k = 8 * kk + (lane & 3);
  a[0] = tw::to_tf32(lds(tile + swz(m, k)));
  a[1] = tw::to_tf32(lds(tile + swz(m + 8, k)));
  a[2] = tw::to_tf32(lds(tile + swz(m, k + 4)));
  a[3] = tw::to_tf32(lds(tile + swz(m + 8, k + 4)));
}

// The rounded A fragment of k8 slice kk of a product over the tile's rows
// whose A rows are the tile's columns m0 + 16 w + g (+ 8): A (m, k) =
// tile[row][m], depths t and t + 4 rows 8 kk + 2 t and 8 kk + 2 t + 1
// (depth_pos). Columns past E (e = 32's padding) are zero.
template <int E>
__device__ __forceinline__ void frag_cols(uint32_t (&a)[4], const unsigned char* tile, int m0,
                                          int kk) {
  const int lane = threadIdx.x & 31;
  const int m = m0 + 16 * ((threadIdx.x / 32) & 3) + (lane >> 2), r = 8 * kk + 2 * (lane & 3);
  if (E < 64 && m >= E) {
    a[0] = a[1] = a[2] = a[3] = 0u;
    return;
  }
  a[0] = tw::to_tf32(lds(tile + swz(r, m)));
  a[1] = tw::to_tf32(lds(tile + swz(r, m + 8)));
  a[2] = tw::to_tf32(lds(tile + swz(r + 1, m)));
  a[3] = tw::to_tf32(lds(tile + swz(r + 1, m + 8)));
}

// Starts acc (64 x N) += A B over K / 8 k8 slices, A the fragments a, B the
// K-major tile at `b` (panels of 32 depths 8 KB apart) from its row n0; not
// committed.
template <int N, int K>
__device__ __forceinline__ void chain(float (&acc)[N / 2], const uint32_t (&a)[K / 8][4],
                                      const unsigned char* b, int n0) {
  const uint64_t d = tw::desc(b) + static_cast<uint64_t>(n0 * 128 / 16);
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk)
    tw::mma<N>(acc, a[kk], d + (kk / 4) * (ROWS * 128 / 16) + (kk % 4) * 2, 1);
}

// acc (64 x 64) = X Y^T over E, X the streamed tile x (its rows the A rows,
// read into registers), Y the own rounded tile y (B): started and committed
// as one group; `a` must stay untouched until the group is waited for.
template <int E>
__device__ __forceinline__ void start_e(float (&acc)[32], uint32_t (&a)[E / 8][4],
                                        const unsigned char* x, const unsigned char* y) {
#pragma unroll
  for (int kk = 0; kk < E / 8; ++kk) frag_rows(a[kk], x, kk);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  wg::fence_regs(a);
  wg::fence_regs(acc);
  wg::wgmma_fence();
  chain<64, E>(acc, a, y, 0);
  wg::wgmma_commit();
}

// acc (64 x N) += X^T Z over the 64 rows of the streamed tile x: A its
// columns [m0, m0 + 64) read into a, B the exchange tile z (rows n0 + n,
// depth_pos order); started and committed as one group, `a` untouched
// until it is waited for (product_rows waits).
template <int E, int N>
__device__ __forceinline__ void start_rows(float (&acc)[N / 2], uint32_t (&a)[8][4],
                                           const unsigned char* x, int m0, const unsigned char* z,
                                           int n0) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) frag_cols<E>(a[kk], x, m0, kk);
  wg::fence_regs(a);
  wg::fence_regs(acc);
  wg::wgmma_fence();
  chain<N, 64>(acc, a, z, n0);
  wg::wgmma_commit();
}
template <int E, int N>
__device__ __forceinline__ void product_rows(float (&acc)[N / 2], const unsigned char* x, int m0,
                                             const unsigned char* z, int n0) {
  uint32_t a[8][4];
  start_rows<E, N>(acc, a, x, m0, z, n0);
  wg::wgmma_wait<0>();
  wg::fence_regs(acc);
  wg::fence_regs(a);
}

// The thread's 32 elements of a 64 x 64 accumulator to or from an exchange
// tile in thread order (a warpgroup's thread i writes, the other's thread i
// reads the same elements): 16-byte words, conflict-free.
__device__ __forceinline__ void put_raw(const float (&x)[32], unsigned char* z) {
  float4* p = reinterpret_cast<float4*>(z) + threadIdx.x % 128;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    p[128 * i] = make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
}
__device__ __forceinline__ void get_raw(float (&x)[32], const unsigned char* z) {
  const float4* p = reinterpret_cast<const float4*>(z) + threadIdx.x % 128;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float4 v = p[128 * i];
    x[4 * i] = v.x;
    x[4 * i + 1] = v.y;
    x[4 * i + 2] = v.z;
    x[4 * i + 3] = v.w;
  }
}

// Writes a 64 x 64 accumulator x (rows r, columns c), rounded, as the
// K-major B operand of a product over its rows: tile row c, depth
// depth_pos(r); made visible to wgmma (a barrier must follow).
__device__ __forceinline__ void put_t(const float (&x)[32], unsigned char* z) {
  const int lane = threadIdx.x & 31, r0 = 16 * ((threadIdx.x / 32) & 3) + (lane >> 2);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + 8 * (e >> 1), c = 8 * i + 2 * (lane & 3) + (e & 1);
      *reinterpret_cast<float*>(z + swz(c, depth_pos(r))) = tw::round_tf32(x[4 * i + e]);
    }
  fence_async_smem();
}

// ---- softmax pieces -------------------------------------------------------------

// P^T of the dq kernel in place of the logits S^T (rows the streamed
// keys, columns the own queries 8 i + 2 t (+ 1), whose lse (log2 e) is
// lse2[2 i (+ 1)]): exp2(S^T scale2 - lse) where the pair attends, else 0,
// by the hardware's ex2.approx (2 ulp, far below the products' TF32
// rounding), as the bf16 kernels take it.
template <class G>
__device__ __forceinline__ void p_keys(float (&s)[32], const G& geo, int j, float scale2,
                                       const float (&lse2)[16]) {
  const int lane = threadIdx.x & 31, r0 = 16 * ((threadIdx.x / 32) & 3) + (lane >> 2);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * i + 2 * (lane & 3) + (e & 1);
      const bool on = geo.mask(j, r0 + 8 * (e >> 1), geo.own_info(col));
      const float x = s[4 * i + e] * scale2 - lse2[2 * i + (e & 1)];
      s[4 * i + e] = on ? wg::exp2_approx(x) : 0.f;
    }
}

// P of the dk/dv kernel in place of the logits S (rows the streamed
// queries, whose lse (log2 e) is lse2[h] for row g + 8 h, columns the own
// keys): as p_keys.
template <class G>
__device__ __forceinline__ void p_queries(float (&s)[32], const G& geo, int j, float scale2,
                                          const float (&lse2)[2]) {
  const int lane = threadIdx.x & 31, r0 = 16 * ((threadIdx.x / 32) & 3) + (lane >> 2);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * i + 2 * (lane & 3) + (e & 1);
      const bool on = geo.mask(j, r0 + 8 * (e >> 1), geo.own_info(col));
      s[4 * i + e] = on ? wg::exp2_approx(s[4 * i + e] * scale2 - lse2[e >> 1]) : 0.f;
    }
}

// The lse (times log2 e) and delta of streamed tile j's rows g and g + 8
// of this thread's warp, read from device memory (0 where a slot holds no
// row).
template <class G>
__device__ __forceinline__ void row_stats(const Args& a, const G& geo, long stat0, int j,
                                          float (&lse2)[2], float (&delta)[2]) {
  const int r0 = 16 * ((threadIdx.x / 32) & 3) + ((threadIdx.x & 31) >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const wg::Pos p = geo.stream(j, r0 + 8 * h);
    lse2[h] = p.ok ? a.lse[stat0 + geo.index(p)] * LOG2E : 0.f;
    delta[h] = p.ok ? a.delta[stat0 + geo.index(p)] : 0.f;
  }
}

// delta = rowsum(out * dout) of the own rows from the landed out and dO
// tiles, THREADS / 64 threads a row: to s_delta and a.delta.
template <int E, int THREADS, class G>
__device__ __forceinline__ void form_delta(const Args& a, const G& geo, long stat0,
                                           const unsigned char* s_out,
                                           const unsigned char* s_do, float* s_delta) {
  constexpr int PER = THREADS / ROWS;
  const int row = threadIdx.x / PER, part = threadIdx.x % PER;
  float sum = 0.f;
#pragma unroll
  for (int c = part; c < E / 4; c += PER) {
    const float4 o = *reinterpret_cast<const float4*>(s_out + swz(row, 4 * c));
    const float4 d = *reinterpret_cast<const float4*>(s_do + swz(row, 4 * c));
    sum += o.x * d.x + o.y * d.y + o.z * d.z + o.w * d.w;
  }
#pragma unroll
  for (int o = 1; o < PER; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (part == 0) {
    s_delta[row] = sum;
    const wg::Pos p = geo.own(row);
    if (p.ok) a.delta[stat0 + geo.index(p)] = sum;
  }
}

// ---- stores ----------------------------------------------------------------------

// Stages a warpgroup's e-by-rows accumulator of NB m64 blocks from e row m0
// (64 own rows each), times mul, as the (64, E) output tile at s_o (row n,
// column m, in the copy engine's swizzle); rows past E are dropped.
template <int E, int NB>
__device__ __forceinline__ void stage_tile(const float (&acc)[NB][32], int m0, float mul,
                                           unsigned char* s_o) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x / 32) & 3;
#pragma unroll
  for (int mb = 0; mb < NB; ++mb)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + 64 * mb + 16 * w + (lane >> 2) + 8 * (e >> 1);
        const int n = 8 * i + 2 * (lane & 3) + (e & 1);
        if (m < E) *reinterpret_cast<float*>(s_o + swz(n, m)) = acc[mb][4 * i + e] * mul;
      }
}

// Starts the copy of the staged (64, E) tile at s_o to the own rows of head
// `head` of image `img` through `map` (rows past the map are not written);
// the copying thread calls it once the block has staged the tile.
template <int E>
__device__ __forceinline__ void store_tile(const unsigned char* s_o, const CUtensorMap* map,
                                           int head, wg::Pos at, int img) {
#pragma unroll
  for (int p = 0; p < E / 32; ++p)
    asm volatile(
        "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group [%0, {%1, %2, %3, %4, %5}], "
        "[%6];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
        "r"(32 * p), "r"(head), "r"(at.x), "r"(at.y), "r"(img),
        "r"(wg::smem_u32(s_o + p * ROWS * 128))
        : "memory");
}
// Commits the copying thread's stores and waits until they have read
// shared memory, so that the block may end.
__device__ __forceinline__ void stores_done() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// ---- the dq kernel ----------------------------------------------------------------

// The dq kernel's shared memory: own Q and dO, the ring's stages of K and
// V, the exchange tile (which holds lse and delta of the own rows until
// they are in registers), the slack that aligns the tiles and holds the
// barriers.
template <int E>
constexpr int DQ_BYTES = (2 + 2 * RING) * TILE_BYTES<E> + X_BYTES;
template <int E>
constexpr size_t DQ_SMEM = DQ_BYTES<E> + 1024;

// The dq kernel: the block's 64 own (query) rows of head blockIdx.y of
// image blockIdx.z against every streamed (key) tile. It forms delta =
// rowsum(out * dout) for its rows (written to a.delta for the dk/dv
// kernel), then dq = scale sum_j dS_j K_j with dS = P (dP - delta), P =
// exp(logits - lse) where the pair attends (else 0), dP = dO V^T, all
// transposed (keys by rows): one warpgroup in turn (E 32, 64), or
// warpgroup 0 forming P^T and warpgroup 1 dP^T and dS (E = 128).
template <int E, class G>
__device__ __forceinline__ void wg_dq_body(const Args& a, const Maps& m, const G& geo) {
  constexpr int T = TILE_BYTES<E>, THREADS = BWD_THREADS<E>;
  constexpr bool SPLIT = BWD_WGS<E> == 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* s_q = wg::aligned_smem(smem_raw);
  unsigned char* s_do = s_q + T;
  unsigned char* s_ring = s_do + T;  // stage st: K at 2 st T, V after it
  unsigned char* s_x = s_ring + 2 * RING * T;
  float* s_stat = reinterpret_cast<float*>(s_x);  // lse2, then delta, until the loop
  uint64_t* bar = init_bars(smem_raw, s_q, DQ_BYTES<E>);  // own, then the stages
  const int head = blockIdx.y, img = blockIdx.z;
  const int wgi = threadIdx.x / 128;
  const long stat0 = (static_cast<long>(img) * a.n_heads + head) * geo.positions;
  const int n_tiles = geo.tiles;
  const float scale2 = a.scale * LOG2E;

  // out waits in stage 1's K slot until delta is formed
  unsigned char* s_out = s_ring + 2 * T;
  if (threadIdx.x == 0) {
    expect(&bar[0], 3 * T);
    copy_tile<E>(s_q, &m.own[0], head, geo.own_box(), img, &bar[0]);
    copy_tile<E>(s_do, &m.own[1], head, geo.own_box(), img, &bar[0]);
    copy_tile<E>(s_out, &m.own[2], head, geo.own_box(), img, &bar[0]);
    copy_stage<E>(s_ring, m, geo, 0, head, img, &bar[1]);
  }
  if (threadIdx.x < ROWS) {
    const wg::Pos p = geo.own(threadIdx.x);
    s_stat[threadIdx.x] = p.ok ? a.lse[stat0 + geo.index(p)] * LOG2E : 0.f;
  }
  gemm::mbar_wait(&bar[0], 0);
  form_delta<E, THREADS>(a, geo, stat0, s_out, s_do, s_stat + ROWS);
  __syncthreads();  // dO read for delta before it is rounded; the stats written
  round_tile<E, THREADS>(s_q);
  round_tile<E, THREADS>(s_do);
  fence_async_smem();  // the first tile's barrier makes them visible

  // this thread's own (query) columns 8 i + 2 t (+ 1): their lse (log2 e)
  // and delta (a split block's warpgroup 0 needs the one, 1 the other)
  float lse2[16], delta[16];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * i + 2 * (threadIdx.x & 3) + e;
      lse2[2 * i + e] = s_stat[col];
      delta[2 * i + e] = s_stat[ROWS + col];
    }
  // dQ^T: every e row of the 64 queries, or a split block's warpgroup's 64
  const int m0 = SPLIT ? 64 * wgi : 0;
  float acc_dq[1][32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_dq[0][i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    gemm::mbar_wait(&bar[1 + st], (j >> 1) & 1);
    // tile j has landed; every thread is done with tile j - 1's stage (and,
    // at j = 0, with out's) and with the exchange tile
    __syncthreads();
    if (threadIdx.x == 0 && j + 1 < n_tiles)
      copy_stage<E>(s_ring + 2 * (st ^ 1) * T, m, geo, j + 1, head, img, &bar[2 - st]);
    const unsigned char* s_k = s_ring + 2 * st * T;
    const unsigned char* s_v = s_k + T;
    float acc_s[32], acc_dp[32];
    uint32_t a_k[E / 8][4], a_v[E / 8][4];
    if constexpr (!SPLIT) {
      // S^T = K Q^T and dP^T = V dO^T, two groups; P^T and dS^T = P^T (dP^T
      // - delta) as they land
      start_e<E>(acc_s, a_k, s_k, s_q);
      start_e<E>(acc_dp, a_v, s_v, s_do);
      wg::wgmma_wait<1>();
      wg::fence_regs(acc_s);
      wg::fence_regs(a_k);
      p_keys(acc_s, geo, j, scale2, lse2);
      wg::wgmma_wait<0>();
      wg::fence_regs(acc_dp);
      wg::fence_regs(a_v);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc_dp[4 * i + e] = acc_s[4 * i + e] * (acc_dp[4 * i + e] - delta[2 * i + (e & 1)]);
      put_t(acc_dp, s_x);
    } else if (wgi == 0) {
      start_e<E>(acc_s, a_k, s_k, s_q);
      wg::wgmma_wait<0>();
      wg::fence_regs(acc_s);
      wg::fence_regs(a_k);
      p_keys(acc_s, geo, j, scale2, lse2);
      put_raw(acc_s, s_x);
      bar_arrive(1, THREADS);
    } else {
      start_e<E>(acc_dp, a_v, s_v, s_do);
      wg::wgmma_wait<0>();
      wg::fence_regs(acc_dp);
      wg::fence_regs(a_v);
      bar_sync(1, THREADS);
      get_raw(acc_s, s_x);
      bar_sync(2, 128);  // every P^T element read before dS overwrites it
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc_dp[4 * i + e] = acc_s[4 * i + e] * (acc_dp[4 * i + e] - delta[2 * i + (e & 1)]);
      put_t(acc_dp, s_x);
    }
    __syncthreads();  // dS is in the exchange tile
    // dQ^T += K^T dS^T over the tile's keys
    product_rows<E, 64>(acc_dq[0], s_k, m0, s_x, 0);
  }
  __syncthreads();  // every product is done with the ring
  stage_tile<E, 1>(acc_dq, m0, a.scale, s_ring);
  fence_async_smem();
  __syncthreads();
  if (threadIdx.x == 0) {
    store_tile<E>(s_ring, &m.out[0], head, geo.own_box(), img);
    stores_done();
  }
}

// ---- the dk/dv kernel ---------------------------------------------------------------

// The dk/dv kernel's shared memory: own K and V, the ring's stages of Q and
// dO, the exchange tile (and P^T's at e = 128), the slack.
template <int E>
constexpr int DKV_BYTES = (2 + 2 * RING) * TILE_BYTES<E> + BWD_WGS<E> * X_BYTES;
template <int E>
constexpr size_t DKV_SMEM = DKV_BYTES<E> + 1024;

// The dk/dv kernel: the block's 64 own (key) rows against every streamed
// (query) tile, with the queries' lse and delta: S = Q K^T, P = exp(S -
// lse) where the pair attends (else 0), dP = dO V^T, dS = P (dP - delta);
// dv = sum_i P^T dO and dk = scale sum_i dS^T Q, accumulated transposed:
// one warpgroup in turn (E 32, 64), or warpgroup 0 forming P, P^T and dK^T
// and warpgroup 1 dP, dS^T and dV^T (E = 128). Slots that hold no row get
// lse and delta 0: the geometry, not their values, rejects them.
template <int E, class G>
__device__ __forceinline__ void wg_dkv_body(const Args& a, const Maps& m, const G& geo) {
  constexpr int T = TILE_BYTES<E>, THREADS = BWD_THREADS<E>;
  constexpr bool SPLIT = BWD_WGS<E> == 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* s_k = wg::aligned_smem(smem_raw);
  unsigned char* s_v = s_k + T;
  unsigned char* s_ring = s_v + T;          // stage st: Q at 2 st T, dO after it
  unsigned char* s_x = s_ring + 2 * RING * T;  // P^T, then dS^T (split: P, then dS^T)
  unsigned char* s_pt = SPLIT ? s_x + X_BYTES : s_x;  // P^T
  uint64_t* bar = init_bars(smem_raw, s_k, DKV_BYTES<E>);  // own, then the stages
  const int head = blockIdx.y, img = blockIdx.z;
  const int wgi = threadIdx.x / 128;
  const long stat0 = (static_cast<long>(img) * a.n_heads + head) * geo.positions;
  const int n_tiles = geo.tiles;
  const float scale2 = a.scale * LOG2E;

  if (threadIdx.x == 0) {
    expect(&bar[0], 2 * T);
    copy_tile<E>(s_k, &m.own[0], head, geo.own_box(), img, &bar[0]);
    copy_tile<E>(s_v, &m.own[1], head, geo.own_box(), img, &bar[0]);
    copy_stage<E>(s_ring, m, geo, 0, head, img, &bar[1]);
  }
  float lse2[2], delta[2];
  row_stats(a, geo, stat0, 0, lse2, delta);
  gemm::mbar_wait(&bar[0], 0);
  round_tile<E, THREADS>(s_k);
  round_tile<E, THREADS>(s_v);
  fence_async_smem();  // the first tile's barrier makes them visible

  // dK^T and dV^T, or a split block's warpgroup's one (0 dK^T, 1 dV^T)
  constexpr int NACC = SPLIT ? 1 : 2;
  float acc_d[NACC][MB<E>][32];
#pragma unroll
  for (int o = 0; o < NACC; ++o)
#pragma unroll
    for (int mb = 0; mb < MB<E>; ++mb)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc_d[o][mb][i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    gemm::mbar_wait(&bar[1 + st], (j >> 1) & 1);
    // tile j has landed; every thread is done with tile j - 1's stage and
    // with the exchange tiles
    __syncthreads();
    if (threadIdx.x == 0 && j + 1 < n_tiles)
      copy_stage<E>(s_ring + 2 * (st ^ 1) * T, m, geo, j + 1, head, img, &bar[2 - st]);
    const float cur_lse2[2] = {lse2[0], lse2[1]}, cur_delta[2] = {delta[0], delta[1]};
    if (j + 1 < n_tiles) row_stats(a, geo, stat0, j + 1, lse2, delta);
    const unsigned char* s_q = s_ring + 2 * st * T;
    const unsigned char* s_do = s_q + T;
    float acc_s[32], acc_dp[32];
    uint32_t a_q[E / 8][4], a_do[E / 8][4];
    if constexpr (!SPLIT) {
      // S = Q K^T and dP = dO V^T, two groups; P^T to the exchange tile,
      // dV^T += dO^T P; then dS = P (dP - delta) as dS^T, dK^T += Q^T dS
      start_e<E>(acc_s, a_q, s_q, s_k);
      start_e<E>(acc_dp, a_do, s_do, s_v);
      wg::wgmma_wait<1>();
      wg::fence_regs(acc_s);
      wg::fence_regs(a_q);
      p_queries(acc_s, geo, j, scale2, cur_lse2);
      put_t(acc_s, s_pt);
      __syncthreads();  // P^T is in the exchange tile
      // dV^T += dO^T P runs while dS = P (dP - delta) is formed
      uint32_t a_t[8][4];
      start_rows<E, 64>(acc_d[NACC - 1][0], a_t, s_do, 0, s_pt, 0);
      wg::wgmma_wait<1>();
      wg::fence_regs(acc_dp);
      wg::fence_regs(a_do);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc_dp[i] = acc_s[i] * (acc_dp[i] - cur_delta[(i >> 1) & 1]);
      wg::wgmma_wait<0>();
      wg::fence_regs(acc_d[NACC - 1][0]);
      wg::fence_regs(a_t);
      __syncthreads();  // every product is done with P^T
      put_t(acc_dp, s_x);
      __syncthreads();  // dS^T is in the exchange tile
      product_rows<E, 64>(acc_d[0][0], s_q, 0, s_x, 0);
    } else if (wgi == 0) {
      start_e<E>(acc_s, a_q, s_q, s_k);
      wg::wgmma_wait<0>();
      wg::fence_regs(acc_s);
      wg::fence_regs(a_q);
      p_queries(acc_s, geo, j, scale2, cur_lse2);
      put_raw(acc_s, s_x);
      put_t(acc_s, s_pt);
      bar_arrive(1, THREADS);
      bar_sync(3, THREADS);  // dS^T is in the exchange tile
      // dK^T += Q^T dS over the tile's queries
#pragma unroll
      for (int mb = 0; mb < MB<E>; ++mb) product_rows<E, 64>(acc_d[0][mb], s_q, 64 * mb, s_x, 0);
    } else {
      start_e<E>(acc_dp, a_do, s_do, s_v);
      wg::wgmma_wait<0>();
      wg::fence_regs(acc_dp);
      wg::fence_regs(a_do);
      bar_sync(1, THREADS);
      get_raw(acc_s, s_x);
      bar_sync(2, 128);  // every P element read before dS^T overwrites it
#pragma unroll
      for (int i = 0; i < 32; ++i) acc_dp[i] = acc_s[i] * (acc_dp[i] - cur_delta[(i >> 1) & 1]);
      put_t(acc_dp, s_x);
      bar_arrive(3, THREADS);
      // dV^T += dO^T P over the tile's queries
#pragma unroll
      for (int mb = 0; mb < MB<E>; ++mb)
        product_rows<E, 64>(acc_d[0][mb], s_do, 64 * mb, s_pt, 0);
    }
  }
  __syncthreads();  // every product is done with the ring
  unsigned char* s_dk = s_ring;
  unsigned char* s_dv = s_ring + T;
  if constexpr (SPLIT) {
    stage_tile<E, MB<E>>(acc_d[0], 0, wgi == 0 ? a.scale : 1.f, wgi == 0 ? s_dk : s_dv);
  } else {
    stage_tile<E, MB<E>>(acc_d[0], 0, a.scale, s_dk);
    stage_tile<E, MB<E>>(acc_d[NACC - 1], 0, 1.f, s_dv);
  }
  fence_async_smem();
  __syncthreads();
  if (threadIdx.x == 0) {
    store_tile<E>(s_dk, &m.out[0], head, geo.own_box(), img);
    store_tile<E>(s_dv, &m.out[1], head, geo.own_box(), img);
    stores_done();
  }
}

// ---- launches -------------------------------------------------------------------

// The tensor map of the E-wide rows of heads of `base` read through strides
// st, as a 5-D (e, head, x, y, image) view of a (b, h, w, heads, E) map (a
// sequence: h = s, w = 1), for boxes of 32 e by one head by bx x by
// positions.
template <int E>
cudaError_t rows_map(CUtensorMap* map, const float* base, const MapStrides& st, int b, int h,
                     int w, int heads, int bx, int by) {
  gemm::EncodeTiled encode;
  const cudaError_t err = gemm::encode_tiled(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[5] = {E, static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(w),
                              static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(b)};
  // a sequence's one column takes the row stride (a stride must not be 0)
  const cuuint64_t strides[4] = {E * 4, static_cast<cuuint64_t>(w > 1 ? st.x : st.y) * 4,
                                 static_cast<cuuint64_t>(st.y) * 4,
                                 static_cast<cuuint64_t>(st.b) * 4};
  const cuuint32_t box[5] = {32, 1, static_cast<cuuint32_t>(bx), static_cast<cuuint32_t>(by), 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 5, const_cast<float*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The maps of both kernels of a backward launch over (b, h, w, heads, E)
// maps: own tiles in boxes of ox x oy positions, streamed ones in sx x sy.
template <int E>
cudaError_t bwd_maps(const Args& a, int b, int h, int w, int ox, int oy, int sx, int sy,
                     Maps& dq, Maps& dkv) {
  const int n = a.n_heads;
  const struct {
    CUtensorMap* map;
    const float* base;
    const MapStrides& st;
    int bx, by;
  } all[] = {{&dq.own[0], a.q, a.sq, ox, oy},        {&dq.own[1], a.dout, a.io, ox, oy},
             {&dq.own[2], a.out, a.io, ox, oy},      {&dq.stream[0], a.k, a.sk, sx, sy},
             {&dq.stream[1], a.v, a.sv, sx, sy},     {&dq.out[0], a.dq, a.io, ox, oy},
             {&dkv.own[0], a.k, a.sk, ox, oy},       {&dkv.own[1], a.v, a.sv, ox, oy},
             {&dkv.stream[0], a.q, a.sq, sx, sy},    {&dkv.stream[1], a.dout, a.io, sx, sy},
             {&dkv.out[0], a.dk, a.io, ox, oy},      {&dkv.out[1], a.dv, a.io, ox, oy}};
  for (const auto& x : all) {
    const cudaError_t err = rows_map<E>(x.map, x.base, x.st, b, h, w, n, x.bx, x.by);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Launches `dq_kernel`, then `dkv_kernel`, on `grid` with the maps and
// the trailing arguments `rest`.
template <int E, class DqKernel, class DkvKernel, class... Rest>
int launch_pair(DqKernel dq_kernel, DkvKernel dkv_kernel, dim3 grid, const Args& a,
                const Maps& dq, const Maps& dkv, cudaStream_t st, Rest... rest) {
  cudaError_t attr = allow_smem(dq_kernel, DQ_SMEM<E>);
  dq_kernel<<<grid, BWD_THREADS<E>, DQ_SMEM<E>, st>>>(a, dq, rest...);
  const int status = launch_status(attr);
  if (status != 0) return status;
  attr = allow_smem(dkv_kernel, DKV_SMEM<E>);
  dkv_kernel<<<grid, BWD_THREADS<E>, DKV_SMEM<E>, st>>>(a, dkv, rest...);
  return launch_status(attr);
}

// The dense kernels (K14 and K9 in f32): a block owns rows [64 blockIdx.x,
// 64 blockIdx.x + 64) of the sequence (wg::Seq) and every 64-row tile
// streams past them.
template <int E>
__global__ void __launch_bounds__(BWD_THREADS<E>, BWD_BLOCKS<E>)
    tf32_wg_dq_kernel(const Args a, const __grid_constant__ Maps m, int s) {
  wg_dq_body<E>(a, m, wg::Seq(blockIdx.x, s));
}

template <int E>
__global__ void __launch_bounds__(BWD_THREADS<E>, BWD_BLOCKS<E>)
    tf32_wg_dkv_kernel(const Args a, const __grid_constant__ Maps m, int s) {
  wg_dkv_body<E>(a, m, wg::Seq(blockIdx.x, s));
}

// The dq kernel (which writes delta), then the dk/dv kernel on the same
// stream, on q, k, v read through `in` (head h at column h * E) and out,
// dout, dq, dk, dv (b, s, heads, E) contiguous; any s >= 1. Returns the
// CUDA error code.
template <int E>
int launch_bwd(const Args& args, Rows in, int b, int s, cudaStream_t st) {
  const Args a = dense<E>(args, in, s);
  Maps dq, dkv;
  const cudaError_t err = bwd_maps<E>(a, b, s, 1, 1, ROWS, 1, ROWS, dq, dkv);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + ROWS - 1) / ROWS, a.n_heads, b);
  return launch_pair<E>(tf32_wg_dq_kernel<E>, tf32_wg_dkv_kernel<E>, grid, a, dq, dkv, st, s);
}

}  // namespace tf32
}  // namespace kdt
