// Exact softmax attention in float32, the kernels of --mixed-precision no,
// on the TF32 wgmma tensor cores: the forward with its logsumexp (below)
// and the pieces it shares with the backward (attn_tf32_bwd.cuh): the
// launch arguments (Args), the tiles' layout, their copies and stores by
// the Tensor Memory Accelerator, and the products. Both are bodies over a
// geometry policy (wgmma.cuh's Seq, na2d.cuh's NaQueries and NaKeys). Over
// wg::Seq the forward is K13 in f32 (flash.cu) and K3 in f32
// (global_packed.cu), the dense kernel below; over NaQueries it is K2 in
// f32 (na2d.cu) and K11 in f32 (na2d_heads.cu, head dims 32, 64 and 128),
// na_tf32.cuh's kernel, and na_proj_tf32.cuh's K15 in f32 runs its
// attention (fwd_attend) in its cluster.
//
// Replaces: k_diffusion_tpu/ops/pallas/flash.py:_fwd_kernel as it runs on
// f32 operands (the JAX model built with dtype=float32): f32 dots with f32
// accumulation, p / l in f32; na_tf32.cuh says what the neighborhood
// kernels replace. Here every product runs on the TF32 tensor cores, its
// operands rounded to nearest (cvt.rna, 10 mantissa bits), with f32
// accumulation, as PyTorch's float32 training does with TF32 on; the
// softmax, its rescales and lse stay in f32.
//
// What bounds the forward on the H100, cifar10 U-Net at batch 64 (s = 256,
// 4 heads, head dim 64): 4 s^2 64 FLOP per image and head, 4.3 GFLOP, 8.7
// us at TF32's 494.7 TFLOP/s, against q, k, v and the output in f32, 4 x
// 16.8 MB, 20 us at 3.35 TB/s: bound by memory (the neighborhood forms at
// 12 FLOP a byte, na_tf32.cuh). A block streams only a few tiles (4 at a
// 7 x 7 window), so what holds it back is latency: the copies of its first
// tiles and the chain of products, exponentials and barriers a tile.
//
// What wgmma asks, and the design's answer. Its .tf32 form takes B from
// shared memory K-major only, and reads a B tile as it lies (the low 13
// bits ignored: truncated, not rounded); A comes from registers (the RS
// form) in either layout. A truncated K or Q would give lse 0.8 of the
// bf16 kernels' error against float64 (a rounded one 0.12), so every
// streamed tile is an A operand, read into registers and rounded as read,
// and the block's own tiles, or the tiles the threads write, the K-major
// B operands, rounded when they are written:
// - forward, own queries Q, streamed keys K and V: S^T = K Q^T (keys by
//   queries), P^T = exp(S^T scale - m) written to shared memory, then O^T
//   += V^T P^T over the tile's keys;
// - backward (attn_tf32_bwd.cuh): the dq and dk/dv kernels' five products.
// The own tiles are rounded once in shared memory when they land; a
// streamed tile lands as the copy leaves it and is only read through
// registers, once a block, so no pass over it rounds it. The accumulators
// come out transposed (e by rows); they are staged in shared memory as the
// output tiles and stored by the copy engine. A product over a tile's rows
// reads its A fragment down the tile's columns; its depth runs over the
// rows in a permuted order (depth t is row 2 t, depth t + 4 row 2 t + 1 of
// each 8), which its B operand's writers follow (depth_pos), so that both
// the fragment reads and the transposed writes fall in 32 banks.
//
// The forward's softmax runs down the columns of S^T: a query is a column,
// its keys lie across the warpgroup's 4 warps. Each tile's column max is
// reduced over a thread's two rows, then over the 8 threads of a warp
// that hold a column (a reduce-scatter by shuffles that leaves each
// thread 2 of its 16 columns), then across the 4 warps through shared
// memory and one barrier; the new max and rescale of a thread's 2 columns
// are gathered back to its 16 by shuffles. O^T's columns are the queries a
// thread holds in S^T (wgmma_tf32.cuh's accumulator layout), so the
// thread rescales its own output columns. l is kept as per-thread partial
// sums (a thread's 2 keys a tile), rescaled with the output, and reduced
// once at the end in the same way. A query with no key in the tiles so far
// keeps m = -inf and takes 0 as its reference, so that p and alpha are
// 2^-inf = 0 and not NaN (in neighborhood attention a query tile's first
// halo tile misses the windows of its lower rows, the last one those of
// its upper rows).
//
// Copies. One thread starts every tile's copy: 32-column boxes of a 5-D
// (e, head, x, y, image) view of each tensor through its strides (Maps,
// encoded on the host each call), which land in wgmma's 128-byte swizzle
// and zero-fill what lies past the map; an mbarrier a stage counts the
// bytes. A box is the geometry's tile of rows (own_box, stream_box): 64
// sequence rows, an 8 x 8 neighborhood tile, or a halo (slab) band of 4
// rows of 16 slots, whose slots past the halo (slab) but inside the map
// hold data the geometry's mask rejects. Streamed tiles go through rings
// of two stages: the backward's of both its tiles, the forward's of K and
// of V apart (fwd_attend says when each stage is refilled).
//
// The forward's blocks. At e = 32 and 64 a block is one warpgroup that
// runs a tile's products in turn, the next tile's S^T issued behind this
// tile's O^T, and two blocks share an SM (97.5 KB at e = 64), so that
// one's softmax, copies and waits overlap the other's products. At e = 32
// O^T runs m64 with its upper 32 rows zero. At e = 128 (177.5 KB, one
// block an SM) the registers would not hold K's 64 fragment registers,
// S^T's 32 and O^T's 64 at once: the block is two warpgroups that split
// the products, not the rows. Warpgroup 0 forms S^T, the max, P^T and the
// rescale, and hands P^T and alpha over in shared memory; warpgroup 1
// accumulates all of O^T (two m64 blocks) while warpgroup 0 forms the next
// tile's S^T. Q K^T runs once a block. Each output element is summed by
// one thread over the streamed tiles in order, and there are no atomics: a
// rerun is bit-equal, and K3 = K13 and K2 = K11 on the same maps bit for
// bit.
#pragma once

#include <cuda.h>

#include <cstdint>

#include "gemm.cuh"
#include "wgmma.cuh"
#include "wgmma_tf32.cuh"

namespace kdt {
namespace tf32 {

constexpr int ROWS = 64;  // rows of every tile, own or streamed
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// The operands of a launch, the forward's and the backward's: q, k and v
// read through sq, sk and sv, head h at column h * E (K11's v is a strided
// third of a projection); out (the forward's output, which the backward
// reads), dout, dq, dk and dv through io; lse and delta (b, heads,
// positions) f32.
struct Args {
  const float *q, *k, *v, *dout;
  float *out, *lse, *delta, *dq, *dk, *dv;
  MapStrides sq, sk, sv, io;
  int n_heads;
  float scale;
};

// A dense launch's strides: q, k and v through `in` (head h at column h *
// E), out, dout, dq, dk and dv (b, s, heads, E) contiguous.
template <int E>
Args dense(Args a, Rows in, int s) {
  const long ld = static_cast<long>(a.n_heads) * E;
  a.sq = a.sk = a.sv = MapStrides{in.batch, in.seq, 0};
  a.io = MapStrides{s * ld, ld, 0};
  return a;
}

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

// The tensor maps of a launch: its own tiles' (forward: Q; dq kernel: Q,
// dO and out; dk/dv kernel: K and V), its streamed tiles' (forward and dq:
// K and V; dk/dv: Q and dO) and its outputs' (forward: out; dq; dk and
// dv).
struct Maps {
  CUtensorMap own[3], stream[2], out[2];
};

// The block's N mbarriers (the own tiles', then each ring stage's: the
// backward's stages of two tiles, the forward's K stages and V stages),
// initialised, in the 1024 bytes of alignment slack: before the tiles
// where the slack there holds them, else after the tiles' `bytes`.
template <int N = 1 + RING>
__device__ __forceinline__ uint64_t* init_bars(unsigned char* raw, unsigned char* tiles,
                                               int bytes) {
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

// Starts the copy of streamed tile j's tile of `map` (the forward's K or
// V) into dst, counted on bar; the copying thread calls it once the block
// is done with the stage.
template <int E, class G>
__device__ __forceinline__ void copy_stream(unsigned char* dst, const CUtensorMap* map,
                                            const G& geo, int j, int head, int img,
                                            uint64_t* bar) {
  fence_async_smem();  // the block's plain reads of the stage come first
  expect(bar, TILE_BYTES<E>);
  copy_tile<E>(dst, map, head, geo.stream_box(j), img, bar);
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

// The forward's products, their fragments read apart from their issue, so
// that every fragment of a group is in registers before the group's first
// product: K's for S^T (rows by e) and V's for O^T (e by rows, from
// column m0).
template <int E>
__device__ __forceinline__ void load_rows(uint32_t (&a)[E / 8][4], const unsigned char* x) {
#pragma unroll
  for (int kk = 0; kk < E / 8; ++kk) frag_rows(a[kk], x, kk);
}
template <int E>
__device__ __forceinline__ void load_cols(uint32_t (&a)[8][4], const unsigned char* x, int m0) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) frag_cols<E>(a[kk], x, m0, kk);
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

// ---- stores ----------------------------------------------------------------------

// Stages a warpgroup's e-by-rows accumulator of NB m64 blocks from e row m0
// (64 own rows each), own row n times mul[n] (mul_of(n)), as the (64, E)
// output tile at s_o (row n, column m, in the copy engine's swizzle); rows
// past E are dropped.
template <int E, int NB, class Mul>
__device__ __forceinline__ void stage_tile(const float (&acc)[NB][32], int m0, const Mul& mul_of,
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
        if (m < E)
          *reinterpret_cast<float*>(s_o + swz(n, m)) = acc[mb][4 * i + e] * mul_of(i, e & 1);
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

// ---- the forward's column softmax ---------------------------------------------------

struct MaxOp {
  __device__ float operator()(float x, float y) const { return fmaxf(x, y); }
};
struct SumOp {
  __device__ float operator()(float x, float y) const { return x + y; }
};

// A thread's 16 columns of a 64 x 64 accumulator are 8 i + 2 t + e, c = 2 i
// + e; the warp's 8 threads of one t (g = lane / 4 = 0..7) hold the same
// ones. scatter16 combines v over those 8 threads by op, leaving this
// thread the results r for its columns c = 2 g and 2 g + 1 (8 g + 2 t and
// 8 g + 2 t + 1): 14 shuffles, each result formed in one thread in a fixed
// order. gather16 is its inverse: each thread's r for its 2 columns, back
// to all 16 of every thread of its t.
template <class Op>
__device__ __forceinline__ void scatter16(const float (&v)[16], float (&r)[2], Op op) {
  const int g = (threadIdx.x & 31) >> 2;
  const bool hi2 = g & 4, hi1 = g & 2, hi0 = g & 1;
  float a[8], b[4];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float keep = hi2 ? v[8 + k] : v[k], send = hi2 ? v[k] : v[8 + k];
    a[k] = op(keep, __shfl_xor_sync(0xffffffffu, send, 16));
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float keep = hi1 ? a[4 + k] : a[k], send = hi1 ? a[k] : a[4 + k];
    b[k] = op(keep, __shfl_xor_sync(0xffffffffu, send, 8));
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float keep = hi0 ? b[2 + k] : b[k], send = hi0 ? b[k] : b[2 + k];
    r[k] = op(keep, __shfl_xor_sync(0xffffffffu, send, 4));
  }
}
__device__ __forceinline__ void gather16(const float (&r)[2], float (&v)[16]) {
  const int g = (threadIdx.x & 31) >> 2;
  const bool hi2 = g & 4, hi1 = g & 2, hi0 = g & 1;
  float b[4], a[8];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float o = __shfl_xor_sync(0xffffffffu, r[k], 4);
    b[k] = hi0 ? o : r[k];
    b[2 + k] = hi0 ? r[k] : o;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float o = __shfl_xor_sync(0xffffffffu, b[k], 8);
    a[k] = hi1 ? o : b[k];
    a[4 + k] = hi1 ? b[k] : o;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float o = __shfl_xor_sync(0xffffffffu, a[k], 16);
    v[k] = hi2 ? o : a[k];
    v[8 + k] = hi2 ? a[k] : o;
  }
}

// The sum over the warpgroup's 4 warps of each column's value r (a
// thread's 2 columns after scatter16) through s_red (4 x 64 floats), in
// warp order, after the warpgroup's barrier `sync()`: every thread of a t
// gets its 2 columns' total, or their max with op fmaxf.
template <class Op, class Sync>
__device__ __forceinline__ void across_warps(float (&r)[2], float* s_red, Op op, Sync sync) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x / 32) & 3;
  const int col = 8 * (lane >> 2) + 2 * (lane & 3);
  *reinterpret_cast<float2*>(s_red + 64 * w + col) = make_float2(r[0], r[1]);
  sync();
  float2 x = *reinterpret_cast<const float2*>(s_red + col);
#pragma unroll
  for (int u = 1; u < 4; ++u) {
    const float2 y = *reinterpret_cast<const float2*>(s_red + 64 * u + col);
    x = make_float2(op(x.x, y.x), op(x.y, y.y));
  }
  r[0] = x.x;
  r[1] = x.y;
}

// ---- the forward -------------------------------------------------------------------

// warpgroups of a forward block at head dim E, its threads and its blocks
// an SM (the launch bounds)
template <int E>
constexpr int FWD_WGS = E == 128 ? 2 : 1;
template <int E>
constexpr int FWD_THREADS = 128 * FWD_WGS<E>;
template <int E>
constexpr int FWD_BLOCKS = E == 128 ? 1 : 2;

// The forward's shared memory: own Q, two stages of K and two of V, the
// exchange tile P^T, and six rows of 64 floats: the column reductions'
// partials (4), alpha and 1 / l of the split block's hand-over; the slack
// that aligns the tiles and holds the barriers (Q's, K's stages', V's).
template <int E>
constexpr int FWD_BYTES = (1 + 2 * RING) * TILE_BYTES<E> + X_BYTES + 6 * ROWS * 4;
template <int E>
constexpr size_t FWD_SMEM = FWD_BYTES<E> + 1024;
constexpr int FWD_BARS = 1 + 2 * RING;

// Named barriers of the forward: warpgroup 0's column reductions, the
// split block's P^T ready (0 to 1), exchange tile free (1 to 0), 1 / l
// ready (0 to 1), and warpgroup 1's stage of the output.
enum FwdBar { RED = 1, P_READY, X_FREE, L_READY, STAGED };

// The attention of the block's 64 own (query) rows of head `head` of image
// `img` against every streamed (key) tile: its shared memory at s
// (FWD_BYTES), its FWD_BARS mbarriers bar; `round` counts the earlier runs
// of this body in the block (K15's second head at e = 32), which set the
// stages and the barriers' phases. Ends with acc_o (in the threads that
// hold O^T: every thread at E 32, 64, warpgroup 1 at 128) the thread's
// share of O^T = sum_j V_j^T P_j^T (e rows 16 w + g (+ 8) of each m64
// block, query columns 8 i + 2 t + e), not yet divided by l, and inv its
// 16 columns' 1 / l; the lse (natural log) of the own rows written to a.lse
// unless it is null; every product done with the tiles.
//
// The schedule of tile j (S_j = K_j Q^T, O_j += V_j^T P_j^T): once S_j is
// done, its column max is reduced, the output rescaled and P_j^T written;
// then O_j is issued and S_{j+1} behind it, a group of its own, and O_j is
// waited for, so that only S_{j+1} runs on into the next tile (a split
// block's warpgroup 0 issues S_{j+1} as it hands P_j^T over, beside
// warpgroup 1's O_j). ptxas keeps a warpgroup's products asynchronous only
// in such a schedule: where O_j ran on into the next tile, or S_{j+1} ran
// beside this tile's softmax, it serialised every product of the kernel
// (advisory C7515; each product waited for, in the compiler's report and
// the machine code), which made the e = 64 kernel 1.2x slower. K_j's stage
// is free once its fragments are read, and V_j's once O_j's are: each
// stage takes the tile after next as soon as the block is past the barrier
// of the next tile's column max.
template <int E, class G>
__device__ __forceinline__ void fwd_attend(const Args& a, const Maps& m, const G& geo, int head,
                                           int img, unsigned char* s, uint64_t* bar, int round,
                                           float (&acc_o)[MB<E>][32], float (&inv)[16]) {
  constexpr int T = TILE_BYTES<E>, THREADS = FWD_THREADS<E>;
  constexpr bool SPLIT = FWD_WGS<E> == 2;
  unsigned char* s_q = s;  // then K's stages, V's stages
  unsigned char* s_x = s_q + (1 + 2 * RING) * T;
  float* s_red = reinterpret_cast<float*>(s_x + X_BYTES);  // 4 x 64
  float* s_alpha = s_red + 4 * ROWS;
  float* s_inv = s_alpha + ROWS;
  const int lane = threadIdx.x & 31, w = (threadIdx.x / 32) & 3, wgi = threadIdx.x / 128;
  const int g = lane >> 2, t = lane & 3;
  const int n_tiles = geo.tiles, j0 = round * n_tiles;  // j0: the stages' count of earlier tiles
  const float scale2 = a.scale * LOG2E;
  // tile j's K or V stage (kv 0 or 1), its barrier, and the wait for it
  const auto tile = [&](int kv, int j) { return s + (1 + kv * RING + ((j0 + j) & 1)) * T; };
  const auto tile_bar = [&](int kv, int j) { return &bar[1 + kv * RING + ((j0 + j) & 1)]; };
  const auto landed = [&](int kv, int j) {
    gemm::mbar_wait(tile_bar(kv, j), ((j0 + j) >> 1) & 1);
  };
  // the copying thread's start of tile j's K or V, if there is a tile j
  const auto fetch = [&](int kv, int j) {
    if (threadIdx.x == 0 && j < n_tiles)
      copy_stream<E>(tile(kv, j), &m.stream[kv], geo, j, head, img, tile_bar(kv, j));
  };

  if (threadIdx.x == 0) {
    expect(&bar[0], T);
    copy_tile<E>(s_q, &m.own[0], head, geo.own_box(), img, &bar[0]);
  }
  for (int j = 0; j < RING; ++j) {
    fetch(0, j);
    fetch(1, j);
  }
  gemm::mbar_wait(&bar[0], round & 1);
  round_tile<E, THREADS>(s_q);
  fence_async_smem();
  __syncthreads();  // Q rounded before any product reads it

#pragma unroll
  for (int mb = 0; mb < MB<E>; ++mb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_o[mb][i] = 0.f;

  if (!SPLIT || wgi == 0) {
    // S^T, the max, P^T and the rescales (and at E <= 64 O^T as well)
    const auto wg_sync = [] {
      if constexpr (SPLIT) bar_sync(RED, 128);
      else __syncthreads();
    };
    // this thread's 16 own (query) columns 8 i + 2 t + e, c = 2 i + e
    typename G::Info info[16];
#pragma unroll
    for (int c = 0; c < 16; ++c) info[c] = geo.own_info(8 * (c >> 1) + 2 * t + (c & 1));
    float acc_s[32], lp[16], m2[2] = {-INFINITY, -INFINITY};
    uint32_t a_k[E / 8][4], a_v[8][4];
#pragma unroll
    for (int c = 0; c < 16; ++c) lp[c] = 0.f;
    // S_j's fragments read and its accumulator zeroed, before its issue
    const auto load_s = [&](int j) {
      landed(0, j);
      load_rows<E>(a_k, tile(0, j));
#pragma unroll
      for (int i = 0; i < 32; ++i) acc_s[i] = 0.f;
      wg::fence_regs(a_k);
      wg::fence_regs(acc_s);
    };
    load_s(0);
    wg::wgmma_fence();
    chain<64, E>(acc_s, a_k, s_q, 0);  // S^T = K Q^T
    wg::wgmma_commit();
    for (int j = 0; j < n_tiles; ++j) {
      wg::wgmma_wait<0>();  // S_j
      wg::fence_regs(acc_s);
      wg::fence_regs(a_k);
      // pairs that do not attend (zero-filled slots included) at -inf; each
      // column's max over the tile's keys
      float cm[16];
      const bool whole = geo.whole(j);
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        float& x0 = acc_s[4 * (c >> 1) + (c & 1)];
        float& x1 = acc_s[4 * (c >> 1) + 2 + (c & 1)];
        if (!whole) {
          if (!geo.mask(j, 16 * w + g, info[c])) x0 = -INFINITY;
          if (!geo.mask(j, 16 * w + g + 8, info[c])) x1 = -INFINITY;
        }
        cm[c] = fmaxf(x0, x1);
      }
      float mx[2];
      scatter16(cm, mx, MaxOp());
      across_warps(mx, s_red, MaxOp(), wg_sync);
      // every thread has read K_j's fragments (and, one warpgroup, O_{j-1}
      // V_{j-1}'s): their stages take K_{j+2} (and V_{j+1})
      fetch(0, j + 2);
      if (!SPLIT && j >= 1) fetch(1, j + 1);
      // this thread's 2 columns: the new max (log2 domain), the reference
      // (0 while a column has no key), the rescale; then all 16
      float ref2[2], alpha2[2], ref[16], alpha[16];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float mnew = fmaxf(m2[k], mx[k] * scale2);
        ref2[k] = mnew == -INFINITY ? 0.f : mnew;
        alpha2[k] = wg::exp2_approx(m2[k] - ref2[k]);
        m2[k] = mnew;
      }
      gather16(ref2, ref);
      gather16(alpha2, alpha);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 2 * i + (e & 1);
          if (e < 2) lp[c] *= alpha[c];
          const float p = wg::exp2_approx(fmaf(acc_s[4 * i + e], scale2, -ref[c]));
          acc_s[4 * i + e] = p;
          lp[c] += p;
        }
      const bool more = j + 1 < n_tiles;
      if constexpr (SPLIT) {
        bar_sync(X_FREE, 256);  // warpgroup 1 is done with O_{j-1}
        if (j >= 1) fetch(1, j + 1);
        put_t(acc_s, s_x);
        if (w == 0)
          *reinterpret_cast<float2*>(s_alpha + 8 * g + 2 * t) = make_float2(alpha2[0], alpha2[1]);
        bar_arrive(P_READY, 256);
        if (more) {
          load_s(j + 1);
          wg::wgmma_fence();
          chain<64, E>(acc_s, a_k, s_q, 0);  // S^T = K Q^T
          wg::wgmma_commit();
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) acc_o[0][i] *= alpha[2 * (i >> 2) + (i & 1)];
        put_t(acc_s, s_x);
        __syncthreads();  // P^T is in the exchange tile
        // O_j += V_j^T P_j^T over the tile's keys; S_{j+1} behind it, in a
        // group of its own; O_j waited for before the next tile
        landed(1, j);
        load_cols<E>(a_v, tile(1, j), 0);
        wg::fence_regs(a_v);
        wg::fence_regs(acc_o[0]);
        wg::wgmma_fence();
        chain<64, 64>(acc_o[0], a_v, s_x, 0);
        wg::wgmma_commit();
        if (more) {
          load_s(j + 1);
          wg::wgmma_fence();
          chain<64, E>(acc_s, a_k, s_q, 0);  // S^T = K Q^T
          wg::wgmma_commit();
          wg::wgmma_wait<1>();
        } else {
          wg::wgmma_wait<0>();
        }
        wg::fence_regs(acc_o[0]);
        wg::fence_regs(a_v);
      }
    }
    // l: each column's partials summed over the warp's threads, then over
    // the warps; 1 / l and lse
    float l2[2];
    scatter16(lp, l2, SumOp());
    across_warps(l2, s_red, SumOp(), wg_sync);
    const float inv2[2] = {1.f / l2[0], 1.f / l2[1]};
    if (w == 0) {
      if (a.lse != nullptr) {
        float* lse = a.lse + (static_cast<long>(img) * a.n_heads + head) * geo.positions;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const wg::Pos p = geo.own(8 * g + 2 * t + k);
          if (p.ok) lse[geo.index(p)] = (m2[k] + __log2f(l2[k])) * LN2;
        }
      }
      if constexpr (SPLIT)
        *reinterpret_cast<float2*>(s_inv + 8 * g + 2 * t) = make_float2(inv2[0], inv2[1]);
    }
    if constexpr (SPLIT) bar_arrive(L_READY, 256);
    else gather16(inv2, inv);
  } else {
    // warpgroup 1 of a split block: O^T += V^T P^T, two m64 blocks of e
    // rows, each tile's once warpgroup 0 has handed its P^T and alpha over
    bar_arrive(X_FREE, 256);
    for (int j = 0; j < n_tiles; ++j) {
      bar_sync(P_READY, 256);
      landed(1, j);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float2 al = *reinterpret_cast<const float2*>(s_alpha + 8 * i + 2 * t);
#pragma unroll
        for (int mb = 0; mb < MB<E>; ++mb) {
          acc_o[mb][4 * i] *= al.x;
          acc_o[mb][4 * i + 1] *= al.y;
          acc_o[mb][4 * i + 2] *= al.x;
          acc_o[mb][4 * i + 3] *= al.y;
        }
      }
      uint32_t a_v[MB<E>][8][4];
#pragma unroll
      for (int mb = 0; mb < MB<E>; ++mb) {
        load_cols<E>(a_v[mb], tile(1, j), 64 * mb);
        wg::fence_regs(a_v[mb]);
        wg::fence_regs(acc_o[mb]);
      }
      wg::wgmma_fence();
#pragma unroll
      for (int mb = 0; mb < MB<E>; ++mb) chain<64, 64>(acc_o[mb], a_v[mb], s_x, 0);
      wg::wgmma_commit();
      wg::wgmma_wait<0>();
#pragma unroll
      for (int mb = 0; mb < MB<E>; ++mb) {
        wg::fence_regs(acc_o[mb]);
        wg::fence_regs(a_v[mb]);
      }
      if (j + 1 < n_tiles) bar_arrive(X_FREE, 256);
    }
    bar_sync(L_READY, 256);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 x = *reinterpret_cast<const float2*>(s_inv + 8 * i + 2 * t);
      inv[2 * i] = x.x;
      inv[2 * i + 1] = x.y;
    }
  }
}

// The forward: fwd_attend on the block's own rows of head blockIdx.y of
// image blockIdx.z; O / l staged in Q's tile (free once every S^T is done)
// and stored by the copy engine through m.out[0].
template <int E, class G>
__device__ __forceinline__ void wg_fwd_body(const Args& a, const Maps& m, const G& geo) {
  constexpr bool SPLIT = FWD_WGS<E> == 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* s = wg::aligned_smem(smem_raw);
  uint64_t* bar = init_bars<FWD_BARS>(smem_raw, s, FWD_BYTES<E>);
  const int head = blockIdx.y, img = blockIdx.z;
  float acc_o[MB<E>][32], inv[16];
  fwd_attend<E>(a, m, geo, head, img, s, bar, 0, acc_o, inv);
  if (SPLIT && threadIdx.x < 128) return;  // warpgroup 1 holds O^T
  stage_tile<E, MB<E>>(acc_o, 0, [&](int i, int e) { return inv[2 * i + e]; }, s);
  fence_async_smem();
  if constexpr (SPLIT) bar_sync(STAGED, 128);
  else __syncthreads();
  if (threadIdx.x == (SPLIT ? 128 : 0)) {
    store_tile<E>(s, &m.out[0], head, geo.own_box(), img);
    stores_done();
  }
}

// ---- launches ---------------------------------------------------------------------

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

// The maps of a forward launch over (b, h, w, heads, E) maps: Q (and, with
// `store`, the output) in boxes of ox x oy positions, K and V in sx x sy.
template <int E>
cudaError_t fwd_maps(const Args& a, int b, int h, int w, int ox, int oy, int sx, int sy,
                     bool store, Maps& m) {
  const int n = a.n_heads;
  cudaError_t err = rows_map<E>(&m.own[0], a.q, a.sq, b, h, w, n, ox, oy);
  if (err == cudaSuccess) err = rows_map<E>(&m.stream[0], a.k, a.sk, b, h, w, n, sx, sy);
  if (err == cudaSuccess) err = rows_map<E>(&m.stream[1], a.v, a.sv, b, h, w, n, sx, sy);
  if (err == cudaSuccess && store) err = rows_map<E>(&m.out[0], a.out, a.io, b, h, w, n, ox, oy);
  return err;
}

// The dense forward (K13 and K3 in f32): a block owns rows [64 blockIdx.x,
// 64 blockIdx.x + 64) of the sequence (wg::Seq) and every 64-row tile
// streams past them.
template <int E>
__global__ void __launch_bounds__(FWD_THREADS<E>, FWD_BLOCKS<E>)
    tf32_wg_fwd_kernel(const Args a, const __grid_constant__ Maps m, int s) {
  wg_fwd_body<E>(a, m, wg::Seq(blockIdx.x, s));
}

// The forward on q, k, v read through `in`; any s >= 1. Returns the CUDA
// error code.
template <int E>
int launch_fwd(const Args& args, Rows in, int b, int s, cudaStream_t st) {
  const Args a = dense<E>(args, in, s);
  Maps m;
  const cudaError_t err = fwd_maps<E>(a, b, s, 1, 1, ROWS, 1, ROWS, true, m);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + ROWS - 1) / ROWS, a.n_heads, b);
  const cudaError_t attr = allow_smem(tf32_wg_fwd_kernel<E>, FWD_SMEM<E>);
  tf32_wg_fwd_kernel<E><<<grid, FWD_THREADS<E>, FWD_SMEM<E>, st>>>(a, m, s);
  return launch_status(attr);
}

}  // namespace tf32
}  // namespace kdt
