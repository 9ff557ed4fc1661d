// Exact softmax attention in float32, the kernels of --mixed-precision no:
// the forward with its logsumexp and the two-kernel backward, as bodies
// over a geometry policy (below, before fwd_body). Over wg::Seq they are
// K13 and K14 in f32 (flash.cu) and K3 and K9 in f32 (global_packed.cu),
// the dense kernels below; over na2d.cuh's NaQueries and NaKeys they are
// K2 and K7 in f32 (na2d.cu) and K11 and K12 in f32 (na2d_heads.cu), the
// kernels of na_tf32.cuh.
//
// Replaces: k_diffusion_tpu/ops/pallas/flash.py:_fwd_kernel,
// :_dq_kernel and :_dkv_kernel as they run on f32 operands (the JAX model
// built with dtype=float32): f32 dots with f32 accumulation, p / l in f32;
// na_tf32.cuh says what the neighborhood kernels replace. Here every
// product runs on the TF32 tensor cores (operands rounded to TF32 by
// cvt.rna, 10 mantissa bits) with f32 accumulation, as PyTorch's float32
// training does with TF32 on; the softmax, its rescales, lse and delta
// stay in f32.
//
// What bounds it on the H100, cifar10 U-Net at batch 64 (s = 256, 4 heads,
// head dim 64): the forward does 4 s^2 64 FLOP per image and head, 4.3
// GFLOP, 8.7 us at TF32's 494.7 TFLOP/s, and moves q, k, v and the output
// in f32, 4 x 16.8 MB, 20 us at 3.35 TB/s: bound by memory. The backward
// does 2.5x the products and moves 2.25x the bytes.
//
// Design: FlashAttention-2's forward and two-kernel backward on warp-level
// mma.sync m16n8k8 (tf32 x tf32 -> f32). A block is 4 warps (8 at E = 128,
// below) and owns 64 rows of one head of one image (grid: row tiles, heads,
// batch); a warp owns 16 of them. The other operand streams through shared memory in
// 64-row f32 tiles, two stages filled by 16-byte cp.async (rows the
// geometry marks as not ok, past s or past a halo, zero-filled by the
// copy's source size), one commit group per tile pair.
// Tiles keep the rows as they lie in memory, padded to E + 4 floats a row,
// so that every fragment load below is one conflict-free 32-bit shared
// load, in whichever orientation a product needs:
// - an A fragment of rows (Q, dO, own K or V): a[i] = X[row g (+8)][k (+4)];
// - the B operand of a product against a tile's rows (Q K^T, dO V^T,
//   K Q^T, V dO^T): b[i] = Y[n0 + g][k0 + t (+4)];
// - the B operand of a product over a tile's rows (P V, dS K, P^T dO,
//   dS^T Q), whose A is the accumulator of the previous product. An m16n8
//   accumulator holds columns 2t and 2t + 1 where the m16n8k8 A fragment
//   takes columns t and t + 4; so within each 8-key group the k index is
//   permuted, A column t being key 2t and column t + 4 key 2t + 1, and B
//   reads rows 2t and 2t + 1 to match. The accumulator is then the next
//   product's A operand with no shuffle.
// (g = lane / 4 and t = lane % 4 name a thread's place in the fragments.)
// The logits are kept in the log2 domain (scale log2 e) and the row max
// reduced over the quad of threads that holds a row. The backward's dq
// kernel also computes delta = rowsum(out * dout), which the JAX package
// computes outside its kernels, and writes it for the dk/dv kernel; no
// atomics, so a rerun is bit-equal. Over Seq the bodies do what the dense
// kernels did before they took a geometry: the same products in the same
// order (a row of global attention always has a key in the first tile, so
// the forward's guard for rows with none never changes a value).
//
// At E = 64 the forward holds 5 tiles (85 KB), each backward kernel 6
// (102 KB): two blocks an SM. At E = 128 (the neighborhood kernels at head
// dim 128) the forward's tiles take 165 KB and each backward kernel's 198.5
// KB: one block an SM; there a block is two warpgroups (WG<128> = 2, 256
// threads), warp w owning rows 16 (w % 4) of the block's 64 and output
// columns [64 (w / 4), 64 (w / 4) + 64): each warpgroup forms the logits
// (and dP) of its rows over all 128 columns itself, so that no thread holds
// accumulators over more than 64 output columns (the dk/dv kernel's two
// sets of 128 would take 128 registers a thread beside the logits'). A
// simple design; making it fast is later work (PERF.md, ROADMAP.md queue
// 2).
#pragma once

#include <cstdint>

#include "wgmma.cuh"

namespace kdt {
namespace tf32 {

constexpr int ROWS = 64;  // rows of every tile, own or streamed
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int E>
constexpr int LD = E + 4;  // f32 row stride of a tile in shared memory
template <int E>
constexpr int TILE = ROWS * LD<E>;  // floats of one tile
// warpgroups a block runs at head dim E, its threads, and the 8-column
// accumulator blocks a warp owns of each output
template <int E>
constexpr int WG = E > 64 ? 2 : 1;
template <int E>
constexpr int BLOCK = 128 * WG<E>;
template <int E>
constexpr int NC = E / 8 / WG<E>;

// The rows (16 (w % 4) of the block's 64) and the first output column
// (64 (w / 4) at E = 128, else 0) of this thread's warp w.
__device__ __forceinline__ int own_row0() { return 16 * ((threadIdx.x / 32) % 4); }
template <int E>
__device__ __forceinline__ int own_col0() {
  return static_cast<int>(threadIdx.x / 128) * 8 * NC<E>;
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// d += a b: m16n8k8, a row-major (16 x 8), b column-major (8 x 8), TF32
// operands, f32 accumulators.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Starts the copy of a padded (64, E) f32 tile whose row r is the E-wide
// row of head `head` of image `img` at map position pos(r) of `base`
// (strides st), rows gathered from anywhere in the map; rows whose
// position is not ok are zero-filled.
template <int E, class RowPos>
__device__ __forceinline__ void load_tile(float* tile, const float* base, const MapStrides& st,
                                          int img, int head, const RowPos& pos) {
  constexpr int CH = E / 4;  // 16-byte chunks per row
  const uint32_t dst = wg::smem_u32(tile);
  const long head0 = st.at(img, 0, 0, head, E);
  for (int i = threadIdx.x; i < ROWS * CH; i += blockDim.x) {
    const int r = i / CH, c = i % CH;
    const wg::Pos p = pos(r);
    const long off = head0 + p.y * st.y + p.x * st.x + c * 4;
    wg::cp_async16(dst + (r * LD<E> + c * 4) * 4, p.ok ? base + off : base, p.ok);
  }
}

// The A fragment of rows [m0, m0 + 16), columns [k0, k0 + 8) of a tile.
template <int E>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const float* tile, int m0, int k0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* p = tile + (m0 + g) * LD<E> + k0 + t;
  a[0] = to_tf32(p[0]);
  a[1] = to_tf32(p[8 * LD<E>]);
  a[2] = to_tf32(p[4]);
  a[3] = to_tf32(p[8 * LD<E> + 4]);
}

// acc[n] (16 x 8 block n of 16 x 64) += X Y^T over E: X rows [m0, m0 + 16)
// of the tile x_tile, Y the 64-row tile y_tile (the product against a
// tile's rows).
template <int E>
__device__ __forceinline__ void mma_nt(float (&acc)[8][4], const float* x_tile, int m0,
                                       const float* y_tile) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < E / 8; ++kk) {
    uint32_t a[4];
    frag_a<E>(a, x_tile, m0, 8 * kk);
    const float* p = y_tile + g * LD<E> + 8 * kk + t;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      mma(acc[n], a, to_tf32(p[8 * n * LD<E>]), to_tf32(p[8 * n * LD<E> + 4]));
  }
}

// acc[n] (16 x 8 block n of 16 x 8 N) += P Y over the tile's 64 rows: P the
// 16 x 64 accumulator p (its 8-key blocks are the A fragments, keys
// permuted within each block), Y the first 8 N columns from y_tile of a
// tile (y_tile may point past the tile's first column).
template <int E, int N = E / 8>
__device__ __forceinline__ void mma_pv(float (&acc)[N][4], const float (&p)[8][4],
                                       const float* y_tile) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int kb = 0; kb < 8; ++kb) {
    const uint32_t a[4] = {to_tf32(p[kb][0]), to_tf32(p[kb][2]), to_tf32(p[kb][1]),
                           to_tf32(p[kb][3])};
    const float* row = y_tile + (8 * kb + 2 * t) * LD<E> + g;
#pragma unroll
    for (int n = 0; n < N; ++n) mma(acc[n], a, to_tf32(row[8 * n]), to_tf32(row[LD<E> + 8 * n]));
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
}

// Writes a warp's 16 x 8 N accumulator, rows m0 + g and m0 + g + 8 of the
// block's own rows (times mul0 and mul1), to their map positions pos(row)
// of head `head` of image `img` in `out` (strides st; out may point past
// the head's first column); rows whose position is not ok are skipped.
template <int E, int N = E / 8, class RowPos>
__device__ __forceinline__ void store_rows(float* out, const MapStrides& st, int img, int head,
                                           const float (&acc)[N][4], int m0,
                                           const RowPos& pos, float mul0, float mul1) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const wg::Pos p = pos(m0 + g + 8 * h);
    if (!p.ok) continue;
    float* row = out + st.at(img, p.y, p.x, head, E);
    const float mul = h ? mul1 : mul0;
#pragma unroll
    for (int n = 0; n < N; ++n)
      *reinterpret_cast<float2*>(row + 8 * n + 2 * t) =
          make_float2(acc[n][2 * h] * mul, acc[n][2 * h + 1] * mul);
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The operands of a launch: q, k and v read through sq, sk and sv, head h
// at column h * E (K11's v is a strided third of a projection); out (the
// forward's output, which the backward reads), dout, dq, dk and dv through
// io; lse and delta (b, heads, positions) f32.
struct Args {
  const float *q, *k, *v, *dout;
  float *out, *lse, *delta, *dq, *dk, *dv;
  MapStrides sq, sk, sv, io;
  int n_heads;
  float scale;
};

// Which rows a block owns, which 64-row tiles stream past them and which
// pairs attend is the geometry G, a template policy of the three bodies
// below (wgmma.cuh's Seq for global attention, whose comment lists the
// members; na2d.cuh's NaQueries and NaKeys for neighborhood attention,
// na_tf32.cuh), as for the bf16 bodies of attn_fwd.cuh and attn_bwd.cuh.
// Each row is copied from its map position through its tensor's strides;
// the mask is tested on the logits' accumulator coordinates (row 16 warp +
// g (+ 8), column 8 n + 2 t (+ 1) of the streamed tile), before p becomes
// the next product's A operand, whose keys are permuted within each 8-key
// group.

// The attention of the block's 64 own (query) rows of head `head` of image
// `img` against every streamed (key) tile, in the 5 tiles at smem: acc_o
// the thread's share of the warp's output columns [own_col0, own_col0 + 8
// NC) of sum_j P_j V_j (not yet divided by l), m each of its two rows' max
// scaled logit (log2 domain) and l the row's sum of p (over the quad). A
// row none of whose keys has streamed past yet keeps m = -inf and takes 0
// as its reference, so that p and alpha are 2^-inf = 0 and not NaN
// (attn_fwd.cuh's guard: in neighborhood attention a query tile's first
// halo tile misses the windows of its lower rows, the last one those of
// its upper rows). Ends with every warp done with the tiles.
template <int E, class G>
__device__ __forceinline__ void attend(const Args& a, const G& geo, int head, int img,
                                       float* smem, float (&acc_o)[NC<E>][4], float (&m)[2],
                                       float (&l)[2]) {
  float* s_q = smem;
  float* s_kv = smem + TILE<E>;  // stage st: K at 2 st TILE, V after it
  const int r0 = own_row0(), c0 = own_col0<E>();
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int n_tiles = geo.tiles;
  const float scale = a.scale * LOG2E;
  const auto own = [&](int i) { return geo.own(i); };
  const auto load_kv = [&](int j, float* kv) {
    const auto row = [&](int i) { return geo.stream(j, i); };
    load_tile<E>(kv, a.k, a.sk, img, head, row);
    load_tile<E>(kv + TILE<E>, a.v, a.sv, img, head, row);
  };

  load_tile<E>(s_q, a.q, a.sq, img, head, own);
  load_kv(0, s_kv);
  wg::cp_async_commit();

  typename G::Info info[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) info[h] = geo.own_info(r0 + g + 8 * h);
  zero(acc_o);
  m[0] = m[1] = -INFINITY;
  l[0] = l[1] = 0.f;
  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      load_kv(j + 1, s_kv + 2 * ((j + 1) & 1) * TILE<E>);
      wg::cp_async_commit();
      wg::cp_async_wait<1>();
    } else {
      wg::cp_async_wait<0>();
    }
    __syncthreads();
    const float* s_k = s_kv + 2 * (j & 1) * TILE<E>;
    float acc_s[8][4];
    zero(acc_s);
    mma_nt<E>(acc_s, s_q, r0, s_k);
    // scaled logits, pairs that do not attend (zero-filled slots included:
    // their logit is 0) at -inf; each row's running max
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool on = geo.mask(j, 8 * n + 2 * t + (i & 1), info[i >> 1]);
        acc_s[n][i] = on ? acc_s[n][i] * scale : -INFINITY;
        mx[i >> 1] = fmaxf(mx[i >> 1], acc_s[n][i]);
      }
    float ref[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = quad_max(mx[h]);
      ref[h] = mx[h] == -INFINITY ? 0.f : mx[h];
      const float alpha = exp2f(m[h] - ref[h]);  // 0 until the row has a key
      m[h] = mx[h];
      l[h] *= alpha;
#pragma unroll
      for (int n = 0; n < NC<E>; ++n) {
        acc_o[n][2 * h] *= alpha;
        acc_o[n][2 * h + 1] *= alpha;
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc_s[n][i] = exp2f(acc_s[n][i] - ref[i >> 1]);
        l[i >> 1] += acc_s[n][i];
      }
    mma_pv<E, NC<E>>(acc_o, acc_s, s_k + TILE<E> + c0);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
}

// The forward: attend() on the block's own rows of head blockIdx.y of
// image blockIdx.z; O / l to a.out and, when a.lse is not null, lse = max +
// log(sum) of each row's scaled logits, natural log.
template <int E, class G>
__device__ __forceinline__ void fwd_body(const Args& a, const G& geo) {
  extern __shared__ __align__(16) float smem[];
  const int head = blockIdx.y, img = blockIdx.z;
  const int r0 = own_row0(), c0 = own_col0<E>();
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  float acc_o[NC<E>][4], m[2], l[2];
  attend<E>(a, geo, head, img, smem, acc_o, m, l);
  const auto own = [&](int i) { return geo.own(i); };
  store_rows<E, NC<E>>(a.out + c0, a.io, img, head, acc_o, r0, own, 1.f / l[0], 1.f / l[1]);
  if (a.lse != nullptr && t == 0 && c0 == 0) {
    float* lse = a.lse + (static_cast<long>(img) * a.n_heads + head) * geo.positions;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const wg::Pos p = geo.own(r0 + g + 8 * h);
      if (p.ok) lse[geo.index(p)] = (m[h] + __log2f(l[h])) * LN2;
    }
  }
}

// The backward's dq kernel: the block's 64 own (query) rows against every
// streamed (key) tile. It first forms delta = rowsum(out * dout) for its
// rows (written to a.delta for the dk/dv kernel), then dq = scale sum_j dS_j
// K_j with dS = P (dP - delta), P = exp(logits - lse) where the pair
// attends (else 0), dP = dO V^T.
template <int E, class G>
__device__ __forceinline__ void dq_body(const Args& a, const G& geo) {
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;
  float* s_do = smem + TILE<E>;
  float* s_kv = smem + 2 * TILE<E>;
  float* s_stat = smem + 6 * TILE<E>;  // lse log2 e, then delta, of the own rows
  const int head = blockIdx.y, img = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = own_row0(), c0 = own_col0<E>();
  const int n_tiles = geo.tiles;
  const float scale = a.scale * LOG2E;
  const auto own = [&](int i) { return geo.own(i); };
  const auto load_kv = [&](int j, float* kv) {
    const auto row = [&](int i) { return geo.stream(j, i); };
    load_tile<E>(kv, a.k, a.sk, img, head, row);
    load_tile<E>(kv + TILE<E>, a.v, a.sv, img, head, row);
  };

  load_tile<E>(s_q, a.q, a.sq, img, head, own);
  load_tile<E>(s_do, a.dout, a.io, img, head, own);
  load_kv(0, s_kv);
  wg::cp_async_commit();

  // delta and lse of the block's 64 rows, PER a warp, one row at a time
  // over the warp
  constexpr int PER = ROWS / (4 * WG<E>);
  const long stat = (static_cast<long>(img) * a.n_heads + head) * geo.positions;
  for (int i = PER * warp; i < PER * (warp + 1); ++i) {
    const wg::Pos p = geo.own(i);
    float d = 0.f;
    if (p.ok) {
      const long at = a.io.at(img, p.y, p.x, head, E);
      const float* o_row = a.out + at;
      const float* do_row = a.dout + at;
      for (int c = lane; c < E; c += 32) d += o_row[c] * do_row[c];
    }
    d = warp_sum(d);
    if (lane == 0) {
      s_stat[i] = p.ok ? a.lse[stat + geo.index(p)] * LOG2E : 0.f;
      s_stat[ROWS + i] = d;
      if (p.ok) a.delta[stat + geo.index(p)] = d;
    }
  }
  __syncthreads();  // at E = 128 a warp reads rows two other warps formed
  float lse[2], delta[2];
  typename G::Info info[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lse[h] = s_stat[r0 + g + 8 * h];
    delta[h] = s_stat[ROWS + r0 + g + 8 * h];
    info[h] = geo.own_info(r0 + g + 8 * h);
  }

  float acc_dq[NC<E>][4];
  zero(acc_dq);
  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      load_kv(j + 1, s_kv + 2 * ((j + 1) & 1) * TILE<E>);
      wg::cp_async_commit();
      wg::cp_async_wait<1>();
    } else {
      wg::cp_async_wait<0>();
    }
    __syncthreads();
    const float* s_k = s_kv + 2 * (j & 1) * TILE<E>;
    const float* s_v = s_k + TILE<E>;
    float acc_s[8][4], acc_dp[8][4];
    zero(acc_s);
    zero(acc_dp);
    mma_nt<E>(acc_s, s_q, r0, s_k);
    mma_nt<E>(acc_dp, s_do, r0, s_v);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool on = geo.mask(j, 8 * n + 2 * t + (i & 1), info[i >> 1]);
        const float p = on ? exp2f(acc_s[n][i] * scale - lse[i >> 1]) : 0.f;
        acc_s[n][i] = p * (acc_dp[n][i] - delta[i >> 1]);  // dS
      }
    mma_pv<E, NC<E>>(acc_dq, acc_s, s_k + c0);
    __syncthreads();
  }
  store_rows<E, NC<E>>(a.dq + c0, a.io, img, head, acc_dq, r0, own, a.scale, a.scale);
}

// The backward's dk/dv kernel: the block's 64 own (key) rows against every
// streamed (query) tile, in the transposed products: S^T = K Q^T, P^T =
// exp(S^T - lse) where the pair attends (else 0), dP^T = V dO^T, dS^T = P^T
// (dP^T - delta); dv = sum_i P^T dO, dk = scale sum_i dS^T Q. lse and delta
// of each streamed tile are staged in shared memory beside it (0 for slots
// that hold no row: the geometry, not their values, rejects them).
template <int E, class G>
__device__ __forceinline__ void dkv_body(const Args& a, const G& geo) {
  extern __shared__ __align__(16) float smem[];
  float* s_k = smem;
  float* s_v = smem + TILE<E>;
  float* s_qd = smem + 2 * TILE<E>;   // stage st: Q at 2 st TILE, dO after it
  float* s_stat = smem + 6 * TILE<E>;  // lse log2 e, then delta, of the streamed tile
  const int head = blockIdx.y, img = blockIdx.z;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int r0 = own_row0(), c0 = own_col0<E>();
  const long stat = (static_cast<long>(img) * a.n_heads + head) * geo.positions;
  const int n_tiles = geo.tiles;
  const float scale = a.scale * LOG2E;
  const auto own = [&](int i) { return geo.own(i); };
  const auto load_qd = [&](int j, float* qd) {
    const auto row = [&](int i) { return geo.stream(j, i); };
    load_tile<E>(qd, a.q, a.sq, img, head, row);
    load_tile<E>(qd + TILE<E>, a.dout, a.io, img, head, row);
  };

  load_tile<E>(s_k, a.k, a.sk, img, head, own);
  load_tile<E>(s_v, a.v, a.sv, img, head, own);
  load_qd(0, s_qd);
  wg::cp_async_commit();

  typename G::Info info[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) info[h] = geo.own_info(r0 + g + 8 * h);
  float acc_dk[NC<E>][4], acc_dv[NC<E>][4];
  zero(acc_dk);
  zero(acc_dv);
  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      load_qd(j + 1, s_qd + 2 * ((j + 1) & 1) * TILE<E>);
      wg::cp_async_commit();
      wg::cp_async_wait<1>();
    } else {
      wg::cp_async_wait<0>();
    }
    if (threadIdx.x < ROWS) {
      const wg::Pos p = geo.stream(j, threadIdx.x);
      s_stat[threadIdx.x] = p.ok ? a.lse[stat + geo.index(p)] * LOG2E : 0.f;
      s_stat[ROWS + threadIdx.x] = p.ok ? a.delta[stat + geo.index(p)] : 0.f;
    }
    __syncthreads();
    const float* s_q = s_qd + 2 * (j & 1) * TILE<E>;
    const float* s_do = s_q + TILE<E>;
    float acc_s[8][4], acc_dp[8][4];
    zero(acc_s);
    zero(acc_dp);
    mma_nt<E>(acc_s, s_k, r0, s_q);
    mma_nt<E>(acc_dp, s_v, r0, s_do);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = 8 * n + 2 * t + (i & 1);  // the query's row in the tile
        const float p =
            geo.mask(j, c, info[i >> 1]) ? exp2f(acc_s[n][i] * scale - s_stat[c]) : 0.f;
        acc_s[n][i] = p;                                       // P^T
        acc_dp[n][i] = p * (acc_dp[n][i] - s_stat[ROWS + c]);  // dS^T
      }
    mma_pv<E, NC<E>>(acc_dv, acc_s, s_do + c0);
    mma_pv<E, NC<E>>(acc_dk, acc_dp, s_q + c0);
    __syncthreads();
  }
  store_rows<E, NC<E>>(a.dk + c0, a.io, img, head, acc_dk, r0, own, a.scale, a.scale);
  store_rows<E, NC<E>>(a.dv + c0, a.io, img, head, acc_dv, r0, own, 1.f, 1.f);
}

template <int E>
constexpr size_t FWD_SMEM = 5 * TILE<E> * sizeof(float);
template <int E>
constexpr size_t BWD_SMEM = (6 * TILE<E> + 2 * ROWS) * sizeof(float);

// The dense kernels (K13 and K3 in f32, K14 and K9 in f32): a block owns
// rows [64 blockIdx.x, 64 blockIdx.x + 64) of the sequence (wg::Seq) and
// every 64-row tile streams past them.
template <int E>
__global__ void __launch_bounds__(BLOCK<E>) tf32_fwd_kernel(const Args a, int s) {
  fwd_body<E>(a, wg::Seq(blockIdx.x, s));
}

template <int E>
__global__ void __launch_bounds__(BLOCK<E>) tf32_dq_kernel(const Args a, int s) {
  dq_body<E>(a, wg::Seq(blockIdx.x, s));
}

template <int E>
__global__ void __launch_bounds__(BLOCK<E>) tf32_dkv_kernel(const Args a, int s) {
  dkv_body<E>(a, wg::Seq(blockIdx.x, s));
}

// A dense launch's strides: q, k and v through `in` (head h at column h *
// E), out, dout, dq, dk and dv (b, s, heads, E) contiguous.
template <int E>
Args dense(Args a, Rows in, int s) {
  const long ld = static_cast<long>(a.n_heads) * E;
  a.sq = a.sk = a.sv = MapStrides{in.batch, in.seq, 0};
  a.io = MapStrides{s * ld, ld, 0};
  return a;
}

// The forward on q, k, v read through `in`; any s >= 1.
template <int E>
int launch_fwd(const Args& args, Rows in, int b, int s, cudaStream_t st) {
  const Args a = dense<E>(args, in, s);
  const dim3 grid((s + ROWS - 1) / ROWS, a.n_heads, b);
  const cudaError_t attr = allow_smem(tf32_fwd_kernel<E>, FWD_SMEM<E>);
  tf32_fwd_kernel<E><<<grid, BLOCK<E>, FWD_SMEM<E>, st>>>(a, s);
  return launch_status(attr);
}

// The dq kernel (which writes delta), then the dk/dv kernel on the same
// stream.
template <int E>
int launch_bwd(const Args& args, Rows in, int b, int s, cudaStream_t st) {
  const Args a = dense<E>(args, in, s);
  const dim3 grid((s + ROWS - 1) / ROWS, a.n_heads, b);
  cudaError_t attr = allow_smem(tf32_dq_kernel<E>, BWD_SMEM<E>);
  tf32_dq_kernel<E><<<grid, BLOCK<E>, BWD_SMEM<E>, st>>>(a, s);
  const int status = launch_status(attr);
  if (status != 0) return status;
  attr = allow_smem(tf32_dkv_kernel<E>, BWD_SMEM<E>);
  tf32_dkv_kernel<E><<<grid, BLOCK<E>, BWD_SMEM<E>, st>>>(a, s);
  return launch_status(attr);
}

}  // namespace tf32
}  // namespace kdt
