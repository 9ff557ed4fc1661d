// Exact global softmax attention in float32 on (b, s, heads, e) q, k, v:
// the forward with its logsumexp (K13 in f32) and the backward (K14 in
// f32), the kernels of --mixed-precision no.
//
// Replaces: k_diffusion_tpu/ops/pallas/flash.py:_fwd_kernel,
// :_dq_kernel and :_dkv_kernel as they run on f32 operands (the JAX model
// built with dtype=float32): f32 dots with f32 accumulation, p / l in f32.
// Here every product runs on the TF32 tensor cores (operands rounded to
// TF32 by cvt.rna, 10 mantissa bits) with f32 accumulation, as PyTorch's
// float32 training does with TF32 on; the softmax, its rescales, lse and
// delta stay in f32.
//
// What bounds it on the H100, cifar10 U-Net at batch 64 (s = 256, 4 heads,
// head dim 64): the forward does 4 s^2 64 FLOP per image and head, 4.3
// GFLOP, 8.7 us at TF32's 494.7 TFLOP/s, and moves q, k, v and the output
// in f32, 4 x 16.8 MB, 20 us at 3.35 TB/s: bound by memory. The backward
// does 2.5x the products and moves 2.25x the bytes.
//
// Design: FlashAttention-2's forward and two-kernel backward on warp-level
// mma.sync m16n8k8 (tf32 x tf32 -> f32). A block is 4 warps and owns 64
// rows of one head of one image (grid: row tiles, heads, batch); a warp
// owns 16 of them. The other operand streams through shared memory in
// 64-row f32 tiles, two stages filled by 16-byte cp.async (rows past s
// zero-filled by the copy's source size), one commit group per tile pair.
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
// atomics, so a rerun is bit-equal.
//
// At E = 64 the forward holds 5 tiles (85 KB), each backward kernel 6
// (102 KB): two blocks an SM. A simple design; making it fast is later work
// (PERF.md, ROADMAP.md queue 2).
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

// Starts the copy of rows [r0, r0 + 64) of one head's (s, E) slice (row
// stride ld, `base` at row 0 of the head) into a padded tile; rows at or
// past s are zero-filled.
template <int E>
__device__ __forceinline__ void load_tile(float* tile, const float* base, long ld, int r0, int s) {
  constexpr int CH = E / 4;  // 16-byte chunks per row
  const uint32_t dst = wg::smem_u32(tile);
  for (int i = threadIdx.x; i < ROWS * CH; i += blockDim.x) {
    const int r = i / CH, c = i % CH;
    const bool ok = r0 + r < s;
    wg::cp_async16(dst + (r * LD<E> + c * 4) * 4, ok ? base + (r0 + r) * ld + c * 4 : base, ok);
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

// acc[n] (16 x 8 block n of 16 x E) += P Y over the tile's 64 rows: P the
// 16 x 64 accumulator p (its 8-key blocks are the A fragments, keys
// permuted within each block), Y the tile y_tile.
template <int E>
__device__ __forceinline__ void mma_pv(float (&acc)[E / 8][4], const float (&p)[8][4],
                                       const float* y_tile) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int kb = 0; kb < 8; ++kb) {
    const uint32_t a[4] = {to_tf32(p[kb][0]), to_tf32(p[kb][2]), to_tf32(p[kb][1]),
                           to_tf32(p[kb][3])};
    const float* row = y_tile + (8 * kb + 2 * t) * LD<E> + g;
#pragma unroll
    for (int n = 0; n < E / 8; ++n) mma(acc[n], a, to_tf32(row[8 * n]), to_tf32(row[LD<E> + 8 * n]));
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
}

// Writes a warp's 16 x E accumulator to rows [r0, r0 + 16) of a contiguous
// (b, s, heads, E) tensor at `out` (row 0 of the head in its image: stride
// heads E a row), rows r0 + g times mul0 and rows r0 + g + 8 times mul1;
// rows at or past s are skipped.
template <int E>
__device__ __forceinline__ void store_rows(float* out, const float (&acc)[E / 8][4], int r0,
                                           int s, int n_heads, float mul0, float mul1) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const long ld = static_cast<long>(n_heads) * E;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
    if (r >= s) continue;
    const float mul = h ? mul1 : mul0;
#pragma unroll
    for (int n = 0; n < E / 8; ++n)
      *reinterpret_cast<float2*>(out + r * ld + 8 * n + 2 * t) =
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

// The operands of a launch: q, k, v (b, s, heads, E) f32 through the
// strides `in`; out (the forward's output, which the backward reads), dout,
// dq, dk, dv (b, s, heads, E) f32 contiguous; lse and delta (b, heads, s)
// f32.
struct Args {
  const float *q, *k, *v, *dout;
  float *out, *lse, *delta, *dq, *dk, *dv;
  Rows in;
  int s, n_heads;
  float scale;
};

// The forward: a block's 64 query rows against every key tile; O / l to
// a.out and, when a.lse is not null, lse = max + log(sum) of each row's
// scaled logits, natural log.
template <int E>
__global__ void __launch_bounds__(128) tf32_fwd_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;
  float* s_kv = smem + TILE<E>;  // stage st: K at 2 st TILE, V after it
  const int tile = blockIdx.x, head = blockIdx.y, img = blockIdx.z, s = a.s;
  const int warp = threadIdx.x / 32, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const long off = img * a.in.batch + static_cast<long>(head) * E;
  const float *q = a.q + off, *k = a.k + off, *v = a.v + off;
  const int n_tiles = (s + ROWS - 1) / ROWS;
  const float scale = a.scale * LOG2E;

  load_tile<E>(s_q, q, a.in.seq, tile * ROWS, s);
  load_tile<E>(s_kv, k, a.in.seq, 0, s);
  load_tile<E>(s_kv + TILE<E>, v, a.in.seq, 0, s);
  wg::cp_async_commit();

  float acc_o[E / 8][4];
  zero(acc_o);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      float* next = s_kv + 2 * ((j + 1) & 1) * TILE<E>;
      load_tile<E>(next, k, a.in.seq, (j + 1) * ROWS, s);
      load_tile<E>(next + TILE<E>, v, a.in.seq, (j + 1) * ROWS, s);
      wg::cp_async_commit();
      wg::cp_async_wait<1>();
    } else {
      wg::cp_async_wait<0>();
    }
    __syncthreads();
    const float* s_k = s_kv + 2 * (j & 1) * TILE<E>;
    float acc_s[8][4];
    zero(acc_s);
    mma_nt<E>(acc_s, s_q, 16 * warp, s_k);
    // scaled logits, keys past s masked; each row's running max
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = j * ROWS + 8 * n + 2 * t + (i & 1);
        acc_s[n][i] = col < s ? acc_s[n][i] * scale : -INFINITY;
        mx[i >> 1] = fmaxf(mx[i >> 1], acc_s[n][i]);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = quad_max(mx[h]);
      const float alpha = exp2f(m[h] - mx[h]);  // 0 on the first tile
      m[h] = mx[h];
      l[h] *= alpha;
#pragma unroll
      for (int n = 0; n < E / 8; ++n) {
        acc_o[n][2 * h] *= alpha;
        acc_o[n][2 * h + 1] *= alpha;
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc_s[n][i] = exp2f(acc_s[n][i] - m[i >> 1]);
        l[i >> 1] += acc_s[n][i];
      }
    mma_pv<E>(acc_o, acc_s, s_k + TILE<E>);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  const int r0 = tile * ROWS + 16 * warp;
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
  float* o = a.out + (static_cast<long>(img) * s) * a.n_heads * E + static_cast<long>(head) * E;
  store_rows<E>(o, acc_o, r0, s, a.n_heads, 1.f / l[0], 1.f / l[1]);
  if (a.lse != nullptr && t == 0) {
    float* lse = a.lse + (static_cast<long>(img) * a.n_heads + head) * s;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (r0 + g + 8 * h < s) lse[r0 + g + 8 * h] = (m[h] + __log2f(l[h])) * LN2;
  }
}

// The backward's dq kernel: a block's 64 query rows against every key tile.
// It first forms delta = rowsum(out * dout) for its rows (written to
// a.delta for the dk/dv kernel), then dq = scale sum_j dS_j K_j with dS =
// P (dP - delta), P = exp(logits - lse), dP = dO V^T.
template <int E>
__global__ void __launch_bounds__(128) tf32_dq_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;
  float* s_do = smem + TILE<E>;
  float* s_kv = smem + 2 * TILE<E>;
  float* s_stat = smem + 6 * TILE<E>;  // lse log2 e, then delta, of the own rows
  const int tile = blockIdx.x, head = blockIdx.y, img = blockIdx.z, s = a.s;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const long off = img * a.in.batch + static_cast<long>(head) * E;
  const float *q = a.q + off, *k = a.k + off, *v = a.v + off;
  const long ld = static_cast<long>(a.n_heads) * E;  // row stride of out, dout, dq
  const long off_c = static_cast<long>(img) * s * ld + static_cast<long>(head) * E;
  const int n_tiles = (s + ROWS - 1) / ROWS;
  const float scale = a.scale * LOG2E;

  load_tile<E>(s_q, q, a.in.seq, tile * ROWS, s);
  load_tile<E>(s_do, a.dout + off_c, ld, tile * ROWS, s);
  load_tile<E>(s_kv, k, a.in.seq, 0, s);
  load_tile<E>(s_kv + TILE<E>, v, a.in.seq, 0, s);
  wg::cp_async_commit();

  // delta and lse of the warp's 16 rows, one row at a time over the warp
  const long stat = (static_cast<long>(img) * a.n_heads + head) * s;
  for (int i = 0; i < 16; ++i) {
    const int r = tile * ROWS + 16 * warp + i;
    float d = 0.f;
    if (r < s) {
      const float* o_row = a.out + off_c + r * ld;
      const float* do_row = a.dout + off_c + r * ld;
      for (int c = lane; c < E; c += 32) d += o_row[c] * do_row[c];
    }
    d = warp_sum(d);
    if (lane == 0) {
      s_stat[16 * warp + i] = r < s ? a.lse[stat + r] * LOG2E : 0.f;
      s_stat[ROWS + 16 * warp + i] = d;
      if (r < s) a.delta[stat + r] = d;
    }
  }
  __syncwarp();
  float lse[2], delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lse[h] = s_stat[16 * warp + g + 8 * h];
    delta[h] = s_stat[ROWS + 16 * warp + g + 8 * h];
  }

  float acc_dq[E / 8][4];
  zero(acc_dq);
  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      float* next = s_kv + 2 * ((j + 1) & 1) * TILE<E>;
      load_tile<E>(next, k, a.in.seq, (j + 1) * ROWS, s);
      load_tile<E>(next + TILE<E>, v, a.in.seq, (j + 1) * ROWS, s);
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
    mma_nt<E>(acc_s, s_q, 16 * warp, s_k);
    mma_nt<E>(acc_dp, s_do, 16 * warp, s_v);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = j * ROWS + 8 * n + 2 * t + (i & 1);
        const float p = col < s ? exp2f(acc_s[n][i] * scale - lse[i >> 1]) : 0.f;
        acc_s[n][i] = p * (acc_dp[n][i] - delta[i >> 1]);  // dS
      }
    mma_pv<E>(acc_dq, acc_s, s_k);
    __syncthreads();
  }
  store_rows<E>(a.dq + off_c, acc_dq, tile * ROWS + 16 * warp, s, a.n_heads, a.scale, a.scale);
}

// The backward's dk/dv kernel: a block's 64 key rows against every query
// tile, in the transposed products: S^T = K Q^T, P^T = exp(S^T - lse),
// dP^T = V dO^T, dS^T = P^T (dP^T - delta); dv = sum_i P^T dO, dk = scale
// sum_i dS^T Q. lse and delta of each query tile are staged in shared
// memory beside it.
template <int E>
__global__ void __launch_bounds__(128) tf32_dkv_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  float* s_k = smem;
  float* s_v = smem + TILE<E>;
  float* s_qd = smem + 2 * TILE<E>;   // stage st: Q at 2 st TILE, dO after it
  float* s_stat = smem + 6 * TILE<E>;  // lse log2 e, then delta, of the query tile
  const int tile = blockIdx.x, head = blockIdx.y, img = blockIdx.z, s = a.s;
  const int warp = threadIdx.x / 32, t = threadIdx.x & 3;
  const long off = img * a.in.batch + static_cast<long>(head) * E;
  const float *q = a.q + off, *k = a.k + off, *v = a.v + off;
  const long ld = static_cast<long>(a.n_heads) * E;
  const long off_c = static_cast<long>(img) * s * ld + static_cast<long>(head) * E;
  const float* dout = a.dout + off_c;
  const long stat = (static_cast<long>(img) * a.n_heads + head) * s;
  const int n_tiles = (s + ROWS - 1) / ROWS;
  const float scale = a.scale * LOG2E;

  load_tile<E>(s_k, k, a.in.seq, tile * ROWS, s);
  load_tile<E>(s_v, v, a.in.seq, tile * ROWS, s);
  load_tile<E>(s_qd, q, a.in.seq, 0, s);
  load_tile<E>(s_qd + TILE<E>, dout, ld, 0, s);
  wg::cp_async_commit();

  float acc_dk[E / 8][4], acc_dv[E / 8][4];
  zero(acc_dk);
  zero(acc_dv);
  for (int i0 = 0; i0 < n_tiles; ++i0) {
    if (i0 + 1 < n_tiles) {
      float* next = s_qd + 2 * ((i0 + 1) & 1) * TILE<E>;
      load_tile<E>(next, q, a.in.seq, (i0 + 1) * ROWS, s);
      load_tile<E>(next + TILE<E>, dout, ld, (i0 + 1) * ROWS, s);
      wg::cp_async_commit();
      wg::cp_async_wait<1>();
    } else {
      wg::cp_async_wait<0>();
    }
    if (threadIdx.x < ROWS) {
      const int r = i0 * ROWS + threadIdx.x;
      s_stat[threadIdx.x] = r < s ? a.lse[stat + r] * LOG2E : 0.f;
      s_stat[ROWS + threadIdx.x] = r < s ? a.delta[stat + r] : 0.f;
    }
    __syncthreads();
    const float* s_q = s_qd + 2 * (i0 & 1) * TILE<E>;
    const float* s_do = s_q + TILE<E>;
    float acc_s[8][4], acc_dp[8][4];
    zero(acc_s);
    zero(acc_dp);
    mma_nt<E>(acc_s, s_k, 16 * warp, s_q);
    mma_nt<E>(acc_dp, s_v, 16 * warp, s_do);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = 8 * n + 2 * t + (i & 1);  // the query's row in the tile
        const float p =
            i0 * ROWS + c < s ? exp2f(acc_s[n][i] * scale - s_stat[c]) : 0.f;
        acc_s[n][i] = p;                                   // P^T
        acc_dp[n][i] = p * (acc_dp[n][i] - s_stat[ROWS + c]);  // dS^T
      }
    mma_pv<E>(acc_dv, acc_s, s_do);
    mma_pv<E>(acc_dk, acc_dp, s_q);
    __syncthreads();
  }
  const int r0 = tile * ROWS + 16 * warp;
  store_rows<E>(a.dk + off_c, acc_dk, r0, s, a.n_heads, a.scale, a.scale);
  store_rows<E>(a.dv + off_c, acc_dv, r0, s, a.n_heads, 1.f, 1.f);
}

template <int E>
constexpr size_t FWD_SMEM = 5 * TILE<E> * sizeof(float);
template <int E>
constexpr size_t BWD_SMEM = (6 * TILE<E> + 2 * ROWS) * sizeof(float);

template <int E>
int launch_fwd(const Args& a, int b, cudaStream_t st) {
  const dim3 grid((a.s + ROWS - 1) / ROWS, a.n_heads, b);
  const cudaError_t attr = allow_smem(tf32_fwd_kernel<E>, FWD_SMEM<E>);
  tf32_fwd_kernel<E><<<grid, 128, FWD_SMEM<E>, st>>>(a);
  return launch_status(attr);
}

// The dq kernel (which writes delta), then the dk/dv kernel on the same
// stream.
template <int E>
int launch_bwd(const Args& a, int b, cudaStream_t st) {
  const dim3 grid((a.s + ROWS - 1) / ROWS, a.n_heads, b);
  cudaError_t attr = allow_smem(tf32_dq_kernel<E>, BWD_SMEM<E>);
  tf32_dq_kernel<E><<<grid, 128, BWD_SMEM<E>, st>>>(a);
  const int status = launch_status(attr);
  if (status != 0) return status;
  attr = allow_smem(tf32_dkv_kernel<E>, BWD_SMEM<E>);
  tf32_dkv_kernel<E><<<grid, 128, BWD_SMEM<E>, st>>>(a);
  return launch_status(attr);
}

}  // namespace tf32
}  // namespace kdt
