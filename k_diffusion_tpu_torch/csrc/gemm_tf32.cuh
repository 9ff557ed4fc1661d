// The TF32 GEMM core of the float32 kernels (--mixed-precision no): the
// attention prologue K1 and its backward K6 (fused_qkv_f32.cu), the
// feed-forward block K4 and its backward K10 and the mapping network K5
// (geglu_f32.cu). What gemm.cuh is to their bf16 forms, on attn_tf32.cuh's
// scheme.
//
// Why not gemm.cuh's wgmma core: wgmma takes TF32 operands K-major only,
// and these products read their weights MN-major (C = A B: K1's and K4's
// W, read along their rows) and both operands MN-major (C = A^T B: the
// weight gradients). So every product here is a warp-level mma.sync
// m16n8k8 (tf32 x tf32 -> f32; operands rounded by cvt.rna, 10 mantissa
// bits), whose fragments are gathered from f32 tiles in shared memory one
// 32-bit load each, in whichever orientation a product needs.
//
// A block is 8 warps and owns a 128-row output tile and NT accumulator
// sets of 64 columns; warp w owns rows [16 w, 16 w + 16) of every set
// (acc[j][n]: the 16 x 8 block n, 32 registers a set). A thread thus holds
// rows g and g + 8 (g = lane / 4) at columns 8 n + 2 t and 8 n + 2 t + 1
// (t = lane % 4) of each set: a 64-column panel's every column of a row
// lies in one quad of lanes, and columns c and c ^ 8 or c ^ 16 (a head's
// RoPE partners at head dim 32 and 64) in one thread, so the prologue's
// epilogues need no exchange. Why 128 rows: a step's tiles come from L2 or
// device memory, and a 64 x 64 f32 output tile does 16 FLOP a byte of
// them, where eight warps sharing each B tile do 21 (NT = 1) or 32 (NT =
// 2).
//
// The depth streams in steps of 32 through a ring of two stages filled by
// 16-byte cp.async, one commit group a step, step s + 1's copies in flight
// while step s's products run; a stage holds the A tile and the NT B tiles
// of one step. (A third stage, or 64-deep steps, ran slower on an H100:
// more shared memory a block, fewer blocks an SM.) A tile keeps its rows
// as they lie in memory, padded so that every fragment load is
// conflict-free:
// - K-major (128 rows of A's M index or 64 of B's N index, 32 depth
//   columns), row stride 36 floats (4 mod 32): fragment element (row g,
//   depth t) at bank 4 g + t;
// - MN-major (32 depth rows, 128 columns of A's M index or 64 of B's N
//   index), row stride 136 or 72 floats (8 mod 32): element (depth t,
//   column g) at bank 8 t + g.
// The three product forms of gemm.cuh: C = A B (A K-major, B MN-major),
// C = A B^T (both K-major) and C = A^T B (both MN-major). Rows or columns
// of A past its M extent, and depth rows of an MN-major operand past the
// depth's end, are zero-filled by the copy's source size; a K-major
// operand's depth is a multiple of 32 everywhere here (d, 3 d, d_ff, 2
// d_ff with d, d_ff multiples of 64).
//
// Row reductions (the weight gradients, d(scale), d(attn_scale)) are
// per-block f32 partials summed by gemm.cuh's reduce_kernel in a fixed
// order, never atomics: a rerun gives bit-equal results. A simple design;
// wgmma with transposed tiles, and TMA, are later work (PERF.md).
#pragma once

#include <climits>
#include <cstdint>

#include "gemm.cuh"

namespace kdt {
namespace tg {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 16 * WARPS;  // rows of a block's output tile, A's M
constexpr int BK = 32;            // depth of a ring step
constexpr int STAGES = 2;
constexpr int LDK = BK + 4;       // row stride of a K-major tile
constexpr int LDA = ROWS + 8;     // row stride of an MN-major A tile
constexpr int LDB = 64 + 8;       // row stride of an MN-major B tile
constexpr int A_TILE = ROWS * LDK;
constexpr int B_TILE = 64 * LDK;
static_assert(A_TILE >= BK * LDA && B_TILE == BK * LDB, "either kind fits its slot");

// Shared memory of a core loop with NT sets: its ring.
template <int NT>
constexpr size_t RING_BYTES = STAGES * (A_TILE + NT * B_TILE) * sizeof(float);

// Row tiles of `tokens` rows an image: ROWS rows, the last one ragged.
__host__ __device__ inline int tiles(int tokens) { return (tokens + ROWS - 1) / ROWS; }

// Rows of one image in ROWS-row tiles: block x of the grid is tile `tile`
// of image `img`, `valid` rows from row0 of the (images * tokens, ...)
// operand. A tile never spans two images, so it takes one norm scale.
struct RowTile {
  long row0;
  int valid, img, tile;
};
__device__ __forceinline__ RowTile row_tile(int tokens) {
  const int n = tiles(tokens), img = blockIdx.x / n, tile = blockIdx.x % n;
  const int valid = tokens - tile * ROWS < ROWS ? tokens - tile * ROWS : ROWS;
  return {static_cast<long>(img) * tokens + static_cast<long>(tile) * ROWS, valid, img, tile};
}

// A row-major (rows, cols) f32 operand held in two parts by columns:
// columns [0, split) at p0 (row stride ld0), the rest at p1 (row stride
// ld1). K6's dR is (dq, dk) in its own buffer and gv as the model gave it.
struct Mat {
  const float* p0;
  long ld0;
  int split;
  const float* p1;
  long ld1;
  __device__ const float* at(long r, int c) const {
    return c < split ? p0 + r * ld0 + c : p1 + r * ld1 + (c - split);
  }
};
__host__ __device__ inline Mat mat(const float* p, long ld) { return {p, ld, INT_MAX, p, ld}; }

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// d += a b: m16n8k8, TF32 operands, f32 accumulators.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][8][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[j][n][0] = acc[j][n][1] = acc[j][n][2] = acc[j][n][3] = 0.f;
}

__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }
// The tile row of a thread's accumulator element h (0: row g, 1: row g + 8).
__device__ __forceinline__ int acc_row(int h) { return 16 * (threadIdx.x / 32) + lane_g() + 8 * h; }

// Starts the copy of a K-major tile: rows [r0, r0 + R) of m (rows at or
// past r_end zero), depth columns [k0, k0 + 32).
template <int R>
__device__ __forceinline__ void load_k(float* tile, const Mat& m, long r0, long r_end, int k0) {
  const uint32_t dst = wg::smem_u32(tile);
  for (int i = threadIdx.x; i < R * 8; i += THREADS) {
    const int r = i >> 3, c = (i & 7) * 4;
    const bool ok = r0 + r < r_end;
    wg::cp_async16(dst + (r * LDK + c) * 4, m.at(ok ? r0 + r : r0, k0 + c), ok);
  }
}

// Starts the copy of an MN-major tile of row stride LD: depth rows [k0, k0
// + 32) of m, columns [c0, c0 + C); rows at or past k_end and columns at
// or past c_end zero.
template <int C, int LD>
__device__ __forceinline__ void load_mn(float* tile, const Mat& m, long k0, long k_end, int c0,
                                        int c_end) {
  const uint32_t dst = wg::smem_u32(tile);
  for (int i = threadIdx.x; i < BK * (C / 4); i += THREADS) {
    const int r = i / (C / 4), c = (i % (C / 4)) * 4;
    const bool ok = k0 + r < k_end && c0 + c < c_end;
    wg::cp_async16(dst + (r * LD + c) * 4, m.at(ok ? k0 + r : k0, ok ? c0 + c : c0), ok);
  }
}

// The identity on an A element: a product's A taken as it is.
struct Plain {
  __device__ float operator()(float v, int, int) const { return v; }
};

// The AdaRMSNorm of a normalised product's A, x (rows, d), folded into the
// product: R = xn W = r ((x nscale) W), r = 1 / sqrt(mean(x^2) + eps) per
// row. Each A element x at depth k enters as x nscale[k] (the image's
// scale, staged in shared memory by load_scale), and its square joins the
// sum of its row (h: the thread's row g or g + 8), so that row_norms gives
// r after the loop: a thread quad sees every column of its rows once. No
// pass over the x tile before the products, and no second read of it.
struct Normed {
  const float* s_ns;
  float ss[2] = {0.f, 0.f};
  __device__ float operator()(float v, int k, int h) {
    ss[h] += v * v;
    return v * s_ns[k];
  }
};

// acc[j] += A B_j over the depth [k_begin, k_end), A and every B_j read as
// AK and BK say (true: K-major). A K-major A is rows [a0, a0 + ROWS) of
// `a`, those at or past a_end zero; an MN-major A is its columns [a0, a0 +
// ROWS), those at or past a_end zero. A K-major B_j is rows [b0[j],
// b0[j] + 64) of `b`; an MN-major one its columns [b0[j], b0[j] + 64).
// `f(v, k, h)` maps each element of a K-major A at depth k in the thread's
// row h before its TF32 rounding (Normed: the norm folded into the
// product). Ends with the ring drained and every thread past it, so that
// the caller may reuse the ring.
template <bool AK, bool BK_, int NT, class F>
__device__ __forceinline__ void mainloop(float (&acc)[NT][8][4], float* ring, const Mat& a,
                                         long a0, long a_end, const Mat& b,
                                         const int (&b0)[NT], long k_begin, long k_end,
                                         F&& f) {
  const int steps = static_cast<int>((k_end - k_begin + BK - 1) / BK);
  constexpr int STAGE = A_TILE + NT * B_TILE;
  auto load = [&](int s, int st) {
    float* stage = ring + st * STAGE;
    const long k0 = k_begin + static_cast<long>(s) * BK;
    if constexpr (AK) load_k<ROWS>(stage, a, a0, a_end, static_cast<int>(k0));
    else load_mn<ROWS, LDA>(stage, a, k0, k_end, static_cast<int>(a0), static_cast<int>(a_end));
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float* tile = stage + A_TILE + j * B_TILE;
      if constexpr (BK_) load_k<64>(tile, b, b0[j], LONG_MAX, static_cast<int>(k0));
      else load_mn<64, LDB>(tile, b, k0, k_end, b0[j], INT_MAX);
    }
  };
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s, s);
    wg::cp_async_commit();
  }
  const int g = lane_g(), t = lane_t(), m0 = 16 * (threadIdx.x / 32);
  for (int s = 0; s < steps; ++s) {
    wg::cp_async_wait<STAGES - 2>();
    __syncthreads();  // step s has landed everywhere; every warp is done with step s - 1
    if (s + STAGES - 1 < steps) load(s + STAGES - 1, (s + STAGES - 1) % STAGES);
    wg::cp_async_commit();
    const float* sa = ring + (s % STAGES) * STAGE;
    const int k0 = static_cast<int>(k_begin) + s * BK;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t fa[4];
      if constexpr (AK) {
        const float* p = sa + (m0 + g) * LDK + kk + t;
        fa[0] = to_tf32(f(p[0], k0 + kk + t, 0));
        fa[1] = to_tf32(f(p[8 * LDK], k0 + kk + t, 1));
        fa[2] = to_tf32(f(p[4], k0 + kk + t + 4, 0));
        fa[3] = to_tf32(f(p[8 * LDK + 4], k0 + kk + t + 4, 1));
      } else {
        const float* p = sa + (kk + t) * LDA + m0 + g;
        fa[0] = to_tf32(p[0]);
        fa[1] = to_tf32(p[8]);
        fa[2] = to_tf32(p[4 * LDA]);
        fa[3] = to_tf32(p[4 * LDA + 8]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float* sb = sa + A_TILE + j * B_TILE;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          if constexpr (BK_) {
            const float* p = sb + (8 * n + g) * LDK + kk + t;
            mma(acc[j][n], fa, to_tf32(p[0]), to_tf32(p[4]));
          } else {
            const float* p = sb + (kk + t) * LDB + 8 * n + g;
            mma(acc[j][n], fa, to_tf32(p[0]), to_tf32(p[4 * LDB]));
          }
        }
      }
    }
  }
  wg::cp_async_wait<0>();
  __syncthreads();
}

// Stages the image's norm scale (d,) f32 in shared memory for Normed; the
// core loop's first barrier orders it before any product reads it.
__device__ __forceinline__ void load_scale(const float* __restrict__ ns_row, int d, float* s_ns) {
  for (int c = 4 * threadIdx.x; c < d; c += 4 * THREADS)
    *reinterpret_cast<float4*>(s_ns + c) = *reinterpret_cast<const float4*>(ns_row + c);
}

// r of the thread's two rows once a Normed loop has run: the quad's sums
// of squares over every column (rows past the tile's end are zero-filled,
// r of a zero row).
__device__ __forceinline__ void row_norms(const Normed& f, int d, float eps, float (&r)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) r[h] = rsqrtf(gemm::quad_sum(f.ss[h]) / d + eps);
}

// xn = x * (nscale r), the plain version's xn, and r of a row tile to
// device memory, for the backwards' weight gradients: r from row_norms
// through s_r (ROWS floats), x read again (from L2, most likely). Every
// thread of the block calls it.
__device__ inline void write_xn(const float* __restrict__ x, const RowTile& t, int d,
                                const float* s_ns, const float (&r)[2], float* s_r,
                                float* __restrict__ xn_out, float* __restrict__ r_out) {
  if (lane_t() == 0) {
    s_r[acc_row(0)] = r[0];
    s_r[acc_row(1)] = r[1];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < t.valid * (d / 4); i += THREADS) {
    const int row = i / (d / 4), c = 4 * (i % (d / 4));
    const float4 v = *reinterpret_cast<const float4*>(x + (t.row0 + row) * d + c);
    const float rr = s_r[row];
    *reinterpret_cast<float4*>(xn_out + (t.row0 + row) * d + c) =
        make_float4(v.x * (s_ns[c] * rr), v.y * (s_ns[c + 1] * rr), v.z * (s_ns[c + 2] * rr),
                    v.w * (s_ns[c + 3] * rr));
  }
  if (static_cast<int>(threadIdx.x) < t.valid) r_out[t.row0 + threadIdx.x] = s_r[threadIdx.x];
}

// Shared memory of a kernel with a normalised product: s_ns (d), s_r
// (ROWS), then the ring, 16-byte aligned (d is a multiple of 64).
template <int NT>
inline size_t normed_smem(int d) {
  return (d + ROWS) * sizeof(float) + RING_BYTES<NT>;
}

// dxn = dR W^T (dR (rows, K) a Mat, W (d, K) row-major) for one row tile
// and one 64-column panel of d (both operands K-major), and the RMS-norm
// VJP in the epilogue (gemm.cuh's note), per row with r and s, the
// fixed-order sum over its `groups` partials dot_part (groups, rows):
//   dx = r dxn nscale - x (r^2 / d) s  (+ res, the block's own residual)
// and the tile's d(nscale) partial, the sum over its rows of dxn x r, into
// dns_part (images * tiles, d). Grid (images * tiles, d / 64), ROWS-row
// tiles.
__global__ void __launch_bounds__(THREADS)
norm_vjp_f32_kernel(Mat dr, const float* __restrict__ w, const float* __restrict__ x,
                    const float* __restrict__ nscale, const float* __restrict__ res,
                    const float* __restrict__ r_rows, const float* __restrict__ dot_part,
                    int groups, float* __restrict__ dx, float* __restrict__ dns_part, long n_rows,
                    int tokens, int d, int k_dim) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float s_red[WARPS][64];
  const RowTile t = row_tile(tokens);
  const int n0 = 64 * blockIdx.y;
  float acc[1][8][4];
  zero(acc);
  const int b0[1] = {n0};
  mainloop<true, true, 1>(acc, smem, dr, t.row0, t.row0 + t.valid, mat(w, k_dim), b0, 0, k_dim,
                          Plain{});
  const int t4 = lane_t(), warp = threadIdx.x / 32;
  const float* ns = nscale + static_cast<long>(t.img) * d + n0;
  float r[2], coef[2];
  bool ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    ok[h] = acc_row(h) < t.valid;
    const long row = t.row0 + (ok[h] ? acc_row(h) : 0);
    float s = 0.f;
    for (int gi = 0; gi < groups; ++gi) s += dot_part[gi * n_rows + row];
    r[h] = r_rows[row];
    coef[h] = r[h] * r[h] * s / d;
  }
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = 8 * n + 2 * t4;
    const float2 nv = *reinterpret_cast<const float2*>(ns + col);
    float p0 = 0.f, p1 = 0.f;  // this column pair's d(nscale) terms
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!ok[h]) continue;
      const long at = (t.row0 + acc_row(h)) * d + n0 + col;
      const float d0 = acc[0][n][2 * h], d1 = acc[0][n][2 * h + 1];
      const float2 xv = *reinterpret_cast<const float2*>(x + at);
      float v0 = r[h] * d0 * nv.x - xv.x * coef[h], v1 = r[h] * d1 * nv.y - xv.y * coef[h];
      if (res != nullptr) {
        const float2 rv = *reinterpret_cast<const float2*>(res + at);
        v0 += rv.x;
        v1 += rv.y;
      }
      *reinterpret_cast<float2*>(dx + at) = make_float2(v0, v1);
      p0 += d0 * xv.x * r[h];
      p1 += d1 * xv.y * r[h];
    }
    p0 = gemm::column_sum(p0);
    p1 = gemm::column_sum(p1);
    if (lane_g() == 0) {
      s_red[warp][col] = p0;
      s_red[warp][col + 1] = p1;
    }
  }
  __syncthreads();
  if (threadIdx.x < 64) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += s_red[w][threadIdx.x];  // warp order
    dns_part[static_cast<long>(blockIdx.x) * d + n0 + threadIdx.x] = s;
  }
}

// dW partials: part[chunk] (m, n) = A[rows of chunk]^T B[rows of chunk],
// A (rows, m) and B (rows, n) Mats, both MN-major. Grid (ceil(m / ROWS), n
// / 64, chunks): a block owns a ROWS x 64 output tile (its rows past m
// zero, not stored) and walks its chunk's rows.
__global__ void __launch_bounds__(THREADS)
atb_f32_kernel(Mat a, Mat b, float* __restrict__ part, long rows, int m, int n, long chunk_rows) {
  extern __shared__ __align__(16) float smem[];
  const int m0 = ROWS * blockIdx.x, n0 = 64 * blockIdx.y;
  const long begin = blockIdx.z * chunk_rows;
  const long end = begin + chunk_rows < rows ? begin + chunk_rows : rows;
  float acc[1][8][4];
  zero(acc);
  const int b0[1] = {n0};
  mainloop<false, false, 1>(acc, smem, a, m0, m, b, b0, begin, end, Plain{});
  float* out = part + (static_cast<long>(blockIdx.z) * m + m0) * n + n0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (m0 + acc_row(h) >= m) continue;
#pragma unroll
    for (int nn = 0; nn < 8; ++nn)
      *reinterpret_cast<float2*>(out + static_cast<long>(acc_row(h)) * n + 8 * nn +
                                 2 * lane_t()) =
          make_float2(acc[0][nn][2 * h], acc[0][nn][2 * h + 1]);
  }
}

// Launches norm_vjp_f32_kernel and the reduction of its partials into dns
// (images, d) f32; dns_part holds images * tiles(tokens) * d floats.
inline cudaError_t launch_norm_vjp(const Mat& dr, const float* w, const float* x,
                                   const float* nscale, const float* res, const float* r,
                                   const float* dot_part, int groups, float* dx,
                                   float* dns_part, float* dns, int images, int tokens, int d,
                                   int k_dim, cudaStream_t st) {
  cudaError_t err = allow_smem(norm_vjp_f32_kernel, RING_BYTES<1>);
  if (err != cudaSuccess) return err;
  const int n_tiles = tiles(tokens);
  norm_vjp_f32_kernel<<<dim3(images * n_tiles, d / 64), THREADS, RING_BYTES<1>, st>>>(
      dr, w, x, nscale, res, r, dot_part, groups, dx, dns_part,
      static_cast<long>(images) * tokens, tokens, d, k_dim);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return gemm::launch_reduce(dns_part, dns, images, n_tiles, d, st);
}

// Launches the dW partials of A^T B over chunks of chunk_rows rows and
// their reduction into dw (m, n) f32; part holds ceil(rows / chunk_rows) *
// m * n floats.
inline cudaError_t launch_atb(const Mat& a, const Mat& b, float* part, float* dw, long rows,
                              int m, int n, long chunk_rows, cudaStream_t st) {
  cudaError_t err = allow_smem(atb_f32_kernel, RING_BYTES<1>);
  if (err != cudaSuccess) return err;
  const int chunks = static_cast<int>((rows + chunk_rows - 1) / chunk_rows);
  atb_f32_kernel<<<dim3((m + ROWS - 1) / ROWS, n / 64, chunks), THREADS, RING_BYTES<1>, st>>>(
      a, b, part, rows, m, n, chunk_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return gemm::launch_reduce(part, dw, 1, chunks, static_cast<long>(m) * n, st);
}

}  // namespace tg
}  // namespace kdt
