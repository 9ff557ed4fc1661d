// Shared device code of the backward kernels of the attention prologue (K6,
// fused_qkv.cu) and of the feed-forward block (K10, geglu.cu).
//
// Both backwards end the same way: a cotangent dR (rows, K) of a projection
// R = AdaRMSNorm(x, nscale) @ W with W (d, K) becomes
// - dW = xn^T dR, reduced over every row (up to 32 * 4096 at the flagship's
//   level 0), and
// - dx and d(nscale) through dxn = dR @ W^T and the RMS-norm VJP.
// On a TPU the Pallas kernels accumulate dW and dnscale by revisiting an
// output block on a sequential grid. Blocks here run in no order, so every
// reduction over rows is written as per-block float32 partials and summed
// by reduce_kernel in a fixed order: a rerun gives bit-equal gradients.
#pragma once

#include "common.cuh"

namespace kdt {
namespace {

// Rows of one image in BM-row tiles: block x of the grid is tile `tile` of
// image `img`, so a tile never spans two images and the per-image partials
// of d(nscale) need no segmenting.
struct RowTile {
  long row0;
  int valid, img;
};

__device__ __forceinline__ RowTile row_tile(int tokens) {
  const int tiles = (tokens + BM - 1) / BM;
  const int img = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int valid = tokens - tile * BM < BM ? tokens - tile * BM : BM;
  return {static_cast<long>(img) * tokens + static_cast<long>(tile) * BM, valid, img};
}

// acc[j] += A (16 x k_len) x columns [16j, 16j + 16) of B (k_len x 64),
// where B is given transposed: B(k, n) = bt[n * ldb + k], i.e. bt is a
// row-major (64, k_len) tile of the matrix whose transpose is multiplied.
template <int NF>
__device__ __forceinline__ void mma_strip_bt(const bf16* a, int lda, const bf16* bt, int ldb,
                                             int k_len, FragC (&acc)[NF]) {
  for (int k0 = 0; k0 < k_len; k0 += 16) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + k0, lda);
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      FragBt fb;
      wmma::load_matrix_sync(fb, bt + 16 * j * ldb + k0, static_cast<unsigned>(ldb));
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
}

// dW partials: part[chunk] (m, n) = A[rows of chunk]^T B[rows of chunk] for
// A (rows, m) and B (rows, n) bf16, f32 accumulation. Grid (m / 64, n / 64,
// chunks); a block owns one 64 x 64 output tile and walks its chunk's rows
// in 64-row steps, each warp taking 16 output rows (columns of A, read as a
// column-major wmma A operand straight from the staged row-major tile).
__global__ void __launch_bounds__(THREADS)
atb_partial_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                   float* __restrict__ part, long rows, int m, int n, int chunk_rows) {
  __shared__ __align__(128) bf16 s_a[BM * LDT];
  __shared__ __align__(128) bf16 s_b[BM * LDT];
  using FragAt = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
  const int warp = threadIdx.x / 32;
  const int i0 = blockIdx.x * PANEL, j0 = blockIdx.y * PANEL;
  const long r_begin = static_cast<long>(blockIdx.z) * chunk_rows;
  const long r_end = r_begin + chunk_rows < rows ? r_begin + chunk_rows : rows;
  FragC acc[4];
  zero(acc);
  for (long r0 = r_begin; r0 < r_end; r0 += BM) {
    const int valid = static_cast<int>(r_end - r0 < BM ? r_end - r0 : BM);
    load_tile(s_a, a + r0 * m + i0, m, BM, valid);
    load_tile(s_b, b + r0 * n + j0, n, BM, valid);
    __syncthreads();
#pragma unroll
    for (int k0 = 0; k0 < BM; k0 += 16) {
      FragAt fa;
      wmma::load_matrix_sync(fa, s_a + k0 * LDT + warp * STRIP, LDT);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        FragB fb;
        wmma::load_matrix_sync(fb, s_b + k0 * LDT + 16 * j, LDT);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
    __syncthreads();
  }
  float* out = part + (static_cast<long>(blockIdx.z) * m + i0 + warp * STRIP) * n + j0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(out + 16 * j, acc[j], static_cast<unsigned>(n), wmma::mem_row_major);
}

// out (outer, m) = sum over c < n of in (outer, n, m), c ascending.
__global__ void reduce_kernel(const float* __restrict__ in, float* __restrict__ out, int outer,
                              int n, long m) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= outer * m) return;
  const long o = i / m, col = i % m;
  const float* src = in + o * n * m + col;
  float s = 0.f;
  for (int c = 0; c < n; ++c) s += src[c * m];
  out[i] = s;
}

// The RMS-norm VJP of a BM-row tile: dxn = dR @ W^T (dR (rows, K), W (d, K)
// bf16, f32 accumulation, kept in shared memory for the tile's full width
// d), then per row with r = 1 / rms(x), g1 = dxn * nscale:
//   dx = r g1 - x (r^3 / d) sum(g1 x)  (+ res, the block's own residual)
// and the tile's d(nscale) partial sum over its rows of dxn * x * r, written
// to dns_part (images, tiles, d). Grid: images * tiles. d <= 512.
__global__ void __launch_bounds__(THREADS)
norm_bwd_kernel(const bf16* __restrict__ dr, const bf16* __restrict__ w,
                const bf16* __restrict__ x, const bf16* __restrict__ nscale,
                const bf16* __restrict__ res, bf16* __restrict__ dx,
                float* __restrict__ dns_part, int tokens, int d, int k_dim, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* s_a = reinterpret_cast<bf16*>(smem);
  bf16* s_b = s_a + BM * LDT;
  float* s_dxn = reinterpret_cast<float*>(s_b + PANEL * LDT);
  const int ldd = d + 4;

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const RowTile t = row_tile(tokens);
  for (int n0 = 0; n0 < d; n0 += PANEL) {
    FragC acc[4];
    zero(acc);
    for (int k0 = 0; k0 < k_dim; k0 += PANEL) {
      load_tile(s_a, dr + t.row0 * k_dim + k0, k_dim, BM, t.valid);
      load_tile(s_b, w + static_cast<long>(n0) * k_dim + k0, k_dim, PANEL, PANEL);
      __syncthreads();
      mma_strip_bt(s_a + warp * STRIP * LDT, LDT, s_b, LDT, PANEL, acc);
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(s_dxn + warp * STRIP * ldd + n0 + 16 * j, acc[j], ldd,
                              wmma::mem_row_major);
  }
  __syncwarp();
  const bf16* ns = nscale + static_cast<long>(t.img) * d;
  for (int r = warp * STRIP; r < (warp + 1) * STRIP && r < t.valid; ++r) {
    const long row = (t.row0 + r) * d;
    float* g = s_dxn + r * ldd;
    float ss = 0.f, dot = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float xv = to_f(x[row + c]);
      ss += xv * xv;
      dot += g[c] * to_f(ns[c]) * xv;
    }
    const float inv = rsqrtf(warp_sum(ss) / d + eps);
    dot = warp_sum(dot);
    const float coef = inv * inv * inv / d * dot;
    for (int c = lane; c < d; c += 32) {
      const float xv = to_f(x[row + c]);
      float v = inv * g[c] * to_f(ns[c]) - xv * coef;
      if (res) v += to_f(res[row + c]);
      dx[row + c] = to_bf(v);
      g[c] = g[c] * xv * inv;  // this row's d(nscale) term
    }
  }
  __syncthreads();
  float* out = dns_part + static_cast<long>(blockIdx.x) * d;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float s = 0.f;
    for (int r = 0; r < t.valid; ++r) s += s_dxn[r * ldd + c];
    out[c] = s;
  }
}

inline size_t norm_bwd_smem(int d) {
  return (BM + PANEL) * LDT * sizeof(bf16) + static_cast<size_t>(BM) * (d + 4) * sizeof(float);
}

constexpr int CHUNK_ROWS = 2048;  // rows per dW partial

// Launches the dW partials of A^T B and their reduction into dw (m, n) f32;
// part holds ceil(rows / CHUNK_ROWS) * m * n floats.
inline cudaError_t launch_atb(const bf16* a, const bf16* b, float* part, float* dw, long rows,
                              int m, int n, cudaStream_t stream) {
  const int chunks = static_cast<int>((rows + CHUNK_ROWS - 1) / CHUNK_ROWS);
  atb_partial_kernel<<<dim3(m / PANEL, n / PANEL, chunks), THREADS, 0, stream>>>(
      a, b, part, rows, m, n, CHUNK_ROWS);
  const long mn = static_cast<long>(m) * n;
  reduce_kernel<<<static_cast<unsigned>((mn + 255) / 256), 256, 0, stream>>>(part, dw, 1,
                                                                          chunks, mn);
  return cudaGetLastError();
}

// Launches norm_bwd_kernel and the reduction of its partials into dns
// (images, d) f32; part holds images * tiles * d floats.
inline cudaError_t launch_norm_bwd(const bf16* dr, const bf16* w, const bf16* x,
                                   const bf16* nscale, const bf16* res, bf16* dx, float* part,
                                   float* dns, int images, int tokens, int d, int k_dim,
                                   float eps, cudaStream_t stream) {
  const size_t smem = norm_bwd_smem(d);
  const cudaError_t attr = allow_smem(norm_bwd_kernel, smem);
  if (attr != cudaSuccess) return attr;
  const int tiles = (tokens + BM - 1) / BM;
  norm_bwd_kernel<<<images * tiles, THREADS, smem, stream>>>(dr, w, x, nscale, res, dx, part,
                                                             tokens, d, k_dim, eps);
  const long n_out = static_cast<long>(images) * d;
  reduce_kernel<<<static_cast<unsigned>((n_out + 255) / 256), 256, 0, stream>>>(part, dns,
                                                                             images, tiles, d);
  return cudaGetLastError();
}

}  // namespace
}  // namespace kdt
