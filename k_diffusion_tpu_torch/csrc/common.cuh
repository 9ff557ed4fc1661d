// Shared device code for the port's hand-written Hopper kernels.
//
// Every kernel is compiled for sm_90a into its own shared library with a
// plain C interface (ops/kernels/_build.py) and called through ctypes. Each
// C entry point launches on the stream it is given, allocates nothing, and
// returns the CUDA error code of the launch (0 on success).
//
// Blocks are four warps. A warp owns a strip of 16 rows; matrix products
// use nvcuda::wmma 16x16x16 bf16 fragments with float32 accumulation. A
// fragment's pointer must be 32-byte aligned and its leading dimension a
// multiple of 8 elements (bf16) or 4 (float): every shared-memory row
// stride below is padded by 8 bf16 or 4 floats and every tile offset is a
// multiple of 16 rows or columns, which keeps both true.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cmath>

namespace kdt {

namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

// A (16 x 16) row-major; B (16 x 16) row-major, i.e. a (K, N) operand;
// Bt (16 x 16) column-major, i.e. the transpose of a row-major (N, K) tile.
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBt = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

constexpr int WARPS = 4;           // warps per block
constexpr int THREADS = WARPS * 32;
constexpr int STRIP = 16;          // rows of a warp's strip
constexpr int PANEL = 64;          // columns of an output panel (= head dim)
constexpr int LDF = PANEL + 4;     // float row stride of a 64-column strip

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 to_bf(float v) { return __float2bfloat16(v); }
// rounds a float to the nearest bf16 and back
__device__ __forceinline__ float bf_round(float v) { return to_f(to_bf(v)); }

// exact (erf) GELU, as torch.nn.functional.gelu(approximate="none")
__device__ __forceinline__ float gelu_erf(float g) {
  return 0.5f * g * (1.0f + erff(g * 0.70710678118654752440f));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Element strides of the batch, row and column axes of a (b, h, w, heads, E)
// map; the head stride is E and the head dim is contiguous. A sequence (b,
// s, heads, E) is the map with h = s and a column stride of 0.
struct MapStrides {
  long b, y, x;
  __device__ long at(int img, int y_, int x_, int head, int e) const {
    return img * b + y_ * y + x_ * x + static_cast<long>(head) * e;
  }
};

template <int NF>
__device__ __forceinline__ void zero(FragC (&acc)[NF]) {
#pragma unroll
  for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[j], 0.f);
}

// acc[j] += A (16 x k_len, row-major, stride lda) x columns [16j, 16j + 16)
// of B (k_len x 16 NF, row-major, stride ldb). A and B may lie in shared or
// global memory.
template <int NF>
__device__ __forceinline__ void mma_strip(const bf16* a, int lda, const bf16* b, long ldb,
                                          int k_len, FragC (&acc)[NF]) {
  for (int k0 = 0; k0 < k_len; k0 += 16) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + k0, lda);
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      FragB fb;
      wmma::load_matrix_sync(fb, b + k0 * ldb + 16 * j, static_cast<unsigned>(ldb));
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
}

// Stores a warp's 16 x 16 NF accumulator strip into its float scratch strip
// (row stride ld).
template <int NF>
__device__ __forceinline__ void store_strip(float* scratch, int ld, FragC (&acc)[NF]) {
#pragma unroll
  for (int j = 0; j < NF; ++j)
    wmma::store_matrix_sync(scratch + 16 * j, acc[j], ld, wmma::mem_row_major);
  __syncwarp();
}

// Row-wise softmax of a warp's 16-row strip of logits, in place: row m of
// the float logits s (stride lds, n columns, n % 16 == 0, n <= lds) becomes
// row m of bf16 probabilities with stride 2 lds, ready as an A operand of
// mma_strip. valid(m, j) masks logit j of row m out (every row keeps at
// least one). The row's max is subtracted before the exponential. When lse
// is given, lane 0 writes row m's logsumexp, max + log(sum), to lse[m].
template <class Valid>
__device__ __forceinline__ void softmax_strip(float* s, int lds, int n, float scale,
                                              const Valid& valid, float* lse = nullptr) {
  const int lane = threadIdx.x & 31;
  for (int m = 0; m < STRIP; ++m) {
    const float* row = s + m * lds;
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32)
      if (valid(m, j)) mx = fmaxf(mx, row[j] * scale);
    mx = warp_max(mx);
    float l = 0.f;
    for (int j = lane; j < n; j += 32)
      if (valid(m, j)) l += __expf(row[j] * scale - mx);
    l = warp_sum(l);
    if (lse != nullptr && lane == 0) lse[m] = mx + __logf(l);
    const float inv_l = 1.f / l;
    bf16* prow = reinterpret_cast<bf16*>(s) + 2 * m * lds;
    // bf16 columns [j0, j0 + 64) overlay float columns [j0/2, j0/2 + 32),
    // which were read by this chunk or an earlier one: read, sync, write.
    for (int j0 = 0; j0 < n; j0 += 64) {
      const int j1 = j0 + lane, j2 = j0 + lane + 32;
      float p1 = 0.f, p2 = 0.f;
      if (j1 < n && valid(m, j1)) p1 = __expf(row[j1] * scale - mx) * inv_l;
      if (j2 < n && valid(m, j2)) p2 = __expf(row[j2] * scale - mx) * inv_l;
      __syncwarp();
      if (j1 < n) prow[j1] = to_bf(p1);
      if (j2 < n) prow[j2] = to_bf(p2);
      __syncwarp();
    }
  }
}

// Rounds a warp's 16-row float strip (stride lds, n columns) to bf16 in
// place, with stride 2 lds, the same overlay as softmax_strip.
__device__ __forceinline__ void strip_to_bf16(float* s, int lds, int n) {
  const int lane = threadIdx.x & 31;
  for (int m = 0; m < STRIP; ++m) {
    const float* row = s + m * lds;
    bf16* prow = reinterpret_cast<bf16*>(s) + 2 * m * lds;
    for (int j0 = 0; j0 < n; j0 += 64) {
      const int j1 = j0 + lane, j2 = j0 + lane + 32;
      const float p1 = j1 < n ? row[j1] : 0.f, p2 = j2 < n ? row[j2] : 0.f;
      __syncwarp();
      if (j1 < n) prow[j1] = to_bf(p1);
      if (j2 < n) prow[j2] = to_bf(p2);
      __syncwarp();
    }
  }
}

// Allows `smem` bytes of dynamic shared memory for `kernel`.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Status of the launch just made; an attribute error from before it wins.
inline int launch_status(cudaError_t before) {
  const cudaError_t after = cudaGetLastError();
  return static_cast<int>(before != cudaSuccess ? before : after);
}

}  // namespace kdt

// Each library exports the name of an error code for the Python wrapper.
#define KDT_DEFINE_ERROR_STRING                             \
  extern "C" const char* kdt_error_string(int e) {          \
    return cudaGetErrorString(static_cast<cudaError_t>(e)); \
  }
