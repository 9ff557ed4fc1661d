// Shared device code for the port's hand-written Hopper kernels.
//
// Every kernel is compiled for sm_90a into its own shared library with a
// plain C interface (ops/kernels/_build.py) and called through ctypes. Each
// C entry point launches on the stream it is given, allocates nothing, and
// returns the CUDA error code of the launch (0 on success).
//
// The attention and GEMM kernels are built from wgmma.cuh's warpgroup
// products (the float32 ones from wgmma_tf32.cuh's TF32 wgmma, but for
// K15-f32's projection on mma.sync TF32 fragments); the bf16 mapping
// network's kernel (geglu.cu)
// takes nvcuda::wmma 16x16x16 bf16 fragments with float32 accumulation
// over strips of 16 rows. A fragment's pointer
// must be 32-byte aligned and its leading dimension a multiple of 8
// elements (bf16) or 4 (float).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cmath>

namespace kdt {

namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

// A (16 x 16) row-major; B (16 x 16) row-major, i.e. a (K, N) operand.
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

constexpr int WARPS = 4;           // warps per block
constexpr int THREADS = WARPS * 32;
constexpr int STRIP = 16;          // rows of a warp's strip
constexpr int PANEL = 64;          // columns of an output panel (= head dim)

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
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
