// Exact global softmax attention on channel-packed (b, s, heads * 64) maps:
// forward (K3) and backward (K9).
//
// Replaces: k_diffusion_tpu/ops/pallas/global_packed.py:_fwd_kernel (the
// forward of packed_global_attention) and :_bwd_kernel (its backward).
//
// The backward is the wgmma design of attn_bwd.cuh, shared with K14: a
// packed map is K14's strided layout with stride_b = s * heads * 64 and
// stride_s = heads * 64. Below, the forward.
//
// What bounds it on the H100, flagship eval shape at batch 8 (s = 256 mid
// level tokens, 8 heads): 4 * s^2 * 64 FLOP per image and head, 1.1 GFLOP
// (1.1 us at 989 TFLOP/s), against 8.4 MB of q, k, v and output (2.5 us at
// 3.35 TB/s). So it is bound by memory and, at 256 blocks, by latency.
//
// Design: a block owns 64 queries of one head of one image; heads are a
// grid dimension, so no head-masked matmuls. Each warp computes its 16
// queries' logits against all s keys with wmma bf16 fragments (f32
// accumulate) into shared memory; the whole row fits, so the softmax is
// exact and two-pass with the max subtracted, no online rescaling. k is then
// overwritten by v in shared memory, and the bf16 probabilities, written in
// place over the logits, multiply v. Takes s <= 512. In training it also
// writes each query's logsumexp for the backward.
#include "attn_bwd.cuh"
#include "common.cuh"

namespace kdt {
namespace {

constexpr int E = 64;
constexpr int LDK = E + 8;

// Float row stride of a warp's strip: it holds the s logits, then the
// 64-column output, so it is at least 64 wide.
__host__ __device__ inline int logit_stride(int s) { return (s > PANEL ? s : PANEL) + 4; }

// Loads rows [0, n) of one head's (s, 64) slice of a packed map (row
// stride c) into shared memory (stride LDK); rows at or past `valid` are 0.
__device__ __forceinline__ void load_head_rows(bf16* dst, const bf16* src, long c, int n,
                                               int valid) {
  for (int i = threadIdx.x; i < n * 8; i += blockDim.x) {
    const int r = i >> 3, cv = (i & 7) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + r * c + cv);
    *reinterpret_cast<uint4*>(dst + r * LDK + cv) = val;
  }
}

__global__ void __launch_bounds__(THREADS)
global_packed_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     float* __restrict__ lse, int s, int n_heads, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lds = logit_stride(s);
  bf16* s_q = reinterpret_cast<bf16*>(smem);
  bf16* s_kv = s_q + BM * LDK;
  float* s_s = reinterpret_cast<float*>(s_kv + s * LDK);

  const int warp = threadIdx.x / 32;
  const int q0 = blockIdx.x * BM;
  const int valid = s - q0 < BM ? s - q0 : BM;
  const long c = static_cast<long>(n_heads) * E;
  const long img = static_cast<long>(blockIdx.z) * s * c + blockIdx.y * E;

  load_head_rows(s_q, q + img + q0 * c, c, BM, valid);
  load_head_rows(s_kv, k + img, c, s, s);
  __syncthreads();

  const bf16* a = s_q + warp * STRIP * LDK;
  float* strip = s_s + warp * STRIP * lds;
  for (int n0 = 0; n0 < s; n0 += 16) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int k0 = 0; k0 < E; k0 += 16) {
      FragA fa;
      FragBt fb;
      wmma::load_matrix_sync(fa, a + k0, LDK);
      wmma::load_matrix_sync(fb, s_kv + n0 * LDK + k0, LDK);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(strip + n0, acc, lds, wmma::mem_row_major);
  }
  __syncthreads();  // every warp is done with k
  load_head_rows(s_kv, v + img, c, s, s);
  __syncwarp();
  __shared__ float s_lse[BM];
  softmax_strip(strip, lds, s, scale, AllValid{}, s_lse + warp * STRIP);
  __syncthreads();  // v is loaded
  if (lse != nullptr && threadIdx.x < valid)
    lse[(static_cast<long>(blockIdx.z) * n_heads + blockIdx.y) * s + q0 + threadIdx.x] =
        s_lse[threadIdx.x];

  FragC o[4];
  zero(o);
  mma_strip(reinterpret_cast<const bf16*>(strip), 2 * lds, s_kv, LDK, s, o);
  __syncwarp();  // every lane is done reading the probabilities
  store_strip(strip, lds, o);
  const int r0 = warp * STRIP;
  write_strip(strip, lds, out + img + (q0 + r0) * c, c, nullptr, valid - r0);
}


}  // namespace
}  // namespace kdt

using namespace kdt;

// q, k, v, out (b, s, heads * 64) bf16; lse (b, heads, s) f32, or null when
// no backward follows. Needs s % 16 == 0 and s <= 512.
extern "C" int kdt_global_packed(const void* q, const void* k, const void* v, void* out,
                                 void* lse, int b, int s, int n_heads, float scale,
                                 void* stream) {
  const size_t smem =
      (BM + s) * LDK * sizeof(bf16) + WARPS * STRIP * logit_stride(s) * sizeof(float);
  const cudaError_t attr = allow_smem(global_packed_kernel, smem);
  const dim3 grid((s + BM - 1) / BM, n_heads, b);
  global_packed_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), static_cast<float*>(lse), s, n_heads, scale);
  return launch_status(attr);
}

// K9: q, k, v, out, dout (b, s, heads * 64) bf16; lse (b, heads, s) f32
// from the forward. Writes dq, dk, dv (b, s, heads * 64) bf16; delta
// (b, heads, s) f32 is scratch. Takes any s >= 1; the wrapper holds it to
// the forward's s % 16 == 0 and s <= 512.
extern "C" int kdt_global_packed_bwd(const void* q, const void* k, const void* v, const void* out,
                                     const void* dout, const void* lse, void* delta, void* dq,
                                     void* dk, void* dv, int b, int s, int n_heads, float scale,
                                     void* stream) {
  const long c = static_cast<long>(n_heads) * E;
  return attn_bwd::launch<E>(q, k, v, out, dout, lse, delta, dq, dk, dv, b, s, n_heads,
                             Rows{s * c, c}, scale, static_cast<cudaStream_t>(stream));
}

KDT_DEFINE_ERROR_STRING
