// Exact global softmax attention on (b, s, heads, e) q, k, v, streaming
// over key tiles: the forward with its logsumexp (K13) and the backward
// (K14), in the manner of FlashAttention-2.
//
// Replaces: k_diffusion_tpu/ops/pallas/flash.py:_fwd_kernel (the forward of
// flash_attention) and :_dq_kernel, :_dkv_kernel (its backward, _flash_bwd).
//
// What bounds it on the H100, U-Net 16x16 level at batch 64 (s = 256, 4
// heads, head dim 64): the forward does 4 s^2 64 FLOP per image and head,
// 4.3 GFLOP (4.3 us at 989 TFLOP/s), and moves q, k, v and the output,
// 4 x 8.4 MB (10 us at 3.35 TB/s): bound by memory. The backward does 2.5x
// the products and moves 2.25x the bytes (q, k, v, out, dout in; dq, dk, dv
// out, the lse and delta rows aside).
//
// Design of the forward. A block is four warps and owns 64 queries of one
// head of one image: the grid is (s / 64 tiles, heads, batch), so no
// head-masked products and no pack transposes: rows are read with the
// caller's batch and sequence strides (the U-Net's q, k, v are strided views
// of one qkv projection), and the head dim is the contiguous last axis.
// Products are wmma 16x16x16 bf16 fragments with float32 accumulation, a
// warp owning a 16-row strip. flash_fwd_kernel streams 64-key tiles of k and
// v through shared memory. Per tile a warp forms its 16 x 64 logits, updates
// each row's running max and sum (the logits are not bounded, so the max is
// subtracted), rescales its running output, which lives in shared memory
// because a wmma accumulator's row layout is opaque, and adds p v. It writes
// out / l in bf16 and lse = max + log(sum) in float32. No tile is
// double-buffered: a simple kernel first.
//
// The backward is the wgmma design of attn_bwd.cuh, which K9 shares; its dq
// kernel also computes delta = rowsum(out * dout), which the JAX package
// computes outside its kernels.
//
// The head dim E is a template parameter, 64 or 32 (the HDiT of
// configs/config_test_tiny.json): the forward's q, k, v tiles are (64, E)
// at row stride E + 8, the logit strips stay 16 x 64 (one key tile), and a
// warp's output strip is 16 x E.
#include "attn_bwd.cuh"
#include "common.cuh"

namespace kdt {
namespace {

constexpr int BN = 64;  // keys (or queries) of a streamed tile

// The (64, E) tile of one head starting at sequence row r0, zero past s.
template <int E>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* base, Rows st, int head,
                                          int r0, int s) {
  const int valid = s - r0 < BM ? s - r0 : BM;
  load_tile<E>(dst, base + r0 * st.seq + head * E, st.seq, BM, valid);
}

template <int E>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, float* __restrict__ lse,
                 int s, int n_heads, Rows in, float scale) {
  constexpr int LDE = E + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* s_q = reinterpret_cast<bf16*>(smem);
  bf16* s_k = s_q + BM * LDE;
  bf16* s_v = s_k + BN * LDE;
  float* s_s = reinterpret_cast<float*>(s_v + BN * LDE);
  float* s_o = s_s + WARPS * STRIP * LDF;

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * BM, head = blockIdx.y;
  const long img = static_cast<long>(blockIdx.z) * in.batch;
  float* sw = s_s + warp * STRIP * LDF;
  float* ow = s_o + warp * STRIP * LDF;

  load_rows<E>(s_q, q + img, in, head, q0, s);
  for (int i = lane; i < STRIP * LDF; i += 32) ow[i] = 0.f;
  __syncthreads();
  FragA qa[E / 16];
#pragma unroll
  for (int kk = 0; kk < E / 16; ++kk)
    wmma::load_matrix_sync(qa[kk], s_q + warp * STRIP * LDE + 16 * kk, LDE);

  float m_run[STRIP], l_run[STRIP];
#pragma unroll
  for (int m = 0; m < STRIP; ++m) {
    m_run[m] = -INFINITY;
    l_run[m] = 0.f;
  }
  for (int k0 = 0; k0 < s; k0 += BN) {
    load_rows<E>(s_k, k + img, in, head, k0, s);
    load_rows<E>(s_v, v + img, in, head, k0, s);
    __syncthreads();
    {
      FragC acc[4];
      zero(acc);
#pragma unroll
      for (int kk = 0; kk < E / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          FragBt fb;
          wmma::load_matrix_sync(fb, s_k + 16 * j * LDE + 16 * kk, LDE);
          wmma::mma_sync(acc[j], qa[kk], fb, acc[j]);
        }
      store_strip(sw, LDF, acc);
    }
    // online softmax: row m's logits become bf16 p in place (stride 2 LDF)
    const bool ok1 = k0 + lane < s, ok2 = k0 + lane + 32 < s;
#pragma unroll
    for (int m = 0; m < STRIP; ++m) {
      const float v1 = ok1 ? sw[m * LDF + lane] * scale : -INFINITY;
      const float v2 = ok2 ? sw[m * LDF + lane + 32] * scale : -INFINITY;
      const float m_new = fmaxf(m_run[m], warp_max(fmaxf(v1, v2)));
      const float alpha = __expf(m_run[m] - m_new);
      const float p1 = __expf(v1 - m_new), p2 = __expf(v2 - m_new);
      l_run[m] = l_run[m] * alpha + warp_sum(p1 + p2);
      m_run[m] = m_new;
#pragma unroll
      for (int j = lane; j < E; j += 32) ow[m * LDF + j] *= alpha;
      __syncwarp();  // every lane has read the row's floats
      bf16* prow = reinterpret_cast<bf16*>(sw) + 2 * m * LDF;
      prow[lane] = to_bf(p1);
      prow[lane + 32] = to_bf(p2);
    }
    __syncwarp();
    {
      FragC acc[E / 16];
      zero(acc);
      mma_strip(reinterpret_cast<const bf16*>(sw), 2 * LDF, s_v, LDE, BN, acc);
      __syncwarp();  // every lane is done reading p
      store_strip(sw, LDF, acc);
    }
    for (int i = lane; i < STRIP * E; i += 32) {
      const int m = i / E, j = i % E;
      ow[m * LDF + j] += sw[m * LDF + j];
    }
    __syncthreads();  // every warp is done with this k and v tile
  }

  const int r0 = warp * STRIP, valid = s - q0 - r0;
  const long ldo = static_cast<long>(n_heads) * E;
#pragma unroll
  for (int m = 0; m < STRIP; ++m) {
    const float inv_l = 1.f / l_run[m];
#pragma unroll
    for (int j = lane; j < E; j += 32) ow[m * LDF + j] *= inv_l;
    if (lse != nullptr && lane == 0 && m < valid)
      lse[(static_cast<long>(blockIdx.z) * n_heads + head) * s + q0 + r0 + m] =
          m_run[m] + __logf(l_run[m]);
  }
  __syncwarp();
  write_strip<E>(ow, LDF, out + (static_cast<long>(blockIdx.z) * s + q0 + r0) * ldo + head * E,
                 ldo, nullptr, valid);
}

template <int E>
constexpr size_t FWD_SMEM =
    (BM + 2 * BN) * (E + 8) * sizeof(bf16) + 2 * WARPS * STRIP * LDF * sizeof(float);
template <int E>
int launch_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int b, int s,
               int n_heads, Rows in, float scale, cudaStream_t st) {
  const cudaError_t attr = allow_smem(flash_fwd_kernel<E>, FWD_SMEM<E>);
  const dim3 grid((s + BM - 1) / BM, n_heads, b);
  flash_fwd_kernel<E><<<grid, THREADS, FWD_SMEM<E>, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), static_cast<float*>(lse), s, n_heads, in, scale);
  return launch_status(attr);
}

}  // namespace
}  // namespace kdt

using namespace kdt;

// K13: q, k, v (b, s, heads, e) bf16, head dim e 32 or 64, with batch
// stride stride_b and sequence stride stride_s (elements; the head axis
// packed at e, the head dim contiguous). Writes out (b, s, heads, e) bf16,
// contiguous, and, when lse is not null, lse (b, heads, s) f32 (max + log
// sum of the scaled logits). Any s >= 1.
extern "C" int kdt_flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                             int b, int s, int n_heads, int e, long stride_b, long stride_s,
                             float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Rows in{stride_b, stride_s};
  switch (e) {
    case 32: return launch_fwd<32>(q, k, v, out, lse, b, s, n_heads, in, scale, st);
    case 64: return launch_fwd<64>(q, k, v, out, lse, b, s, n_heads, in, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K14: q, k, v as for K13; out (K13's) and dout (b, s, heads, e) bf16
// contiguous; lse from K13, (b, heads, s) f32. Writes delta = rowsum(out *
// dout), (b, heads, s) f32 scratch, and dq, dk, dv (b, s, heads, e) bf16,
// contiguous.
extern "C" int kdt_flash_bwd(const void* q, const void* k, const void* v, const void* out,
                             const void* dout, const void* lse, void* delta, void* dq, void* dk,
                             void* dv, int b, int s, int n_heads, int e, long stride_b,
                             long stride_s, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Rows in{stride_b, stride_s};
  switch (e) {
    case 32:
      return attn_bwd::launch<32>(q, k, v, out, dout, lse, delta, dq, dk, dv, b, s, n_heads, in,
                                  scale, st);
    case 64:
      return attn_bwd::launch<64>(q, k, v, out, dout, lse, delta, dq, dk, dv, b, s, n_heads, in,
                                  scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

KDT_DEFINE_ERROR_STRING
