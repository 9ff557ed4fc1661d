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
// Both are wgmma designs that K3 and K9 share: the forward attn_fwd.cuh
// (Q as register A fragments, K and V tiles through a 3-stage cp.async
// ring, the online softmax and the output held in registers), the backward
// attn_bwd.cuh (its dq kernel also computes delta = rowsum(out * dout),
// which the JAX package computes outside its kernels). Rows are read with
// the caller's batch and sequence strides (the U-Net's q, k, v are strided
// views of one qkv projection), and the head dim is the contiguous last
// axis; a block owns 64 rows of one head of one image, so no head-masked
// products and no pack transposes.
//
// The head dim E is a template parameter, 64 or 32 (the HDiT of
// configs/config_test_tiny.json).
//
// The float32 forms of both (--mixed-precision no): the forward is
// attn_tf32.cuh's mma.sync kernel, the backward attn_tf32_bwd.cuh's TF32
// wgmma kernels; the same contract on f32 operands, products on the TF32
// tensor cores.
#include "attn_bwd.cuh"
#include "attn_fwd.cuh"
#include "attn_tf32.cuh"
#include "attn_tf32_bwd.cuh"

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
    case 32: return attn_fwd::launch<32>(q, k, v, out, lse, b, s, n_heads, in, scale, st);
    case 64: return attn_fwd::launch<64>(q, k, v, out, lse, b, s, n_heads, in, scale, st);
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

// K13 in float32: kdt_flash_fwd's contract with q, k, v and out f32; the
// strides multiples of 4 elements and the rows 16-byte aligned.
extern "C" int kdt_flash_fwd_f32(const void* q, const void* k, const void* v, void* out,
                                 void* lse, int b, int s, int n_heads, int e, long stride_b,
                                 long stride_s, float scale, void* stream) {
  tf32::Args a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.out = static_cast<float*>(out);
  a.lse = static_cast<float*>(lse);
  a.n_heads = n_heads;
  a.scale = scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (e) {
    case 32: return tf32::launch_fwd<32>(a, Rows{stride_b, stride_s}, b, s, st);
    case 64: return tf32::launch_fwd<64>(a, Rows{stride_b, stride_s}, b, s, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K14 in float32: kdt_flash_bwd's contract with q, k, v, out, dout, dq,
// dk, dv f32.
extern "C" int kdt_flash_bwd_f32(const void* q, const void* k, const void* v, const void* out,
                                 const void* dout, const void* lse, void* delta, void* dq,
                                 void* dk, void* dv, int b, int s, int n_heads, int e,
                                 long stride_b, long stride_s, float scale, void* stream) {
  tf32::Args a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.out = static_cast<float*>(const_cast<void*>(out));
  a.dout = static_cast<const float*>(dout);
  a.lse = static_cast<float*>(const_cast<void*>(lse));
  a.delta = static_cast<float*>(delta);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.n_heads = n_heads;
  a.scale = scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (e) {
    case 32: return tf32::launch_bwd<32>(a, Rows{stride_b, stride_s}, b, s, st);
    case 64: return tf32::launch_bwd<64>(a, Rows{stride_b, stride_s}, b, s, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

KDT_DEFINE_ERROR_STRING
