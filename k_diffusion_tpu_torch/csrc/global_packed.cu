// Exact global softmax attention on channel-packed (b, s, heads * 64) maps:
// forward (K3) and backward (K9).
//
// Replaces: k_diffusion_tpu/ops/pallas/global_packed.py:_fwd_kernel (the
// forward of packed_global_attention) and :_bwd_kernel (its backward).
//
// What bounds it on the H100, flagship eval shape at batch 8 (s = 256 mid
// level tokens, 8 heads): 4 * s^2 * 64 FLOP per image and head, 1.1 GFLOP
// (1.1 us at 989 TFLOP/s), against 8.4 MB of q, k, v and output (2.5 us at
// 3.35 TB/s). So it is bound by memory and, at 256 blocks (less than one
// wave), by the latency of each block's chain of 4 key tiles.
//
// A packed map is the flash kernels' strided layout with stride_b = s *
// heads * 64, stride_s = heads * 64 and the head at column head * 64, so
// K3 runs the wgmma forward of attn_fwd.cuh and K9 the wgmma backward of
// attn_bwd.cuh, which K13 and K14 share: a block owns 64 rows of one head
// of one image (no head-masked products), streams 64-row tiles through a
// 3-stage cp.async ring, and keeps its logits, its softmax statistics and
// its output in registers. Both take any s >= 1; the wrapper routes to them
// only the global levels the JAX model sends to this Pallas kernel (s a
// multiple of 16 up to 512).
//
// Their float32 forms (--mixed-precision no) run attn_tf32.cuh's TF32
// wgmma forward and attn_tf32_bwd.cuh's two-kernel backward, which K13 and
// K14 share in float32, on the same strided layout: no kernel body of
// their own, as in bf16.
#include "attn_bwd.cuh"
#include "attn_fwd.cuh"
#include "attn_tf32.cuh"
#include "attn_tf32_bwd.cuh"

namespace kdt {
namespace {

constexpr int E = 64;

}  // namespace
}  // namespace kdt

using namespace kdt;

// K3: q, k, v, out (b, s, heads * 64) bf16; lse (b, heads, s) f32, or null
// when no backward follows.
extern "C" int kdt_global_packed(const void* q, const void* k, const void* v, void* out,
                                 void* lse, int b, int s, int n_heads, float scale,
                                 void* stream) {
  const long c = static_cast<long>(n_heads) * E;
  return attn_fwd::launch<E>(q, k, v, out, lse, b, s, n_heads, Rows{s * c, c}, scale,
                             static_cast<cudaStream_t>(stream));
}

// K9: q, k, v, out, dout (b, s, heads * 64) bf16; lse (b, heads, s) f32
// from the forward. Writes dq, dk, dv (b, s, heads * 64) bf16; delta
// (b, heads, s) f32 is scratch.
extern "C" int kdt_global_packed_bwd(const void* q, const void* k, const void* v, const void* out,
                                     const void* dout, const void* lse, void* delta, void* dq,
                                     void* dk, void* dv, int b, int s, int n_heads, float scale,
                                     void* stream) {
  const long c = static_cast<long>(n_heads) * E;
  return attn_bwd::launch<E>(q, k, v, out, dout, lse, delta, dq, dk, dv, b, s, n_heads,
                             Rows{s * c, c}, scale, static_cast<cudaStream_t>(stream));
}

// K3 in float32: kdt_global_packed's contract with q, k, v and out f32.
extern "C" int kdt_global_packed_f32(const void* q, const void* k, const void* v, void* out,
                                     void* lse, int b, int s, int n_heads, float scale,
                                     void* stream) {
  const long c = static_cast<long>(n_heads) * E;
  tf32::Args a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.out = static_cast<float*>(out);
  a.lse = static_cast<float*>(lse);
  a.n_heads = n_heads;
  a.scale = scale;
  return tf32::launch_fwd<E>(a, Rows{s * c, c}, b, s, static_cast<cudaStream_t>(stream));
}

// K9 in float32: kdt_global_packed_bwd's contract with q, k, v, out, dout,
// dq, dk, dv f32.
extern "C" int kdt_global_packed_bwd_f32(const void* q, const void* k, const void* v,
                                         const void* out, const void* dout, const void* lse,
                                         void* delta, void* dq, void* dk, void* dv, int b, int s,
                                         int n_heads, float scale, void* stream) {
  const long c = static_cast<long>(n_heads) * E;
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
  return tf32::launch_bwd<E>(a, Rows{s * c, c}, b, s, static_cast<cudaStream_t>(stream));
}

KDT_DEFINE_ERROR_STRING
