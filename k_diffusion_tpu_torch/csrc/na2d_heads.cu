// Per-head 2-D neighborhood attention on (b, h, w, heads, e) maps: the
// forward with its logsumexp (K11), its backward (K12), and the packed
// forward with the out-projection and residual epilogue (K15).
//
// Replaces: k_diffusion_tpu/ops/pallas/na2d.py:_na_fwd_kernel (the forward
// of na2d), :_na_dq_kernel and :_na_dkv_kernel (its backward, _na_bwd), and
// :_na_packed_proj_kernel (the forward of na2d_packed_proj).
//
// K11 is na_fwd.cuh's wgmma forward, which K2 runs at 64 on packed maps:
// a block per (8 x 8 query tile, head, image), the key halo streamed as
// 64-row tiles of K and V, the logits, online softmax and output in
// registers, q and k read through their strides and v through its own (v
// is a strided third of the qkv projection where the model calls it), at
// head dims 32, 64 and 128 (wgmma.cuh's tiles; at 128 two blocks an SM).
// The JAX dispatcher moves heads in front for the TPU; the port reads the
// maps in place. What bounds it on the H100, the flagship's unfused
// training forward at batch 32 (k = 7, e = 64): 4 * 49 * 64 FLOP per query
// and head, 3.3 GFLOP at level 0 (3.3 us at 989 TFLOP/s), against q, k, v,
// out and lse, 4 * 33.5 + 1 MB (40 us at 3.35 TB/s): bound by memory.
//
// K12, two kernels launched together, no per-tile partials, no atomics (a
// rerun gives bit-equal gradients): na_bwd.cuh's wgmma backward, which K7
// runs at 64 on packed maps: a dq kernel per 8 x 8 query tile and its key
// halo, a dk/dv kernel per 8 x 8 key tile and the slab of queries whose
// windows reach it, each streaming 64-row tiles through attn_bwd.cuh's
// 3-stage cp.async ring with the logits, p, dP and ds in wgmma's
// registers; q, k and v each read through its own strides (the bodies'
// OWN_V), and delta = rowsum(out * dout) formed by the dq kernel from the
// out and dout rows it reads, at head dims 32, 64 and 128 (at 128 a dk/dv
// block of two warpgroups taking alternate query tiles). It
// replaces a wmma design (one block an SM: 137.7 KB for the dq kernel's q,
// dout, 208-row K and V halo and f32 strips, 110.5 KB for the dk/dv
// kernel's; p and ds formed by scalar loops over shared-memory strips; the
// dq product over all 112 halo keys a warp's rows can see; every copy
// finished before any product; delta a float32 reduction in PyTorch).
// Bound: 5 products of 2 * 49 * e FLOP per query and head (the logits
// recomputed, dP, dv, dk, dq: 8.2 GFLOP at the flagship's level 0, batch
// 32, 8 us) against q, k, v, out, dout, lse read and dq, dk, dv written (8
// * 33.5 MB, 80 us): memory.
//
// The float32 forms of K11 and K12 (--mixed-precision no) at head dims 32,
// 64 and 128 are na_tf32.cuh's TF32 kernels, q, k and v each through its
// own strides, which K2 and K7 run in float32 at 64 on packed maps (at 128
// a block of two warpgroups, one an SM).
//
// K15, the packed forward with the out-projection and the residual fused
// into its epilogue, is na_proj.cuh's cluster kernel: a cluster per query
// tile and image, a rank per 64 channels running attn_fwd.cuh's attention
// over NaQueries, then a wgmma product with w_out whose A operand, the
// ranks' attention outputs, comes as register fragments over distributed
// shared memory. Its float32 form is na_proj_tf32.cuh's: the same cluster
// on attn_tf32.cuh's TF32 wgmma attention, the ranks' f32 outputs read as
// mma.sync A fragments over distributed shared memory.
#include "na2d.cuh"
#include "na_bwd.cuh"
#include "na_fwd.cuh"
#include "na_proj.cuh"
#include "na_proj_tf32.cuh"
#include "na_tf32.cuh"

using namespace kdt;

namespace {

MapStrides strides(const long* s) { return MapStrides{s[0], s[1], s[2]}; }

// K11: na_fwd.cuh's wgmma forward, v through its own strides.
template <int E>
int launch_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int b, int h,
               int w, int n_heads, int ks, float scale, const long* st, cudaStream_t stream) {
  const long c = static_cast<long>(n_heads) * E;
  const attn_fwd::Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                         static_cast<const bf16*>(v), static_cast<bf16*>(out),
                         static_cast<float*>(lse), strides(st), strides(st + 3), strides(st + 6),
                         MapStrides{h * w * c, w * c, c}, n_heads, scale};
  return na_fwd::launch<E, true>(a, b, h, w, ks, stream);
}

// K12: na_bwd.cuh's wgmma backward, q, k and v each through its own
// strides, delta written by its dq kernel.
template <int E>
int launch_bwd(const void* q, const void* k, const void* v, const void* out, const void* dout,
               const void* lse, void* delta, void* dq, void* dk, void* dv, int b, int h, int w,
               int n_heads, int ks, float scale, const long* st, cudaStream_t stream) {
  const long c = static_cast<long>(n_heads) * E;
  attn_bwd::Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                   static_cast<const bf16*>(v), static_cast<const bf16*>(out),
                   static_cast<const bf16*>(dout), static_cast<const float*>(lse),
                   static_cast<float*>(delta), static_cast<bf16*>(dq), static_cast<bf16*>(dk),
                   static_cast<bf16*>(dv), strides(st), MapStrides{h * w * c, w * c, c},
                   n_heads, scale};
  a.sk = strides(st + 3);
  a.sv = strides(st + 6);
  return na_bwd::launch<E, true>(a, b, h, w, ks, stream);
}

}  // namespace

// K11: q, k, v (b, h, w, heads, e) bf16, e 32, 64 or 128, with element
// strides st[0..2] (q's batch, row, column), st[3..5] (k's), st[6..8]
// (v's); the head axis packed at e and the head dim contiguous. Writes out
// (b, h, w, heads, e) bf16 contiguous and, when lse is not null, lse (b,
// heads, h, w) f32. Needs h % 8 == w % 8 == 0 and 1 <= ks <= min(7, h, w).
extern "C" int kdt_na2d_heads(const void* q, const void* k, const void* v, void* out, void* lse,
                              int b, int h, int w, int n_heads, int e, int ks, float scale,
                              const long* st, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (e) {
    case 32: return launch_fwd<32>(q, k, v, out, lse, b, h, w, n_heads, ks, scale, st, s);
    case 64: return launch_fwd<64>(q, k, v, out, lse, b, h, w, n_heads, ks, scale, st, s);
    case 128: return launch_fwd<128>(q, k, v, out, lse, b, h, w, n_heads, ks, scale, st, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K12: q, k, v and their strides as for K11; out (K11's) and dout (b, h, w,
// heads, e) bf16 contiguous; lse from K11, (b, heads, h, w) f32. Writes
// delta = rowsum(out * dout), (b, heads, h, w) f32 scratch (the dq kernel
// forms it), and dq, dk, dv (b, h, w, heads, e) bf16 contiguous.
extern "C" int kdt_na2d_heads_bwd(const void* q, const void* k, const void* v, const void* out,
                                  const void* dout, const void* lse, void* delta, void* dq,
                                  void* dk, void* dv, int b, int h, int w, int n_heads, int e,
                                  int ks, float scale, const long* st, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (e) {
    case 32:
      return launch_bwd<32>(q, k, v, out, dout, lse, delta, dq, dk, dv, b, h, w, n_heads, ks,
                            scale, st, s);
    case 64:
      return launch_bwd<64>(q, k, v, out, dout, lse, delta, dq, dk, dv, b, h, w, n_heads, ks,
                            scale, st, s);
    case 128:
      return launch_bwd<128>(q, k, v, out, dout, lse, delta, dq, dk, dv, b, h, w, n_heads, ks,
                             scale, st, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K15: q, k, v, skip (b, h, w, c) bf16 contiguous with c = e * heads, e 32
// or 64, c <= 512 and c % 128 == 0; w_out (c, c) bf16. Writes out = NA(q,
// k, v) @ w_out + skip, (b, h, w, c) bf16. h, w and ks as for K11.
extern "C" int kdt_na2d_proj(const void* q, const void* k, const void* v, const void* skip,
                             const void* w_out, void* out, int b, int h, int w, int n_heads,
                             int e, int ks, float scale, void* stream) {
  const long c = static_cast<long>(n_heads) * e;
  if ((e != 32 && e != 64) || c > 512 || c % 128) return static_cast<int>(cudaErrorInvalidValue);
  const MapStrides packed{h * w * c, w * c, c};
  const attn_fwd::Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                         static_cast<const bf16*>(v), static_cast<bf16*>(out), nullptr,
                         packed, packed, packed, packed, n_heads, scale};
  const bf16* s = static_cast<const bf16*>(skip);
  const bf16* wo = static_cast<const bf16*>(w_out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ranks = static_cast<int>(c / 64);
  return e == 32 ? na_proj::launch<32>(a, s, wo, b, h, w, ks, ranks, st)
                 : na_proj::launch<64>(a, s, wo, b, h, w, ks, ranks, st);
}

namespace {

tf32::Args heads_f32(const void* q, const void* k, const void* v, void* out, void* lse, int h,
                     int w, int n_heads, int e, float scale, const long* st) {
  const long c = static_cast<long>(n_heads) * e;
  tf32::Args a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.out = static_cast<float*>(out);
  a.lse = static_cast<float*>(lse);
  a.sq = strides(st);
  a.sk = strides(st + 3);
  a.sv = strides(st + 6);
  a.io = MapStrides{h * w * c, w * c, c};
  a.n_heads = n_heads;
  a.scale = scale;
  return a;
}

}  // namespace

// K11 in float32: kdt_na2d_heads's contract with q, k, v and out f32 (e 32,
// 64 or 128); the strides multiples of 4 elements, the rows 16-byte
// aligned.
extern "C" int kdt_na2d_heads_f32(const void* q, const void* k, const void* v, void* out,
                                  void* lse, int b, int h, int w, int n_heads, int e, int ks,
                                  float scale, const long* st, void* stream) {
  const tf32::Args a = heads_f32(q, k, v, out, lse, h, w, n_heads, e, scale, st);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (e) {
    case 32: return na_tf32::launch_fwd<32>(a, b, h, w, ks, s);
    case 64: return na_tf32::launch_fwd<64>(a, b, h, w, ks, s);
    case 128: return na_tf32::launch_fwd<128>(a, b, h, w, ks, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K12 in float32: kdt_na2d_heads_bwd's contract with q, k, v, out, dout,
// dq, dk and dv f32 (e 32, 64 or 128); delta is written by the dq kernel
// at every head dim.
extern "C" int kdt_na2d_heads_bwd_f32(const void* q, const void* k, const void* v,
                                      const void* out, const void* dout, const void* lse,
                                      void* delta, void* dq, void* dk, void* dv, int b, int h,
                                      int w, int n_heads, int e, int ks, float scale,
                                      const long* st, void* stream) {
  tf32::Args a = heads_f32(q, k, v, const_cast<void*>(out), const_cast<void*>(lse), h, w,
                           n_heads, e, scale, st);
  a.dout = static_cast<const float*>(dout);
  a.delta = static_cast<float*>(delta);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (e) {
    case 32: return na_tf32::launch_bwd<32>(a, b, h, w, ks, s);
    case 64: return na_tf32::launch_bwd<64>(a, b, h, w, ks, s);
    case 128: return na_tf32::launch_bwd<128>(a, b, h, w, ks, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K15 in float32: kdt_na2d_proj's contract with q, k, v, skip, w_out and
// out f32.
extern "C" int kdt_na2d_proj_f32(const void* q, const void* k, const void* v, const void* skip,
                                 const void* w_out, void* out, int b, int h, int w, int n_heads,
                                 int e, int ks, float scale, void* stream) {
  const long c = static_cast<long>(n_heads) * e;
  if ((e != 32 && e != 64) || c > 512 || c % 128) return static_cast<int>(cudaErrorInvalidValue);
  const MapStrides packed{h * w * c, w * c, c};
  tf32::Args a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.out = static_cast<float*>(out);
  a.sq = a.sk = a.sv = a.io = packed;
  a.n_heads = n_heads;
  a.scale = scale;
  const float* s = static_cast<const float*>(skip);
  const float* wo = static_cast<const float*>(w_out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ranks = static_cast<int>(c / 64);
  return e == 32 ? na_proj_tf32::launch<32>(a, s, wo, b, h, w, ks, ranks, st)
                 : na_proj_tf32::launch<64>(a, s, wo, b, h, w, ks, ranks, st);
}

KDT_DEFINE_ERROR_STRING
