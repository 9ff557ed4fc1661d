// Channel-packed 2-D neighborhood attention: each query attends to
// exactly ks x ks keys, its window start clamp(i - (ks - 1) / 2, 0, n - ks)
// on each axis (NATTEN's contract).
//
// The forward (K2: na_fwd.cuh, attn_fwd.cuh's wgmma forward over the
// query tile's key halo), its backward (K7, na_bwd.cuh: dq, dk and dv
// written once by two wgmma kernels) and the overlap-add of per-tile halo
// partials (K8, below), which no model path runs: K7 needs no partials.
//
// Replaces: k_diffusion_tpu/ops/pallas/na2d.py:_na_packed_fwd_kernel (the
// forward of na2d_packed; na_fwd.cuh), :_na_packed_dqkv_kernel (its
// backward: dq and per-tile dk/dv halo partials; na_bwd.cuh) and
// :_overlap_add_kernel (the overlap-add of those partials into dk/dv maps).
//
// What bounds it on the H100, flagship eval shapes at batch 8 (k = 7): the
// useful work is 2 * 2 * 49 * 64 FLOP per query and head, 0.82 GFLOP at
// level 0 (64 x 64, 2 heads) and 0.41 at level 1 (32 x 32, 4 heads), while
// q, k, v and the output are 34 MB at level 0 (10 us at 3.35 TB/s) and 17 MB
// at level 1. So the floor is memory.
//
// The packed map is the per-head layout with the head at column head * 64,
// so K2 is K11's forward (na2d_heads.cu) at head dim 64 with one stride set
// for q, k and v: no head-masked matmuls, heads a grid dimension. In
// training it also writes each query's logsumexp, max + log(sum), for the
// backward.
//
// The float32 forms of K2 and K7 (--mixed-precision no) are na_tf32.cuh's
// TF32 kernels, which K11 and K12 run in float32 too: the same contract on
// f32 maps. K8's float32 form is the same kernel writing f32 dk and dv.
#include <type_traits>

#include "na2d.cuh"
#include "na_bwd.cuh"
#include "na_fwd.cuh"
#include "na_tf32.cuh"

namespace kdt {
namespace {

constexpr int E = 64;

// K8: overlap-adds per-tile f32 halo partials (b, heads, tiles, 208, 64),
// each 8 x 8 query tile's dk and dv over its 14 x 14 halo, into dk and dv
// maps, bf16 or (F32) f32 as the Pallas kernel writes the partials' dtype:
// the second half of the Pallas backward's design, which K7 folds into its
// dk/dv kernel. A thread owns one channel of one key (4 keys per block of
// 256 threads) and gathers, in a fixed tile order, the partial of every
// tile whose halo holds that key (at most 3 x 3 tiles; halo origins clamped
// like the window starts), so the sum is deterministic. Reads 2 * 218 MB of
// f32 partials at the flagship's level 0, batch 32: bound by memory.
template <bool F32>
__global__ void __launch_bounds__(256)
na2d_overlap_add_kernel(const float* __restrict__ dk_part, const float* __restrict__ dv_part,
                        std::conditional_t<F32, float, bf16>* __restrict__ dk,
                        std::conditional_t<F32, float, bf16>* __restrict__ dv, int h, int w,
                        int n_heads, int ks) {
  const int pixel = blockIdx.x * 4 + threadIdx.x / E, e = threadIdx.x % E;
  if (pixel >= h * w) return;
  const int y = pixel / w, xx = pixel % w, head = blockIdx.y;
  const int tiles_h = h / TQ, tiles_w = w / TQ, r = (ks - 1) / 2;
  const long part0 = (static_cast<long>(blockIdx.z) * n_heads + head) * tiles_h * tiles_w;
  float sk = 0.f, sv = 0.f;
  for (int ty = max(0, y / TQ - 3); ty <= min(tiles_h - 1, y / TQ + 3); ++ty) {
    const int ky = y - clampi(ty * TQ - r, 0, h - ks);
    if (ky < 0 || ky >= HALO) continue;
    for (int tx = max(0, xx / TQ - 3); tx <= min(tiles_w - 1, xx / TQ + 3); ++tx) {
      const int kx = xx - clampi(tx * TQ - r, 0, w - ks);
      if (kx < 0 || kx >= HALO) continue;
      const long idx = ((part0 + ty * tiles_w + tx) * NKEYS_ALLOC + ky * HALO + kx) * E + e;
      sk += dk_part[idx];
      sv += dv_part[idx];
    }
  }
  const long dst = ((static_cast<long>(blockIdx.z) * h + y) * w + xx) * n_heads * E + head * E + e;
  if constexpr (F32) {
    dk[dst] = sk;
    dv[dst] = sv;
  } else {
    dk[dst] = to_bf(sk);
    dv[dst] = to_bf(sv);
  }
}

template <bool F32>
int launch_overlap_add(const void* dk_part, const void* dv_part, void* dk, void* dv, int b,
                       int h, int w, int n_heads, int ks, void* stream) {
  using Out = std::conditional_t<F32, float, bf16>;
  const dim3 grid((h * w + 3) / 4, n_heads, b);
  na2d_overlap_add_kernel<F32><<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dk_part), static_cast<const float*>(dv_part),
      static_cast<Out*>(dk), static_cast<Out*>(dv), h, w, n_heads, ks);
  return launch_status(cudaSuccess);
}

}  // namespace
}  // namespace kdt

using namespace kdt;

// q, k, v, out (b, h, w, heads * 64) bf16; lse (b, heads, h, w) f32, or
// null when no backward follows. Needs h % 8 == w % 8 == 0 and
// 1 <= ks <= min(7, h, w).
extern "C" int kdt_na2d_packed(const void* q, const void* k, const void* v, void* out, void* lse,
                               int b, int h, int w, int n_heads, int ks, float scale,
                               void* stream) {
  const long c = static_cast<long>(n_heads) * E;
  const MapStrides packed{h * w * c, w * c, c};
  const attn_fwd::Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                         static_cast<const bf16*>(v), static_cast<bf16*>(out),
                         static_cast<float*>(lse), packed, packed, packed, packed, n_heads,
                         scale};
  return na_fwd::launch<E, false>(a, b, h, w, ks, static_cast<cudaStream_t>(stream));
}

// K7: q, k, v, out, dout (b, h, w, heads * 64) bf16; lse (b, heads, h, w)
// f32 from the forward. Writes delta = rowsum(out * dout), (b, heads, h, w)
// f32 scratch, and dq, dk, dv (b, h, w, heads * 64) bf16 (na_bwd.cuh's two
// kernels). h, w and ks as for K2.
extern "C" int kdt_na2d_packed_bwd(const void* q, const void* k, const void* v, const void* out,
                                   const void* dout, const void* lse, void* delta, void* dq,
                                   void* dk, void* dv, int b, int h, int w, int n_heads, int ks,
                                   float scale, void* stream) {
  const long c = static_cast<long>(n_heads) * E;
  const MapStrides packed{h * w * c, w * c, c};
  const attn_bwd::Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                         static_cast<const bf16*>(v), static_cast<const bf16*>(out),
                         static_cast<const bf16*>(dout), static_cast<const float*>(lse),
                         static_cast<float*>(delta), static_cast<bf16*>(dq),
                         static_cast<bf16*>(dk), static_cast<bf16*>(dv), packed, packed,
                         n_heads, scale};
  return na_bwd::launch<E, false>(a, b, h, w, ks, static_cast<cudaStream_t>(stream));
}

// K8: the halo partials dk_part, dv_part (b, heads, tiles, 208, 64) f32 ->
// dk, dv (b, h, w, heads * 64) bf16.
extern "C" int kdt_na2d_overlap_add(const void* dk_part, const void* dv_part, void* dk, void* dv,
                                    int b, int h, int w, int n_heads, int ks, void* stream) {
  return launch_overlap_add<false>(dk_part, dv_part, dk, dv, b, h, w, n_heads, ks, stream);
}

// K8 in float32: kdt_na2d_overlap_add's contract with dk, dv f32.
extern "C" int kdt_na2d_overlap_add_f32(const void* dk_part, const void* dv_part, void* dk,
                                        void* dv, int b, int h, int w, int n_heads, int ks,
                                        void* stream) {
  return launch_overlap_add<true>(dk_part, dv_part, dk, dv, b, h, w, n_heads, ks, stream);
}

namespace {

tf32::Args packed_f32(const void* q, const void* k, const void* v, void* out, void* lse, int h,
                      int w, int n_heads, float scale) {
  const long c = static_cast<long>(n_heads) * E;
  const MapStrides packed{h * w * c, w * c, c};
  tf32::Args a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.out = static_cast<float*>(out);
  a.lse = static_cast<float*>(lse);
  a.sq = a.sk = a.sv = a.io = packed;
  a.n_heads = n_heads;
  a.scale = scale;
  return a;
}

}  // namespace

// K2 in float32: kdt_na2d_packed's contract with q, k, v and out f32.
extern "C" int kdt_na2d_packed_f32(const void* q, const void* k, const void* v, void* out,
                                   void* lse, int b, int h, int w, int n_heads, int ks,
                                   float scale, void* stream) {
  return na_tf32::launch_fwd<E>(packed_f32(q, k, v, out, lse, h, w, n_heads, scale), b,
                                       h, w, ks, static_cast<cudaStream_t>(stream));
}

// K7 in float32: kdt_na2d_packed_bwd's contract with q, k, v, out, dout,
// dq, dk and dv f32.
extern "C" int kdt_na2d_packed_bwd_f32(const void* q, const void* k, const void* v,
                                       const void* out, const void* dout, const void* lse,
                                       void* delta, void* dq, void* dk, void* dv, int b, int h,
                                       int w, int n_heads, int ks, float scale, void* stream) {
  tf32::Args a = packed_f32(q, k, v, const_cast<void*>(out), const_cast<void*>(lse), h, w,
                            n_heads, scale);
  a.dout = static_cast<const float*>(dout);
  a.delta = static_cast<float*>(delta);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  return na_tf32::launch_bwd<E>(a, b, h, w, ks, static_cast<cudaStream_t>(stream));
}

KDT_DEFINE_ERROR_STRING
