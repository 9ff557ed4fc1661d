// Channel-packed 2-D neighborhood attention, forward: each query attends to
// exactly ks x ks keys, its window start clamp(i - (ks - 1) / 2, 0, n - ks)
// on each axis (NATTEN's contract).
//
// Forward (K2) and backward (K7, K8).
//
// Replaces: k_diffusion_tpu/ops/pallas/na2d.py:_na_packed_fwd_kernel (the
// forward of na2d_packed), :_na_packed_dqkv_kernel (its backward: dq and
// per-tile dk/dv halo partials) and :_overlap_add_kernel (the overlap-add of
// those partials into dk/dv maps).
//
// What bounds it on the H100, flagship eval shapes at batch 8 (k = 7): the
// useful work is 2 * 2 * 49 * 64 FLOP per query and head, 0.82 GFLOP at
// level 0 (64 x 64, 2 heads) and 0.41 at level 1 (32 x 32, 4 heads), while
// q, k, v and the output are 34 MB at level 0 (10 us at 3.35 TB/s) and 17 MB
// at level 1. So the floor is memory; in this design the softmax over each
// query's masked logits on the CUDA cores is the likelier limit.
//
// Design (na2d.cuh): no halo gather and no mask tables. A block owns an
// 8 x 8 query tile of one head of one image and loads the clamped union of
// its windows, at most 14 x 14 keys, for k and v into shared memory (zeros
// outside the map); a warp computes its 16 queries' logits over the 112 halo
// keys their windows can reach with wmma, masks each query to its window,
// takes the softmax with the running max subtracted and multiplies by v.
// Heads are a grid dimension: no head-masked matmuls. In training it also
// writes each query's logsumexp, max + log(sum), for the backward. K2 is
// that forward at head dim 64 on channel-packed maps; K11 (na2d_heads.cu)
// is the same forward at head dims 32, 64 and 128 on strided maps.
#include "na2d.cuh"

namespace kdt {
namespace {

constexpr int E = 64;
constexpr int LDK = NaDims<E>::LDK;
constexpr int LDS = NaDims<E>::LDS;
constexpr int LDP = NKEYS_ALLOC + 8;   // bf16 stride of a full-halo row

// K7, the backward of a query tile. What bounds it on the H100, flagship
// training shapes at batch 32 (k = 7): 8 products of 2 * 49 * 64 FLOP per
// query and head, 13 GFLOP at level 0, against q, k, v, out, dout, dq
// (6 * 33.5 MB) plus the f32 halo partials written here and read by K8
// (2 * 2 * 218 MB): bound by memory.
//
// Design (the query-centric split of the Pallas kernel, which avoids
// enumerating the clamped windows that see a key): a block owns the 8 x 8
// query tile of one head of one image and loads q, dout, the 14 x 14 k and
// v halos, the forward's logsumexp and delta = rowsum(dout * out). A warp
// recomputes its 16 queries' logits and dP = dout v^T over its 112 window
// keys (wmma, f32), forms p = exp(s - lse) masked to each window and ds =
// p (dP - delta), and writes both in bf16 into zeroed full-halo rows (208
// keys) of shared memory. Then
// - dq = ds @ k_halo (the zeros outside the window add nothing);
// - the halo partials dk = ds^T q and dv = p^T dout of the whole tile, 13
//   key blocks x 4 column blocks each, summed over the 4 warps in a fixed
//   order and written in f32 to (b, heads, tiles, 208, 64). No atomics.
__global__ void __launch_bounds__(THREADS)
na2d_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                const bf16* __restrict__ o, const bf16* __restrict__ dout,
                const float* __restrict__ lse, bf16* __restrict__ dq, float* __restrict__ dk_part,
                float* __restrict__ dv_part, int h, int w, int n_heads, int ks, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* s_q = reinterpret_cast<bf16*>(smem);
  bf16* s_do = s_q + TQ * TQ * LDK;
  bf16* s_k = s_do + TQ * TQ * LDK;
  bf16* s_v = s_k + NKEYS_ALLOC * LDK;
  bf16* s_p = s_v + NKEYS_ALLOC * LDK;
  bf16* s_ds = s_p + WARPS * STRIP * LDP;
  float* s_s = reinterpret_cast<float*>(s_ds + WARPS * STRIP * LDP);
  float* s_dp = s_s + WARPS * STRIP * LDS;
  float* s_lse = s_dp + WARPS * STRIP * LDS;
  float* s_delta = s_lse + TQ * TQ;
  using FragAt = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int tiles_w = w / TQ;
  const int head = blockIdx.y, img = blockIdx.z;
  const TileGeometry t(blockIdx.x, h, w, ks);
  const long c = static_cast<long>(n_heads) * E;
  const MapStrides packed{static_cast<long>(h) * w * c, w * c, c};
  const long lse0 = (static_cast<long>(img) * n_heads + head) * h * w;

  load_tile_and_halo<E>(s_q, s_k, s_v, q, k, v, packed, packed, packed, img, head, t, h, w);
  for (int i = threadIdx.x; i < TQ * TQ * 8; i += blockDim.x) {
    const int qi = i >> 3, cv = (i & 7) * 8;
    *reinterpret_cast<uint4*>(s_do + qi * LDK + cv) = *reinterpret_cast<const uint4*>(
        dout + packed.at(img, t.y0 + qi / TQ, t.x0 + qi % TQ, head, E) + cv);
  }
  for (int i = threadIdx.x; i < WARPS * STRIP * LDP / 4; i += blockDim.x) {
    reinterpret_cast<uint2*>(s_p)[i] = make_uint2(0u, 0u);
    reinterpret_cast<uint2*>(s_ds)[i] = make_uint2(0u, 0u);
  }
  if (threadIdx.x < TQ * TQ) {
    const int qi = threadIdx.x;
    s_lse[qi] = lse[lse0 + (t.y0 + qi / TQ) * static_cast<long>(w) + t.x0 + qi % TQ];
  }
  for (int m = 0; m < STRIP; ++m) {
    const int qi = warp * STRIP + m;
    const long src = packed.at(img, t.y0 + qi / TQ, t.x0 + qi % TQ, head, E);
    const float2 ov = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o + src + 2 * lane));
    const float2 dv = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(dout + src + 2 * lane));
    const float dsum = warp_sum(ov.x * dv.x + ov.y * dv.y);
    if (lane == 0) s_delta[qi] = dsum;
  }
  __syncthreads();

  const int qy0 = t.y0 + 2 * warp;
  const int kr = clampi(qy0 - t.r, 0, h - ks) - t.hr0;
  float* strip = s_s + warp * STRIP * LDS;
  float* dp_strip = s_dp + warp * STRIP * LDS;
  window_products<E>(s_q + warp * STRIP * LDK, s_k + kr * HALO * LDK, strip);
  window_products<E>(s_do + warp * STRIP * LDK, s_v + kr * HALO * LDK, dp_strip);
  const WindowMask mask{qy0, t.x0, t.hr0 + kr, t.hc0, h, w, ks, t.r};
  for (int m = 0; m < STRIP; ++m) {
    const float lse_m = s_lse[warp * STRIP + m], delta_m = s_delta[warp * STRIP + m];
    bf16* p_row = s_p + (warp * STRIP + m) * LDP + kr * HALO;
    bf16* ds_row = s_ds + (warp * STRIP + m) * LDP + kr * HALO;
    for (int j = lane; j < WKEYS; j += 32) {
      const float p = mask(m, j) ? __expf(strip[m * LDS + j] * scale - lse_m) : 0.f;
      p_row[j] = to_bf(p);
      ds_row[j] = to_bf(p * (dp_strip[m * LDS + j] - delta_m));
    }
  }
  __syncwarp();

  FragC acc[4];
  zero(acc);
  mma_strip(s_ds + warp * STRIP * LDP, LDP, s_k, LDK, NKEYS_ALLOC, acc);
  store_strip(strip, LDS, acc);
  for (int m = 0; m < STRIP; ++m) {
    const long dst = packed.at(img, qy0 + m / TQ, t.x0 + m % TQ, head, E);
    const int cc = 2 * lane;
    *reinterpret_cast<__nv_bfloat162*>(dq + dst + cc) = __floats2bfloat162_rn(
        strip[m * LDS + cc] * scale, strip[m * LDS + cc + 1] * scale);
  }
  __syncthreads();  // every warp's p and ds rows are written

  const int n_tiles = (h / TQ) * tiles_w;
  const long part0 =
      ((static_cast<long>(blockIdx.z) * n_heads + head) * n_tiles + blockIdx.x) * NKEYS_ALLOC * E;
  constexpr int KB = NKEYS_ALLOC / 16, CB = E / 16;
  for (int f = warp; f < 2 * KB * CB; f += WARPS) {
    const bool is_dk = f < KB * CB;
    const int kb = (f % (KB * CB)) / CB, cb = f % CB;
    const bf16* a = (is_dk ? s_ds : s_p) + 16 * kb;
    const bf16* b = (is_dk ? s_q : s_do) + 16 * cb;
    FragC sum;
    wmma::fill_fragment(sum, 0.f);
#pragma unroll
    for (int ww = 0; ww < WARPS; ++ww) {
      FragAt fa;
      FragB fb;
      wmma::load_matrix_sync(fa, a + ww * STRIP * LDP, LDP);
      wmma::load_matrix_sync(fb, b + ww * STRIP * LDK, LDK);
      wmma::mma_sync(sum, fa, fb, sum);
    }
    if (is_dk)
      for (int t = 0; t < sum.num_elements; ++t) sum.x[t] *= scale;
    wmma::store_matrix_sync((is_dk ? dk_part : dv_part) + part0 + (16 * kb) * E + 16 * cb, sum,
                            E, wmma::mem_row_major);
  }
}

// K8: overlap-adds K7's halo partials into dk and dv maps. A thread owns
// one channel of one key (4 keys per block of 256 threads) and gathers, in
// a fixed tile order, the partial of every tile whose 14 x 14 halo holds
// that key (at most 3 x 3 tiles; halo origins are clamped like K7's), so
// the sum is deterministic. Reads 2 * 218 MB of f32 partials at the
// flagship's level 0, batch 32: bound by memory.
__global__ void __launch_bounds__(256)
na2d_overlap_add_kernel(const float* __restrict__ dk_part, const float* __restrict__ dv_part,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int h, int w, int n_heads,
                        int ks) {
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
  dk[dst] = to_bf(sk);
  dv[dst] = to_bf(sv);
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
  const cudaError_t attr = allow_smem(na2d_fwd_kernel<E>, FWD_SMEM<E>);
  const dim3 grid((h / TQ) * (w / TQ), n_heads, b);
  const long c = static_cast<long>(n_heads) * E;
  const MapStrides packed{h * w * c, w * c, c};
  na2d_fwd_kernel<E><<<grid, THREADS, FWD_SMEM<E>, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      packed, packed, packed, static_cast<bf16*>(out), static_cast<float*>(lse), h, w, n_heads,
      ks, scale);
  return launch_status(attr);
}

// K7: q, k, v, out, dout (b, h, w, heads * 64) bf16; lse (b, heads, h, w)
// f32 from the forward. Writes dq (b, h, w, heads * 64) bf16 and the f32
// halo partials dk_part, dv_part (b, heads, tiles, 208, 64).
extern "C" int kdt_na2d_packed_bwd(const void* q, const void* k, const void* v, const void* out,
                                   const void* dout, const void* lse, void* dq, void* dk_part,
                                   void* dv_part, int b, int h, int w, int n_heads, int ks,
                                   float scale, void* stream) {
  const size_t smem = (2 * TQ * TQ + 2 * NKEYS_ALLOC) * LDK * sizeof(bf16) +
                      2 * WARPS * STRIP * LDP * sizeof(bf16) +
                      (2 * WARPS * STRIP * LDS + 2 * TQ * TQ) * sizeof(float);
  const cudaError_t attr = allow_smem(na2d_bwd_kernel, smem);
  const dim3 grid((h / TQ) * (w / TQ), n_heads, b);
  na2d_bwd_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<bf16*>(dq), static_cast<float*>(dk_part),
      static_cast<float*>(dv_part), h, w, n_heads, ks, scale);
  return launch_status(attr);
}

// K8: the halo partials of K7 -> dk, dv (b, h, w, heads * 64) bf16.
extern "C" int kdt_na2d_overlap_add(const void* dk_part, const void* dv_part, void* dk, void* dv,
                                    int b, int h, int w, int n_heads, int ks, void* stream) {
  const dim3 grid((h * w + 3) / 4, n_heads, b);
  na2d_overlap_add_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dk_part), static_cast<const float*>(dv_part),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), h, w, n_heads, ks);
  return launch_status(cudaSuccess);
}

KDT_DEFINE_ERROR_STRING
