// Per-head 2-D neighborhood attention on (b, h, w, heads, e) maps: the
// forward with its logsumexp (K11), its backward (K12), and the packed
// forward with the out-projection and residual epilogue (K15).
//
// Replaces: k_diffusion_tpu/ops/pallas/na2d.py:_na_fwd_kernel (the forward
// of na2d), :_na_dq_kernel and :_na_dkv_kernel (its backward, _na_bwd), and
// :_na_packed_proj_kernel (the forward of na2d_packed_proj).
//
// K11 at head dims 32 and 64 is na_fwd.cuh's wgmma forward, which K2 runs
// at 64 on packed maps: a block per (8 x 8 query tile, head, image), the
// key halo streamed as 64-row tiles of K and V, the logits, online softmax
// and output in registers, q and k read through their strides and v
// through its own (v is a strided third of the qkv projection where the
// model calls it). At head dim 128 it is na2d_fwd_kernel<128> of na2d.cuh:
// the 14 x 14 key/value halo in shared memory, wmma logits over the 112
// keys a warp's queries can see, f32 softmax with the running max
// subtracted (the Pallas body does not subtract it and leans on the
// cosine-sim bound of the logits). The JAX dispatcher moves heads in
// front for the TPU; the port reads the maps in place. What bounds it on
// the H100, the flagship's unfused training forward at batch 32 (k = 7, e
// = 64): 4 * 49 * 64 FLOP per query and head, 3.3 GFLOP at level 0 (3.3
// us at 989 TFLOP/s), against q, k, v, out and lse, 4 * 33.5 + 1 MB (40
// us at 3.35 TB/s): bound by memory.
//
// K12, two kernels launched together, no per-tile partials, no atomics (a
// rerun gives bit-equal gradients). At head dims 32 and 64 it is
// na_bwd.cuh's wgmma backward, which K7 runs at 64 on packed maps: a dq
// kernel per 8 x 8 query tile and its key halo, a dk/dv kernel per 8 x 8
// key tile and the slab of queries whose windows reach it, each streaming
// 64-row tiles through attn_bwd.cuh's 3-stage cp.async ring with the
// logits, p, dP and ds in wgmma's registers; q, k and v each read through
// its own strides (the bodies' OWN_V), and delta = rowsum(out * dout)
// formed by the dq kernel from the out and dout tiles it holds. It
// replaces a wmma design (one block an SM: 137.7 KB for the dq kernel's q,
// dout, 208-row K and V halo and f32 strips, 110.5 KB for the dk/dv
// kernel's; p and ds formed by scalar loops over shared-memory strips; the
// dq product over all 112 halo keys a warp's rows can see; every copy
// finished before any product; delta a float32 reduction in PyTorch).
// At head dim 128 that wmma design stays, as na2d_dq_kernel and
// na2d_dkv_kernel below, with delta from the caller: wgmma.cuh's tiles and
// swizzles take 32 and 64 only, and no shipped config has an NA level of
// head dim 128.
// - na2d_dq_kernel: a block per query tile, as the forward: recomputes the
//   logits and dP = dout v^T over the warp's 112 halo keys, p = exp(s -
//   lse) masked to each window, ds = p (dP - delta), dq = ds k.
// - na2d_dkv_kernel: a block per 8 x 8 KEY tile. The queries whose
//   clamped windows can reach the tile form a slab of at most 14 x 14
//   (TQ + ks - 1 rows and columns, fewer at the edges, where the clamped
//   windows pile up), as _na_dkv_kernel gathers its row slab. q, dout, lse
//   and delta of the slab go to shared memory; a warp owns 16 keys and
//   streams the slab in chunks of 64 queries: p^T and ds^T for its keys,
//   dv += p^T dout, dk += ds^T q, in registers.
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
// on attn_tf32.cuh's TF32 attention, the ranks' f32 outputs read as
// mma.sync A fragments over distributed shared memory.
#include "na2d.cuh"
#include "na_bwd.cuh"
#include "na_fwd.cuh"
#include "na_proj.cuh"
#include "na_proj_tf32.cuh"
#include "na_tf32.cuh"

namespace kdt {
namespace {

// Converts p (or ds) rows of a warp's float strip to bf16 in place after
// computing them: row m's values for keys [0, n) at stride 2 lds in bf16.
template <class F>
__device__ __forceinline__ void strip_map_to_bf16(float* s, int lds, int n, const F& f) {
  const int lane = threadIdx.x & 31;
  for (int m = 0; m < STRIP; ++m) {
    bf16* row = reinterpret_cast<bf16*>(s) + 2 * m * lds;
    for (int j0 = 0; j0 < n; j0 += 64) {
      const int j1 = j0 + lane, j2 = j0 + lane + 32;
      const float p1 = j1 < n ? f(m, j1) : 0.f, p2 = j2 < n ? f(m, j2) : 0.f;
      __syncwarp();
      if (j1 < n) row[j1] = to_bf(p1);
      if (j2 < n) row[j2] = to_bf(p2);
      __syncwarp();
    }
  }
}

// Head dim of the wmma backward.
constexpr int BE = 128;

__global__ void __launch_bounds__(THREADS)
na2d_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, MapStrides sq, MapStrides sk, MapStrides sv,
               const bf16* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, bf16* __restrict__ dq, int h, int w,
               int n_heads, int ks, float scale) {
  constexpr int E = BE, LDK = NaDims<E>::LDK, LDS = NaDims<E>::LDS;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* s_q = reinterpret_cast<bf16*>(smem);
  bf16* s_do = s_q + TQ * TQ * LDK;
  bf16* s_k = s_do + TQ * TQ * LDK;
  bf16* s_v = s_k + NKEYS_ALLOC * LDK;
  float* s_s = reinterpret_cast<float*>(s_v + NKEYS_ALLOC * LDK);
  float* s_dp = s_s + WARPS * STRIP * LDS;
  __shared__ float s_lse[TQ * TQ], s_delta[TQ * TQ];

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int head = blockIdx.y, img = blockIdx.z;
  const TileGeometry t(blockIdx.x, h, w, ks);
  const long c = static_cast<long>(n_heads) * E;
  const MapStrides packed{static_cast<long>(h) * w * c, w * c, c};
  const long stat0 = (static_cast<long>(img) * n_heads + head) * h * w;

  load_tile_and_halo<E>(s_q, s_k, s_v, q, k, v, sq, sk, sv, img, head, t, h, w);
  constexpr int V = E / 8;
  for (int i = threadIdx.x; i < TQ * TQ * V; i += blockDim.x) {
    const int qi = i / V, cv = (i % V) * 8;
    *reinterpret_cast<uint4*>(s_do + qi * LDK + cv) = *reinterpret_cast<const uint4*>(
        dout + packed.at(img, t.y0 + qi / TQ, t.x0 + qi % TQ, head, E) + cv);
  }
  if (threadIdx.x < TQ * TQ) {
    const int qi = threadIdx.x;
    const long at = stat0 + (t.y0 + qi / TQ) * static_cast<long>(w) + t.x0 + qi % TQ;
    s_lse[qi] = lse[at];
    s_delta[qi] = delta[at];
  }
  __syncthreads();

  const int qy0 = t.y0 + 2 * warp;
  const int kr = clampi(qy0 - t.r, 0, h - ks) - t.hr0;
  const bf16* keys_k = s_k + kr * HALO * LDK;
  float* strip = s_s + warp * STRIP * LDS;
  float* dp_strip = s_dp + warp * STRIP * LDS;
  window_products<E>(s_q + warp * STRIP * LDK, keys_k, strip);
  window_products<E>(s_do + warp * STRIP * LDK, s_v + kr * HALO * LDK, dp_strip);
  const WindowMask mask{qy0, t.x0, t.hr0 + kr, t.hc0, h, w, ks, t.r};
  const float* lse_w = s_lse + warp * STRIP;
  const float* delta_w = s_delta + warp * STRIP;
  // ds = p (dP - delta), p = exp(s - lse) inside the window, in bf16 in place
  strip_map_to_bf16(strip, LDS, WKEYS, [&](int m, int j) {
    if (!mask(m, j)) return 0.f;
    const float p = __expf(strip[m * LDS + j] * scale - lse_w[m]);
    return p * (dp_strip[m * LDS + j] - delta_w[m]);
  });

  FragC acc[E / 16];
  zero(acc);
  mma_strip(reinterpret_cast<const bf16*>(strip), 2 * LDS, keys_k, LDK, WKEYS, acc);
#pragma unroll
  for (int j = 0; j < E / 16; ++j)
    for (int i = 0; i < acc[j].num_elements; ++i) acc[j].x[i] *= scale;
  store_strip(dp_strip, LDS, acc);
  for (int m = 0; m < STRIP; ++m) {
    const long dst = packed.at(img, qy0 + m / TQ, t.x0 + m % TQ, head, E);
    for (int cc = 2 * lane; cc < E; cc += 64)
      *reinterpret_cast<__nv_bfloat162*>(dq + dst + cc) =
          __floats2bfloat162_rn(dp_strip[m * LDS + cc], dp_strip[m * LDS + cc + 1]);
  }
}

constexpr int CHUNK = 64;  // queries of the slab a warp takes at a time

struct DkvDims {
  static constexpr int LDK = NaDims<BE>::LDK;
  static constexpr int LDC = (BE > CHUNK ? BE : CHUNK) + 4;  // float strip stride
};

__global__ void __launch_bounds__(THREADS)
na2d_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, MapStrides sq, MapStrides sk, MapStrides sv,
                const bf16* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
                int h, int w, int n_heads, int ks, float scale) {
  constexpr int E = BE, LDK = DkvDims::LDK, LDC = DkvDims::LDC;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* s_k = reinterpret_cast<bf16*>(smem);
  bf16* s_v = s_k + TQ * TQ * LDK;
  bf16* s_q = s_v + TQ * TQ * LDK;        // the query slab, row-major
  bf16* s_do = s_q + NKEYS_ALLOC * LDK;
  float* s_s = reinterpret_cast<float*>(s_do + NKEYS_ALLOC * LDK);
  float* s_dp = s_s + WARPS * STRIP * LDC;
  __shared__ float s_lse[NKEYS_ALLOC], s_delta[NKEYS_ALLOC];

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int head = blockIdx.y, img = blockIdx.z;
  const int tiles_w = w / TQ;
  const int ky0 = (blockIdx.x / tiles_w) * TQ, kx0 = (blockIdx.x % tiles_w) * TQ;
  const Reach rows(ky0, h, ks), cols(kx0, w, ks);
  const int ncols = cols.hi - cols.lo + 1;
  const int nq = (rows.hi - rows.lo + 1) * ncols;  // <= NKEYS
  const int r = (ks - 1) / 2;
  const long c = static_cast<long>(n_heads) * E;
  const MapStrides packed{static_cast<long>(h) * w * c, w * c, c};
  const long stat0 = (static_cast<long>(img) * n_heads + head) * h * w;

  constexpr int V = E / 8;
  for (int i = threadIdx.x; i < TQ * TQ * V; i += blockDim.x) {
    const int kj = i / V, cv = (i % V) * 8;
    const int y = ky0 + kj / TQ, xx = kx0 + kj % TQ;
    *reinterpret_cast<uint4*>(s_k + kj * LDK + cv) =
        *reinterpret_cast<const uint4*>(k + sk.at(img, y, xx, head, E) + cv);
    *reinterpret_cast<uint4*>(s_v + kj * LDK + cv) =
        *reinterpret_cast<const uint4*>(v + sv.at(img, y, xx, head, E) + cv);
  }
  for (int i = threadIdx.x; i < NKEYS_ALLOC * V; i += blockDim.x) {
    const int qi = i / V, cv = (i % V) * 8;
    uint4 qv = make_uint4(0u, 0u, 0u, 0u), dv4 = qv;
    if (qi < nq) {
      const int y = rows.lo + qi / ncols, xx = cols.lo + qi % ncols;
      qv = *reinterpret_cast<const uint4*>(q + sq.at(img, y, xx, head, E) + cv);
      dv4 = *reinterpret_cast<const uint4*>(dout + packed.at(img, y, xx, head, E) + cv);
    }
    *reinterpret_cast<uint4*>(s_q + qi * LDK + cv) = qv;
    *reinterpret_cast<uint4*>(s_do + qi * LDK + cv) = dv4;
  }
  for (int qi = threadIdx.x; qi < NKEYS_ALLOC; qi += blockDim.x) {
    float l = 0.f, d = 0.f;
    if (qi < nq) {
      const long at = stat0 + (rows.lo + qi / ncols) * static_cast<long>(w) + cols.lo +
                      qi % ncols;
      l = lse[at];
      d = delta[at];
    }
    s_lse[qi] = l;
    s_delta[qi] = d;
  }
  __syncthreads();

  // the warp's 16 keys: tile rows 2 warp and 2 warp + 1
  const bf16* ka = s_k + warp * STRIP * LDK;
  const bf16* va = s_v + warp * STRIP * LDK;
  float* pt = s_s + warp * STRIP * LDC;
  float* dst = s_dp + warp * STRIP * LDC;
  FragC acc_dk[E / 16], acc_dv[E / 16];
  zero(acc_dk);
  zero(acc_dv);
  for (int q0 = 0; q0 < nq; q0 += CHUNK) {
    // the chunk's queries, a multiple of 16 that stays inside the slab's
    // NKEYS_ALLOC rows (the rows past nq are zeros)
    const int cw = min(CHUNK, (nq - q0 + 15) / 16 * 16);
    {
      FragC acc_s[CHUNK / 16], acc_dp[CHUNK / 16];
      zero(acc_s);
      zero(acc_dp);
      for (int k0 = 0; k0 < E; k0 += 16) {
        FragA fk, fv;
        wmma::load_matrix_sync(fk, ka + k0, LDK);
        wmma::load_matrix_sync(fv, va + k0, LDK);
#pragma unroll
        for (int j = 0; j < CHUNK / 16; ++j) {
          if (16 * j >= cw) break;
          FragBt fb;
          wmma::load_matrix_sync(fb, s_q + (q0 + 16 * j) * LDK + k0, LDK);
          wmma::mma_sync(acc_s[j], fk, fb, acc_s[j]);
          wmma::load_matrix_sync(fb, s_do + (q0 + 16 * j) * LDK + k0, LDK);
          wmma::mma_sync(acc_dp[j], fv, fb, acc_dp[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < CHUNK / 16; ++j) {
        if (16 * j >= cw) break;
        wmma::store_matrix_sync(pt + 16 * j, acc_s[j], LDC, wmma::mem_row_major);
        wmma::store_matrix_sync(dst + 16 * j, acc_dp[j], LDC, wmma::mem_row_major);
      }
      __syncwarp();
    }
    // rows: the warp's keys; columns: the chunk's queries
    for (int i = lane; i < STRIP * cw; i += 32) {
      const int m = i / cw, j = i % cw, qi = q0 + j;
      const int ky = ky0 + 2 * warp + m / TQ, kx = kx0 + m % TQ;
      const int qy = rows.lo + qi / ncols, qx = cols.lo + qi % ncols;
      const int wy = clampi(qy - r, 0, h - ks), wx = clampi(qx - r, 0, w - ks);
      const bool in = qi < nq && static_cast<unsigned>(ky - wy) < static_cast<unsigned>(ks) &&
                      static_cast<unsigned>(kx - wx) < static_cast<unsigned>(ks);
      const float p = in ? __expf(pt[m * LDC + j] * scale - s_lse[qi]) : 0.f;
      pt[m * LDC + j] = p;
      dst[m * LDC + j] = p * (dst[m * LDC + j] - s_delta[qi]);
    }
    __syncwarp();
    strip_to_bf16(pt, LDC, cw);
    strip_to_bf16(dst, LDC, cw);
    mma_strip(reinterpret_cast<const bf16*>(pt), 2 * LDC, s_do + q0 * LDK, LDK, cw, acc_dv);
    mma_strip(reinterpret_cast<const bf16*>(dst), 2 * LDC, s_q + q0 * LDK, LDK, cw, acc_dk);
    __syncwarp();  // every lane is done reading p and ds before the next chunk
  }
#pragma unroll
  for (int j = 0; j < E / 16; ++j)
    for (int i = 0; i < acc_dk[j].num_elements; ++i) acc_dk[j].x[i] *= scale;
  store_strip(pt, LDC, acc_dk);
  store_strip(dst, LDC, acc_dv);
  for (int m = 0; m < STRIP; ++m) {
    const long at = packed.at(img, ky0 + 2 * warp + m / TQ, kx0 + m % TQ, head, E);
    for (int cc = 2 * lane; cc < E; cc += 64) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at + cc) =
          __floats2bfloat162_rn(pt[m * LDC + cc], pt[m * LDC + cc + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + cc) =
          __floats2bfloat162_rn(dst[m * LDC + cc], dst[m * LDC + cc + 1]);
    }
  }
}

}  // namespace
}  // namespace kdt

using namespace kdt;

namespace {

MapStrides strides(const long* s) { return MapStrides{s[0], s[1], s[2]}; }

constexpr size_t DQ_SMEM = (2 * TQ * TQ + 2 * NKEYS_ALLOC) * NaDims<BE>::LDK * sizeof(bf16) +
                           2 * WARPS * STRIP * NaDims<BE>::LDS * sizeof(float);
constexpr size_t DKV_SMEM = (2 * TQ * TQ + 2 * NKEYS_ALLOC) * DkvDims::LDK * sizeof(bf16) +
                            2 * WARPS * STRIP * DkvDims::LDC * sizeof(float);

// K11 at head dims 32 and 64: na_fwd.cuh's wgmma forward, v through its own
// strides; at 128, na2d.cuh's wmma forward (wgmma.cuh's tiles take 32 and
// 64).
template <int E>
int launch_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int b, int h,
               int w, int n_heads, int ks, float scale, const long* st, cudaStream_t stream) {
  if constexpr (E == 128) {
    const cudaError_t attr = allow_smem(na2d_fwd_kernel<E>, FWD_SMEM<E>);
    const dim3 grid((h / TQ) * (w / TQ), n_heads, b);
    na2d_fwd_kernel<E><<<grid, THREADS, FWD_SMEM<E>, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        strides(st), strides(st + 3), strides(st + 6), static_cast<bf16*>(out),
        static_cast<float*>(lse), h, w, n_heads, ks, scale);
    return launch_status(attr);
  } else {
    const long c = static_cast<long>(n_heads) * E;
    const attn_fwd::Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                           static_cast<const bf16*>(v), static_cast<bf16*>(out),
                           static_cast<float*>(lse), strides(st), strides(st + 3),
                           strides(st + 6), MapStrides{h * w * c, w * c, c}, n_heads, scale};
    return na_fwd::launch<E, true>(a, b, h, w, ks, stream);
  }
}

// K12 at head dims 32 and 64: na_bwd.cuh's wgmma backward, q, k and v
// each through its own strides, delta written by its dq kernel; at 128 the
// wmma kernels above, delta read.
template <int E>
int launch_bwd(const void* q, const void* k, const void* v, const void* out, const void* dout,
               const void* lse, void* delta, void* dq, void* dk, void* dv, int b, int h, int w,
               int n_heads, int ks, float scale, const long* st, cudaStream_t stream) {
  if constexpr (E == BE) {
    const dim3 grid((h / TQ) * (w / TQ), n_heads, b);
    cudaError_t attr = allow_smem(na2d_dq_kernel, DQ_SMEM);
    na2d_dq_kernel<<<grid, THREADS, DQ_SMEM, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        strides(st), strides(st + 3), strides(st + 6), static_cast<const bf16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<bf16*>(dq), h, w, n_heads, ks, scale);
    const int status = launch_status(attr);
    if (status != 0) return status;
    attr = allow_smem(na2d_dkv_kernel, DKV_SMEM);
    na2d_dkv_kernel<<<grid, THREADS, DKV_SMEM, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        strides(st), strides(st + 3), strides(st + 6), static_cast<const bf16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), h, w, n_heads, ks, scale);
    return launch_status(attr);
  } else {
    const long c = static_cast<long>(n_heads) * E;
    attn_bwd::Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                     static_cast<const bf16*>(v), static_cast<const bf16*>(out),
                     static_cast<const bf16*>(dout), static_cast<const float*>(lse),
                     static_cast<float*>(delta), static_cast<bf16*>(dq),
                     static_cast<bf16*>(dk), static_cast<bf16*>(dv), strides(st),
                     MapStrides{h * w * c, w * c, c}, n_heads, scale};
    a.sk = strides(st + 3);
    a.sv = strides(st + 6);
    return na_bwd::launch<E, true>(a, b, h, w, ks, stream);
  }
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
// heads, e) bf16 contiguous; lse from K11, (b, heads, h, w) f32. At e 32
// and 64 delta = rowsum(out * dout), (b, heads, h, w) f32, is written (the
// dq kernel forms it); at 128 it is read, formed by the caller, and out is
// not read. Writes dq, dk, dv (b, h, w, heads, e) bf16 contiguous.
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
