// 2-D neighborhood attention, the device code its kernels share: each query
// attends to exactly ks x ks keys, its window start clamp(i - (ks - 1) / 2,
// 0, n - ks) on each axis (NATTEN's contract), ks <= 7.
//
// The wgmma kernels run attn_fwd.cuh's and attn_bwd.cuh's bodies over the
// geometry policies below (NaQueries, NaKeys): na_fwd.cuh (K2, K11 at head
// dims 32 and 64) and na_bwd.cuh (K7, K12 at head dims 32 and 64).
//
// The wmma code below serves K11 and K12 at head dim 128 (wgmma.cuh's
// tiles take 32 and 64); K15 (na_proj.cuh) runs the wgmma forward's
// attention over NaQueries. A block owns an 8 x 8 query tile of one head of
// one image. The clamped union of the tile's windows is at most 14 x 14
// keys (the halo); a warp owns two query rows (16 queries), whose windows
// lie within 8 consecutive halo rows, i.e. 112 consecutive halo keys. The
// forward of a tile (na_tile_forward) computes each warp's 16 x 112 logits
// with wmma bf16 fragments (f32 accumulate), masks each query to its own
// window from the coordinates, takes the softmax with the running max
// subtracted, and multiplies the bf16 probabilities by the same 112 rows
// of v.
//
// The head dim E is a template parameter (32, 64 or 128). Maps are (b, h,
// w, heads, E) with the head axis packed at E and the head dim contiguous;
// the batch, row and column strides come from the caller (MapStrides), so a
// strided view (one third of a qkv projection) is read in place.
#pragma once

#include "common.cuh"
#include "wgmma.cuh"

namespace kdt {
namespace {

constexpr int TQ = 8;                  // query tile edge
constexpr int HALO = 14;               // halo edge: TQ + 7 - 1
constexpr int NKEYS = HALO * HALO;     // halo keys
constexpr int NKEYS_ALLOC = 208;       // rounded up to 16
constexpr int WKEYS = 8 * HALO;        // keys a warp's 2 query rows can see

// Shared-memory row strides for head dim E: bf16 rows of q, k, v, and the
// float strips that hold a warp's logits (WKEYS columns) or its output (E).
template <int E>
struct NaDims {
  static constexpr int LDK = E + 8;
  static constexpr int LDS = (E > WKEYS ? E : WKEYS) + 4;
};

// Is halo key j (of the warp's 112) in the window of the warp's query m?
struct WindowMask {
  int qy0, qx0;  // the warp's first query
  int ky0, kx0;  // map coordinates of the warp's first key
  int h, w, ks, r;
  __device__ bool operator()(int m, int j) const {
    const int qy = qy0 + (m >> 3), qx = qx0 + (m & 7);
    const int ky = ky0 + j / HALO, kx = kx0 + j % HALO;
    const int wy = clampi(qy - r, 0, h - ks), wx = clampi(qx - r, 0, w - ks);
    return static_cast<unsigned>(ky - wy) < static_cast<unsigned>(ks) &&
           static_cast<unsigned>(kx - wx) < static_cast<unsigned>(ks);
  }
};

// The tile's query (y0, x0) geometry: the halo's origin (hr0, hc0).
struct TileGeometry {
  int y0, x0, hr0, hc0, r;
  __device__ TileGeometry(int tile, int h, int w, int ks) {
    const int tiles_w = w / TQ;
    y0 = (tile / tiles_w) * TQ;
    x0 = (tile % tiles_w) * TQ;
    r = (ks - 1) / 2;
    hr0 = clampi(y0 - r, 0, h - ks);
    hc0 = clampi(x0 - r, 0, w - ks);
  }
};

// The query rows (or columns) [lo, hi] whose clamped windows reach keys
// [k0, k0 + TQ) on an axis of n positions: an interval, since the window
// start is monotone in the query, of at most TQ + ks - 1 positions.
struct Reach {
  int lo, hi;
  __device__ Reach(int k0, int n, int ks) {
    const int r = (ks - 1) / 2;
    lo = max(0, k0 - (ks - 1));
    hi = min(n - 1, k0 + TQ - 1 + ks - 1);
    while (clampi(lo - r, 0, n - ks) + ks - 1 < k0) ++lo;
    while (clampi(hi - r, 0, n - ks) > k0 + TQ - 1) --hi;
  }
};

// The geometry policies of the wgmma attention bodies (wgmma.cuh's Seq
// lists the members) for neighborhood attention: NaQueries, a query tile
// and its key halo, for the forward (na_fwd.cuh) and the dq kernel
// (na_bwd.cuh); NaKeys, a key tile and the queries reaching it, for the
// dk/dv kernel. The own rows are an 8 x 8 tile, wgmma's M = 64; a streamed
// tile is BANDS halo (slab) rows of SLOTS slots each, so that a column's
// row and column in the halo are a shift and a mask of its index.
using wg::Pos;
using wg::ROWS;

constexpr int SLOTS = 16;             // slots of a halo (slab) row
constexpr int BANDS = ROWS / SLOTS;   // halo (slab) rows of a streamed tile

// The forward's and the dq kernel's block: 8 x 8 query tile `tile`
// (row-major over the map's tiles) and the tiles of its halo. The halo is
// he = 8 + ks - 1 rows and columns from the window start of the tile's
// first query (TileGeometry); its keys stream past as tiles of 4 halo rows
// of 16 key slots (slots past he or past the map zero-filled by the copy):
// 4 tiles at ks = 7. A pair attends where the key lies in the query's
// window; no slot past the halo or the map ever does. No row can count on
// a key in every tile: at ks = 7 the window of row t of an interior tile
// spans halo rows t to t + 6, so the first tile (halo rows 0-3) holds no
// key of rows 4-7 and the last (halo rows 12-13) none of rows 0-5.
struct NaQueries {
  int y0, x0, hr0, hc0, r, he, h, w, ks, tiles, positions;
  __device__ NaQueries(int tile, int h_, int w_, int ks_) : h(h_), w(w_), ks(ks_) {
    const TileGeometry t(tile, h_, w_, ks_);
    y0 = t.y0;
    x0 = t.x0;
    hr0 = t.hr0;
    hc0 = t.hc0;
    r = t.r;
    he = TQ + ks_ - 1;
    tiles = (he + BANDS - 1) / BANDS;
    positions = h_ * w_;
  }
  __device__ Pos own(int i) const { return {y0 + i / TQ, x0 + i % TQ, true}; }
  __device__ Pos stream(int j, int i) const {
    const int hy = BANDS * j + i / SLOTS, hx = i % SLOTS;
    const int y = hr0 + hy, x = hc0 + hx;
    return {y, x, hy < he && hx < he && y < h && x < w};
  }
  __device__ long index(Pos p) const { return static_cast<long>(p.y) * w + p.x; }
  struct Info {
    int wy, wx;  // the query's window start
  };
  __device__ Info own_info(int i) const {
    return {clampi(y0 + i / TQ - r, 0, h - ks), clampi(x0 + i % TQ - r, 0, w - ks)};
  }
  // key slot col of halo tile j in the window: keys past the halo or the
  // map never are
  __device__ bool mask(int j, int col, Info q) const {
    const int ky = hr0 + BANDS * j + col / SLOTS, kx = hc0 + col % SLOTS;
    return static_cast<unsigned>(ky - q.wy) < static_cast<unsigned>(ks) &&
           static_cast<unsigned>(kx - q.wx) < static_cast<unsigned>(ks);
  }
  __device__ bool whole(int) const { return false; }
};

// The dk/dv kernel's block: 8 x 8 key tile `tile` and the tiles of the
// slab of queries that reach it.
struct NaKeys {
  int ky0, kx0, qy0, qx0, ny, nx, r, h, w, ks, tiles, positions;
  __device__ NaKeys(int tile, int h_, int w_, int ks_) : h(h_), w(w_), ks(ks_) {
    const int tiles_w = w_ / TQ;
    ky0 = tile / tiles_w * TQ;
    kx0 = tile % tiles_w * TQ;
    const Reach rows(ky0, h_, ks_), cols(kx0, w_, ks_);
    qy0 = rows.lo;
    qx0 = cols.lo;
    ny = rows.hi - rows.lo + 1;
    nx = cols.hi - cols.lo + 1;  // <= 14 < SLOTS
    r = (ks_ - 1) / 2;
    tiles = (ny + BANDS - 1) / BANDS;
    positions = h_ * w_;
  }
  __device__ Pos own(int i) const { return {ky0 + i / TQ, kx0 + i % TQ, true}; }
  __device__ Pos stream(int j, int i) const {
    const int sy = BANDS * j + i / SLOTS, sx = i % SLOTS;
    return {qy0 + sy, qx0 + sx, sy < ny && sx < nx};
  }
  __device__ long index(Pos p) const { return static_cast<long>(p.y) * w + p.x; }
  struct Info {
    int ky, kx;  // the key
  };
  __device__ Info own_info(int i) const { return {ky0 + i / TQ, kx0 + i % TQ}; }
  // the key in the window of query slot col of slab tile j; empty slots
  // hold no query
  __device__ bool mask(int j, int col, Info k) const {
    const int sy = BANDS * j + col / SLOTS, sx = col % SLOTS;
    const int wy = clampi(qy0 + sy - r, 0, h - ks), wx = clampi(qx0 + sx - r, 0, w - ks);
    return sy < ny && sx < nx && static_cast<unsigned>(k.ky - wy) < static_cast<unsigned>(ks) &&
           static_cast<unsigned>(k.kx - wx) < static_cast<unsigned>(ks);
  }
};

// Loads the tile's 64 queries of one head (rows of s_q) and the k and v
// halo (NKEYS_ALLOC rows of s_k, s_v; zeros past the map and past NKEYS)
// into shared memory in 16-byte vectors, the whole block taking part.
template <int E>
__device__ __forceinline__ void load_tile_and_halo(bf16* s_q, bf16* s_k, bf16* s_v,
                                                   const bf16* q, const bf16* k, const bf16* v,
                                                   MapStrides sq, MapStrides sk, MapStrides sv,
                                                   int img, int head, const TileGeometry& t,
                                                   int h, int w) {
  constexpr int LDK = NaDims<E>::LDK, V = E / 8;
  for (int i = threadIdx.x; i < TQ * TQ * V; i += blockDim.x) {
    const int qi = i / V, cv = (i % V) * 8;
    *reinterpret_cast<uint4*>(s_q + qi * LDK + cv) = *reinterpret_cast<const uint4*>(
        q + sq.at(img, t.y0 + qi / TQ, t.x0 + qi % TQ, head, E) + cv);
  }
  for (int i = threadIdx.x; i < NKEYS_ALLOC * V; i += blockDim.x) {
    const int kj = i / V, cv = (i % V) * 8;
    const int y = t.hr0 + kj / HALO, xx = t.hc0 + kj % HALO;
    uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
    if (kj < NKEYS && y < h && xx < w) {
      kv = *reinterpret_cast<const uint4*>(k + sk.at(img, y, xx, head, E) + cv);
      vv = *reinterpret_cast<const uint4*>(v + sv.at(img, y, xx, head, E) + cv);
    }
    *reinterpret_cast<uint4*>(s_k + kj * LDK + cv) = kv;
    *reinterpret_cast<uint4*>(s_v + kj * LDK + cv) = vv;
  }
}

// A warp's 16 x 112 products a k^T with the halo keys its queries' windows
// can reach: a its 16 rows of q (or dout), keys the first of those halo rows
// of k (or v); into its float strip (stride LDS), in f32.
template <int E>
__device__ __forceinline__ void window_products(const bf16* a, const bf16* keys, float* strip) {
  constexpr int LDK = NaDims<E>::LDK, LDS = NaDims<E>::LDS;
  FragC acc[WKEYS / 16];
  zero(acc);
  for (int k0 = 0; k0 < E; k0 += 16) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + k0, LDK);
#pragma unroll
    for (int j = 0; j < WKEYS / 16; ++j) {
      FragBt fb;
      wmma::load_matrix_sync(fb, keys + 16 * j * LDK + k0, LDK);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
  store_strip(strip, LDS, acc);
}

// The forward of the block's 64 queries of one head, from s_q and the k, v
// halo that load_tile_and_halo put in shared memory: warp w's 16 outputs,
// normalised, land in columns [0, E) of its float strip s_s + w * 16 * LDS,
// and their logsumexps (max + log sum) in s_lse[w * 16 + m].
template <int E>
__device__ __forceinline__ void na_tile_forward(const bf16* s_q, const bf16* s_k, const bf16* s_v,
                                                float* s_s, float* s_lse, const TileGeometry& t,
                                                int h, int w, int ks, float scale) {
  constexpr int LDK = NaDims<E>::LDK, LDS = NaDims<E>::LDS;
  const int warp = threadIdx.x / 32;
  // the warp's queries: rows qy0, qy0 + 1 of the tile, all 8 columns; their
  // windows start at halo row kr or kr + 1 and span at most 8 rows
  const int qy0 = t.y0 + 2 * warp;
  const int kr = clampi(qy0 - t.r, 0, h - ks) - t.hr0;
  const bf16* keys_v = s_v + kr * HALO * LDK;
  float* strip = s_s + warp * STRIP * LDS;
  window_products<E>(s_q + warp * STRIP * LDK, s_k + kr * HALO * LDK, strip);
  softmax_strip(strip, LDS, WKEYS, scale,
                WindowMask{qy0, t.x0, t.hr0 + kr, t.hc0, h, w, ks, t.r}, s_lse + warp * STRIP);
  __syncwarp();

  FragC o[E / 16];
  zero(o);
  mma_strip(reinterpret_cast<const bf16*>(strip), 2 * LDS, keys_v, LDK, WKEYS, o);
  __syncwarp();  // every lane is done reading the probabilities
  store_strip(strip, LDS, o);
}

// The forward kernel: the block's output written once in bf16 to out (b, h,
// w, heads, E), contiguous, and, when lse is not null, each query's
// logsumexp to lse (b, heads, h, w) f32 for the backward.
template <int E>
__global__ void __launch_bounds__(THREADS)
na2d_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, MapStrides sq, MapStrides sk, MapStrides sv,
                bf16* __restrict__ out, float* __restrict__ lse, int h, int w, int n_heads,
                int ks, float scale) {
  constexpr int LDK = NaDims<E>::LDK, LDS = NaDims<E>::LDS;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* s_q = reinterpret_cast<bf16*>(smem);
  bf16* s_k = s_q + TQ * TQ * LDK;
  bf16* s_v = s_k + NKEYS_ALLOC * LDK;
  float* s_s = reinterpret_cast<float*>(s_v + NKEYS_ALLOC * LDK);
  __shared__ float s_lse[WARPS * STRIP];

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int head = blockIdx.y, img = blockIdx.z;
  const TileGeometry t(blockIdx.x, h, w, ks);
  load_tile_and_halo<E>(s_q, s_k, s_v, q, k, v, sq, sk, sv, img, head, t, h, w);
  __syncthreads();
  na_tile_forward<E>(s_q, s_k, s_v, s_s, s_lse, t, h, w, ks, scale);

  const int qy0 = t.y0 + 2 * warp;
  if (lse != nullptr && lane < STRIP)
    lse[((static_cast<long>(img) * n_heads + head) * h + qy0 + lane / TQ) * w + t.x0 +
        lane % TQ] = s_lse[warp * STRIP + lane];
  const float* strip = s_s + warp * STRIP * LDS;
  const long c = static_cast<long>(n_heads) * E;
  for (int m = 0; m < STRIP; ++m) {
    const long dst = ((static_cast<long>(img) * h + qy0 + m / TQ) * w + t.x0 + m % TQ) * c +
                     head * E;
    for (int cc = 2 * lane; cc < E; cc += 64)
      *reinterpret_cast<__nv_bfloat162*>(out + dst + cc) =
          __floats2bfloat162_rn(strip[m * LDS + cc], strip[m * LDS + cc + 1]);
  }
}

// Shared memory of na2d_fwd_kernel<E>: q, the k and v halos, the strips.
template <int E>
constexpr size_t FWD_SMEM = (TQ * TQ + 2 * NKEYS_ALLOC) * NaDims<E>::LDK * sizeof(bf16) +
                            WARPS * STRIP * NaDims<E>::LDS * sizeof(float);

}  // namespace
}  // namespace kdt
