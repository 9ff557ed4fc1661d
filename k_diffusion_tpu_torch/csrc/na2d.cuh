// 2-D neighborhood attention, the device code its kernels share: each query
// attends to exactly ks x ks keys, its window start clamp(i - (ks - 1) / 2,
// 0, n - ks) on each axis (NATTEN's contract), ks <= 7.
//
// The wgmma kernels run attn_fwd.cuh's and attn_bwd.cuh's bodies over the
// geometry policies below (NaQueries, NaKeys): na_fwd.cuh (K2, K11 at head
// dims 32, 64 and 128) and na_bwd.cuh (K7, K12 at the same head dims); K15
// (na_proj.cuh) runs the wgmma forward's attention over NaQueries, and the
// TF32 forms (na_tf32.cuh, na_proj_tf32.cuh) the same geometry. A block
// owns an 8 x 8 tile of one head of one image; the clamped union of a
// query tile's windows is at most 14 x 14 keys (the halo), whose rows K8's
// halo partials (na2d.cu) hold.
//
// Maps are (b, h, w, heads, E) with the head axis packed at E and the head
// dim contiguous; the batch, row and column strides come from the caller
// (MapStrides), so a strided view (one third of a qkv projection) is read
// in place.
#pragma once

#include "common.cuh"
#include "wgmma.cuh"

namespace kdt {
namespace {

constexpr int TQ = 8;                  // query tile edge
constexpr int HALO = 14;               // halo edge: TQ + 7 - 1
constexpr int NKEYS_ALLOC = 208;       // halo keys, 14 x 14 rounded up to 16

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
  __device__ Pos own_box() const { return {y0, x0, true}; }
  __device__ Pos stream_box(int j) const { return {hr0 + BANDS * j, hc0, true}; }
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
  __device__ Pos own_box() const { return {ky0, kx0, true}; }
  __device__ Pos stream_box(int j) const { return {qy0 + BANDS * j, qx0, true}; }
};

}  // namespace
}  // namespace kdt
