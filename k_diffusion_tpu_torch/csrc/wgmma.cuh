// The Hopper building blocks of the attention kernels, shared by the
// forward (attn_fwd.cuh: K3, K13; na_fwd.cuh: K2, K11) and the backward
// (attn_bwd.cuh: K9, K14; na_bwd.cuh: K7, K12), and of the GEMM core of the
// weight-gradient backwards (gemm.cuh: K6, K10):
// swizzled (64, E) bf16 tiles in shared memory filled by cp.async through a
// ring of stages, wgmma descriptors and products with f32 accumulators in
// registers, register A fragments (from a tile by ldmatrix, or from an
// accumulator rounded to bf16), the staged 16-byte store of a tile, and
// Seq, the attention bodies' geometry policy for global attention.
//
// Shared-memory tiles are (64, E) bf16, E 32, 64 or 128, in wgmma's
// canonical K-major layout with the swizzle of their row width: at E = 64 a
// row is one 128-byte swizzle atom, at E = 32 a 64-byte one. At E = 128 a
// row is two atoms: the tile is two (64, 64) column halves of 8 KB, each
// 128-byte swizzled (CUTLASS's K_SW128 atom tiled along K), so that half h
// is a (64, 64) tile in its own right. A contraction over E steps its k16
// slices along a half's row and then to the next half (k_slice); the same
// tile read with the transpose bit set is the MN-major B operand of a
// product over its rows, at E = 128 one N = 64 product per half.
// Loads are cp.async 16-byte copies (rows past s zero-filled by the copy's
// source size; or rows gathered one by one from map positions), one commit
// group per tile or pair of tiles. cp.async, not
// TMA: it takes the U-Net's strided views and the ragged last tile as they
// are, with no tensor map to encode on the host for every call.
//
// Accumulator layout of wgmma m64nN (f32): thread t of warp w holds rows
// 16 w + t / 4 and 16 w + t / 4 + 8, at columns 8 i + 2 (t % 4) and that
// + 1, as d[4 i + 2 h] and d[4 i + 2 h + 1] for the row + 8 h.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace kdt {

struct Rows {
  long batch, seq;  // element strides of the batch and sequence axes
};

namespace wg {

constexpr int ROWS = 64;  // rows of every tile: wgmma's M, and the key or query tile

template <int E>
constexpr int TILE = ROWS * E;  // elements of one (64, E) tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c of row r in a swizzled (64, E) tile: the
// 128-byte swizzle (E = 64) XORs the chunk with r mod 8, the 64-byte one
// (E = 32) with (r / 2) mod 4, as the hardware does on the address bits; at
// E = 128 chunks 8-15 are those of the second column half, 8 KB on.
template <int E>
__device__ __forceinline__ uint32_t swizzle(int r, int c) {
  static_assert(E == 32 || E == 64 || E == 128, "tiles take E 32, 64 or 128");
  if constexpr (E == 128) return (c >> 3) * (ROWS * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
  else if constexpr (E == 64) return r * 128 + ((c ^ (r & 7)) << 4);
  else return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}

// The elements of a swizzle atom's row: a tile's row pitch in shared memory.
template <int E>
constexpr int ATOM = E < 64 ? E : 64;

// wgmma shared-memory descriptor of a (64, E) tile at `tile` (aligned to
// 1024 bytes), or of one column half of it at E = 128. Both majors use the
// same strides: 8-row groups SBO apart (8 rows of one atom's row); LBO is
// unused by every product here (each reads one swizzle atom's width).
template <int E>
__device__ __forceinline__ uint64_t desc(const bf16* tile) {
  constexpr uint64_t layout = ATOM<E> == 64 ? 1 : 2;  // 128-byte / 64-byte swizzle
  constexpr uint64_t sbo = 8 * 2 * ATOM<E> / 16;
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) | (1ull << 16) |
         (sbo << 32) | (layout << 62);
}
// Descriptor steps, in 16-byte units: one k16 slice along a row (K-major,
// the contraction over E), one column half of an E = 128 tile, and one k16
// slice down 16 rows (MN-major, over the tile's rows).
constexpr uint64_t K_STEP = 2;
constexpr uint64_t HALF_STEP = ROWS * 128 / 16;
template <int E>
constexpr uint64_t ROW_STEP = 16 * 2 * ATOM<E> / 16;
// The descriptor offset of k16 slice kk of a contraction over E: at E = 128
// slices 4-7 lie in the second column half.
template <int E>
__device__ __forceinline__ constexpr uint64_t k_slice(int kk) {
  return E == 128 ? (kk / 4) * HALF_STEP + (kk % 4) * K_STEP : kk * K_STEP;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most N of this thread's groups are in flight, then makes
// the copies visible to wgmma (the async proxy); a __syncthreads must follow
// before another thread's copies are read.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Starts the copy of rows [r0, r0 + 64) of one head's (s, E) slice (row
// stride ld, `base` at row 0 of the head) into a swizzled tile; rows at or
// past s are zero-filled.
template <int E>
__device__ __forceinline__ void load_tile_async(bf16* tile, const bf16* base, long ld, int r0,
                                                int s) {
  constexpr int CH = E / 8;  // 16-byte chunks per row
  const uint32_t dst = smem_u32(tile);
  for (int i = threadIdx.x; i < ROWS * CH; i += blockDim.x) {
    const int r = i / CH, c = i % CH;
    const bool ok = r0 + r < s;
    cp_async16(dst + swizzle<E>(r, c), ok ? base + (r0 + r) * ld + c * 8 : base, ok);
  }
}

// A tile row's map position: row y, column x, and whether the row holds one.
struct Pos {
  int y, x;
  bool ok;
};

// The geometry of global attention, a template policy of the attention
// bodies (attn_fwd.cuh, attn_bwd.cuh; na2d.cuh has neighborhood
// attention's): a block owns rows [64 tile, 64 tile + 64 WG) of the
// sequence (WG warpgroups a block) and every 64-row tile streams past
// them; a pair attends where the streamed row lies before s. Members:
// - tiles, the streamed tiles, and positions, the map positions per image
//   and head (the length of a row of lse and delta);
// - own(r) and stream(j, r): the map position of row r of the own rows or
//   of streamed tile j; rows gathered one by one through each tensor's
//   MapStrides, rows that are not ok zero-filled;
// - index(p): a position's index into its row of lse and delta;
// - own_info(r) and mask(j, col, info): whether own row r and column col of
//   streamed tile j attend, from a per-row summary kept in registers;
// - whole(j): whether every column of tile j attends for every own row, so
//   that the forward need not test the mask;
// - own_box() and stream_box(j): the map position of row 0 of the own rows
//   and of streamed tile j, the origin of the box by which the Tensor
//   Memory Accelerator copies the tile (the float32 backward,
//   attn_tf32_bwd.cuh): a sequence's 64 rows, a neighborhood tile's 8 x 8
//   positions or a halo (slab) band's 4 rows of 16 slots.
struct Seq {
  int r0, s, tiles, positions;
  __device__ Seq(int tile, int s_)
      : r0(tile * ROWS), s(s_), tiles((s_ + ROWS - 1) / ROWS), positions(s_) {}
  __device__ Pos own(int r) const { return {r0 + r, 0, r0 + r < s}; }
  __device__ Pos stream(int j, int r) const { return {j * ROWS + r, 0, j * ROWS + r < s}; }
  __device__ long index(Pos p) const { return p.y; }
  struct Info {};
  __device__ Info own_info(int) const { return {}; }
  __device__ bool mask(int j, int col, Info) const { return j * ROWS + col < s; }
  __device__ bool whole(int j) const { return (j + 1) * ROWS <= s; }
  __device__ Pos own_box() const { return {r0, 0, true}; }
  __device__ Pos stream_box(int j) const { return {j * ROWS, 0, true}; }
};

// Starts the copy of a (64, E) tile whose row r is the E-wide row of head
// `head` of image `img` at map position pos(r) of `base` (strides st), rows
// gathered from anywhere in the map; rows whose position is not ok are
// zero-filled. With tile2 and base2, the same rows of base2 (the same
// strides) go to tile2 from the same offsets.
template <int E, class RowPos>
__device__ __forceinline__ void load_rows_async(bf16* tile, const bf16* base, const MapStrides& st,
                                                int img, int head, const RowPos& pos,
                                                bf16* tile2 = nullptr,
                                                const bf16* base2 = nullptr) {
  constexpr int CH = E / 8;
  const uint32_t dst = smem_u32(tile), dst2 = tile2 ? smem_u32(tile2) : 0;
  const long head0 = st.at(img, 0, 0, head, E);
  for (int i = threadIdx.x; i < ROWS * CH; i += blockDim.x) {
    const int r = i / CH, c = i % CH;
    const Pos p = pos(r);
    const long off = head0 + p.y * st.y + p.x * st.x + c * 8;
    cp_async16(dst + swizzle<E>(r, c), p.ok ? base + off : base, p.ok);
    if (tile2) cp_async16(dst2 + swizzle<E>(r, c), p.ok ? base2 + off : base2, p.ok);
  }
}

// Copies each row r of a swizzled (64, E) tile whose position pos(r) is ok
// to that position of head `head` of image `img` in dst (strides st), in
// whole 16-byte chunks, the block taking part.
template <int E, class RowPos>
__device__ __forceinline__ void store_rows(const bf16* stage, bf16* dst, const MapStrides& st,
                                           int img, int head, const RowPos& pos) {
  constexpr int CH = E / 8;
  const unsigned char* base = reinterpret_cast<const unsigned char*>(stage);
  for (int i = threadIdx.x; i < ROWS * CH; i += blockDim.x) {
    const int r = i / CH, c = i % CH;
    const Pos p = pos(r);
    if (p.ok)
      *reinterpret_cast<uint4*>(dst + st.at(img, p.y, p.x, head, E) + c * 8) =
          *reinterpret_cast<const uint4*>(base + swizzle<E>(r, c));
  }
}

constexpr float LOG2E = 1.4426950408889634f;

// 2^x, the hardware's approximation (as __expf uses it); 2^-inf = 0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N of the warpgroup's wgmma groups are in flight (the
// oldest complete first).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of these registers across
// the wgmma launch or wait next to it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// d (64 x N, f32) = or += A (64 x 16, bf16 pairs in registers) B (16 x N),
// B in shared memory, K-major (TRANS_B 0) or MN-major (TRANS_B 1); `acc` 0
// overwrites d. d is the thread's N / 2 accumulator elements from d[OFF]
// (OFF 32: the second 64 columns of an m64n128 accumulator).
template <int N, int TRANS_B, int OFF = 0, int M>
__device__ __forceinline__ void wgmma_rs(float (&d)[M], const uint32_t (&a)[4], uint64_t b,
                                         int acc) {
  static_assert(OFF + N / 2 <= M, "the accumulator holds the product");
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]), "+f"(d[OFF + 4]),
          "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]), "+f"(d[OFF + 8]), "+f"(d[OFF + 9]),
          "+f"(d[OFF + 10]), "+f"(d[OFF + 11]), "+f"(d[OFF + 12]), "+f"(d[OFF + 13]),
          "+f"(d[OFF + 14]), "+f"(d[OFF + 15]), "+f"(d[OFF + 16]), "+f"(d[OFF + 17]),
          "+f"(d[OFF + 18]), "+f"(d[OFF + 19]), "+f"(d[OFF + 20]), "+f"(d[OFF + 21]),
          "+f"(d[OFF + 22]), "+f"(d[OFF + 23]), "+f"(d[OFF + 24]), "+f"(d[OFF + 25]),
          "+f"(d[OFF + 26]), "+f"(d[OFF + 27]), "+f"(d[OFF + 28]), "+f"(d[OFF + 29]),
          "+f"(d[OFF + 30]), "+f"(d[OFF + 31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc), "n"(TRANS_B));
  } else {
    static_assert(N == 32, "wgmma_rs takes N 32 or 64");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]), "+f"(d[OFF + 4]),
          "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]), "+f"(d[OFF + 8]), "+f"(d[OFF + 9]),
          "+f"(d[OFF + 10]), "+f"(d[OFF + 11]), "+f"(d[OFF + 12]), "+f"(d[OFF + 13]),
          "+f"(d[OFF + 14]), "+f"(d[OFF + 15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc), "n"(TRANS_B));
  }
}

// d (64 x 64, f32) = or += A (64 x 16) B (16 x 64), both (64, 64) tiles in
// shared memory: A K-major (TRANS_A 0, rows M) or MN-major (TRANS_A 1, rows
// K), B K-major (TRANS_B 0, rows N) or MN-major (TRANS_B 1, rows K); `acc` 0
// overwrites d.
template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc), "n"(TRANS_A), "n"(TRANS_B));
}

// The bf16 A fragments of the warpgroup's (64, E) tile in shared memory for
// a product over E: k16 slice kk of each warp's 16 rows, by ldmatrix (lane
// l gives row l % 8 of 8 x 8 matrix l / 8: rows +8 for odd matrices,
// columns +8 for the upper two).
template <int E>
__device__ __forceinline__ void load_a(const bf16* tile, uint32_t (&a)[E / 16][4]) {
  const int lane = threadIdx.x & 31, m = lane / 8;
  const int row = (threadIdx.x / 32) * 16 + (m & 1) * 8 + (lane & 7);
  const uint32_t base = smem_u32(tile);
#pragma unroll
  for (int kk = 0; kk < E / 16; ++kk)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(a[kk][0]), "=r"(a[kk][1]), "=r"(a[kk][2]), "=r"(a[kk][3])
                 : "r"(base + swizzle<E>(row, 2 * kk + (m >> 1))));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Starts d = X Y^T over E for (64, E) tiles, X in registers as A fragments
// and Y K-major in shared memory, as a chain of E / 16 wgmma, not
// committed.
template <int E>
__device__ __forceinline__ void chain_rs(float (&d)[32], const uint32_t (&x)[E / 16][4],
                                         const bf16* y) {
  const uint64_t dy = desc<E>(y);
#pragma unroll
  for (int kk = 0; kk < E / 16; ++kk) wgmma_rs<64, 0>(d, x[kk], dy + k_slice<E>(kk), kk);
}

// d += A B over the tile's 64 rows: A the 4 k16 slices of a 64 x 64 bf16
// register operand, B a (64, E) tile read MN-major (at E = 128 an N = 64
// product per column half, into d's first and second 32 elements: the
// layout of one m64n128 accumulator). Started and committed as one group,
// not waited for.
template <int E>
__device__ __forceinline__ void rows_product(float (&d)[E / 2], uint32_t (&a)[4][4],
                                             const bf16* b) {
  const uint64_t db = desc<E>(b);
  fence_regs(a);
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (E == 128) {
      wgmma_rs<64, 1>(d, a[kk], db + kk * ROW_STEP<E>, 1);
      wgmma_rs<64, 1, 32>(d, a[kk], db + HALF_STEP + kk * ROW_STEP<E>, 1);
    } else {
      wgmma_rs<E, 1>(d, a[kk], db + kk * ROW_STEP<E>, 1);
    }
  }
  wgmma_commit();
}

// Packs a thread's accumulator elements of one 64 x 64 tile as the bf16
// A operand of the next product over the tile's columns: k16 slice kk is
// accumulator columns [16 kk, 16 kk + 16), which the thread holds as
// x[8 kk .. 8 kk + 8) in the order the A fragment takes them.
__device__ __forceinline__ void pack_a(const float (&x)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[kk][j] = pack_bf16(x[8 * kk + 2 * j], x[8 * kk + 2 * j + 1]);
}

// Rounds a thread's part of a 64 x E accumulator, times `mul`, to bf16 in
// the swizzled (64, E) tile `stage` in shared memory.
template <int E>
__device__ __forceinline__ void stage_acc(const float (&d)[E / 2], float mul, bf16* stage) {
  const int lane = threadIdx.x & 31;
  const int r = (threadIdx.x / 32) * 16 + lane / 4, c = 2 * (lane & 3);
  unsigned char* base = reinterpret_cast<unsigned char*>(stage);
#pragma unroll
  for (int i = 0; i < E / 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<__nv_bfloat162*>(base + swizzle<E>(r + 8 * h, i) + 2 * c) =
          __floats2bfloat162_rn(d[4 * i + 2 * h] * mul, d[4 * i + 2 * h + 1] * mul);
}

// Copies rows [0, valid) of a swizzled (64, E) tile to dst (row stride ld)
// in whole 16-byte chunks, the block taking part.
template <int E>
__device__ __forceinline__ void store_tile(const bf16* stage, bf16* dst, long ld, int valid) {
  constexpr int CH = E / 8;
  const unsigned char* base = reinterpret_cast<const unsigned char*>(stage);
  for (int i = threadIdx.x; i < ROWS * CH; i += blockDim.x) {
    const int r = i / CH, c = i % CH;
    if (r < valid)
      *reinterpret_cast<uint4*>(dst + r * ld + c * 8) =
          *reinterpret_cast<const uint4*>(base + swizzle<E>(r, c));
  }
}

// Streamed tiles go through a ring of STAGES stages: the tile two ahead of
// the current one is in flight while wgmma runs on the current one.
constexpr int STAGES = 3;

// The dynamic shared memory, its start rounded up to 1024 bytes (the
// swizzle pattern repeats every 1024 bytes of the shared address).
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* smem) {
  return smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);
}

}  // namespace wg
}  // namespace kdt
