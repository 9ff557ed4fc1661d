// The TF32 wgmma core of the float32 prologue, feed-forward block and
// mapping network (--mixed-precision no): their forwards K1
// (fused_qkv_f32.cu, qkv_f32_fwd_kernel), K4 (geglu_f32.cu,
// ffn_f32_fwd_kernel, one launch at d = 64, 128, 256 and 512; at other
// widths its wide route, ffn_f32_wide_up_kernel and
// ffn_f32_wide_down_kernel) and K5 (geglu_f32.cu, mapping_f32_kernel, one
// launch, the weights the M side of its products), and their backwards K6
// and K10 (the first kernels there, dxn_kernel and dw_kernel here).
//
// What wgmma asks of a TF32 product, and how these kernels meet it:
// - Both operands K-major. A B operand comes from shared memory and must
//   lie K-major; an A operand may come from registers (the RS form), whose
//   fragment is mma.sync m16n8k8's: a thread holds rows g and g + 8 at
//   depths t and t + 4 of a k8 slice, so an A tile may lie either way in
//   shared memory. So every product here takes A from registers and B
//   from a K-major tile, and each intermediate a product reads as B is
//   written once in that layout by the kernel that makes it: K10's dup
//   and h, K6's dR go out transposed, (2 d_ff, rows), (d_ff, rows), (3d,
//   rows); the weights read along their rows (x W_up, x W_qkv, h W_down)
//   come from a transposed copy made once per call (round_weights_kernel;
//   K4's W_down^T with each 8 of its depth in depth_pos order, so that the
//   accumulator of h is the A fragment of the down product as it lies).
// - A .tf32 operand is the f32 bit pattern with its low 13 bits ignored:
//   a tile landed as it is would be truncated. Every product operand is
//   rounded to nearest (cvt.rna) instead: A fragments in registers as they
//   are read, B operands by whoever writes them (the weight copies, the
//   transposed intermediates).
//
// Tiles. A 32-deep f32 step row is 128 bytes, one 128-byte swizzle atom:
// a K-major (rows, 32) tile is one TMA box in CU_TENSOR_MAP_SWIZZLE_128B,
// wgmma's canonical K-major layout (8-row groups 1024 bytes apart), and k8
// slice kk is the descriptor start 32 kk bytes on. An A tile that lies
// MN-major (its 128 rows along the matrix's contiguous axis) is four boxes
// of 32 depth rows by 32 of its rows, each 4 KB, read with the same
// swizzle by address; the copy engine starts a box on 16 bytes, so a tile
// whose first row is not a multiple of 4 (an image of 49 tokens) takes
// five boxes from the multiple of 4 below it and reads them shifted.
//
// Blocks. Three warpgroups: two consumers, each owning 64 rows of a
// 128-row output tile, and a producer whose one thread keeps the TMA copies
// of S ring stages in flight (full barriers: a stage's bytes have landed;
// empty barriers: each of the 8 consumer warps is done with it). The
// producer gives its registers to the consumers (setmaxnreg), though
// ptxas compiles every thread to the 168 registers that three warps a
// scheduler leave (a kernel without the producer warpgroup, its ring fed
// by a consumer thread, got 255 and ran slower on an H100). A block stays
// on its SM and walks a contiguous range of work items (neighbours share a
// row tile and an image's scale): the producer runs on into the next
// item's steps while the consumers run an item's epilogue (K4's forward:
// one item a block, its clusters' partials meeting at the end). An item is
// one output tile and its depth, one or more products (K10's first kernel:
// the up projection, then dh), each a run of 32-deep steps of 4 wgmma
// m64nNk8 (N 64 to 192). Where a step's A fragments are made in registers
// (stepwise), a warpgroup waits for a step's products before it makes the
// next step's; the other warpgroup's products keep the tensor cores busy
// meanwhile. (With one step's products left in flight, wgmma_wait<1>,
// reruns on the card were not bit-equal, and no faster.) Where none are
// made (chained: A in shared memory, or in registers already), the next
// step's products are issued first, and a stage goes back only once its
// own are done: reruns bit-equal.
//
// Accumulators. wgmma's m64nN f32 accumulator is mma.sync's m16n8 C
// layout repeated along N: element 4 i + 2 h + e of a thread lies at row
// 16 w + g + 8 h of the tile (w the consumer warp, 0-7; g = lane / 4) and
// column 8 i + 2 t + e (t = lane % 4), mma.sync m16n8's C layout repeated
// along N.
//
// Row reductions (the weight gradients over row chunks, d(scale), d
// (attn_scale)) are f32 partials summed in a fixed order, never atomics: a
// rerun is bit-equal.
//
// What bounds the backwards on the H100: bytes. At the flagship's level 0 (batch-8
// step shapes: 32768 rows, d 128, d_ff 384) K10 does 25.8 GFLOP, 52 us at
// TF32's 494.7 TFLOP/s, while its f32 intermediates (dup and h written
// once and read back, xn) and operands move about 530 MB through device
// memory, 160 us at 3.35 TB/s; K6 (dR, xn) about 280 MB against 9.7
// GFLOP. The kernels overlap the copies with the products and store
// through shared memory in whole 16-byte words; keeping dup and dR on
// chip would need another design.
#pragma once

#include <cuda.h>

#include <cstdint>

#include "gemm.cuh"
#include "wgmma_tf32.cuh"

namespace kdt {
namespace tw {

constexpr int BK = 32;                          // depth of a ring step
constexpr int CONSUMERS = 2;                    // consumer warpgroups
constexpr int THREADS = 128 * (CONSUMERS + 1);  // and the producer's
constexpr int ROWS = 64 * CONSUMERS;            // rows of an item's output tile
constexpr int S = 4;                            // ring stages
constexpr int K_TILE = ROWS * BK * 4;           // a K-major A tile, one box
constexpr int BOX = 32 * BK * 4;                // an MN-major A box, 32 x 32
// a stage's A tile: K-major, one box; or MN-major, up to five boxes (a
// tile whose first row lies past a multiple of 4 takes a fifth: the copy
// engine starts a box on 16 bytes)
constexpr int A_BYTES = (ROWS / 32 + 1) * BOX;
constexpr int B_BYTES = 128 * BK * 4;           // its B tile, N <= 128
constexpr int STAGE = A_BYTES + B_BYTES;
// the dynamic shared memory of the ring and the slack to align it to 1024
constexpr size_t RING_SMEM = S * STAGE + 1024;

// Row tiles of `tokens` rows an image, ROWS rows each, the last ragged: tile
// `index` is tile `tile` of image `img`, `valid` rows from row0.
struct RowTile {
  long row0;
  int valid, img, tile;
};
__host__ __device__ inline int tiles(int tokens) { return (tokens + ROWS - 1) / ROWS; }
__device__ __forceinline__ RowTile row_tile(int tokens, int index) {
  const int n = tiles(tokens), img = index / n, tile = index % n;
  const int valid = tokens - tile * ROWS < ROWS ? tokens - tile * ROWS : ROWS;
  return {static_cast<long>(img) * tokens + static_cast<long>(tile) * ROWS, valid, img, tile};
}

__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }
// the consumer warp of the thread, 0 to 4 CONSUMERS - 1
__device__ __forceinline__ int warp() { return threadIdx.x / 32; }
// The tile row of a consumer thread's accumulator element h (row g or g + 8
// of its warp's 16).
__device__ __forceinline__ int acc_row(int h) { return 16 * warp() + lane_g() + 8 * h; }

// ---- the ring ----------------------------------------------------------------

// The ring's barriers: full[st], the stage's bytes have landed (the
// producer's arrival and the copies' bytes); empty[st], the consumer warps
// are done with it. A kernel's ring has `stages` of them (S, or up to
// MAX_S where its stages are small).
constexpr int MAX_S = 8;
struct Ring {
  uint64_t full[MAX_S], empty[MAX_S];
};

__device__ __forceinline__ void ring_init(Ring& r, int stages = S) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(&r.full[s])),
                   "r"(1)
                   : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(&r.empty[s])),
                   "r"(4 * CONSUMERS)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The roles: every thread of the block calls one of the two right after
// ring_init, in one if-else that never joins again (else the compiler
// ignores setmaxnreg).
__device__ __forceinline__ bool is_producer() { return threadIdx.x >= 128 * CONSUMERS; }
__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
}
// the producer warpgroup's thread that starts the copies
__device__ __forceinline__ bool tma_thread() { return threadIdx.x == 128 * CONSUMERS; }

// Barriers among the consumers: all their warps, or one warpgroup's 4.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * CONSUMERS) : "memory");
}
__device__ __forceinline__ void warpgroup_sync() {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + static_cast<int>(threadIdx.x / 128)) : "memory");
}

// The copy of the box at (c0, c1) (column, row of the matrix) of `map` into
// shared memory at dst, its bytes counted on bar.
__device__ __forceinline__ void tma(void* dst, const CUtensorMap* map, int c0, long c1,
                                    uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, "
      "{%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(static_cast<int>(c1)),
      "r"(smem_u32(bar))
      : "memory");
}

// The producer's walk over the ring: next() waits until the stage of its
// next step is free, tells the stage's barrier to expect `bytes` and
// returns the stage; the caller then starts the step's copies on `bar`.
// Stages lie `stride` bytes apart (STAGE, or a kernel's own), `stages` of
// them.
struct Producer {
  Ring& r;
  unsigned char* ring;
  int step = 0;
  int stride = STAGE;
  int stages = S;
  __device__ unsigned char* next(uint32_t bytes, uint64_t*& bar) {
    const int st = step % stages;
    if (step >= stages) gemm::mbar_wait(&r.empty[st], (step / stages - 1) & 1);
    bar = &r.full[st];
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
                 "r"(bytes)
                 : "memory");
    ++step;
    return ring + st * stride;
  }
};

// The consumers' walk: wait() returns the stage of the next step once its
// copies have landed; release(st) is the warp's arrival once it is done
// with stage st.
struct Consumer {
  Ring& r;
  const unsigned char* ring;
  int step = 0;
  int stages = S;
  __device__ int wait() {
    const int st = step % stages;
    gemm::mbar_wait(&r.full[st], (step / stages) & 1);
    ++step;
    return st;
  }
  __device__ void release(int st) {
    if ((threadIdx.x & 31) == 0) gemm::mbar_arrive(&r.empty[st]);
  }
};

// The work items [begin, end) of this block: a contiguous share of `items`,
// so that its neighbouring items share a row tile and an image's scale.
struct Items {
  int begin, end;
};
__device__ __forceinline__ Items my_items(int items) {
  const int per = (items + gridDim.x - 1) / gridDim.x, begin = blockIdx.x * per;
  return {begin, begin + per < items ? begin + per : items};
}

// ---- products ------------------------------------------------------------------
// (the wgmma wrappers mma<N>, desc and the rounding are wgmma_tf32.cuh's)

// Element (m, k) of a stage's A tile: K-major, its 128 rows of 32 depths
// one swizzled box; or MN-major, four boxes of 32 depth rows by 32 rows m.
__device__ __forceinline__ float a_kmajor(const unsigned char* tile, int m, int k) {
  return *reinterpret_cast<const float*>(tile + m * 128 + ((((k >> 2) ^ m) & 7) << 4) +
                                         ((k & 3) << 2));
}
__device__ __forceinline__ float a_mnmajor(const unsigned char* tile, int m, int k) {
  return *reinterpret_cast<const float*>(tile + ((m >> 5) << 12) + k * 128 +
                                         ((((m >> 2) ^ k) & 7) << 4) + ((m & 3) << 2));
}

// The thread's A fragment of k8 slice kk of a stage, rounded: the four
// elements (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4) of its warp's 16
// rows. The fragment makers take (stage, step, kk, a). An MN-major tile's
// row m lies at m + shift of its boxes.
struct RoundedK {
  __device__ void operator()(const unsigned char* s, int, int kk, uint32_t (&a)[4]) const {
    const int m = acc_row(0), k = 8 * kk + lane_t();
    a[0] = to_tf32(a_kmajor(s, m, k));
    a[1] = to_tf32(a_kmajor(s, m + 8, k));
    a[2] = to_tf32(a_kmajor(s, m, k + 4));
    a[3] = to_tf32(a_kmajor(s, m + 8, k + 4));
  }
};
struct RoundedMN {
  int shift;
  __device__ void operator()(const unsigned char* s, int, int kk, uint32_t (&a)[4]) const {
    const int m = acc_row(0) + shift, k = 8 * kk + lane_t();
    a[0] = to_tf32(a_mnmajor(s, m, k));
    a[1] = to_tf32(a_mnmajor(s, m + 8, k));
    a[2] = to_tf32(a_mnmajor(s, m, k + 4));
    a[3] = to_tf32(a_mnmajor(s, m + 8, k + 4));
  }
};

// The AdaRMSNorm of a K-major A, x (rows, d), folded into the product: R =
// xn W = r ((x nscale) W), r = 1 / sqrt(mean(x^2) + eps) per row. Each
// element x at depth k enters as x nscale[k] (s_ns, the image's scale in
// shared memory), rounded, and its square joins its row's sum (h: row g or
// g + 8); a thread quad sees every depth of its rows once, so norms() gives
// r after the product. No pass over the x tile before the products.
struct Normed {
  const float* s_ns;
  float ss[2] = {0.f, 0.f};
  __device__ void operator()(const unsigned char* s, int step, int kk, uint32_t (&a)[4]) {
    const int m = acc_row(0), k = 8 * kk + lane_t(), k0 = BK * step + k;
    const float v0 = a_kmajor(s, m, k), v1 = a_kmajor(s, m + 8, k);
    const float v2 = a_kmajor(s, m, k + 4), v3 = a_kmajor(s, m + 8, k + 4);
    ss[0] += v0 * v0 + v2 * v2;
    ss[1] += v1 * v1 + v3 * v3;
    a[0] = to_tf32(v0 * s_ns[k0]);
    a[1] = to_tf32(v1 * s_ns[k0]);
    a[2] = to_tf32(v2 * s_ns[k0 + 4]);
    a[3] = to_tf32(v3 * s_ns[k0 + 4]);
  }
  // r of the thread's two rows (rows past the matrix's end are zero)
  __device__ void norms(int d, float eps, float (&r)[2]) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) r[h] = rsqrtf(gemm::quad_sum(ss[h]) / d + eps);
  }
};

// acc (64 x N a warpgroup) = A B over `steps` ring steps, the consumers'
// next ones: each step's A fragments from `frag`, its B the stage's K-major
// tile of N rows. Each step's stage goes back to the producer once its
// products are done, before the next step's fragments are read.
template <int N, class Frag>
__device__ __forceinline__ void product(float (&acc)[N / 2], Consumer& c, int steps,
                                        Frag&& frag) {
  for (int k = 0; k < steps; ++k) {
    const int st = c.wait();
    const unsigned char* stage = c.ring + st * STAGE;
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) frag(stage, k, kk, a[kk]);
    const uint64_t b = desc(stage + A_BYTES);
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma<N>(acc, a[kk], b + 2 * kk, k > 0 || kk > 0);
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_regs(acc);
    c.release(st);
  }
}

// The consumers' walk over `steps` ring steps of one product whose A
// fragments are made in registers: step by step, prep(stage, k, a) makes
// step k's fragments, issue(stage, k, a) issues its wgmma between a fence
// and a commit; the step's products are waited for and its stage goes back
// to the producer before the next step's. (Making step k + 1's fragments
// while step k's products run, in a second set of registers, ran slower on
// an H100.) Stages lie `stride` bytes apart. C: Consumer, or a kernel's
// own walk with Consumer's wait(), release() and ring. The caller fences
// its accumulators (wg::fence_regs) after the walk, before it reads them.
template <class C, class Prep, class Issue>
__device__ __forceinline__ void stepwise(C& c, int steps, int stride, Prep&& prep,
                                         Issue&& issue) {
  for (int k = 0; k < steps; ++k) {
    const int st = c.wait();
    const unsigned char* stage = c.ring + st * stride;
    uint32_t a[4][4];
    prep(stage, k, a);
    wg::wgmma_fence();
    issue(stage, k, a);
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    c.release(st);
  }
}

// The walk where no A fragment is to be made (SS products, or A already
// in registers): issue(stage, k) for k < steps (STEPS where it is known
// when compiling, the loop then unrolled), step k + 1's products issued
// before step k's are waited for. A stage goes back to the producer once
// its products are done; a product is issued after the one before it on
// the same accumulator, so a rerun sums in the same order.
template <int STEPS = 0, class C, class Issue>
__device__ __forceinline__ void chained(C& c, int steps, int stride, Issue&& issue) {
  const int n = STEPS ? STEPS : steps;
  int prev = 0;
#pragma unroll
  for (int k = 0; k < n; ++k) {
    const int st = c.wait();
    wg::wgmma_fence();
    issue(c.ring + st * stride, k);
    wg::wgmma_commit();
    if (k > 0) {
      wg::wgmma_wait<1>();
      c.release(prev);
    }
    prev = st;
  }
  wg::wgmma_wait<0>();
  c.release(prev);
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
}

// Stages the image's norm scale (d,) in shared memory for Normed, among the
// consumers, once the previous item is done with it.
__device__ __forceinline__ void stage_scale(const float* __restrict__ ns_row, int d, float* s_ns) {
  consumers_sync();
  for (int c = 4 * threadIdx.x; c < d; c += 4 * 128 * CONSUMERS)
    *reinterpret_cast<float4*>(s_ns + c) = *reinterpret_cast<const float4*>(ns_row + c);
  consumers_sync();
}

// xn = x * (nscale r) rounded to TF32, the A operand of dW = xn^T dR, and r,
// for the warpgroup's 64 rows of a row tile: r from the product through s_r
// (ROWS floats), x read again (from L2, most likely). Every thread of the
// warpgroup calls it.
__device__ inline void write_xn(const float* __restrict__ x, const RowTile& t, int d,
                                const float* s_ns, const float (&r)[2], float* s_r,
                                float* __restrict__ xn_out, float* __restrict__ r_out) {
  if (lane_t() == 0) {
    s_r[acc_row(0)] = r[0];
    s_r[acc_row(1)] = r[1];
  }
  warpgroup_sync();
  const int base = 64 * (threadIdx.x / 128), tid = threadIdx.x % 128;
  for (int i = tid; i < 64 * (d / 4); i += 128) {
    const int row = base + i / (d / 4), c = 4 * (i % (d / 4));
    if (row >= t.valid) break;
    const float4 v = *reinterpret_cast<const float4*>(x + (t.row0 + row) * d + c);
    const float rr = s_r[row];
    *reinterpret_cast<float4*>(xn_out + (t.row0 + row) * d + c) = make_float4(
        round_tf32(v.x * (s_ns[c] * rr)), round_tf32(v.y * (s_ns[c + 1] * rr)),
        round_tf32(v.z * (s_ns[c + 2] * rr)), round_tf32(v.w * (s_ns[c + 3] * rr)));
  }
  if (tid < 64 && base + tid < t.valid) r_out[t.row0 + base + tid] = s_r[base + tid];
  warpgroup_sync();  // s_r is free again
}

// A (64, ROWS) tile staged in shared memory for a transposed store: element
// (column c, row m) at c * ST_LD + m, so that a warp's accumulator writes
// (8 rows by 4 columns 2 apart) fall in 32 banks.
constexpr int ST_LD = ROWS + 4;
constexpr int STAGING = 64 * ST_LD * 4;

// Copies the staged tile's 64 columns, rows [0, valid), to dst + c * ld,
// coalesced: 16-byte stores where dst lies on 16 bytes (ld is a multiple of
// 4), else 4-byte ones. Every consumer thread calls it between
// consumers_sync()s: after the tile is staged, and before it is staged again.
__device__ inline void store_t(const float* s, float* __restrict__ dst, long ld, int valid) {
  const int tid = threadIdx.x;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    for (int i = tid; i < 64 * (ROWS / 4); i += 128 * CONSUMERS) {
      const int c = i / (ROWS / 4), m = 4 * (i % (ROWS / 4));
      if (m >= valid) continue;
      const float4 v = *reinterpret_cast<const float4*>(s + c * ST_LD + m);
      float* out = dst + c * ld + m;
      if (m + 4 <= valid) {
        *reinterpret_cast<float4*>(out) = v;
      } else {
        out[0] = v.x;
        if (m + 1 < valid) out[1] = v.y;
        if (m + 2 < valid) out[2] = v.z;
      }
    }
  } else {
    for (int i = tid; i < 64 * ROWS; i += 128 * CONSUMERS) {
      const int c = i / ROWS, m = i % ROWS;
      if (m < valid) dst[c * ld + m] = s[c * ST_LD + m];
    }
  }
}

// ---- the dxn and weight-gradient kernels ---------------------------------------

// dxn = dR W^T and the RMS-norm VJP for one row tile and NB columns of d (an
// item; NB 128, or 64 where 128-column items would leave SMs idle), both
// backwards' second step. A is dR^T (K, ld) (map_a, boxes of 32 x 32: read
// MN-major), B the rounded W (d, K) (map_b, boxes of 32 x NB, K-major).
// The epilogue, per row with r and s, the fixed-order sum over its `groups`
// partials dot_part (groups, rows) (gemm.cuh's note):
//   dx = r dxn nscale - x (r^2 / d) s  (+ res, the block's own residual)
// and the tile's d(nscale) partial, the sum over its rows of dxn x r, into
// dns_part (images * tiles, d).
template <int NB>
__global__ void __launch_bounds__(THREADS, 1)
dxn_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
           const float* __restrict__ x, const float* __restrict__ nscale,
           const float* __restrict__ res, const float* __restrict__ r_rows,
           const float* __restrict__ dot_part, int groups, float* __restrict__ dx,
           float* __restrict__ dns_part, long n_rows, int images, int tokens, int d, int k_dim) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ Ring ring;
  __shared__ float s_red[4 * CONSUMERS][NB];
  unsigned char* smem = wg::aligned_smem(smem_raw);
  ring_init(ring);
  const int n_tiles = (d + NB - 1) / NB, steps = k_dim / BK;
  const Items span = my_items(images * tiles(tokens) * n_tiles);
  if (is_producer()) {
    producer_regs();
    if (!tma_thread()) return;
    Producer p{ring, smem};
    for (int item = span.begin; item < span.end; ++item) {
      const RowTile t = row_tile(tokens, item / n_tiles);
      const int n0 = NB * (item % n_tiles);
      // the boxes start on a row that is a multiple of 4
      const int first = static_cast<int>(t.row0) & ~3, boxes = ROWS / 32 + (t.row0 & 3 ? 1 : 0);
      for (int k = 0; k < steps; ++k) {
        uint64_t* bar;
        unsigned char* st = p.next(boxes * BOX + NB * BK * 4, bar);
        for (int j = 0; j < boxes; ++j) tma(st + BOX * j, &map_a, first + 32 * j, BK * k, bar);
        tma(st + A_BYTES, &map_b, BK * k, n0, bar);
      }
    }
    return;
  }
  consumer_regs();
  Consumer c{ring, smem};
  const int t4 = lane_t(), w = warp();
  for (int item = span.begin; item < span.end; ++item) {
    const int rt = item / n_tiles;
    const RowTile t = row_tile(tokens, rt);
    const int n0 = NB * (item % n_tiles);
    // the rows' r and dot sums, read before the product to hide their latency
    float r[2], coef[2];
    bool ok[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ok[h] = acc_row(h) < t.valid;
      const long row = t.row0 + (ok[h] ? acc_row(h) : 0);
      float s = 0.f;
      for (int gi = 0; gi < groups; ++gi) s += dot_part[gi * n_rows + row];
      r[h] = r_rows[row];
      coef[h] = r[h] * r[h] * s / d;
    }
    float acc[NB / 2];
    zero(acc);
    product<NB>(acc, c, steps, RoundedMN{static_cast<int>(t.row0 & 3)});
    const float* ns = nscale + static_cast<long>(t.img) * d;
#pragma unroll
    for (int i = 0; i < NB / 8; ++i) {
      const int col = n0 + 8 * i + 2 * t4;
      const bool in = col < d;
      const float2 nv = in ? *reinterpret_cast<const float2*>(ns + col) : make_float2(0.f, 0.f);
      float p0 = 0.f, p1 = 0.f;  // this column pair's d(nscale) terms
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!ok[h] || !in) continue;
        const long at = (t.row0 + acc_row(h)) * d + col;
        const float d0 = acc[4 * i + 2 * h], d1 = acc[4 * i + 2 * h + 1];
        const float2 xv = *reinterpret_cast<const float2*>(x + at);
        float v0 = r[h] * d0 * nv.x - xv.x * coef[h], v1 = r[h] * d1 * nv.y - xv.y * coef[h];
        if (res != nullptr) {
          const float2 rv = *reinterpret_cast<const float2*>(res + at);
          v0 += rv.x;
          v1 += rv.y;
        }
        *reinterpret_cast<float2*>(dx + at) = make_float2(v0, v1);
        p0 += d0 * xv.x * r[h];
        p1 += d1 * xv.y * r[h];
      }
      p0 = gemm::column_sum(p0);
      p1 = gemm::column_sum(p1);
      if (lane_g() == 0) {
        s_red[w][8 * i + 2 * t4] = p0;
        s_red[w][8 * i + 2 * t4 + 1] = p1;
      }
    }
    consumers_sync();
    if (threadIdx.x < NB && n0 + static_cast<int>(threadIdx.x) < d) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 4 * CONSUMERS; ++j) s += s_red[j][threadIdx.x];  // warp order
      dns_part[static_cast<long>(rt) * d + n0 + threadIdx.x] = s;
    }
    consumers_sync();  // s_red is free again
  }
}

// dW partials: part[chunk] (m, n) = A[rows of chunk]^T B[rows of chunk] for
// A (rows, m) (map_a, boxes of 32 x 32: read MN-major) and B given as B^T
// (n, ld) (map_b, boxes of 32 x 128, K-major). An item is one ROWS x 128
// output tile of one chunk, its rows past m and columns past n not stored;
// the items of a chunk are neighbours, so that blocks in flight together
// read the same rows.
__global__ void __launch_bounds__(THREADS, 1)
dw_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
          float* __restrict__ part, long rows, int m, int n, long chunk_rows) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ Ring ring;
  unsigned char* smem = wg::aligned_smem(smem_raw);
  ring_init(ring);
  const int m_tiles = (m + ROWS - 1) / ROWS, n_tiles = (n + 127) / 128;
  const int tiles_ = m_tiles * n_tiles;
  const Items span = my_items(static_cast<int>((rows + chunk_rows - 1) / chunk_rows) * tiles_);
  auto depth = [&](int item, long& begin) {
    begin = item / tiles_ * chunk_rows;
    const long end = begin + chunk_rows < rows ? begin + chunk_rows : rows;
    return static_cast<int>((end - begin + BK - 1) / BK);
  };
  if (is_producer()) {
    producer_regs();
    if (!tma_thread()) return;
    Producer p{ring, smem};
    for (int item = span.begin; item < span.end; ++item) {
      long begin;
      const int steps = depth(item, begin);
      const int m0 = ROWS * (item % tiles_ / n_tiles), n0 = 128 * (item % n_tiles);
      for (int k = 0; k < steps; ++k) {
        uint64_t* bar;
        unsigned char* st = p.next(ROWS / 32 * BOX + B_BYTES, bar);
#pragma unroll
        for (int j = 0; j < ROWS / 32; ++j)
          tma(st + BOX * j, &map_a, m0 + 32 * j, begin + BK * k, bar);
        tma(st + A_BYTES, &map_b, static_cast<int>(begin + BK * k), n0, bar);
      }
    }
    return;
  }
  consumer_regs();
  Consumer c{ring, smem};
  for (int item = span.begin; item < span.end; ++item) {
    long begin;
    const int steps = depth(item, begin);
    const int m0 = ROWS * (item % tiles_ / n_tiles), n0 = 128 * (item % n_tiles);
    float acc[64];
    zero(acc);
    product<128>(acc, c, steps, RoundedMN{0});
    float* out = part + (static_cast<long>(item / tiles_) * m + m0) * n + n0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (m0 + acc_row(h) >= m) continue;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int col = 8 * i + 2 * lane_t();
        if (n0 + col < n)
          *reinterpret_cast<float2*>(out + static_cast<long>(acc_row(h)) * n + col) =
              make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
      }
    }
  }
}

// out (n, m) = the sum over c < chunks of in (chunks, m, n), c ascending,
// transposed: dW_down from the partials of (g^T h).
__global__ void reduce_t_kernel(const float* __restrict__ in, float* __restrict__ out,
                                int chunks, int m, int n) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long count = static_cast<long>(m) * n;
  if (i >= count) return;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += in[c * count + i];
  out[(i % n) * m + i / n] = s;
}

// The depth position, in a product whose A fragments are an accumulator
// as it lies (K4's h), of depth r: the accumulator holds columns 2 t and 2
// t + 1 of each 8 where the fragment holds depths t and t + 4.
__host__ __device__ inline int depth_pos(int r) {
  return (r & ~7) | ((r & 1) << 2) | ((r & 7) >> 1);
}

// Where not null, dst (rows, cols) and dst_t (cols, rows): src (rows,
// cols) rounded to TF32, a weight as the products read it; with `perm`,
// dst_t's columns (src's rows) in depth_pos order within each 8 (rows a
// multiple of 8). Grid (ceil(cols / 32), ceil(rows / 32)), blocks of 32 x
// 8 threads.
__global__ void round_weights_kernel(const float* __restrict__ src, int rows, int cols,
                                     float* __restrict__ dst, float* __restrict__ dst_t,
                                     int perm) {
  __shared__ float tile[32][33];
  const int c0 = 32 * blockIdx.x, r0 = 32 * blockIdx.y;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int r = r0 + i, c = c0 + threadIdx.x;
    if (r < rows && c < cols) {
      const float v = round_tf32(src[static_cast<long>(r) * cols + c]);
      if (dst != nullptr) dst[static_cast<long>(r) * cols + c] = v;
      tile[i][threadIdx.x] = v;
    }
  }
  if (dst_t == nullptr) return;
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int c = c0 + i, r = r0 + threadIdx.x;
    if (c < cols && r < rows)
      dst_t[static_cast<long>(c) * rows + (perm ? depth_pos(r) : r)] = tile[threadIdx.x][i];
  }
}

// ---- launches --------------------------------------------------------------------

// The tensor map of a row-major (rows, cols) f32 matrix, rows ld floats
// apart, for boxes of box_rows rows by 32 columns (one 128-byte row each).
inline cudaError_t map_f32(CUtensorMap* map, const float* base, long rows, long cols, long ld,
                           int box_rows) {
  return gemm::tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, base, rows, cols,
                          ld * static_cast<long>(sizeof(float)), BK, box_rows);
}

// The SMs of the current device.
inline int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// Blocks of a grid of `items` work items: one an SM, at most one an item.
inline int grid(long items) {
  const int sms = sm_count();
  return static_cast<int>(items < sms ? items : sms);
}

inline cudaError_t launch_round(const float* src, int rows, int cols, float* dst, float* dst_t,
                                cudaStream_t st, bool perm = false) {
  round_weights_kernel<<<dim3((cols + 31) / 32, (rows + 31) / 32), dim3(32, 8), 0, st>>>(
      src, rows, cols, dst, dst_t, perm ? 1 : 0);
  return cudaGetLastError();
}

template <int NB>
inline cudaError_t launch_dxn_nb(const CUtensorMap& map_a, const float* w, const float* x,
                                 const float* nscale, const float* res, const float* r,
                                 const float* dot_part, int groups, float* dx, float* dns_part,
                                 long items, int images, int tokens, int d, int k_dim,
                                 cudaStream_t st) {
  CUtensorMap map_b;
  cudaError_t err = map_f32(&map_b, w, d, k_dim, k_dim, NB);
  if (err == cudaSuccess) err = allow_smem(dxn_kernel<NB>, RING_SMEM);
  if (err != cudaSuccess) return err;
  dxn_kernel<NB><<<grid(items), THREADS, RING_SMEM, st>>>(
      map_a, map_b, x, nscale, res, r, dot_part, groups, dx, dns_part,
      static_cast<long>(images) * tokens, images, tokens, d, k_dim);
  return cudaGetLastError();
}

// Launches dxn_kernel, dR^T (k_dim, ld) and the rounded w (d, k_dim), and
// the reduction of its partials into dns (images, d) f32; dns_part holds
// images * tiles(tokens) * d floats.
inline cudaError_t launch_dxn(const float* drt, long ld, const float* w, const float* x,
                              const float* nscale, const float* res, const float* r,
                              const float* dot_part, int groups, float* dx, float* dns_part,
                              float* dns, int images, int tokens, int d, int k_dim,
                              cudaStream_t st) {
  const long rows = static_cast<long>(images) * tokens;
  CUtensorMap map_a;
  cudaError_t err = map_f32(&map_a, drt, k_dim, rows, ld, 32);
  if (err != cudaSuccess) return err;
  const long row_tiles = static_cast<long>(images) * tiles(tokens);
  err = row_tiles * ((d + 127) / 128) >= sm_count()
            ? launch_dxn_nb<128>(map_a, w, x, nscale, res, r, dot_part, groups, dx, dns_part,
                                 row_tiles * ((d + 127) / 128), images, tokens, d, k_dim, st)
            : launch_dxn_nb<64>(map_a, w, x, nscale, res, r, dot_part, groups, dx, dns_part,
                                row_tiles * (d / 64), images, tokens, d, k_dim, st);
  if (err != cudaSuccess) return err;
  return gemm::launch_reduce(dns_part, dns, images, tiles(tokens), d, st);
}

// Launches the dW partials of A^T B over chunks of chunk_rows rows, A (rows,
// m) and B^T (n, ld), and their reduction into dw: (m, n), or with
// `transposed` (n, m); part holds ceil(rows / chunk_rows) * m * n floats.
inline cudaError_t launch_dw(const float* a, const float* bt, long ld, float* part, float* dw,
                             bool transposed, long rows, int m, int n, long chunk_rows,
                             cudaStream_t st) {
  CUtensorMap map_a, map_b;
  cudaError_t err = map_f32(&map_a, a, rows, m, m, 32);
  if (err == cudaSuccess) err = map_f32(&map_b, bt, n, rows, ld, 128);
  if (err == cudaSuccess) err = allow_smem(dw_kernel, RING_SMEM);
  if (err != cudaSuccess) return err;
  const int chunks = static_cast<int>((rows + chunk_rows - 1) / chunk_rows);
  const long items = static_cast<long>(chunks) * ((m + ROWS - 1) / ROWS) * ((n + 127) / 128);
  dw_kernel<<<grid(items), THREADS, RING_SMEM, st>>>(map_a, map_b, part, rows, m, n,
                                                            chunk_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long count = static_cast<long>(m) * n;
  if (!transposed) return gemm::launch_reduce(part, dw, 1, chunks, count, st);
  reduce_t_kernel<<<static_cast<unsigned>((count + 255) / 256), 256, 0, st>>>(part, dw, chunks, m,
                                                                               n);
  return cudaGetLastError();
}

}  // namespace tw
}  // namespace kdt
