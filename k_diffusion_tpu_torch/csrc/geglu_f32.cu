// The GEGLU kernels in float32, the kernels of --mixed-precision no: the
// HDiT feed-forward block, forward (K4 in f32) and backward (K10 in f32),
// and the whole mapping network (K5 in f32). K4 at d = 64, 128, 256 and
// 512 and K10 run on gemm_tf32_wg.cuh's TF32 wgmma core; K5, and K4 at
// other widths (its wide route: 768, the widest shipped level, and any
// width past 512), on gemm_tf32.cuh's TF32 mma.sync core.
//
// Replaces: k_diffusion_tpu/ops/pallas/fused_ffn.py:_ffn_kernel (the
// forward of fused_geglu_ffn), :_ffn_bwd_kernel (its backward) and
// k_diffusion_tpu/ops/pallas/fused_mapping.py:_mapping_kernel (the forward
// of fused_mapping), as they run on f32 operands (the JAX model built with
// dtype=float32): f32 dots with f32 accumulation. Here every product runs
// on the TF32 tensor cores with f32 accumulation, as PyTorch's float32
// training does with TF32 on; the norms, the exact-erf GELU, its
// derivative and the residuals stay in f32.
//
// What bounds them on the H100, the flagship's shapes:
// - FF block (eval, batch 8): 6 tokens d d_ff = 9.7 GFLOP at every level
//   (20 us at TF32's 494.7 TFLOP/s) against x in and out, 34 MB at level 0
//   (10 us at 3.35 TB/s): bound by the tensor cores, as long as the hidden
//   activation h (50 MB in f32 at level 0) never leaves the chip.
// - FF backward at batch-8 training shapes: the recomputed up projection
//   and four VJP products, 16 tokens d d_ff FLOP, 2.7x the forward's.
// - Mapping network (batch 8, d 256, d_ff 768, 2 blocks): 4.7 MB of f32
//   weights (1.4 us at 3.35 TB/s) on an (8, 256) activation: bound by
//   latency, and by how many SMs share the weight reads.
//
// K4 in f32 (ffn_f32_fwd_kernel<NO, RES>), one launch after W_up^T and
// W_down^T are copied rounded to TF32 (tw::round_weights_kernel; W_down^T
// with each 8 of its depth in depth_pos order), on the bf16 form's plan
// (geglu.cu's ffn_fwd_kernel). A block is gemm_tf32_wg.cuh's: two consumer
// warpgroups over a 128-row tile that never spans two images, 64 rows
// each, and a producer warp keeping the TMA ring full. It owns NO = min(d,
// 256) output columns and the hidden panels of NU units (64, or 32 where
// NO = 256: the output tiles take 128 of a thread's 168 registers, the
// most ptxas gives with three warps a scheduler) r, r + G, ... of its rank
// r in a thread block cluster of G. Per panel: a | gate = r ((x nscale)
// W_up) into one accumulator (N = 2 NU), the GEGLU in registers (exact
// erf), h rounded to TF32 in place: the accumulator's columns 2 t, 2 t + 1
// of each 8 are the A fragment's depths t, t + 4, which the permuted
// W_down^T's depth order matches, so h is the register A operand of out
// += h W_down[panel] as it lies. The output tiles stay in registers across
// the panels. h never leaves the chip. Shared memory, f32 doubling every
// tile:
// - d <= 256 (RES): the x tile is resident (d / 32 boxes, 32 KB at d = 64
//   to 128 KB at 256, landed once), rounded in place as x nscale with each
//   row's r, and read by the up product as its shared-memory A operand (the
//   SS form: no fragment made a step); the ring then carries only weight
//   tiles, up to 8 stages of 16 KB.
// - d = 512 (256 KB of x): x streams from L2 beside W_up^T in each up
//   stage, its A fragments made in registers (tw::Normed). The 512 output
//   columns take two blocks' registers, a column slab each; they pair up
//   in the cluster (2 G blocks) and share h rather than form the up
//   product twice: of each pair of the rank's panels, the slab-s block
//   forms h of the s-th and writes its A fragments into a slot of its own
//   and of its partner's shared memory (distributed shared memory, two
//   slots, mbarriers at cluster scope); both then run the pair's two down
//   products in panel order from their slots.
// At the end each block stages its f32 partial in its own shared memory
// (the x tiles and the ring are free by then); after a cluster barrier
// each block sums its share of the tile's rows over its slab's ranks'
// partials in rank order (distributed shared memory), adds the residual
// x in f32 and writes 16-byte words, the loads of 8 words a thread issued
// together. No atomics: a rerun is bit-equal.
// The wide route: ffn_f32_up_kernel, per 128-row tile and 64 hidden
// units, a | gate = r (x nscale) W_up[value, gate columns] in two
// accumulator sets, then h = a gelu(gate) in f32 into device memory;
// ffn_f32_down_kernel, per 128-row tile and 64 output columns, out = res +
// h W_down (A K-major, B MN-major).
// K10 in f32, three steps (the bf16 form's, geglu.cu) on gemm_tf32_wg.cuh's
// TF32 wgmma core, after W_up, W_up^T and W_down are copied rounded to TF32
// (tw::round_weights_kernel):
// (a) ffn_f32_dup_kernel: per row tile and hidden panel, the up product
//     recomputed and dh = g W_down^T, the GEGLU derivative in registers:
//     h^T and dup^T = (da, dgate)^T rounded, (once) xn and r, and the
//     per-row sums of dup (a, gate) for the RMS-norm VJP;
// (b) tw::dxn_kernel: dxn = dup W_up^T over K = 2 d_ff and the RMS-norm
//     VJP: dx (+ g, the residual) and the d(scale) partials;
// (c) tw::dw_kernel: dW_up = xn^T dup and dW_down = (g^T h)^T as split-K
//     f32 partials over row chunks, every partial summed in a fixed order.
// K5 in f32 runs the network as the wide route's kernels on the (b, d)
// activation, the batch one "image" whose scale is the block's own norm
// scale (a row stride of 0): rms_rows_kernel (x = RMSNorm(emb, in_scale)),
// per block ffn_f32_up_kernel and ffn_f32_down_kernel (x += GEGLU(RMSNorm(x,
// ns) W_up) W_down, the down product's depth split in chunks of 256 hidden
// units, whose partials add_parts_kernel sums with the residual),
// rms_rows_kernel (the out norm); 2 + 3 n kernels. It takes any width, d
// and d_ff multiples of 64: nothing is resident, where the bf16 form keeps
// each layer's share in a thread block cluster's shared memory.
#include <cooperative_groups.h>

#include "gemm_tf32.cuh"
#include "gemm_tf32_wg.cuh"

namespace kdt {
namespace {

constexpr float INV_SQRT_2PI = 0.3989422804014327f;
// hidden units of a chunk of K5's split down product
constexpr int MAP_CHUNK = 256;

// gelu(g) and d gelu(g) / dg for the exact (erf) GELU, one erf for both
__device__ __forceinline__ void gelu_erf_both(float g, float& gelu, float& grad) {
  const float cdf = 0.5f * (1.0f + erff(g * 0.70710678118654752440f));
  gelu = g * cdf;
  grad = cdf + g * INV_SQRT_2PI * __expf(-0.5f * g * g);
}

// h = a gelu(gate) for one row tile and 64 hidden units. Grid (images *
// tiles, d_ff / 64). nscale (images, d): image i's row at nscale + i *
// scale_stride (0: one scale for every row).
__global__ void __launch_bounds__(tg::THREADS)
ffn_f32_up_kernel(const float* __restrict__ x, const float* __restrict__ nscale, int scale_stride,
                  const float* __restrict__ w_up, float* __restrict__ h, int tokens, int d,
                  int d_ff, float eps) {
  extern __shared__ __align__(16) float smem[];
  float* s_ns = smem;
  const tg::RowTile t = tg::row_tile(tokens);
  const int u0 = 64 * blockIdx.y;
  tg::load_scale(nscale + static_cast<long>(t.img) * scale_stride, d, s_ns);
  float acc[2][8][4];
  tg::zero(acc);
  const int b0[2] = {u0, d_ff + u0};
  tg::Normed norm{s_ns};
  tg::mainloop<2>(acc, smem + d + tg::ROWS, x, d, t.row0, t.row0 + t.valid, w_up, 2L * d_ff, b0,
                  0, d, norm);
  float rows_r[2];
  tg::row_norms(norm, d, eps, rows_r);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = tg::acc_row(hh);
    if (row >= t.valid) continue;
    float* out = h + (t.row0 + row) * d_ff + u0 + 2 * tg::lane_t();
    const float r = rows_r[hh];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float a0 = acc[0][n][2 * hh] * r, a1 = acc[0][n][2 * hh + 1] * r;
      const float g0 = acc[1][n][2 * hh] * r, g1 = acc[1][n][2 * hh + 1] * r;
      *reinterpret_cast<float2*>(out + 8 * n) = make_float2(a0 * gelu_erf(g0), a1 * gelu_erf(g1));
    }
  }
}

// out = res + a W for one 128-row tile of a (rows, k_dim) and 64 columns of
// W (k_dim, n), rows = images * tokens. Grid (images * tiles, n / 64,
// splits): with part not null, block z takes the depth [z k_chunk, (z + 1)
// k_chunk) and writes its partial to part (splits, rows, n) instead, for
// add_parts_kernel (the mapping network's few rows: a split of the depth
// gives it more blocks than n / 64).
__global__ void __launch_bounds__(tg::THREADS)
ffn_f32_down_kernel(const float* __restrict__ a, const float* __restrict__ w,
                    const float* __restrict__ res, float* __restrict__ out,
                    float* __restrict__ part, int tokens, int k_dim, int n, int k_chunk) {
  extern __shared__ __align__(16) float smem[];
  const tg::RowTile t = tg::row_tile(tokens);
  const int n0 = 64 * blockIdx.y;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = k_begin + k_chunk < k_dim ? k_begin + k_chunk : k_dim;
  float acc[1][8][4];
  tg::zero(acc);
  const int b0[1] = {n0};
  tg::mainloop<1>(acc, smem, a, k_dim, t.row0, t.row0 + t.valid, w, n, b0, k_begin, k_end,
                  tg::Plain{});
  const long rows = static_cast<long>(gridDim.x / tg::tiles(tokens)) * tokens;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = tg::acc_row(hh);
    if (row >= t.valid) continue;
    const long at = (t.row0 + row) * n + n0 + 2 * tg::lane_t();
#pragma unroll
    for (int nn = 0; nn < 8; ++nn) {
      const float2 v = make_float2(acc[0][nn][2 * hh], acc[0][nn][2 * hh + 1]);
      if (part != nullptr) {
        *reinterpret_cast<float2*>(part + blockIdx.z * rows * n + at + 8 * nn) = v;
      } else {
        const float2 rv = *reinterpret_cast<const float2*>(res + at + 8 * nn);
        *reinterpret_cast<float2*>(out + at + 8 * nn) = make_float2(rv.x + v.x, rv.y + v.y);
      }
    }
  }
}

// out = res + the sum of the `splits` partials (splits, count), in split
// order: no atomics, a rerun is bit-equal.
__global__ void add_parts_kernel(const float* __restrict__ res, const float* __restrict__ part,
                                 float* __restrict__ out, long count, int splits) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = res[i];
  for (int z = 0; z < splits; ++z) s += part[z * count + i];
  out[i] = s;
}

// K10's first kernel in f32, on gemm_tf32_wg.cuh's core. An item is one
// row tile and hidden panel u of 64 units: a | gate = r ((x nscale) W_up)
// over the panel's value and gate columns (one N = 128 product, B from the
// rounded W_up^T) and dh = g W_down^T over its rows (N = 64, B the rounded
// W_down, K-major as it lies); h = a gelu(gate), da = dh gelu(gate), dgate
// = dh a gelu'(gate) (exact erf), each rounded to TF32 and written
// transposed into ht (d_ff, ld) and dupt (2 d_ff, ld), the B operands of
// the weight gradients; the per-row sum of dup (a, gate) over the panel's
// columns, unrounded, into dot_part (d_ff / 64, rows). Panel 0 writes xn
// and r.
__global__ void __launch_bounds__(tw::THREADS, 1)
ffn_f32_dup_kernel(const __grid_constant__ CUtensorMap map_x,
                   const __grid_constant__ CUtensorMap map_g,
                   const __grid_constant__ CUtensorMap map_upt,
                   const __grid_constant__ CUtensorMap map_down, const float* __restrict__ x,
                   const float* __restrict__ nscale, float* __restrict__ ht,
                   float* __restrict__ dupt, long ld, float* __restrict__ xn,
                   float* __restrict__ r_out, float* __restrict__ dot_part, long n_rows,
                   int images, int tokens, int d, int d_ff, float eps) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ tw::Ring ring;
  __shared__ float s_r[tw::ROWS];
  unsigned char* smem = wg::aligned_smem(smem_raw);
  float* s_ns = reinterpret_cast<float*>(smem + tw::S * tw::STAGE);
  float* s_t = s_ns + d;  // one output's (64, ROWS) transposed tile, staged
  tw::ring_init(ring);
  const int panels = d_ff / 64, steps = d / tw::BK;
  const tw::Items span = tw::my_items(images * tw::tiles(tokens) * panels);
  if (tw::is_producer()) {
    tw::producer_regs();
    if (!tw::tma_thread()) return;
    tw::Producer p{ring, smem};
    for (int item = span.begin; item < span.end; ++item) {
      const tw::RowTile t = tw::row_tile(tokens, item / panels);
      const int u0 = 64 * (item % panels);
      uint64_t* bar;
      for (int k = 0; k < steps; ++k) {  // the up product: x, then W_up^T's two slabs
        unsigned char* st = p.next(tw::K_TILE + tw::B_BYTES, bar);
        tw::tma(st, &map_x, tw::BK * k, t.row0, bar);
        tw::tma(st + tw::A_BYTES, &map_upt, tw::BK * k, u0, bar);
        tw::tma(st + tw::A_BYTES + tw::B_BYTES / 2, &map_upt, tw::BK * k, d_ff + u0, bar);
      }
      for (int k = 0; k < steps; ++k) {  // dh: g, then W_down's panel rows
        unsigned char* st = p.next(tw::K_TILE + tw::B_BYTES / 2, bar);
        tw::tma(st, &map_g, tw::BK * k, t.row0, bar);
        tw::tma(st + tw::A_BYTES, &map_down, tw::BK * k, u0, bar);
      }
    }
    return;
  }
  tw::consumer_regs();
  tw::Consumer c{ring, smem};
  int staged = -1;  // the image whose scale s_ns holds
  for (int item = span.begin; item < span.end; ++item) {
    const tw::RowTile t = tw::row_tile(tokens, item / panels);
    const int p = item % panels, u0 = 64 * p;
    if (t.img != staged) tw::stage_scale(nscale + static_cast<long>(t.img) * d, d, s_ns);
    staged = t.img;
    float up[64], dh[32];
    tw::zero(up);
    tw::zero(dh);
    tw::Normed norm{s_ns};
    tw::product<128>(up, c, steps, norm);
    tw::product<64>(dh, c, steps, tw::RoundedK{});
    float rows_r[2];
    norm.norms(d, eps, rows_r);
    // h, da, dgate at the thread's elements (i = 4 n + 2 hh + e: row hh,
    // column 8 n + 2 t + e of the panel) and the rows' dot partials
    float hv[32], da[32], dg[32];
    float dot[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float r = rows_r[i / 2 % 2];
      const float a = up[i] * r, gt = up[32 + i] * r, dhv = dh[i];
      float gl, grad;
      gelu_erf_both(gt, gl, grad);
      hv[i] = tw::round_tf32(a * gl);
      da[i] = dhv * gl;
      dg[i] = dhv * a * grad;
      dot[i / 2 % 2] += da[i] * a + dg[i] * gt;
      da[i] = tw::round_tf32(da[i]);
      dg[i] = tw::round_tf32(dg[i]);
    }
    // each output staged transposed, then stored coalesced
    const long at = t.row0 + static_cast<long>(u0) * ld;
    auto emit = [&](const float (&v)[32], float* dst) {
      float* st = s_t + 2 * tw::lane_t() * tw::ST_LD + tw::acc_row(0);
#pragma unroll
      for (int i = 0; i < 32; ++i) st[(8 * (i / 4) + i % 2) * tw::ST_LD + 8 * (i / 2 % 2)] = v[i];
      tw::consumers_sync();
      tw::store_t(s_t, dst + at, ld, t.valid);
      tw::consumers_sync();
    };
    emit(hv, ht);
    emit(da, dupt);
    emit(dg, dupt + static_cast<long>(d_ff) * ld);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float s = gemm::quad_sum(dot[hh]);
      if (tw::lane_t() == 0 && tw::acc_row(hh) < t.valid)
        dot_part[p * n_rows + t.row0 + tw::acc_row(hh)] = s;
    }
    if (p == 0) tw::write_xn(x, t, d, s_ns, rows_r, s_r, xn, r_out);
  }
}

// K4 in f32 on gemm_tf32_wg.cuh's core: the plan of an NO-column block,
// RES where the x tile is resident. Without it (d = 512) the two column
// slabs of a row tile pair up in the cluster and share h (PAIR).
template <int NO, bool RES>
struct FfnPlan {
  static constexpr bool PAIR = !RES;
  static constexpr int NU = NO == 256 ? 32 : 64;    // hidden units a panel
  static constexpr int NSUB = NO < 128 ? NO : 128;  // output columns a down product
  static constexpr int SUBS = NO / NSUB;
  static constexpr int DOWN = NU / tw::BK * SUBS;    // down steps a panel
  static constexpr int PLD = NO + 8;                 // the partial's row stride, floats
  // a ring stage: an up step's W_up^T rows (value, gate), after x's box
  // where x streams, or a down product's W_down^T rows
  static constexpr int XB = RES ? 0 : tw::K_TILE;
  static constexpr int UP_BYTES = XB + 2 * NU * tw::BK * 4;
  static constexpr int DOWN_BYTES = NSUB * tw::BK * 4;
  static constexpr int STAGE = RES ? 16384 : 24576;
  static_assert(UP_BYTES <= STAGE && DOWN_BYTES <= STAGE, "a stage holds a step");
  // PAIR: h's A fragments of a panel pair, two slots (HF words a thread)
  static constexpr int HF = NU / 2;
  static constexpr int H_BYTES = PAIR ? 2 * 2 * HF * 128 * tw::CONSUMERS * 4 : 0;
  // the dynamic shared memory a block may take: an H100's 227 KB less the
  // static barriers and row norms
  static constexpr int BUDGET = 232448 - 1024;
  __host__ __device__ static int x_bytes(int d) { return RES ? d / tw::BK * tw::K_TILE : 0; }
  // ring stages: as many as the rest holds, at most MAX_S
  __host__ __device__ static int stages(int d) {
    const int n = (BUDGET - 1024 - x_bytes(d) - H_BYTES - d * 4) / STAGE;
    return n < tw::MAX_S ? n : tw::MAX_S;
  }
  // where the h slots start: after the x tile and the ring
  __host__ __device__ static int h_at(int d) { return x_bytes(d) + stages(d) * STAGE; }
  // the bytes before the norm scale: the x tile, the ring and the h slots,
  // or the f32 partial that takes their place at the end
  __host__ __device__ static int body(int d) {
    const int prods = h_at(d) + H_BYTES, part = tw::ROWS * PLD * 4;
    return prods > part ? prods : part;
  }
  static size_t smem(int d) { return 1024 + body(d) + d * sizeof(float); }
};

// Waits, with the cluster's acquire, for the phase of `bar` with the given
// parity (arrivals from the cluster's other blocks).
__device__ __forceinline__ void cluster_wait(uint64_t* bar, int parity) {
  for (int i = 0;; ++i) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(tw::smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (i == 1 << 24) __trap();
  }
}

// This warp's arrival, its writes released to the cluster, on `bar` here
// and on the same barrier of the block of cluster rank `other`.
__device__ __forceinline__ void arrive_both(uint64_t* bar, int other) {
  __syncwarp();
  if ((threadIdx.x & 31) != 0) return;
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(tw::smem_u32(bar)), "r"(other));
  asm volatile("mbarrier.arrive.release.cluster.shared::cta.b64 _, [%0];\n" ::"r"(
                   tw::smem_u32(bar))
               : "memory");
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(remote)
               : "memory");
}

// K4 in f32 (the file's note). Clusters of G blocks (2 G with PAIR) along
// x of the grid (images * tiles * cluster, d / NO (1 with PAIR)): cluster
// i owns row tile i; a block owns the output columns [NO y, NO (y + 1))
// of its slab y (grid y, or with PAIR its cluster rank's parity) and, as
// group rank r (its cluster rank, or half of it with PAIR), the hidden
// panels r, r + G, ..., its list. map_x: x (rows, d), boxes of 128 rows;
// map_upt: the rounded W_up^T (2 d_ff, d), boxes of NU rows; map_downt:
// the rounded, permuted W_down^T (d, d_ff), boxes of NSUB rows. RES (d <=
// 256): the x tile lands once and is rounded in place as x nscale, the A
// operand of SS products; else x's box streams in each up stage, the A
// fragments made in registers (tw::Normed), and the list goes in pairs:
// the slab-y block forms h of the pair's panel y alone and writes its A
// fragments into its own and its partner's h slot (distributed shared
// memory), then both run the down products of the pair's two panels in
// list order from their slots, so that the up product is not formed
// twice. nscale (images, d): image i's row at nscale + i * scale_stride.
template <int NO, bool RES>
__global__ void __launch_bounds__(tw::THREADS, 1)
ffn_f32_fwd_kernel(const __grid_constant__ CUtensorMap map_x,
                   const __grid_constant__ CUtensorMap map_upt,
                   const __grid_constant__ CUtensorMap map_downt, const float* __restrict__ x,
                   const float* __restrict__ nscale, int scale_stride, float* __restrict__ out,
                   int tokens, int d, int d_ff, float eps) {
  namespace cg = cooperative_groups;
  using P = FfnPlan<NO, RES>;
  constexpr int NU = P::NU, NSUB = P::NSUB, SUBS = P::SUBS, XB = P::XB, HF = P::HF;
  constexpr int CT = 128 * tw::CONSUMERS;  // consumer threads
  extern __shared__ unsigned char smem_raw[];
  __shared__ tw::Ring ring;
  __shared__ uint64_t x_full;                  // the resident x tile has landed
  __shared__ uint64_t h_full[2], h_empty[2];   // PAIR: a slot written, read
  __shared__ float s_r[tw::ROWS];             // the resident tile's rows' r
  unsigned char* smem = wg::aligned_smem(smem_raw);
  unsigned char* ring_base = smem + P::x_bytes(d);
  uint32_t* s_h = reinterpret_cast<uint32_t*>(smem + P::h_at(d));  // [slot][panel][HF][CT]
  float* s_ns = reinterpret_cast<float*>(smem + P::body(d));
  float* s_part = reinterpret_cast<float*>(smem);  // (ROWS, PLD), at the end
  const int stages = P::stages(d);
  if (threadIdx.x == 0) {
    gemm::mbar_init(&x_full);
    for (int i = 0; i < 2; ++i) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(tw::smem_u32(&h_full[i])),
                   "r"(8 * tw::CONSUMERS)
                   : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(tw::smem_u32(&h_empty[i])),
                   "r"(8 * tw::CONSUMERS)
                   : "memory");
    }
  }
  tw::ring_init(ring, stages);  // its barrier also publishes the inits above
  cg::cluster_group cluster = cg::this_cluster();
  const int size = static_cast<int>(cluster.num_blocks());
  const int crank = static_cast<int>(cluster.block_rank());
  const int groups = P::PAIR ? size / 2 : size, rank = P::PAIR ? crank / 2 : crank;
  const int slab = P::PAIR ? crank % 2 : static_cast<int>(blockIdx.y), other = crank ^ 1;
  if (P::PAIR) cluster.sync();  // the partner's barriers are set up
  const tw::RowTile t = tw::row_tile(tokens, blockIdx.x / size);
  const int slab0 = NO * slab, steps = d / tw::BK;
  const int mine = (d_ff / NU - rank + groups - 1) / groups;  // this rank's list
  // the panels this block forms h of: every one, or its own of each pair
  auto forms = [&](int q) { return !P::PAIR || q % 2 == slab; };
  if (tw::is_producer()) {
    tw::producer_regs();
    if (tw::tma_thread()) {
      if (RES) {
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                         tw::smem_u32(&x_full)),
                     "r"(steps * tw::K_TILE)
                     : "memory");
        for (int k = 0; k < steps; ++k)
          tw::tma(smem + k * tw::K_TILE, &map_x, tw::BK * k, t.row0, &x_full);
      }
      tw::Producer p{ring, ring_base, 0, P::STAGE, stages};
      uint64_t* bar;
      auto up = [&](int q) {  // (x,) W_up^T's value and gate rows of panel q
        const int u0 = NU * (rank + q * groups);
        for (int k = 0; k < steps; ++k) {
          unsigned char* st = p.next(P::UP_BYTES, bar);
          if (!RES) tw::tma(st, &map_x, tw::BK * k, t.row0, bar);
          tw::tma(st + XB, &map_upt, tw::BK * k, u0, bar);
          tw::tma(st + XB + NU * tw::BK * 4, &map_upt, tw::BK * k, d_ff + u0, bar);
        }
      };
      auto down = [&](int q) {  // the slab's W_down^T rows at panel q's units
        const int u0 = NU * (rank + q * groups);
        for (int k = 0; k < NU / tw::BK; ++k)
#pragma unroll
          for (int s = 0; s < SUBS; ++s) {
            unsigned char* st = p.next(P::DOWN_BYTES, bar);
            tw::tma(st, &map_downt, u0 + tw::BK * k, slab0 + NSUB * s, bar);
          }
      };
      const int span = P::PAIR ? 2 : 1;
      for (int q0 = 0; q0 < mine; q0 += span) {
        for (int q = q0; q < q0 + span && q < mine; ++q)
          if (forms(q)) up(q);
        for (int q = q0; q < q0 + span && q < mine; ++q) down(q);
      }
    }
    __syncwarp();
    cluster.sync();  // every rank's partial is in place
    cluster.sync();  // every rank is done reading them
    return;
  }
  tw::consumer_regs();
  tw::Consumer c{ring, ring_base, 0, stages};
  tw::stage_scale(nscale + static_cast<long>(t.img) * scale_stride, d, s_ns);
  float r[2] = {0.f, 0.f};
  if (RES) {
    // x nscale rounded in place, two threads a row, and the rows' r
    gemm::mbar_wait(&x_full, 0);
    const int row = threadIdx.x >> 1;
    float ss = 0.f;
    for (int col = 4 * (threadIdx.x & 1); col < d; col += 8) {
      float4* at = reinterpret_cast<float4*>(smem + (col >> 5) * tw::K_TILE + row * 128 +
                                             ((((col >> 2) & 7) ^ (row & 7)) << 4));
      const float4 v = *at, n = *reinterpret_cast<const float4*>(s_ns + col);
      ss += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
      *at = make_float4(tw::round_tf32(v.x * n.x), tw::round_tf32(v.y * n.y),
                        tw::round_tf32(v.z * n.z), tw::round_tf32(v.w * n.w));
    }
    ss += __shfl_xor_sync(0xffffffffu, ss, 1);
    if ((threadIdx.x & 1) == 0) s_r[row] = rsqrtf(ss / d + eps);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the tile feeds wgmma
    tw::consumers_sync();
    r[0] = s_r[tw::acc_row(0)];
    r[1] = s_r[tw::acc_row(1)];
  }
  float o[SUBS][NSUB / 2];  // the output tiles
#pragma unroll
  for (int s = 0; s < SUBS; ++s) tw::zero(o[s]);
  // the warpgroup's 64 rows of the resident tile
  const unsigned char* x_rows = smem + 64 * 128 * (threadIdx.x / 128);
  bool have_r = RES;
  uint32_t hf[NU / 8][4];  // h of a panel as the down product's A fragments
  // hf = h of list panel q: a | gate = r ((x nscale) W_up) (N = 2 NU), h =
  // a gelu(gate) rounded; element 4 i + 2 hh + e of the accumulator (row
  // hh, unit 8 i + 2 t + e) is k8 slice i's depth t + 4 e
  auto form_h = [&]() {
    float up[NU];
    if constexpr (RES) {
      tw::chained(c, steps, P::STAGE, [&](const unsigned char* stage, int k) {
        const uint64_t a = tw::desc(x_rows + k * tw::K_TILE), b = tw::desc(stage);
#pragma unroll
        for (int i = 0; i < 4; ++i) tw::mma_ss<2 * NU>(up, a + 2 * i, b + 2 * i, k > 0 || i > 0);
        wg::fence_regs(up);
      });
    } else {
      tw::Normed norm{s_ns};
      tw::stepwise(
          c, steps, P::STAGE,
          [&](const unsigned char* stage, int k, uint32_t(&a)[4][4]) {
#pragma unroll
            for (int i = 0; i < 4; ++i) norm(stage, k, i, a[i]);
          },
          [&](const unsigned char* stage, int k, const uint32_t(&a)[4][4]) {
            const uint64_t b = tw::desc(stage + XB);
#pragma unroll
            for (int i = 0; i < 4; ++i) tw::mma<2 * NU>(up, a[i], b + 2 * i, k > 0 || i > 0);
            wg::fence_regs(up);
          });
      if (!have_r) norm.norms(d, eps, r);
      have_r = true;
    }
    wg::fence_regs(up);  // read after the walk's last wait
#pragma unroll
    for (int i = 0; i < NU / 8; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int at = 4 * i + 2 * hh + e;
          hf[i][2 * e + hh] = tw::to_tf32(up[at] * r[hh] * gelu_erf(up[at + NU / 2] * r[hh]));
        }
  };
  // o += h W_down[panel]: depth chunk k / SUBS of the panel, output columns
  // [NSUB s, NSUB (s + 1)) of the slab, s = k % SUBS
  auto down = [&]() {
    tw::chained<P::DOWN>(c, 0, P::STAGE, [&](const unsigned char* stage, int k) {
      const uint64_t b = tw::desc(stage);
      const int s = k % SUBS;
#pragma unroll
      for (int i = 0; i < 4; ++i) tw::mma<NSUB>(o[s], hf[4 * (k / SUBS) + i], b + 2 * i, 1);
      wg::fence_regs(o[s]);
    });
#pragma unroll
    for (int s = 0; s < SUBS; ++s) wg::fence_regs(o[s]);  // read after the last wait
  };
  if constexpr (!P::PAIR) {
    for (int q = 0; q < mine; ++q) {
      form_h();
      down();
    }
  } else {
    const int tid = threadIdx.x;
    uint32_t* far = cluster.map_shared_rank(s_h, other);
    for (int q0 = 0, j = 0; q0 < mine; q0 += 2, ++j) {
      const int slot = j & 1, q = q0 + slab;
      if (q < mine) {  // this block's panel of the pair, into both slots
        form_h();
        if (j >= 2) cluster_wait(&h_empty[slot], ((j >> 1) - 1) & 1);
        const int at = (slot * 2 + slab) * HF * CT + tid;
#pragma unroll
        for (int e = 0; e < HF; ++e) {
          s_h[at + e * CT] = hf[e / 4][e % 4];
          far[at + e * CT] = hf[e / 4][e % 4];
        }
      }
      arrive_both(&h_full[slot], other);
      cluster_wait(&h_full[slot], (j >> 1) & 1);
      for (int p = 0; p < 2 && q0 + p < mine; ++p) {
        const int at = (slot * 2 + p) * HF * CT + tid;
#pragma unroll
        for (int e = 0; e < HF; ++e) hf[e / 4][e % 4] = s_h[at + e * CT];
        down();
      }
      arrive_both(&h_empty[slot], other);
    }
  }
  tw::consumers_sync();  // every product is done: the tiles take the partial
#pragma unroll
  for (int s = 0; s < SUBS; ++s)
#pragma unroll
    for (int i = 0; i < NSUB / 8; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(s_part + tw::acc_row(hh) * P::PLD + NSUB * s + 8 * i +
                                   2 * tw::lane_t()) =
            make_float2(o[s][4 * i + 2 * hh], o[s][4 * i + 2 * hh + 1]);
  cluster.sync();  // every rank's partial is in place
  // this rank's rows: the sum over the slab's ranks' partials in rank
  // order, + x, FLY 16-byte words a thread at a time, their loads issued
  // together
  constexpr int CH = NO / 4, FLY = 8;
  const int first = tw::ROWS * rank / groups, last = tw::ROWS * (rank + 1) / groups;
  const int words = ((t.valid < last ? t.valid : last) - first) * CH;
  for (int i0 = threadIdx.x; i0 < words; i0 += FLY * CT) {
    float4 v[FLY], xv[FLY];
#pragma unroll
    for (int u = 0; u < FLY; ++u) {
      const int i = i0 + u * CT;
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < words)
        xv[u] = *reinterpret_cast<const float4*>(x + (t.row0 + first + i / CH) * d + slab0 +
                                                 4 * (i % CH));
    }
    for (int g = 0; g < groups; ++g) {  // rank order
      const float* part = cluster.map_shared_rank(s_part, P::PAIR ? 2 * g + slab : g);
#pragma unroll
      for (int u = 0; u < FLY; ++u) {
        const int i = i0 + u * CT;
        if (i >= words) break;
        const float4 pv =
            *reinterpret_cast<const float4*>(part + (first + i / CH) * P::PLD + 4 * (i % CH));
        v[u].x += pv.x;
        v[u].y += pv.y;
        v[u].z += pv.z;
        v[u].w += pv.w;
      }
    }
#pragma unroll
    for (int u = 0; u < FLY; ++u) {
      const int i = i0 + u * CT;
      if (i >= words) break;
      *reinterpret_cast<float4*>(out + (t.row0 + first + i / CH) * d + slab0 + 4 * (i % CH)) =
          make_float4(v[u].x + xv[u].x, v[u].y + xv[u].y, v[u].z + xv[u].z, v[u].w + xv[u].w);
    }
  }
  cluster.sync();  // no block leaves while another reads its partial
}

// out (rows, d) = x * (scale / rms(x)), a warp a row.
__global__ void rms_rows_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                                float* __restrict__ out, int rows, int d, float eps) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32, lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* xr = x + static_cast<long>(row) * d;
  float ss = 0.f;
  for (int c = lane; c < d; c += 32) ss += xr[c] * xr[c];
  const float r = rsqrtf(warp_sum(ss) / d + eps);
  for (int c = lane; c < d; c += 32) out[static_cast<long>(row) * d + c] = xr[c] * (scale[c] * r);
}

cudaError_t launch_up(const float* x, const float* nscale, int scale_stride, const float* w_up,
                      float* h, int images, int tokens, int d, int d_ff, float eps,
                      cudaStream_t st) {
  const size_t smem = tg::normed_smem<2>(d);
  const cudaError_t err = allow_smem(ffn_f32_up_kernel, smem);
  if (err != cudaSuccess) return err;
  ffn_f32_up_kernel<<<dim3(images * tg::tiles(tokens), d_ff / 64), tg::THREADS, smem, st>>>(
      x, nscale, scale_stride, w_up, h, tokens, d, d_ff, eps);
  return cudaGetLastError();
}

// out = res + a W; with part, the depth splits in chunks of k_chunk (a
// multiple of 32), partials in part, summed by add_parts_kernel.
cudaError_t launch_down(const float* a, const float* w, const float* res, float* out, int images,
                        int tokens, int k_dim, int n, cudaStream_t st, float* part = nullptr,
                        int k_chunk = 0) {
  cudaError_t err = allow_smem(ffn_f32_down_kernel, tg::RING_BYTES<1>);
  if (err != cudaSuccess) return err;
  const int splits = part == nullptr ? 1 : (k_dim + k_chunk - 1) / k_chunk;
  ffn_f32_down_kernel<<<dim3(images * tg::tiles(tokens), n / 64, splits), tg::THREADS,
                        tg::RING_BYTES<1>, st>>>(a, w, res, out, part, tokens, k_dim, n,
                                                 part == nullptr ? k_dim : k_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess || part == nullptr) return err;
  const long count = static_cast<long>(images) * tokens * n;
  add_parts_kernel<<<static_cast<unsigned>((count + 255) / 256), 256, 0, st>>>(res, part, out,
                                                                              count, splits);
  return cudaGetLastError();
}

cudaError_t launch_rms_rows(const float* x, const float* scale, float* out, int rows, int d,
                            float eps, cudaStream_t st) {
  rms_rows_kernel<<<(rows + 7) / 8, 256, 0, st>>>(x, scale, out, rows, d, eps);
  return cudaGetLastError();
}

// The launch of K4 in f32 with the hidden panels over clusters of `groups`
// blocks; with `clusters`, it is not launched and the number of clusters
// that fit on the device at once goes there instead.
template <int NO, bool RES>
cudaError_t launch_ffn_fwd(const float* x, const float* nscale, int scale_stride,
                           const float* upt, const float* downt, float* out, int images,
                           int tokens, int d, int d_ff, int groups, float eps, cudaStream_t st,
                           int* clusters) {
  const size_t smem = FfnPlan<NO, RES>::smem(d);
  cudaError_t err = allow_smem(ffn_f32_fwd_kernel<NO, RES>, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  const int size = FfnPlan<NO, RES>::PAIR ? 2 * groups : groups;  // blocks a cluster
  cluster.val.clusterDim.x = size;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(images * tw::tiles(tokens) * size, FfnPlan<NO, RES>::PAIR ? 1 : d / NO);
  cfg.blockDim = dim3(tw::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  if (clusters != nullptr)
    return cudaOccupancyMaxActiveClusters(clusters, ffn_f32_fwd_kernel<NO, RES>, &cfg);
  const long rows = static_cast<long>(images) * tokens;
  CUtensorMap map_x, map_upt, map_downt;
  err = tw::map_f32(&map_x, x, rows, d, d, tw::ROWS);
  if (err == cudaSuccess) err = tw::map_f32(&map_upt, upt, 2 * d_ff, d, d, FfnPlan<NO, RES>::NU);
  if (err == cudaSuccess)
    err = tw::map_f32(&map_downt, downt, d, d_ff, d_ff, FfnPlan<NO, RES>::NSUB);
  if (err != cudaSuccess) return err;
  return cudaLaunchKernelEx(&cfg, ffn_f32_fwd_kernel<NO, RES>, map_x, map_upt, map_downt, x,
                            nscale, scale_stride, out, tokens, d, d_ff, eps);
}

}  // namespace
}  // namespace kdt

using namespace kdt;

// K4 in f32 in one launch, at d = 64, 128, 256 or 512. x (rows, d) f32
// with rows = images * tokens; nscale (images, d) f32, image i's row at
// nscale + i * scale_stride (scale_stride >= d, a multiple of 4: a
// condcache row's block, read in place); w_up (d, 2 d_ff), w_down (d_ff,
// d) f32; out (rows, d) f32. Scratch f32: w_upt (2 d_ff, d) and w_downt
// (d, d_ff), the rounded W_up^T and W_down^T (its depth in depth_pos
// order). The hidden panels (d_ff / 64, or d_ff / 32 at d = 256 and 512)
// split over `groups` blocks of a cluster (1 to 8, at most the panels; at
// d = 512 1 to 4, the cluster 2 groups blocks, its two column slabs).
// With `clusters` not null nothing is launched: the number of clusters
// that fit on the device at once is written there. Needs d_ff % 64 == 0.
extern "C" int kdt_ffn_fwd_f32(const void* x, const void* nscale, const void* w_up,
                               const void* w_down, void* out, void* w_upt, void* w_downt,
                               int images, int tokens, int d, int d_ff, int groups,
                               int scale_stride, float eps, void* stream, int* clusters) {
  const int units = d >= 256 ? 32 : 64;
  if ((d != 64 && d != 128 && d != 256 && d != 512) || d_ff % 64 || groups < 1 ||
      groups > (d == 512 ? 4 : 8) || groups > d_ff / units || scale_stride < d || scale_stride % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  cudaError_t err = cudaSuccess;
  if (clusters == nullptr) {
    err = tw::launch_round(f(w_up), d, 2 * d_ff, nullptr, o(w_upt), st);
    if (err == cudaSuccess) err = tw::launch_round(f(w_down), d_ff, d, nullptr, o(w_downt), st, true);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
#define KDT_FFN_FWD_F32(NO, RES)                                                            \
  err = launch_ffn_fwd<NO, RES>(f(x), f(nscale), scale_stride, f(w_upt), f(w_downt), o(out), \
                                images, tokens, d, d_ff, groups, eps, st, clusters)
  switch (d) {
    case 64: KDT_FFN_FWD_F32(64, true); break;
    case 128: KDT_FFN_FWD_F32(128, true); break;
    case 256: KDT_FFN_FWD_F32(256, true); break;
    default: KDT_FFN_FWD_F32(256, false); break;
  }
#undef KDT_FFN_FWD_F32
  return static_cast<int>(err);
}

// K4 in f32 on its wide route (any d and d_ff multiples of 64; the
// wrapper takes it past d = 512): x, nscale, scale_stride, w_up, w_down
// and out as kdt_ffn_fwd_f32's; h (rows, d_ff) f32 scratch.
extern "C" int kdt_ffn_fwd_f32_wide(const void* x, const void* nscale, const void* w_up,
                                    const void* w_down, void* out, void* h, int images,
                                    int tokens, int d, int d_ff, int scale_stride, float eps,
                                    void* stream) {
  if (d % 64 || d_ff % 64 || scale_stride < d || scale_stride % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* hf = static_cast<float*>(h);
  cudaError_t err = launch_up(xf, static_cast<const float*>(nscale), scale_stride,
                              static_cast<const float*>(w_up), hf, images, tokens, d, d_ff, eps,
                              st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_down(hf, static_cast<const float*>(w_down), xf,
                                      static_cast<float*>(out), images, tokens, d_ff, d, st));
}

// K10 in f32. x, g (rows, d) f32 with rows = images * tokens; nscale
// (images, d) f32; w_up (d, 2 d_ff), w_down (d_ff, d) f32. Writes dx (rows,
// d) (the residual's g included), dscale (images, d), dw_up (d, 2 d_ff) and
// dw_down (d_ff, d) f32. Scratch f32: the rounded weights w_upt (2 d_ff, d),
// w_up_r (d, 2 d_ff) and w_down_r (d_ff, d); ht (d_ff, ld), dupt (2 d_ff,
// ld), xn (rows, d), r (rows), dot_part (d_ff / 64, rows), dns_part (images
// * tiles, d) and dw_part, which holds the larger of ceil(rows / chunk_up)
// * 2 d d_ff and ceil(rows / chunk_down) * d d_ff floats (dw_down's
// partials reuse it); tiles = ceil(tokens / tw::ROWS), the count the
// caller sized dns_part for (refused if it differs); ld >= rows, a
// multiple of 4 (a 16-byte row pitch for the copy engine); chunk_up and
// chunk_down multiples of 32. Needs d, d_ff % 64 == 0.
extern "C" int kdt_ffn_bwd_f32(const void* x, const void* nscale, const void* w_up,
                               const void* w_down, const void* g, void* dx, void* dscale,
                               void* dw_up, void* dw_down, void* w_upt, void* w_up_r,
                               void* w_down_r, void* ht, void* dupt, void* xn, void* r,
                               void* dot_part, void* dns_part, void* dw_part, int images,
                               int tokens, int tiles, int d, int d_ff, long ld, long chunk_up,
                               long chunk_down, float eps, void* stream) {
  const long rows = static_cast<long>(images) * tokens;
  if (d % 64 || d_ff % 64 || chunk_up < 1 || chunk_down < 1 || chunk_up % 32 ||
      chunk_down % 32 || tiles != tw::tiles(tokens) || ld < rows || ld % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  float *upt = o(w_upt), *up_r = o(w_up_r), *down_r = o(w_down_r);
  cudaError_t err = tw::launch_round(f(w_up), d, 2 * d_ff, up_r, upt, st);
  if (err == cudaSuccess) err = tw::launch_round(f(w_down), d_ff, d, down_r, nullptr, st);
  CUtensorMap map_x, map_g, map_upt, map_down;
  if (err == cudaSuccess) err = tw::map_f32(&map_x, f(x), rows, d, d, tw::ROWS);
  if (err == cudaSuccess) err = tw::map_f32(&map_g, f(g), rows, d, d, tw::ROWS);
  if (err == cudaSuccess) err = tw::map_f32(&map_upt, upt, 2 * d_ff, d, d, 64);
  if (err == cudaSuccess) err = tw::map_f32(&map_down, down_r, d_ff, d, d, 64);
  const size_t smem = tw::RING_SMEM + d * sizeof(float) + tw::STAGING;
  if (err == cudaSuccess) err = allow_smem(ffn_f32_dup_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long items = static_cast<long>(images) * tiles * (d_ff / 64);
  ffn_f32_dup_kernel<<<tw::grid(items), tw::THREADS, smem, st>>>(
      map_x, map_g, map_upt, map_down, f(x), f(nscale), o(ht), o(dupt), ld, o(xn), o(r),
      o(dot_part), rows, images, tokens, d, d_ff, eps);
  err = cudaGetLastError();
  if (err == cudaSuccess)
    err = tw::launch_dxn(o(dupt), ld, up_r, f(x), f(nscale), f(g), o(r), o(dot_part), d_ff / 64,
                         o(dx), o(dns_part), o(dscale), images, tokens, d, 2 * d_ff, st);
  if (err == cudaSuccess)
    err = tw::launch_dw(o(xn), o(dupt), ld, o(dw_part), o(dw_up), false, rows, d, 2 * d_ff,
                        chunk_up, st);
  // dW_down = h^T g as its transpose g^T h, written back as (d_ff, d)
  if (err == cudaSuccess)
    err = tw::launch_dw(f(g), o(ht), ld, o(dw_part), o(dw_down), true, rows, d, d_ff, chunk_down,
                        st);
  return static_cast<int>(err);
}

// K5 in f32. emb (b, d) f32; in_scale, out_scale (d,) f32; weights: 3 n
// pointers, each block's norm scale (d,), W_up (d, 2 d_ff) and W_down
// (d_ff, d), all f32; out (b, d) f32. Scratch f32: xa, xb (b, d), h (b,
// d_ff) and part (ceil(d_ff / MAP_CHUNK), b, d), the down product's
// partials over chunks of MAP_CHUNK hidden units. Needs d, d_ff % 64 == 0
// and 1 <= n.
extern "C" int kdt_mapping_f32(const void* emb, const void* in_scale, const void* out_scale,
                               const void* const* weights, void* out, void* xa, void* xb,
                               void* h, void* part, int b, int d, int d_ff, int n_blocks,
                               float eps, void* stream) {
  if (d % 64 || d_ff % 64 || n_blocks < 1 || b < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float *x = static_cast<float*>(xa), *y = static_cast<float*>(xb), *hf = static_cast<float*>(h);
  float* parts = static_cast<float*>(part);
  cudaError_t err = launch_rms_rows(static_cast<const float*>(emb),
                                    static_cast<const float*>(in_scale), x, b, d, eps, st);
  for (int l = 0; l < n_blocks && err == cudaSuccess; ++l) {
    const float* ns = static_cast<const float*>(weights[3 * l]);
    const float* up = static_cast<const float*>(weights[3 * l + 1]);
    const float* down = static_cast<const float*>(weights[3 * l + 2]);
    err = launch_up(x, ns, 0, up, hf, 1, b, d, d_ff, eps, st);
    if (err == cudaSuccess)
      err = launch_down(hf, down, x, y, 1, b, d_ff, d, st, parts, MAP_CHUNK);
    float* swap = x;
    x = y;
    y = swap;
  }
  if (err == cudaSuccess)
    err = launch_rms_rows(x, static_cast<const float*>(out_scale), static_cast<float*>(out), b, d,
                          eps, st);
  return static_cast<int>(err);
}

KDT_DEFINE_ERROR_STRING
