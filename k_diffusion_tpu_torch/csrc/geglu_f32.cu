// The GEGLU kernels in float32, the kernels of --mixed-precision no: the
// HDiT feed-forward block, forward (K4 in f32) and backward (K10 in f32),
// and the whole mapping network (K5 in f32), all on gemm_tf32_wg.cuh's
// TF32 wgmma core: K4 in one launch at d = 64, 128, 256 and 512 and on its
// wide route at other widths (768, the widest shipped level, and any
// width past 512), K5 in one launch.
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
// - FF block on the wide route (config_512_hdit's 768 level, 8 x 256
//   tokens, d_ff 2304): 21.7 GFLOP, 44 us at TF32's rate, against 34 MB of
//   x, out and weights: bound by the tensor cores; h (18.9 MB) goes through
//   device memory once each way.
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
// The wide route, two kernels after the same weight copies (W_down^T's
// depth in order): ffn_f32_wide_up_kernel, per 128-row tile and 64 hidden
// units, a | gate = r ((x nscale) W_up) in one N = 128 product (x and the
// W_up^T slabs by TMA, x's A fragments rounded as read) and h = a
// gelu(gate) rounded to TF32 once into device memory, in 16-byte words;
// ffn_f32_wide_down_kernel, per 128-row tile and 128 (or 64) output
// columns, out = x + h W_down, both operands K-major TMA boxes (h the
// shared-memory A of the SS form). One design takes every width multiple
// of 64: a block's registers hold one output tile, and nothing grows
// with d but the staged norm scale.
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
// K5 in f32 (mapping_f32_kernel<N>), one launch on the bf16 form's plan
// (geglu.cu's mapping_kernel): a thread block cluster of `ranks` blocks
// (up to 16) a strip of N batch rows (N = 8, 16, 32 or 64: wgmma's N, the
// batch rounded up to a multiple of 8, narrowed where a strip's xn and
// partials would crowd out the ring); rank r owns the pairs of 32-unit
// hidden panels [P r / ranks, P (r + 1) / ranks) of P = d_ff / 64 and, of
// the strip's rows, n = r, r + ranks, ...: their f32 residual x and next
// xn. The batch cannot fill wgmma's 64 rows, so the products are swapped
// to make the weights the M side, read as the model holds them (no
// transposed copy, no extra launch):
// - up, per pair: (a | gate)^T = W_up^T xn^T. A is W_up's (32 depth x 32
//   units) boxes as TMA lands them (MN-major), read through registers and
//   rounded as read: warpgroup w takes the pair's panel w, its value box
//   as rows g and its gate box as rows g + 8 of each warp's 16, so that a
//   thread holds a and gate of one unit for the same batch rows; B is xn^T,
//   the strip's xn rounded and K-major in shared memory (xs). The GEGLU
//   runs in registers and h = a gelu(gate) is written rounded, K-major,
//   into the panel's tile of hs.
// - down, per 128 output features: out^T = W_down^T h^T over the rank's
//   panels, A W_down's boxes (MN-major, rounded as read), B the h tiles;
//   the f32 partial (N, d) goes into xs, whose xn the up products are done
//   with.
// Every weight box of the rank, every block of the network, goes through
// one ring of up to 16 stages of 16 KB that the producer thread fills by
// TMA from the top, as far as it holds them, and refills as stages free.
// Then, among the consumers (the producer may be waiting on the next
// block's stages): a cluster barrier (mbarriers at cluster scope); each
// owner sums its rows' partials over the ranks in rank order (distributed
// shared memory), adds x, and forms the next block's xn = RMSNorm(x, ns)
// rounded (after the last block, the output RMSNorm(x, out_scale)); a
// second barrier; each rank pulls the strip's xn from the owners into its
// xs. No atomics: a rerun is bit-equal. Products as gemm_tf32_wg.cuh's
// stepwise walk (making a step's A fragments while the step before's
// products ran was 3-5% slower on an H100). The prologue, x =
// RMSNorm(emb, in_scale) and the first xn, runs on the owners the same
// way. Widths: d, d_ff multiples of 64, as long as a strip of 8 rows
// leaves two ring stages (MapLayout: up to d 4 480 at d_ff 8 192).
#include <cooperative_groups.h>

#include "gemm_tf32_wg.cuh"

namespace kdt {
namespace {

constexpr float INV_SQRT_2PI = 0.3989422804014327f;

// gelu(g) and d gelu(g) / dg for the exact (erf) GELU, one erf for both
__device__ __forceinline__ void gelu_erf_both(float g, float& gelu, float& grad) {
  const float cdf = 0.5f * (1.0f + erff(g * 0.70710678118654752440f));
  gelu = g * cdf;
  grad = cdf + g * INV_SQRT_2PI * __expf(-0.5f * g * g);
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

// ---- K4 in f32, its wide route ----------------------------------------------------

// The staged h tile's row stride, floats: a 16-byte row start and, for the
// float2 stores of a warp (8 rows 68 floats apart by 4 column pairs), 32
// banks.
constexpr int H_LD = 64 + 4;

// The wide route's first kernel: per 128-row tile and hidden panel of 64
// units (an item; a block walks a contiguous share, so that neighbours
// share a row tile), a | gate = r ((x nscale) W_up) over the panel's value
// and gate columns in one N = 128 product (ffn_f32_dup_kernel's up
// product: x's box and the rounded W_up^T's two slabs a ring stage, the A
// fragments made in registers by tw::Normed), then h = a gelu(gate)
// (exact erf) rounded to TF32 once, staged in shared memory and stored
// into h (rows, d_ff) in 16-byte words. map_x: x (rows, d), boxes of 128
// rows; map_upt: the rounded W_up^T (2 d_ff, d), boxes of 64 rows. nscale
// (images, d): image i's row at nscale + i * scale_stride.
__global__ void __launch_bounds__(tw::THREADS, 1)
ffn_f32_wide_up_kernel(const __grid_constant__ CUtensorMap map_x,
                       const __grid_constant__ CUtensorMap map_upt,
                       const float* __restrict__ nscale, int scale_stride, float* __restrict__ h,
                       int images, int tokens, int d, int d_ff, float eps) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ tw::Ring ring;
  unsigned char* smem = wg::aligned_smem(smem_raw);
  float* s_ns = reinterpret_cast<float*>(smem + tw::S * tw::STAGE);
  float* s_h = s_ns + d;  // the item's h tile, (ROWS, H_LD)
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
      for (int k = 0; k < steps; ++k) {
        uint64_t* bar;
        unsigned char* st = p.next(tw::K_TILE + tw::B_BYTES, bar);
        tw::tma(st, &map_x, tw::BK * k, t.row0, bar);
        tw::tma(st + tw::A_BYTES, &map_upt, tw::BK * k, u0, bar);
        tw::tma(st + tw::A_BYTES + tw::B_BYTES / 2, &map_upt, tw::BK * k, d_ff + u0, bar);
      }
    }
    return;
  }
  tw::consumer_regs();
  tw::Consumer c{ring, smem};
  int staged = -1;  // the image whose scale s_ns holds
  for (int item = span.begin; item < span.end; ++item) {
    const tw::RowTile t = tw::row_tile(tokens, item / panels);
    const int u0 = 64 * (item % panels);
    if (t.img != staged) tw::stage_scale(nscale + static_cast<long>(t.img) * scale_stride, d, s_ns);
    staged = t.img;
    float up[64];
    tw::zero(up);
    tw::Normed norm{s_ns};
    tw::product<128>(up, c, steps, norm);
    float r[2];
    norm.norms(d, eps, r);
    // element i = 4 n + 2 hh + e: row hh, unit 8 n + 2 t + e (a; its gate
    // 32 elements on)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const float rr = r[i / 2 % 2];
      *reinterpret_cast<float2*>(s_h + tw::acc_row(i / 2 % 2) * H_LD + 8 * (i / 4) +
                                 2 * tw::lane_t()) =
          make_float2(tw::round_tf32(up[i] * rr * gelu_erf(up[32 + i] * rr)),
                      tw::round_tf32(up[i + 1] * rr * gelu_erf(up[33 + i] * rr)));
    }
    tw::consumers_sync();
    for (int w = threadIdx.x; w < tw::ROWS * 16; w += 128 * tw::CONSUMERS) {
      const int row = w / 16, c4 = 4 * (w % 16);
      if (row < t.valid)
        *reinterpret_cast<float4*>(h + (t.row0 + row) * d_ff + u0 + c4) =
            *reinterpret_cast<const float4*>(s_h + row * H_LD + c4);
    }
    tw::consumers_sync();  // s_h is free again
  }
}

// The wide route's second kernel: out = x + h W_down per 128-row tile and
// NB output columns (an item). Both operands lie K-major in the ring: the
// h tile (a TMA box of 128 rows, already rounded) is the shared-memory A
// operand of the SS form, each warpgroup 64 of its rows, and the rounded
// W_down^T's NB rows are B. No fragment is made in registers, so the walk
// is tw::chained (the next step's products issued before the last's are
// waited for; a rerun sums in the same order). map_h: h (rows, d_ff),
// boxes of 128 rows; map_downt: the rounded W_down^T (d, d_ff), boxes of
// NB rows.
template <int NB>
__global__ void __launch_bounds__(tw::THREADS, 1)
ffn_f32_wide_down_kernel(const __grid_constant__ CUtensorMap map_h,
                         const __grid_constant__ CUtensorMap map_downt,
                         const float* __restrict__ x, float* __restrict__ out, int images,
                         int tokens, int d, int d_ff) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ tw::Ring ring;
  unsigned char* smem = wg::aligned_smem(smem_raw);
  tw::ring_init(ring);
  const int n_tiles = (d + NB - 1) / NB, steps = d_ff / tw::BK;
  const tw::Items span = tw::my_items(images * tw::tiles(tokens) * n_tiles);
  if (tw::is_producer()) {
    tw::producer_regs();
    if (!tw::tma_thread()) return;
    tw::Producer p{ring, smem};
    for (int item = span.begin; item < span.end; ++item) {
      const tw::RowTile t = tw::row_tile(tokens, item / n_tiles);
      const int n0 = NB * (item % n_tiles);
      for (int k = 0; k < steps; ++k) {
        uint64_t* bar;
        unsigned char* st = p.next(tw::K_TILE + NB * tw::BK * 4, bar);
        tw::tma(st, &map_h, tw::BK * k, t.row0, bar);
        tw::tma(st + tw::A_BYTES, &map_downt, tw::BK * k, n0, bar);
      }
    }
    return;
  }
  tw::consumer_regs();
  tw::Consumer c{ring, smem};
  const int a_rows = 64 * 128 * (threadIdx.x / 128);  // the warpgroup's rows of the h box
  for (int item = span.begin; item < span.end; ++item) {
    const tw::RowTile t = tw::row_tile(tokens, item / n_tiles);
    const int n0 = NB * (item % n_tiles);
    float acc[NB / 2];
    tw::zero(acc);
    tw::chained(c, steps, tw::STAGE, [&](const unsigned char* stage, int k) {
      const uint64_t a = tw::desc(stage + a_rows), b = tw::desc(stage + tw::A_BYTES);
#pragma unroll
      for (int i = 0; i < 4; ++i) tw::mma_ss<NB>(acc, a + 2 * i, b + 2 * i, k > 0 || i > 0);
      wg::fence_regs(acc);
    });
    wg::fence_regs(acc);  // read after the walk's last wait
#pragma unroll
    for (int i = 0; i < NB / 8; ++i) {
      const int col = n0 + 8 * i + 2 * tw::lane_t();
      if (col >= d) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (tw::acc_row(hh) >= t.valid) continue;
        const long at = (t.row0 + tw::acc_row(hh)) * d + col;
        const float2 xv = *reinterpret_cast<const float2*>(x + at);
        *reinterpret_cast<float2*>(out + at) =
            make_float2(xv.x + acc[4 * i + 2 * hh], xv.y + acc[4 * i + 2 * hh + 1]);
      }
    }
  }
}

// ---- K5 in f32 -------------------------------------------------------------------------

constexpr int MAP_MAX_DEPTH = 8;           // blocks of the network (fused_mapping.MAX_DEPTH)
constexpr int MAP_MAX_S = 16;              // ring stages at most
constexpr int MAP_STAGE = 4 * tw::BOX;     // a stage: four 32 x 32 weight boxes, 16 KB
constexpr int MAP_BUDGET = 232448 - 1024;  // dynamic shared memory: 227 KB less the static
constexpr int MAP_TIMES = 4;               // the stamps of a block (kdt_mapping_f32)

__host__ __device__ inline int up_1k(int bytes) { return (bytes + 1023) & ~1023; }

// The shared memory of a K5-f32 block, a strip of `rows` batch rows over
// `ranks` ranks (fused_mapping.f32_stages mirrors it): after the ring of
// `stages` stages, xs (the strip's xn as wgmma's K-major B, d / 32 tiles
// of rows x 128 bytes; the f32 partial (rows, ld) in its place once the up
// products are done), hs (h of each of the rank's panels of 32 units as
// the down product's K-major B, rows x 128 bytes each) and own (the f32
// residual x and the next xn of the rows the rank owns).
struct MapLayout {
  int ld, xs, hs, own, stages;
  __host__ __device__ MapLayout(int d, int d_ff, int rows, int ranks) {
    ld = d + 4;
    xs = up_1k(rows * ld * 4);
    hs = 2 * ((d_ff / 64 + ranks - 1) / ranks) * rows * 128;
    own = up_1k(2 * ((rows + ranks - 1) / ranks) * d * 4);
    const int n = (MAP_BUDGET - 1024 - xs - hs - own) / MAP_STAGE;
    stages = n < MAP_MAX_S ? n : MAP_MAX_S;
  }
  size_t smem() const { return 1024 + static_cast<size_t>(stages) * MAP_STAGE + xs + hs + own; }
};

// The launch's arguments: each block's tensor maps of W_up (d, 2 d_ff) and
// W_down (d_ff, d) as the model holds them, boxes of 32 x 32, and its norm
// scale; stamps, where not null, gets MAP_TIMES clock64 counts a block.
struct MapArgs {
  CUtensorMap up[MAP_MAX_DEPTH], down[MAP_MAX_DEPTH];
  const float* ns[MAP_MAX_DEPTH];
  const float* emb;
  const float* in_scale;
  const float* out_scale;
  float* out;
  long long* stamps;
  int b, d, d_ff, n;
  float eps;
};

struct MapRing {
  uint64_t full[MAP_MAX_S], empty[MAP_MAX_S];
};

// The consumers' walk over the ring (tw::stepwise's C); with `timing`
// (thread 0, with stamps), the cycles it waits for stages and the time
// its last wait returned.
struct MapConsumer {
  MapRing& r;
  const unsigned char* ring;
  int stages;
  bool timing;
  int step = 0;
  long long waited = 0, landed = 0;
  __device__ int wait() {
    const int st = step % stages;
    const long long t0 = timing ? clock64() : 0;
    gemm::mbar_wait(&r.full[st], (step / stages) & 1);
    if (timing) {
      landed = clock64();
      waited += landed - t0;
    }
    ++step;
    return st;
  }
  __device__ void release(int st) {
    if ((threadIdx.x & 31) == 0) gemm::mbar_arrive(&r.empty[st]);
  }
};

// The sum of v over the consumer threads, the same in each, summed in
// warp order.
__device__ __forceinline__ float consumers_sum(float v, float* s_red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x / 32] = v;
  tw::consumers_sync();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < 4 * tw::CONSUMERS; ++w) s += s_red[w];
  tw::consumers_sync();  // s_red is free again
  return s;
}

// A barrier of the cluster's consumers (the producers may have left, or be
// waiting for ring stages): once a block's consumers are here, lane q of
// its first warp arrives on barrier `phase % 2` of rank q (cluster scope,
// releasing what the consumers wrote; one lane a rank, so that the remote
// arrivals are in flight together: one thread's, one after another, took
// about 5 us a barrier on an H100); every consumer then waits on its own.
// Two barriers alternate, so that an early rank's next arrival never
// counts towards a phase another rank has not left.
__device__ __forceinline__ void map_cluster_bar(uint64_t* cbar, int& phase, int ranks) {
  tw::consumers_sync();
  uint64_t* bar = &cbar[phase & 1];
  if (threadIdx.x < ranks) {
    uint32_t remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(remote)
                 : "r"(tw::smem_u32(bar)), "r"(static_cast<int>(threadIdx.x)));
    asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(remote)
                 : "memory");
  }
  cluster_wait(bar, (phase >> 1) & 1);
  ++phase;
}

// The A fragment of k8 slice kk of an up stage, rounded: rows g of the
// warpgroup's value box (box 2 w: its 32 units, the warp's 8 of them) and
// rows g + 8 of its gate box (2 w + 1, the same units), so that a thread's
// accumulator holds a and gate of one unit for the same batch rows.
__device__ __forceinline__ void geglu_frag(const unsigned char* s, int kk, uint32_t (&a)[4]) {
  const int m = 64 * (threadIdx.x / 128) + 8 * (tw::warp() % 4) + tw::lane_g();
  const int k = 8 * kk + tw::lane_t();
  a[0] = tw::to_tf32(tw::a_mnmajor(s, m, k));
  a[1] = tw::to_tf32(tw::a_mnmajor(s, m + 32, k));
  a[2] = tw::to_tf32(tw::a_mnmajor(s, m, k + 4));
  a[3] = tw::to_tf32(tw::a_mnmajor(s, m + 32, k + 4));
}

// Element (row n, depth k) of a K-major tile of 128-byte rows in the
// 128-byte swizzle (tw::a_kmajor's layout).
__device__ __forceinline__ float* kmajor_at(unsigned char* tile, int n, int k) {
  return reinterpret_cast<float*>(tile + n * 128 + ((((k >> 2) ^ n) & 7) << 4) + ((k & 3) << 2));
}

// K5 in f32 (the file's note): a cluster of `ranks` blocks a strip of N
// batch rows (N = 8, 16, 32 or 64, wgmma's N), grid (strips * ranks).
template <int N>
__global__ void __launch_bounds__(tw::THREADS, 1)
mapping_f32_kernel(const __grid_constant__ MapArgs a) {
  namespace cg = cooperative_groups;
  constexpr int CT = 128 * tw::CONSUMERS;  // consumer threads
  extern __shared__ unsigned char smem_raw[];
  __shared__ MapRing bars;
  __shared__ uint64_t cbar[2];
  __shared__ float s_red[4 * tw::CONSUMERS];
  unsigned char* smem = wg::aligned_smem(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int d = a.d;
  const MapLayout lay(d, a.d_ff, N, ranks);
  unsigned char* ring = smem;
  unsigned char* xs = ring + lay.stages * MAP_STAGE;
  unsigned char* hs = xs + lay.xs;
  const int own = (N + ranks - 1) / ranks;  // rows of the strip a rank owns
  float* x_own = reinterpret_cast<float*>(hs + lay.hs);
  float* xn_own = x_own + own * d;
  if (threadIdx.x == 0) {
    for (int s = 0; s < lay.stages; ++s) {
      gemm::mbar_init(&bars.full[s]);
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(tw::smem_u32(&bars.empty[s])),
                   "r"(4 * tw::CONSUMERS)
                   : "memory");
    }
    for (int i = 0; i < 2; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(tw::smem_u32(&cbar[i])),
                   "r"(ranks)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();  // every rank's barriers are set up
  // this rank's pairs of 32-unit panels (64 hidden units each) [p0, p0 + pr)
  const int pairs = a.d_ff / 64, p0 = pairs * rank / ranks;
  const int pr = pairs * (rank + 1) / ranks - p0;
  const int ksteps = d / tw::BK, mtiles = (d + 127) / 128;
  if (tw::is_producer()) {
    tw::producer_regs();
    if (!tw::tma_thread()) return;
    int step = 0;
    auto next = [&](uint64_t*& bar) {
      const int st = step % lay.stages;
      if (step >= lay.stages) gemm::mbar_wait(&bars.empty[st], (step / lay.stages - 1) & 1);
      bar = &bars.full[st];
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                       tw::smem_u32(bar)),
                   "r"(MAP_STAGE)
                   : "memory");
      ++step;
      return ring + st * MAP_STAGE;
    };
    for (int l = 0; l < a.n; ++l) {
      // up: per pair and 32-deep step, the value and gate boxes of each
      // warpgroup's 32 units (W_up's columns u and d_ff + u)
      for (int j = 0; j < pr; ++j) {
        const int u0 = 64 * (p0 + j);
        for (int k = 0; k < ksteps; ++k) {
          uint64_t* bar;
          unsigned char* st = next(bar);
          tw::tma(st, &a.up[l], u0, tw::BK * k, bar);
          tw::tma(st + tw::BOX, &a.up[l], a.d_ff + u0, tw::BK * k, bar);
          tw::tma(st + 2 * tw::BOX, &a.up[l], u0 + 32, tw::BK * k, bar);
          tw::tma(st + 3 * tw::BOX, &a.up[l], a.d_ff + u0 + 32, tw::BK * k, bar);
        }
      }
      // down: per 128 output features and panel of 32 units, W_down's rows
      // of the panel, four boxes of 32 features (past d: zeros)
      for (int m = 0; m < mtiles; ++m)
        for (int kp = 0; kp < 2 * pr; ++kp) {
          uint64_t* bar;
          unsigned char* st = next(bar);
#pragma unroll
          for (int jb = 0; jb < 4; ++jb)
            tw::tma(st + jb * tw::BOX, &a.down[l], 128 * m + 32 * jb, 64 * p0 + 32 * kp, bar);
        }
    }
    return;
  }
  tw::consumer_regs();
  const int tid = threadIdx.x, wgi = tid / 128, t4 = tw::lane_t();
  const bool timing = a.stamps != nullptr && tid == 0;
  const long long t_start = timing ? clock64() : 0;
  long long t_bars = 0;
  MapConsumer c{bars, ring, lay.stages, timing};
  int phase = 0;
  auto bar = [&]() {
    const long long t0 = timing ? clock64() : 0;
    map_cluster_bar(cbar, phase, ranks);
    if (timing) t_bars += clock64() - t0;
  };
  const long strip0 = static_cast<long>(blockIdx.x / ranks) * N;
  // the strip's xn into xs from the rows' owners (rank n % ranks, slot n /
  // ranks), swizzled K-major
  auto pull = [&]() {
#pragma unroll 4
    for (int w = tid; w < N * (d / 4); w += CT) {
      const int n = w / (d / 4), k = 4 * (w % (d / 4));
      const float* src = cluster.map_shared_rank(xn_own, n % ranks) + (n / ranks) * d + k;
      *reinterpret_cast<float4*>(kmajor_at(xs + (k / 32) * N * 128, n, k % 32)) =
          *reinterpret_cast<const float4*>(src);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // xs feeds wgmma
    tw::consumers_sync();
  };
  // the owned rows: x = RMSNorm(emb, in_scale) and the first xn =
  // RMSNorm(x, ns_0) rounded; rows past the batch stay zero
  for (int i = 0; i < own; ++i) {
    const int n = rank + ranks * i;
    if (n >= N) break;
    float *xo = x_own + i * d, *xno = xn_own + i * d;
    const long row = strip0 + n;
    if (row >= a.b) {
      for (int f = tid; f < d; f += CT) xno[f] = 0.f;
      continue;
    }
    const float* e = a.emb + row * d;
    float ss = 0.f;
    for (int f = tid; f < d; f += CT) ss += e[f] * e[f];
    float rr = rsqrtf(consumers_sum(ss, s_red) / d + a.eps);
    ss = 0.f;
    for (int f = tid; f < d; f += CT) {
      const float v = e[f] * (a.in_scale[f] * rr);
      xo[f] = v;
      ss += v * v;
    }
    rr = rsqrtf(consumers_sum(ss, s_red) / d + a.eps);
    for (int f = tid; f < d; f += CT) xno[f] = tw::round_tf32(xo[f] * (a.ns[0][f] * rr));
  }
  bar();  // every owner's xn is in place
  pull();
  float* part = reinterpret_cast<float*>(xs);
  for (int l = 0; l < a.n; ++l) {
    // up: (a | gate)^T = W_up^T xn^T per pair, each warpgroup its 32 units;
    // h = a gelu(gate) rounded into the panel's tile of hs (row n, unit u)
    for (int j = 0; j < pr; ++j) {
      float acc[N / 2];
      tw::zero(acc);
      tw::stepwise(
          c, ksteps, MAP_STAGE,
          [&](const unsigned char* stage, int, uint32_t(&f)[4][4]) {
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) geglu_frag(stage, kk, f[kk]);
          },
          [&](const unsigned char*, int k, const uint32_t(&f)[4][4]) {
            const uint64_t b = tw::desc(xs + k * N * 128);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) tw::mma<N>(acc, f[kk], b + 2 * kk, k > 0 || kk > 0);
            wg::fence_regs(acc);
          });
      wg::fence_regs(acc);
      unsigned char* tile = hs + (2 * j + wgi) * N * 128;
      const int u = 8 * (tw::warp() % 4) + tw::lane_g();
#pragma unroll
      for (int i = 0; i < N / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          *kmajor_at(tile, 8 * i + 2 * t4 + e, u) =
              tw::round_tf32(acc[4 * i + e] * gelu_erf(acc[4 * i + 2 + e]));
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // hs feeds wgmma
    tw::consumers_sync();  // every h tile is in place; xs is free
    // down: out^T = W_down^T h^T over the rank's panels, 128 features a
    // round (64 a warpgroup), the f32 partial into xs as (N, ld)
    for (int m = 0; m < mtiles; ++m) {
      float acc[N / 2];
      tw::zero(acc);
      tw::stepwise(
          c, 2 * pr, MAP_STAGE,
          [&](const unsigned char* stage, int k, uint32_t(&f)[4][4]) {
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) tw::RoundedMN{0}(stage, k, kk, f[kk]);
          },
          [&](const unsigned char*, int k, const uint32_t(&f)[4][4]) {
            const uint64_t b = tw::desc(hs + k * N * 128);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) tw::mma<N>(acc, f[kk], b + 2 * kk, k > 0 || kk > 0);
            wg::fence_regs(acc);
          });
      wg::fence_regs(acc);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int feat = 128 * m + tw::acc_row(hh);
        if (feat >= d) continue;
#pragma unroll
        for (int i = 0; i < N / 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            part[(8 * i + 2 * t4 + e) * lay.ld + feat] = acc[4 * i + 2 * hh + e];
      }
    }
    bar();  // every rank's partial is in place
    // the owned rows: x += the ranks' partials, summed in rank order; then
    // the next block's xn, or after the last block the output
    const bool last = l + 1 == a.n;
    for (int i = 0; i < own; ++i) {
      const int n = rank + ranks * i;
      if (n >= N) break;
      const long row = strip0 + n;
      if (row >= a.b) continue;
      float *xo = x_own + i * d, *xno = xn_own + i * d;
      float ss = 0.f;
      for (int f = tid; f < d; f += CT) {
        float s = 0.f;
#pragma unroll 4
        for (int q = 0; q < ranks; ++q) s += cluster.map_shared_rank(part, q)[n * lay.ld + f];
        const float v = xo[f] + s;
        xo[f] = v;
        ss += v * v;
      }
      const float rr = rsqrtf(consumers_sum(ss, s_red) / d + a.eps);
      if (last) {
        for (int f = tid; f < d; f += CT) a.out[row * d + f] = xo[f] * (a.out_scale[f] * rr);
      } else {
        for (int f = tid; f < d; f += CT) xno[f] = tw::round_tf32(xo[f] * (a.ns[l + 1][f] * rr));
      }
    }
    bar();  // no rank reads a partial any more; the next xn rows are in place
    if (!last) pull();
  }
  if (timing) {
    long long* out = a.stamps + static_cast<long>(blockIdx.x) * MAP_TIMES;
    out[0] = c.landed - t_start;
    out[1] = c.waited;
    out[2] = t_bars;
    out[3] = clock64() - t_start;
  }
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

// K4-f32's wide route: the weight copies, then its two kernels.
cudaError_t launch_ffn_wide(const float* x, const float* nscale, int scale_stride,
                            const float* w_up, const float* w_down, float* out, float* upt,
                            float* downt, float* h, int images, int tokens, int d, int d_ff,
                            float eps, cudaStream_t st) {
  const long rows = static_cast<long>(images) * tokens;
  cudaError_t err = tw::launch_round(w_up, d, 2 * d_ff, nullptr, upt, st);
  if (err == cudaSuccess) err = tw::launch_round(w_down, d_ff, d, nullptr, downt, st);
  CUtensorMap map_x, map_upt, map_h, map_downt;
  const int nb = d % 128 ? 64 : 128;  // output columns an item
  if (err == cudaSuccess) err = tw::map_f32(&map_x, x, rows, d, d, tw::ROWS);
  if (err == cudaSuccess) err = tw::map_f32(&map_upt, upt, 2 * d_ff, d, d, 64);
  if (err == cudaSuccess) err = tw::map_f32(&map_h, h, rows, d_ff, d_ff, tw::ROWS);
  if (err == cudaSuccess) err = tw::map_f32(&map_downt, downt, d, d_ff, d_ff, nb);
  const size_t up_smem = tw::RING_SMEM + (d + tw::ROWS * H_LD) * sizeof(float);
  if (err == cudaSuccess) err = allow_smem(ffn_f32_wide_up_kernel, up_smem);
  if (err != cudaSuccess) return err;
  const long tiles = static_cast<long>(images) * tw::tiles(tokens);
  ffn_f32_wide_up_kernel<<<tw::grid(tiles * (d_ff / 64)), tw::THREADS, up_smem, st>>>(
      map_x, map_upt, nscale, scale_stride, h, images, tokens, d, d_ff, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (nb == 128) {
    err = allow_smem(ffn_f32_wide_down_kernel<128>, tw::RING_SMEM);
    if (err != cudaSuccess) return err;
    ffn_f32_wide_down_kernel<128><<<tw::grid(tiles * (d / 128)), tw::THREADS, tw::RING_SMEM, st>>>(
        map_h, map_downt, x, out, images, tokens, d, d_ff);
  } else {
    err = allow_smem(ffn_f32_wide_down_kernel<64>, tw::RING_SMEM);
    if (err != cudaSuccess) return err;
    ffn_f32_wide_down_kernel<64><<<tw::grid(tiles * (d / 64)), tw::THREADS, tw::RING_SMEM, st>>>(
        map_h, map_downt, x, out, images, tokens, d, d_ff);
  }
  return cudaGetLastError();
}

// The launch of K5 in f32, `strips` clusters of `ranks` blocks; with
// `clusters`, it is not launched and the number of clusters that fit on
// the device at once goes there instead (0 where the shared memory holds
// fewer than two ring stages).
template <int N>
cudaError_t launch_mapping(const MapArgs& args, int strips, int ranks, cudaStream_t st,
                           int* clusters) {
  const MapLayout lay(args.d, args.d_ff, N, ranks);
  if (lay.stages < 2) {
    if (clusters == nullptr) return cudaErrorInvalidValue;
    *clusters = 0;
    return cudaSuccess;
  }
  cudaError_t err = allow_smem(mapping_f32_kernel<N>, lay.smem());
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(mapping_f32_kernel<N>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = ranks;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(strips * ranks);
  cfg.blockDim = dim3(tw::THREADS);
  cfg.dynamicSmemBytes = lay.smem();
  cfg.stream = st;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  if (clusters != nullptr)
    return cudaOccupancyMaxActiveClusters(clusters, mapping_f32_kernel<N>, &cfg);
  return cudaLaunchKernelEx(&cfg, mapping_f32_kernel<N>, args);
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
// wrapper takes it at d outside 64, 128, 256, 512): x, nscale,
// scale_stride, w_up, w_down and out as kdt_ffn_fwd_f32's. Scratch f32:
// w_upt (2 d_ff, d) and w_downt (d, d_ff), the rounded W_up^T and W_down^T
// (its depth in order), and h (rows, d_ff).
extern "C" int kdt_ffn_fwd_f32_wide(const void* x, const void* nscale, const void* w_up,
                                    const void* w_down, void* out, void* w_upt, void* w_downt,
                                    void* h, int images, int tokens, int d, int d_ff,
                                    int scale_stride, float eps, void* stream) {
  if (d % 64 || d_ff % 64 || scale_stride < d || scale_stride % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  return static_cast<int>(launch_ffn_wide(f(x), f(nscale), scale_stride, f(w_up), f(w_down),
                                          o(out), o(w_upt), o(w_downt), o(h), images, tokens, d,
                                          d_ff, eps, static_cast<cudaStream_t>(stream)));
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

// K5 in f32 in one launch. emb (b, d) f32; in_scale, out_scale (d,) f32;
// weights: 3 n pointers, each block's norm scale (d,), W_up (d, 2 d_ff) and
// W_down (d_ff, d), all f32, read as they lie; out (b, d) f32. A cluster of
// `ranks` blocks (1 to 16, at most d_ff / 64) a strip of `rows` batch rows
// (8, 16, 32 or 64); its shared memory (MapLayout) must hold two ring
// stages. Where stamps is not null, (strips * ranks, MAP_TIMES) int64
// clock64 counts a block: from its start to its last weight stage's
// landing, waiting for stages, waiting at cluster barriers, to its end.
// With `clusters` not null nothing is launched (the pointers may be null):
// the number of such clusters that fit on the device at once, 0 where the
// layout does not fit, is written there. Needs d, d_ff % 64 == 0 and 1 <=
// n <= MAP_MAX_DEPTH.
extern "C" int kdt_mapping_f32(const void* emb, const void* in_scale, const void* out_scale,
                               const void* const* weights, void* out, int b, int d, int d_ff,
                               int n_blocks, int rows, int ranks, float eps, void* stream,
                               void* stamps, int* clusters) {
  if (d % 64 || d_ff % 64 || n_blocks < 1 || n_blocks > MAP_MAX_DEPTH || b < 1 || ranks < 1 ||
      ranks > 16 || ranks > d_ff / 64 || (rows != 8 && rows != 16 && rows != 32 && rows != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  MapArgs args = {};
  args.emb = static_cast<const float*>(emb);
  args.in_scale = static_cast<const float*>(in_scale);
  args.out_scale = static_cast<const float*>(out_scale);
  args.out = static_cast<float*>(out);
  args.stamps = static_cast<long long*>(stamps);
  args.b = b;
  args.d = d;
  args.d_ff = d_ff;
  args.n = n_blocks;
  args.eps = eps;
  cudaError_t err = cudaSuccess;
  for (int l = 0; clusters == nullptr && l < n_blocks && err == cudaSuccess; ++l) {
    args.ns[l] = static_cast<const float*>(weights[3 * l]);
    err = tw::map_f32(&args.up[l], static_cast<const float*>(weights[3 * l + 1]), d, 2 * d_ff,
                      2 * d_ff, 32);
    if (err == cudaSuccess)
      err = tw::map_f32(&args.down[l], static_cast<const float*>(weights[3 * l + 2]), d_ff, d, d,
                        32);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int strips = (b + rows - 1) / rows;
  switch (rows) {
    case 8: err = launch_mapping<8>(args, strips, ranks, st, clusters); break;
    case 16: err = launch_mapping<16>(args, strips, ranks, st, clusters); break;
    case 32: err = launch_mapping<32>(args, strips, ranks, st, clusters); break;
    default: err = launch_mapping<64>(args, strips, ranks, st, clusters); break;
  }
  return static_cast<int>(err);
}

KDT_DEFINE_ERROR_STRING
