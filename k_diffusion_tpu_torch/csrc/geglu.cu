// GEGLU feed-forward kernels: the HDiT FF block, forward (K4, one launch)
// and backward (K10), and the whole mapping network (K5, one launch),
// sharing the GEGLU block device code below.
//
// Replaces: k_diffusion_tpu/ops/pallas/fused_ffn.py:_ffn_kernel (the forward
// of fused_geglu_ffn) with ffn_fwd_kernel, fused_ffn.py:_ffn_bwd_kernel (its
// backward) with ffn_dup_kernel and the shared steps of gemm.cuh, and
// k_diffusion_tpu/ops/pallas/fused_mapping.py:_mapping_kernel (the forward
// of fused_mapping) with mapping_kernel.
//
// What bounds them on the H100, flagship eval shapes at batch 8:
// - FF block: 6 * tokens * d * d_ff = 9.7 GFLOP at every level (9.8 us at
//   989 TFLOP/s) against x in and out, 17 MB at level 0 (5 us at 3.35
//   TB/s): bound by the tensor cores, and by the GEGLU epilogue's exact erf
//   per hidden unit (one erf per 6 d FLOP: as much issue time as the
//   products at d = 128), as long as the hidden activation h never leaves
//   the chip.
// - Mapping network: 2 blocks of (256 x 1536) + (768 x 256) bf16 weights,
//   2.4 MB (0.7 us), on an (8, 256) activation: bound by latency.
// - FF backward (K10), training shapes at batch 32: the recomputed up
//   projection plus four VJP products, 16 * tokens * d * d_ff = 103 GFLOP
//   at levels 0 and 1 (104 us at 989 TFLOP/s), against x, g, dx (100 MB at
//   level 0) and, in this design, h (rows, d_ff), dup (rows, 2 d_ff) and xn
//   written once and read back (2 * 335 MB at level 0, 200 us): bound by
//   memory, and at batch 8 by latency (a few hundred 64-row blocks).
//
// Design:
// - ffn_fwd_kernel (K4), one launch on gemm.cuh's pipelined wgmma core: a
//   block owns a 64-row tile and NB 64-column tiles of the output,
//   normalises its x tile once into resident tiles, and walks its hidden
//   panels of 64 units: a | gate = xn W_up into two accumulator sets, the
//   GEGLU in registers (exact erf), h rounded to bf16 there (the Pallas
//   rounding point) and multiplied into out += h W_down[panel], with the
//   f32 output tiles held in registers across every panel. h never touches
//   device memory: with one warpgroup a block (d / 64 = 1, 2 or 4) it is the
//   register A operand of the down product (as attn_fwd.cuh's P V); with
//   two (d = 512, 768), which split the output tiles between them and take
//   a panel each a round, it passes through one shared tile each. Two
//   warpgroups keep every output tile of d = 512 in registers (four each,
//   128 registers a thread) without recomputing the up projection. The
//   weight tiles stream through gemm.cuh's 3-stage ring by the Tensor Memory
//   Accelerator: the value and gate tiles of one 64-deep slab of d, or the
//   W_down tiles of a down step. The hidden panels split over a thread
//   block cluster of up to 8 blocks, as many as fill the SMs in the fewest
//   rounds (the wrapper's occupancy query and cost model), whose f32
//   partials meet in distributed shared memory: each block sums its share
//   of the tile's rows over the cluster's partials in rank order, adds the
//   residual x in f32 and rounds once. No atomics: a rerun gives bit-equal
//   outputs. Why the copy engine: with the copies by cp.async, the copies,
//   not the products or the barriers, held this kernel back on an H100, and
//   a deeper ring did not help (PERF.md).
// - K10, three steps on gemm.cuh's pipelined wgmma core (one warpgroup a
//   block, operands through a 3-stage cp.async ring, accumulators in
//   registers, no atomics):
//   (a) ffn_dup_kernel: per row tile and group of hidden panels, the up
//       projection recomputed and dh = g W_down^T, the GEGLU derivative in
//       registers; writes bf16 h, dup and (once) xn, r and the per-row sums
//       for the RMS-norm VJP. The x tile is normalised once per block, not
//       once per panel;
//   (b) gemm::norm_vjp_kernel: dxn = dup W_up^T over K = 2 d_ff, 128
//       columns a block, and the RMS-norm VJP in its epilogue: dx (+ g, the
//       residual) and the d(scale) partials, with no f32 staging and no
//       row exchange between blocks;
//   (c) gemm::atb_kernel: dW_up = xn^T dup and dW_down = h^T g as split-K
//       f32 partials over row chunks, summed in a fixed order.
//   Grids are sized to about two blocks an SM: the hidden panels of (a)
//   and the row chunks of (c) split as far as the row tiles leave room.
// - mapping_kernel: one block per 16-row strip of the batch holds the
//   strip's residual stream in f32 shared memory and runs every block of
//   the network through the same strip code (mma_strip, geglu_strip) with
//   W read from L2.
#include <cooperative_groups.h>

#include "gemm.cuh"

namespace kdt {
namespace {

// h strip = a * gelu(gate), on a warp's 16 x 64 accumulators (both have
// the same fragment layout, so the product is elementwise), written as bf16
// rows of dst (stride ldd) through the warp's scratch strip.
__device__ __forceinline__ void geglu_strip(FragC (&a)[4], FragC (&g)[4], float* scratch,
                                            bf16* dst, long ldd, int valid) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int t = 0; t < a[j].num_elements; ++t) a[j].x[t] *= gelu_erf(g[j].x[t]);
  store_strip(scratch, LDF, a);
  write_strip(scratch, LDF, dst, ldd, nullptr, valid);
}

// RMS-normalises the rows of the f32 residual stream xs (16 rows, stride
// ldx) with scale (d,) f32, as the Pallas kernel does: bf16(bf16(x) *
// bf16(scale / rms)). Writes bf16 rows to xn (stride ldn) when given, else
// back into xs as floats. Each warp takes rows warp, warp + 4, ...
__device__ void mapping_rms(float* xs, int ldx, const float* scale, int d, float eps, bf16* xn,
                            int ldn) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  for (int r = warp; r < STRIP; r += WARPS) {
    float* xr = xs + r * ldx;
    float ss = 0.f;
    for (int c = lane; c < d; c += 32) ss += xr[c] * xr[c];
    const float inv = rsqrtf(warp_sum(ss) / d + eps);
    for (int c = lane; c < d; c += 32) {
      const bf16 y = to_bf(bf_round(xr[c]) * bf_round(scale[c] * inv));
      if (xn)
        xn[r * ldn + c] = y;
      else
        xr[c] = to_f(y);
    }
  }
}

// emb (b, d) bf16; scales f32; norm_scales (n, d) f32; w_up (n, d, 2 d_ff)
// and w_down (n, d_ff, d) bf16; out (b, d) bf16. Block x owns batch rows
// [16 x, 16 x + 16).
__global__ void __launch_bounds__(THREADS)
mapping_kernel(const bf16* __restrict__ emb, const float* __restrict__ in_scale,
               const float* __restrict__ out_scale, const float* __restrict__ norm_scales,
               const bf16* __restrict__ w_up, const bf16* __restrict__ w_down,
               bf16* __restrict__ out, int b, int d, int d_ff, int n_blocks, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldx = d + 4, ldn = d + 8, ldh = d_ff + 8;
  bf16* xn = reinterpret_cast<bf16*>(smem);
  bf16* hs = xn + STRIP * ldn;
  float* scratch = reinterpret_cast<float*>(hs + STRIP * ldh);
  float* xs = scratch + WARPS * STRIP * LDF;

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  float* strip = scratch + warp * STRIP * LDF;
  const int r0 = blockIdx.x * STRIP;
  const int rows = b - r0 < STRIP ? b - r0 : STRIP;
  emb += static_cast<long>(r0) * d;
  out += static_cast<long>(r0) * d;
  for (int i = threadIdx.x; i < STRIP * d; i += blockDim.x) {
    const int r = i / d, c = i % d;
    xs[r * ldx + c] = r < rows ? to_f(emb[r * d + c]) : 0.f;
  }
  __syncthreads();
  mapping_rms(xs, ldx, in_scale, d, eps, nullptr, 0);
  __syncthreads();

  for (int blk = 0; blk < n_blocks; ++blk) {
    const bf16* wu = w_up + static_cast<long>(blk) * d * 2 * d_ff;
    const bf16* wd = w_down + static_cast<long>(blk) * d_ff * d;
    mapping_rms(xs, ldx, norm_scales + blk * d, d, eps, xn, ldn);
    __syncthreads();
    for (int n0 = warp * PANEL; n0 < d_ff; n0 += WARPS * PANEL) {
      FragC acc_a[4], acc_g[4];
      zero(acc_a);
      zero(acc_g);
      mma_strip(xn, ldn, wu + n0, 2L * d_ff, d, acc_a);
      mma_strip(xn, ldn, wu + d_ff + n0, 2L * d_ff, d, acc_g);
      geglu_strip(acc_a, acc_g, strip, hs + n0, ldh, STRIP);
    }
    __syncthreads();
    for (int n0 = warp * PANEL; n0 < d; n0 += WARPS * PANEL) {
      FragC acc[4];
      zero(acc);
      mma_strip(hs, ldh, wd + n0, d, d_ff, acc);
      store_strip(strip, LDF, acc);
      for (int r = 0; r < STRIP; ++r) {
        xs[r * ldx + n0 + lane] += strip[r * LDF + lane];
        xs[r * ldx + n0 + lane + 32] += strip[r * LDF + lane + 32];
      }
      __syncwarp();
    }
    __syncthreads();
  }
  mapping_rms(xs, ldx, out_scale, d, eps, nullptr, 0);
  __syncthreads();
  for (int i = threadIdx.x; i < rows * d; i += blockDim.x)
    out[i] = to_bf(xs[(i / d) * ldx + i % d]);
}


// K4 on gemm.cuh's core. A block is WG warpgroups (1 or 2) over one 64-row
// tile and NB 64-column tiles of the output, OUT = NB / WG of them in each
// warpgroup's registers. Grid (images * tiles * groups, d / (64 NB)),
// clusters of `groups` blocks along x: cluster i owns row tile i, block y
// the output columns [64 NB y, 64 NB (y + 1)), and the block of rank r in
// its cluster the hidden panels r, r + groups, ..., WG a round. A round
// takes kt = d / 64 up steps, in which warpgroup g forms a | gate = xn W_up
// of the round's panel g (C = A B, its value and gate tiles of one 64-deep
// slab); then warpgroup g rounds h = a gelu(gate) (exact erf) to bf16 into
// shared h tile g (with one warpgroup: into the register A fragments of
// the down product, as attn_fwd.cuh's P V); then the down steps, in which
// each warpgroup adds h_u W_down[panel u] over the round's panels u to TPS
// of its output tiles (A K-major or from registers, B MN-major). A stage of the ring holds 2 WG tiles: the round's
// value and gate tiles of one slab, or the W_down tiles of one down step.
// The first slab of a panel and the first round's down products overwrite
// their accumulators (wgmma's scale-d), so that no instruction but wgmma
// writes them inside the loop. At the end the f32 output tiles go to the
// block's own shared memory (the x tiles and the ring are free by then),
// and after a cluster barrier each block sums its share of the rows over
// every rank's partial in rank order, adds x and writes bf16 with 16-byte
// stores.
template <int WG, int NB>
__global__ void __launch_bounds__(WG * gemm::THREADS, 1)
ffn_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ nscale,
               const __grid_constant__ CUtensorMap map_up,
               const __grid_constant__ CUtensorMap map_down, bf16* __restrict__ out, int tokens,
               int d, int d_ff, float eps) {
  using namespace gemm;
  namespace cg = cooperative_groups;
  static_assert((WG == 1 || WG == 2) && NB % WG == 0, "NB output tiles over WG warpgroups");
  constexpr int OUT = NB / WG;  // output tiles a warpgroup
  constexpr int TPS = 2 / WG;   // of them a down step
  constexpr int DOWN = (OUT + TPS - 1) / TPS;  // down steps a round
  constexpr int ST = 2 * WG;    // tiles a stage
  constexpr int PLD = 64 * NB + 8;  // row stride of the f32 partial, in floats
  extern __shared__ unsigned char smem_raw[];
  const int kt = d / 64;
  bf16* s_x = reinterpret_cast<bf16*>(aligned_smem(smem_raw));  // kt tiles
  bf16* s_h = s_x + kt * T;  // h of each warpgroup's panel (two warpgroups)
  bf16* s_ring = s_h + (WG - 1) * 2 * T;
  // the row norms wait in the ring's last stage, which no copy fills before
  // the first refill
  float* s_r = reinterpret_cast<float*>(s_ring + (S - 1) * ST * T);
  // after the products: the (64, 64 NB) f32 partial over the tiles, (kt +
  // 2 (WG - 1) + ST S) tiles >= 64 PLD floats for NB <= 4 WG
  float* s_part = reinterpret_cast<float*>(s_x);
  __shared__ uint64_t full[S];  // a stage's tiles have landed
  tma_init(full);

  cg::cluster_group cluster = cg::this_cluster();
  const int groups = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int wgi = threadIdx.x / gemm::THREADS;  // this thread's warpgroup
  const RowTile t = row_tile(tokens, blockIdx.x / groups);
  const int col0 = 64 * NB * blockIdx.y;
  const int per = kt + DOWN;  // steps a round
  const int mine = (d_ff / 64 - rank + groups - 1) / groups;
  const int steps = (mine + WG - 1) / WG * per;
  // the round's panel u, or -1 past this block's last one
  auto panel = [&](int round, int u) {
    const int q = WG * round + u;
    return q < mine ? rank + q * groups : -1;
  };
  // thread 0: step s's weight tiles into stage st
  auto load = [&](int s, int st) {
    const int round = s / per, sub = s % per;
    bf16* stage = s_ring + st * ST * T;
#pragma unroll
    for (int u = 0; u < WG; ++u) {
      const int p = panel(round, u);
      if (p < 0) continue;
      if (sub < kt) {
        tma_tile(stage + 2 * u * T, &map_up, 64 * p, 64 * sub, &full[st]);
        tma_tile(stage + (2 * u + 1) * T, &map_up, d_ff + 64 * p, 64 * sub, &full[st]);
        continue;
      }
#pragma unroll
      for (int g = 0; g < WG; ++g)
#pragma unroll
        for (int e = 0; e < TPS; ++e) {
          const int j = (sub - kt) * TPS + e;  // warpgroup g's output tile j
          if (j < OUT)
            tma_tile(stage + ((g * WG + u) * TPS + e) * T, &map_down, col0 + 64 * (g * OUT + j),
                     64 * p, &full[st]);
        }
    }
    mbar_arrive(&full[st]);
  };
  load_x_tiles(x, t, d, s_x);
  cp_async_commit();
  tma_start(steps, load);
  cp_async_wait<0>();
  __syncthreads();
  norm_tiles(t, d, nscale + static_cast<long>(t.img) * d, eps, s_x, s_r, nullptr, nullptr,
             threadIdx.x, blockDim.x);

  float up[2][32], o[OUT][32];  // a and gate; the output tiles
  uint32_t a_h[4][4];           // h as A fragments (one warpgroup only)
  zero(up);
  zero(o);
  for (int s = 0, round = 0; s < steps; ++round) {
    const bool has = panel(round, wgi) >= 0;
    for (int k = 0; k < kt; ++k, ++s) {
      tma_step(s, steps, full, load);
      if (has) {
        wgmma_fence();
        product<0, 1>(up, s_x + k * T, s_ring + ((s % S) * ST + 2 * wgi) * T, k);
        wgmma_commit();
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      // past the next barrier the last round's down products are done in
      // every warpgroup, so h may be written again (two warpgroups: kt >= 2)
    }
    wgmma_wait<0>();  // also the last round's down products, which read h
    fence_acc(up);
    if constexpr (WG == 1) fence_regs(a_h);
    if (has) {
      // h = bf16(a gelu(gate)): with one warpgroup the A fragments of the
      // down product (accumulator columns [16 kk, 16 kk + 16) are k16
      // slice kk, as wgmma.cuh's pack_a), with two shared tile wgi
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int at = 4 * i + 2 * hh;
          const __nv_bfloat162 hv = __floats2bfloat162_rn(up[0][at] * gelu_erf(up[1][at]),
                                                          up[0][at + 1] * gelu_erf(up[1][at + 1]));
          if constexpr (WG == 1)
            a_h[i / 2][(i & 1) * 2 + hh] = *reinterpret_cast<const uint32_t*>(&hv);
          else
            stage_pair(s_h + wgi * T, acc_row(hh), 8 * i + acc_col(), hv);
        }
      if constexpr (WG > 1)
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // h feeds wgmma
    }
    if constexpr (WG == 1) fence_regs(a_h);
    // with two warpgroups the first down step's barrier publishes h
#pragma unroll
    for (int j = 0; j < DOWN; ++j, ++s) {
      tma_step(s, steps, full, load);
      const bf16* stage = s_ring + (s % S) * ST * T;
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < WG; ++u) {
        if (u > 0 && panel(round, u) < 0) break;
        const uint64_t da = desc<64>(s_h + u * T);
#pragma unroll
        for (int e = 0; e < TPS; ++e) {
          if (j * TPS + e >= OUT) break;
          const uint64_t db = desc<64>(stage + ((wgi * WG + u) * TPS + e) * T);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const int add = round > 0 || u > 0 || kk > 0;
            if constexpr (WG == 1)
              wgmma_rs<64, 1>(o[j * TPS + e], a_h[kk], db + kk * ROW_STEP<64>, add);
            else
              wgmma_ss<0, 1>(o[j * TPS + e], da + kk * K_STEP, db + kk * ROW_STEP<64>, add);
          }
        }
      }
      wgmma_commit();
      wgmma_wait<1>();
    }
  }
  wgmma_wait<0>();
  fence_acc(o);
  if constexpr (WG == 1) fence_regs(a_h);
  __syncthreads();  // every product is done: the tiles take the partial
#pragma unroll
  for (int j = 0; j < OUT; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(s_part + acc_row(hh) * PLD + 64 * (wgi * OUT + j) + 8 * i +
                                   acc_col()) =
            make_float2(o[j][4 * i + 2 * hh], o[j][4 * i + 2 * hh + 1]);
  cluster.sync();  // every rank's partial is in place
  constexpr int CH = 8 * NB;  // 8-column chunks a row
  const int first_row = ROWS * rank / groups, last_row = ROWS * (rank + 1) / groups;
  for (int i = threadIdx.x; i < (last_row - first_row) * CH; i += blockDim.x) {
    const int row = first_row + i / CH, c = (i % CH) * 8;
    if (row >= t.valid) break;  // rows grow with i
    float v[8] = {};
    for (int g = 0; g < groups; ++g) {
      const float* src = cluster.map_shared_rank(s_part, g) + row * PLD + c;
      const float4 lo = *reinterpret_cast<const float4*>(src);
      const float4 hi = *reinterpret_cast<const float4*>(src + 4);
      v[0] += lo.x;
      v[1] += lo.y;
      v[2] += lo.z;
      v[3] += lo.w;
      v[4] += hi.x;
      v[5] += hi.y;
      v[6] += hi.z;
      v[7] += hi.w;
    }
    const long at = (t.row0 + row) * d + col0 + c;
    const uint4 xv = *reinterpret_cast<const uint4*>(x + at);
    const bf16* xe = reinterpret_cast<const bf16*>(&xv);
    uint4 ov;
    bf16* oe = reinterpret_cast<bf16*>(&ov);
#pragma unroll
    for (int e = 0; e < 8; ++e) oe[e] = to_bf(v[e] + to_f(xe[e]));
    *reinterpret_cast<uint4*>(out + at) = ov;
  }
  cluster.sync();  // no block leaves while another reads its partial
}

// x tiles, h tiles, the ring (2 WG tiles a stage) and the slack to align
// them; the row norms and the f32 partial live inside.
inline size_t ffn_fwd_smem(int d, int wg) {
  return (d / 64 + (wg - 1) * 2 + 2 * wg * gemm::S) * gemm::T * sizeof(bf16) + 1024;
}

// The launch of K4 with NB output tiles over WG warpgroups a block and the
// hidden panels over clusters of `groups` blocks; with `clusters`, it is
// not launched and the number of clusters that fit on the device at once
// goes there instead.
template <int WG, int NB>
cudaError_t launch_ffn_fwd(const bf16* x, const bf16* nscale, const bf16* w_up,
                           const bf16* w_down, bf16* out, int images, int tokens, int d,
                           int d_ff, int groups, float eps, cudaStream_t st, int* clusters) {
  const size_t smem = ffn_fwd_smem(d, WG);
  const cudaError_t err = gemm::allow_shared(ffn_fwd_kernel<WG, NB>, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (tokens + wg::ROWS - 1) / wg::ROWS;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = groups;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(images * tiles * groups, d / (64 * NB));
  cfg.blockDim = dim3(WG * gemm::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  if (clusters != nullptr)
    return cudaOccupancyMaxActiveClusters(clusters, ffn_fwd_kernel<WG, NB>, &cfg);
  CUtensorMap map_up, map_down;
  cudaError_t map_err = gemm::tile_map(&map_up, w_up, d, 2 * d_ff);
  if (map_err == cudaSuccess) map_err = gemm::tile_map(&map_down, w_down, d_ff, d);
  if (map_err != cudaSuccess) return map_err;
  return cudaLaunchKernelEx(&cfg, ffn_fwd_kernel<WG, NB>, x, nscale, map_up, map_down, out, tokens,
                            d, d_ff, eps);
}

// K10's first kernel, on gemm.cuh's core. Grid (images * tiles, groups):
// a block owns one 64-row tile and the hidden panels y, y + groups, ... of
// 64 units each. It normalises its x tile once into resident tiles (group
// 0 also writes xn and r), keeps its g tile resident, and streams per
// panel and 64-deep slab of d the value and gate tiles of W_up and the
// W_down tile through the ring: a | gate = xn W_up (C = A B) and dh = g
// W_down^T (C = A B^T), three accumulator sets. The epilogue forms, in
// registers, h = a gelu(gate), da = dh gelu(gate) and dgate = dh a
// gelu'(gate) (exact erf) and writes bf16 h and dup = (da, dgate), the
// Pallas rounding points, once, staged through the step's own ring stage
// (its products are done) for 16-byte stores; it also sums bf16(dup) (a, gate) over the
// block's columns into its per-row partial of dot_part (groups, rows), for
// the RMS-norm VJP (gemm.cuh's note).
__global__ void __launch_bounds__(gemm::THREADS)
ffn_dup_kernel(const bf16* __restrict__ x, const bf16* __restrict__ nscale,
               const bf16* __restrict__ w_up, const bf16* __restrict__ w_down,
               const bf16* __restrict__ g, bf16* __restrict__ h, bf16* __restrict__ dup,
               bf16* __restrict__ xn, float* __restrict__ r_out, float* __restrict__ dot_part,
               long n_rows, int tokens, int d, int d_ff, int groups, float eps) {
  using namespace gemm;
  extern __shared__ unsigned char smem_raw[];
  const int kt = d / 64;
  bf16* s_xn = reinterpret_cast<bf16*>(aligned_smem(smem_raw));  // kt tiles
  bf16* s_g = s_xn + kt * T;                                     // kt tiles
  bf16* s_ring = s_g + kt * T;  // stage: the value, gate and W_down tiles
  float* s_r = reinterpret_cast<float*>(s_ring + S * 3 * T);

  const RowTile t = row_tile(tokens);
  const int r0 = static_cast<int>(t.row0), end = r0 + t.valid;
  const int steps = (d_ff / 64 - static_cast<int>(blockIdx.y) + groups - 1) / groups * kt;
  const long ld_up = 2L * d_ff;
  for (int k = 0; k < kt; ++k) load_tile_async<64>(s_g + k * T, g + 64 * k, d, r0, end);
  auto panel = [&](int s) { return static_cast<int>(blockIdx.y) + s / kt * groups; };
  auto load = [&](int s, int st) {
    const int p = panel(s), k0 = 64 * (s % kt);
    bf16* stage = s_ring + st * 3 * T;
    load_tile_async<64>(stage, w_up + 64 * p, ld_up, k0, d);
    load_tile_async<64>(stage + T, w_up + d_ff + 64 * p, ld_up, k0, d);
    load_tile_async<64>(stage + 2 * T, w_down + k0, d, 64 * p, d_ff);
  };
  load_x_tiles(x, t, d, s_xn);
  ring_start(steps, load);
  ring_arrive();
  const bool first = blockIdx.y == 0;
  norm_tiles(t, d, nscale + static_cast<long>(t.img) * d, eps, s_xn, s_r, first ? xn : nullptr,
             first ? r_out : nullptr, threadIdx.x, blockDim.x);

  float acc[2][32], acc_dh[1][32];  // a and gate; dh
  zero(acc);
  zero(acc_dh);
  float dot[2] = {0.f, 0.f};
  for (int s = 0; s < steps; ++s) {
    const int k = s % kt;
    ring_arrive();
    bf16* stage = s_ring + (s % S) * 3 * T;
    wgmma_fence();
    product<0, 1>(acc, s_xn + k * T, stage, k);
    product<0, 0>(acc_dh, s_g + k * T, stage + 2 * T, k);
    wgmma_commit();
    if (k < kt - 1) {
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
      fence_acc(acc);
      fence_acc(acc_dh);
      __syncthreads();  // this step's stage is free: it stages h, da, dgate
      const int p0 = 64 * panel(s);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float hv[2], da[2], dg[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int at = 4 * i + 2 * hh + e;
            const float a = acc[0][at], gate = acc[1][at], dh = acc_dh[0][at];
            // gelu(g) = g Phi(g), gelu'(g) = Phi(g) + g phi(g)
            const float cdf = 0.5f * (1.0f + erff(gate * 0.70710678118654752440f));
            const float gel = gate * cdf;
            hv[e] = a * gel;
            da[e] = dh * gel;
            dg[e] = dh * a * (cdf + gate * __expf(-0.5f * gate * gate) * 0.39894228040143267794f);
          }
          const __nv_bfloat162 hb = __floats2bfloat162_rn(hv[0], hv[1]);
          const __nv_bfloat162 db = __floats2bfloat162_rn(da[0], da[1]);
          const __nv_bfloat162 gb = __floats2bfloat162_rn(dg[0], dg[1]);
          const int at = 4 * i + 2 * hh;
          dot[hh] += __low2float(db) * acc[0][at] + __high2float(db) * acc[0][at + 1] +
                     __low2float(gb) * acc[1][at] + __high2float(gb) * acc[1][at + 1];
          const int row = acc_row(hh), col = 8 * i + acc_col();
          stage_pair(stage, row, col, hb);
          stage_pair(stage + T, row, col, db);
          stage_pair(stage + 2 * T, row, col, gb);
        }
      __syncthreads();
      store_tile<64>(stage, h + t.row0 * d_ff + p0, d_ff, t.valid);
      store_tile<64>(stage + T, dup + t.row0 * ld_up + p0, ld_up, t.valid);
      store_tile<64>(stage + 2 * T, dup + t.row0 * ld_up + d_ff + p0, ld_up, t.valid);
    }
    ring_refill(s, steps, load);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float v = quad_sum(dot[hh]);
    const int row = acc_row(hh);
    if ((threadIdx.x & 3) == 0 && row < t.valid)
      dot_part[blockIdx.y * n_rows + t.row0 + row] = v;
  }
}

inline size_t ffn_dup_smem(int d) {
  return (2 * (d / 64) + gemm::S * 3) * gemm::T * sizeof(bf16) + wg::ROWS * sizeof(float) + 1024;
}

}  // namespace
}  // namespace kdt

using namespace kdt;

// The FF block forward (K4): out = x + bf16(GEGLU(xn W_up)) W_down with xn
// = AdaRMSNorm(x, nscale). x, out (rows, d) bf16 with rows = images *
// tokens; nscale (images, d) bf16; w_up (d, 2 d_ff), w_down (d_ff, d) bf16.
// A block is `warpgroups` warpgroups holding out_tiles 64-column tiles of
// the output (one warpgroup: 1, 2 or 4 tiles; two: 2, 6 or 8; out_tiles
// divides d / 64); the hidden panels split over clusters of `groups`
// blocks (1 to 8, at most d_ff / 64). With `clusters` not null nothing is launched: the number of
// clusters that fit on the device at once is written there. Needs d, d_ff
// % 64 == 0.
extern "C" int kdt_ffn_fwd(const void* x, const void* nscale, const void* w_up,
                           const void* w_down, void* out, int images, int tokens, int d,
                           int d_ff, int warpgroups, int out_tiles, int groups, float eps,
                           void* stream, int* clusters) {
  if (d % 64 || d_ff % 64 || out_tiles < 1 || (d / 64) % out_tiles || groups < 1 ||
      groups > 8 || groups > d_ff / 64)
    return static_cast<int>(cudaErrorInvalidValue);
  const bf16 *x_b = static_cast<const bf16*>(x), *ns_b = static_cast<const bf16*>(nscale);
  const bf16 *up_b = static_cast<const bf16*>(w_up), *down_b = static_cast<const bf16*>(w_down);
  bf16* out_b = static_cast<bf16*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define KDT_FFN_FWD(WG, NB)                                                                \
  if (warpgroups == WG && out_tiles == NB)                                                 \
    return static_cast<int>(launch_ffn_fwd<WG, NB>(x_b, ns_b, up_b, down_b, out_b, images, \
                                                   tokens, d, d_ff, groups, eps, st, clusters));
  KDT_FFN_FWD(1, 1)
  KDT_FFN_FWD(1, 2)
  KDT_FFN_FWD(1, 4)
  KDT_FFN_FWD(2, 2)
  KDT_FFN_FWD(2, 6)
  KDT_FFN_FWD(2, 8)
#undef KDT_FFN_FWD
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int kdt_mapping(const void* emb, const void* in_scale, const void* out_scale,
                           const void* norm_scales, const void* w_up, const void* w_down,
                           void* out, int b, int d, int d_ff, int n_blocks, float eps,
                           void* stream) {
  const size_t smem = STRIP * (d + 8 + d_ff + 8) * sizeof(bf16) +
                      (WARPS * STRIP * LDF + STRIP * (d + 4)) * sizeof(float);
  const cudaError_t attr = allow_smem(mapping_kernel, smem);
  mapping_kernel<<<(b + STRIP - 1) / STRIP, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(emb), static_cast<const float*>(in_scale),
      static_cast<const float*>(out_scale), static_cast<const float*>(norm_scales),
      static_cast<const bf16*>(w_up), static_cast<const bf16*>(w_down), static_cast<bf16*>(out),
      b, d, d_ff, n_blocks, eps);
  return launch_status(attr);
}

// The FF backward (K10). x, g (rows, d) bf16 with rows = images * tokens;
// nscale (images, d) bf16; w_up (d, 2 d_ff), w_down (d_ff, d) bf16.
// Writes dx (rows, d) bf16 (the residual's g included), dscale (images, d),
// dw_up (d, 2 d_ff) and dw_down (d_ff, d) f32. Scratch: h (rows, d_ff), dup
// (rows, 2 d_ff) and xn (rows, d) bf16; r (rows), dot_part (groups, rows),
// dns_part (images * tiles, d) and dw_part (chunks, d, 2 d_ff) f32, tiles =
// ceil(tokens / 64), chunks the larger of ceil(rows / chunk_up) and ceil(
// rows / chunk_down) (dw_down's partials reuse dw_part). The first kernel
// takes the hidden panels in `groups` groups; chunk_up and chunk_down are
// the rows per dW partial, multiples of 64. Needs d, d_ff % 64 == 0.
extern "C" int kdt_ffn_bwd(const void* x, const void* nscale, const void* w_up,
                           const void* w_down, const void* g, void* dx, void* dscale,
                           void* dw_up, void* dw_down, void* h, void* dup, void* xn, void* r,
                           void* dot_part, void* dns_part, void* dw_part, int images, int tokens,
                           int d, int d_ff, int groups, int chunk_up, int chunk_down, float eps,
                           void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d % 64 || d_ff % 64) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = ffn_dup_smem(d);
  cudaError_t err = gemm::allow_shared(ffn_dup_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (tokens + wg::ROWS - 1) / wg::ROWS;
  const int rows = images * tokens;
  const bf16 *x_b = static_cast<const bf16*>(x), *ns_b = static_cast<const bf16*>(nscale);
  const bf16 *w_up_b = static_cast<const bf16*>(w_up), *g_b = static_cast<const bf16*>(g);
  bf16 *h_b = static_cast<bf16*>(h), *dup_b = static_cast<bf16*>(dup);
  bf16* xn_b = static_cast<bf16*>(xn);
  float *r_f = static_cast<float*>(r), *dot_f = static_cast<float*>(dot_part);
  ffn_dup_kernel<<<dim3(images * tiles, groups), gemm::THREADS, smem, st>>>(
      x_b, ns_b, w_up_b, static_cast<const bf16*>(w_down), g_b, h_b, dup_b, xn_b, r_f, dot_f,
      rows, tokens, d, d_ff, groups, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const gemm::Split dup_s{dup_b, 2L * d_ff, 2 * d_ff, dup_b, 2L * d_ff};
  err = gemm::launch_norm_vjp(dup_s, w_up_b, x_b, ns_b, g_b, r_f, dot_f, groups,
                              static_cast<bf16*>(dx), static_cast<float*>(dns_part),
                              static_cast<float*>(dscale), images, tokens, d, 2 * d_ff, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* part = static_cast<float*>(dw_part);
  err = gemm::launch_atb(xn_b, d, dup_s, part, static_cast<float*>(dw_up), rows, d, 2 * d_ff,
                         chunk_up, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const gemm::Split g_s{g_b, d, d, g_b, d};
  return static_cast<int>(gemm::launch_atb(h_b, d_ff, g_s, part, static_cast<float*>(dw_down),
                                           rows, d_ff, d, chunk_down, st));
}

KDT_DEFINE_ERROR_STRING
