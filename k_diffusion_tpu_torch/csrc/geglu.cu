// GEGLU feed-forward kernels: the HDiT FF block, forward (K4, two launches)
// and backward (K10), and the whole mapping network (K5, one launch),
// sharing the GEGLU block device code below.
//
// Replaces: k_diffusion_tpu/ops/pallas/fused_ffn.py:_ffn_kernel (the forward
// of fused_geglu_ffn) with ffn_up_kernel + ffn_down_kernel,
// fused_ffn.py:_ffn_bwd_kernel (its backward) with ffn_dup_kernel and the
// shared steps of gemm.cuh, and
// k_diffusion_tpu/ops/pallas/fused_mapping.py:_mapping_kernel (the forward
// of fused_mapping) with mapping_kernel.
//
// What bounds them on the H100, flagship eval shapes at batch 8:
// - FF block: 6 * tokens * d * d_ff = 9.7 GFLOP at every level (9.8 us at
//   989 TFLOP/s). x in and out is 17 MB at level 0 (5 us at 3.35 TB/s), but
//   this two-launch design also writes and reads the bf16 hidden activation
//   h (tokens, d_ff): 50 MB more at level 0, so it is bound by memory
//   (20 us) until the two launches become one.
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
// - ffn_up_kernel: a block owns 64 token rows and 64 hidden units: the
//   matching 64 columns of both GEGLU halves of W_up (value a and gate). It
//   takes each row's RMS statistics, then walks d in chunks of 64 staging
//   the AdaRMSNorm'd x chunk and both W_up chunks in shared memory; each
//   warp multiplies its 16 rows with wmma bf16 fragments into f32. The
//   epilogue forms h = a * gelu(gate) (exact erf) on the accumulators and
//   writes bf16 h, the rounding point of the Pallas kernel.
// - ffn_down_kernel: a block owns 64 rows and 64 output columns, walks d_ff
//   in chunks of 64 staging h and W_down, and adds the residual x before
//   the bf16 write.
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

__global__ void __launch_bounds__(THREADS)
ffn_up_kernel(const bf16* __restrict__ x, const bf16* __restrict__ nscale,
              const bf16* __restrict__ w_up, bf16* __restrict__ h, long rows, int tokens, int d,
              int d_ff, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* s_a = reinterpret_cast<bf16*>(smem);
  bf16* s_val = s_a + BM * LDT;
  bf16* s_gate = s_val + PANEL * LDT;
  float* scratch = reinterpret_cast<float*>(s_gate + PANEL * LDT);
  float* s_inv = scratch + WARPS * STRIP * LDF;
  int* s_img = reinterpret_cast<int*>(s_inv + BM);

  const int warp = threadIdx.x / 32;
  const long row0 = static_cast<long>(blockIdx.x) * BM;
  const int valid = static_cast<int>(rows - row0 < BM ? rows - row0 : BM);
  const int n0 = blockIdx.y * PANEL;
  const long ld_w = 2L * d_ff;

  norm_stats(x, row0, valid, d, tokens, eps, s_inv, s_img);
  __syncthreads();

  FragC acc_a[4], acc_g[4];
  zero(acc_a);
  zero(acc_g);
  for (int k0 = 0; k0 < d; k0 += PANEL) {
    load_norm_tile(s_a, x, row0, valid, d, k0, nscale, s_inv, s_img);
    load_tile(s_val, w_up + k0 * ld_w + n0, ld_w, PANEL, PANEL);
    load_tile(s_gate, w_up + k0 * ld_w + d_ff + n0, ld_w, PANEL, PANEL);
    __syncthreads();
    const bf16* a = s_a + warp * STRIP * LDT;
    mma_strip(a, LDT, s_val, LDT, PANEL, acc_a);
    mma_strip(a, LDT, s_gate, LDT, PANEL, acc_g);
    __syncthreads();
  }
  geglu_strip(acc_a, acc_g, scratch + warp * STRIP * LDF,
              h + (row0 + warp * STRIP) * d_ff + n0, d_ff, valid - warp * STRIP);
}

__global__ void __launch_bounds__(THREADS)
ffn_down_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w_down,
                const bf16* __restrict__ x, bf16* __restrict__ out, long rows, int d, int d_ff) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* s_a = reinterpret_cast<bf16*>(smem);
  bf16* s_b = s_a + BM * LDT;
  float* scratch = reinterpret_cast<float*>(s_b + PANEL * LDT);

  const int warp = threadIdx.x / 32;
  const long row0 = static_cast<long>(blockIdx.x) * BM;
  const int valid = static_cast<int>(rows - row0 < BM ? rows - row0 : BM);
  const int n0 = blockIdx.y * PANEL;

  FragC acc[4];
  zero(acc);
  for (int k0 = 0; k0 < d_ff; k0 += PANEL) {
    load_tile(s_a, h + row0 * d_ff + k0, d_ff, BM, valid);
    load_tile(s_b, w_down + static_cast<long>(k0) * d + n0, d, PANEL, PANEL);
    __syncthreads();
    mma_strip(s_a + warp * STRIP * LDT, LDT, s_b, LDT, PANEL, acc);
    __syncthreads();
  }
  float* strip = scratch + warp * STRIP * LDF;
  store_strip(strip, LDF, acc);
  const long r0 = (row0 + warp * STRIP) * d + n0;
  write_strip(strip, LDF, out + r0, d, x + r0, valid - warp * STRIP);
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
             first ? r_out : nullptr);

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

// x (rows, d) bf16 with rows = images * tokens; nscale (images, d) bf16;
// w_up (d, 2 d_ff) bf16; h (rows, d_ff) bf16. Needs d, d_ff % 64 == 0.
extern "C" int kdt_ffn_up(const void* x, const void* nscale, const void* w_up, void* h,
                          long rows, int tokens, int d, int d_ff, float eps, void* stream) {
  const size_t smem = (BM + 2 * PANEL) * LDT * sizeof(bf16) +
                      WARPS * STRIP * LDF * sizeof(float) + BM * (sizeof(float) + sizeof(int));
  const cudaError_t attr = allow_smem(ffn_up_kernel, smem);
  const dim3 grid(static_cast<unsigned>((rows + BM - 1) / BM), d_ff / PANEL);
  ffn_up_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(nscale),
      static_cast<const bf16*>(w_up), static_cast<bf16*>(h), rows, tokens, d, d_ff, eps);
  return launch_status(attr);
}

// h (rows, d_ff) bf16; w_down (d_ff, d) bf16; x, out (rows, d) bf16:
// out = x + h @ w_down.
extern "C" int kdt_ffn_down(const void* h, const void* w_down, const void* x, void* out,
                            long rows, int d, int d_ff, void* stream) {
  const size_t smem = (BM + PANEL) * LDT * sizeof(bf16) + WARPS * STRIP * LDF * sizeof(float);
  const cudaError_t attr = allow_smem(ffn_down_kernel, smem);
  const dim3 grid(static_cast<unsigned>((rows + BM - 1) / BM), d / PANEL);
  ffn_down_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w_down),
      static_cast<const bf16*>(x), static_cast<bf16*>(out), rows, d, d_ff);
  return launch_status(attr);
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
