// GEGLU feed-forward kernels: the HDiT FF block, forward (K4, two launches)
// and backward (K10), and the whole mapping network (K5, one launch),
// sharing the GEGLU block device code below.
//
// Replaces: k_diffusion_tpu/ops/pallas/fused_ffn.py:_ffn_kernel (the forward
// of fused_geglu_ffn) with ffn_up_kernel + ffn_down_kernel,
// fused_ffn.py:_ffn_bwd_kernel (its backward) with ffn_hidden_bwd_kernel and
// the shared steps of grad.cuh, and
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
// - FF backward, training shapes at batch 32: the recomputed up projection
//   plus four VJP products, 16 * tokens * d * d_ff = 103 GFLOP at levels 0
//   and 1 (104 us at 989 TFLOP/s), against x, g, dx (100 MB at level 0), in
//   this design, h (rows, d_ff), dup (rows, 2 d_ff) and xn written and read
//   back (2 * 335 MB at level 0, 200 us): bound by memory.
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
// - ffn_hidden_bwd_kernel: the up-kernel's tiling; recomputes a and gate,
//   computes dh = g @ W_down^T for the same 64 hidden units, and writes h =
//   a gelu(gate) and dup = (dh gelu(gate), dh a gelu'(gate)) in bf16 (the
//   Pallas rounding points); panel 0 also writes xn. Then grad.cuh:
//   norm_bwd_kernel gives dx (+ g, the residual) and d(scale) from
//   dup @ W_up^T; atb_partial_kernel gives dW_up = xn^T dup and dW_down =
//   h^T g as fixed-order f32 sums.
// - mapping_kernel: one block per 16-row strip of the batch holds the
//   strip's residual stream in f32 shared memory and runs every block of
//   the network through the same strip code (mma_strip, geglu_strip) with
//   W read from L2.
#include "grad.cuh"

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


// gelu'(g) = Phi(g) + g phi(g), exact erf as the forward
__device__ __forceinline__ float gelu_erf_grad(float g) {
  const float cdf = 0.5f * (1.0f + erff(g * 0.70710678118654752440f));
  return cdf + g * __expf(-0.5f * g * g) * 0.39894228040143267794f;
}

__global__ void __launch_bounds__(THREADS)
ffn_hidden_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ nscale,
                      const bf16* __restrict__ w_up, const bf16* __restrict__ w_down,
                      const bf16* __restrict__ g, bf16* __restrict__ h, bf16* __restrict__ dup,
                      bf16* __restrict__ xn, int tokens, int d, int d_ff, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* s_a = reinterpret_cast<bf16*>(smem);
  bf16* s_val = s_a + BM * LDT;
  bf16* s_gate = s_val + PANEL * LDT;
  float* scratch = reinterpret_cast<float*>(s_gate + PANEL * LDT);
  float* s_inv = scratch + WARPS * STRIP * LDF;
  int* s_img = reinterpret_cast<int*>(s_inv + BM);

  const int warp = threadIdx.x / 32;
  const RowTile t = row_tile(tokens);
  const int n0 = blockIdx.y * PANEL;
  const long ld_w = 2L * d_ff;

  norm_stats(x, t.row0, t.valid, d, tokens, eps, s_inv, s_img);
  __syncthreads();

  FragC acc_a[4], acc_g[4], acc_dh[4];
  zero(acc_a);
  zero(acc_g);
  zero(acc_dh);
  const bf16* a_strip = s_a + warp * STRIP * LDT;
  for (int k0 = 0; k0 < d; k0 += PANEL) {
    load_norm_tile(s_a, x, t.row0, t.valid, d, k0, nscale, s_inv, s_img);
    load_tile(s_val, w_up + k0 * ld_w + n0, ld_w, PANEL, PANEL);
    load_tile(s_gate, w_up + k0 * ld_w + d_ff + n0, ld_w, PANEL, PANEL);
    __syncthreads();
    if (blockIdx.y == 0) {
      for (int i = threadIdx.x; i < t.valid * 8; i += blockDim.x) {
        const int r = i >> 3, c = (i & 7) * 8;
        *reinterpret_cast<uint4*>(xn + (t.row0 + r) * d + k0 + c) =
            *reinterpret_cast<const uint4*>(s_a + r * LDT + c);
      }
    }
    mma_strip(a_strip, LDT, s_val, LDT, PANEL, acc_a);
    mma_strip(a_strip, LDT, s_gate, LDT, PANEL, acc_g);
    __syncthreads();
  }
  // dh = g @ W_down^T for hidden units [n0, n0 + 64): W_down rows n0.. as
  // the transposed operand
  for (int k0 = 0; k0 < d; k0 += PANEL) {
    load_tile(s_a, g + t.row0 * d + k0, d, BM, t.valid);
    load_tile(s_val, w_down + static_cast<long>(n0) * d + k0, d, PANEL, PANEL);
    __syncthreads();
    mma_strip_bt(a_strip, LDT, s_val, LDT, PANEL, acc_dh);
    __syncthreads();
  }
  // the three accumulators share one fragment layout: elementwise in place
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < acc_a[j].num_elements; ++e) {
      const float a = acc_a[j].x[e], gate = acc_g[j].x[e], dh = acc_dh[j].x[e];
      const float gel = gelu_erf(gate);
      acc_a[j].x[e] = a * gel;                        // h
      acc_g[j].x[e] = dh * a * gelu_erf_grad(gate);   // d gate
      acc_dh[j].x[e] = dh * gel;                      // d a
    }
  float* strip = scratch + warp * STRIP * LDF;
  const long r0 = t.row0 + warp * STRIP;
  const int valid = t.valid - warp * STRIP;
  store_strip(strip, LDF, acc_a);
  write_strip(strip, LDF, h + r0 * d_ff + n0, d_ff, nullptr, valid);
  store_strip(strip, LDF, acc_dh);
  write_strip(strip, LDF, dup + r0 * ld_w + n0, ld_w, nullptr, valid);
  store_strip(strip, LDF, acc_g);
  write_strip(strip, LDF, dup + r0 * ld_w + d_ff + n0, ld_w, nullptr, valid);
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

// The FF backward. x, g (rows, d) bf16 with rows = images * tokens; nscale
// (images, d) bf16; w_up (d, 2 d_ff), w_down (d_ff, d) bf16. Writes dx
// (rows, d) bf16 (the residual's g included), dscale (images, d), dw_up
// (d, 2 d_ff) and dw_down (d_ff, d) f32. Scratch: h (rows, d_ff), dup
// (rows, 2 d_ff) and xn (rows, d) bf16; dns_part (images * tiles, d) and
// dw_part (chunks, d, 2 d_ff) f32, with tiles = ceil(tokens / 64) and
// chunks = ceil(rows / 2048) (dw_down's partials reuse dw_part).
extern "C" int kdt_ffn_bwd(const void* x, const void* nscale, const void* w_up,
                           const void* w_down, const void* g, void* dx, void* dscale,
                           void* dw_up, void* dw_down, void* h, void* dup, void* xn,
                           void* dns_part, void* dw_part, int images, int tokens, int d,
                           int d_ff, float eps, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (BM + 2 * PANEL) * LDT * sizeof(bf16) +
                      WARPS * STRIP * LDF * sizeof(float) + BM * (sizeof(float) + sizeof(int));
  cudaError_t err = allow_smem(ffn_hidden_bwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (tokens + BM - 1) / BM;
  const long rows = static_cast<long>(images) * tokens;
  const bf16* w_up_b = static_cast<const bf16*>(w_up);
  const bf16* g_b = static_cast<const bf16*>(g);
  ffn_hidden_bwd_kernel<<<dim3(images * tiles, d_ff / PANEL), THREADS, smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(nscale), w_up_b,
      static_cast<const bf16*>(w_down), g_b, static_cast<bf16*>(h), static_cast<bf16*>(dup),
      static_cast<bf16*>(xn), tokens, d, d_ff, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_norm_bwd(static_cast<const bf16*>(dup), w_up_b, static_cast<const bf16*>(x),
                        static_cast<const bf16*>(nscale), g_b, static_cast<bf16*>(dx),
                        static_cast<float*>(dns_part), static_cast<float*>(dscale), images,
                        tokens, d, 2 * d_ff, eps, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_atb(static_cast<const bf16*>(xn), static_cast<const bf16*>(dup),
                   static_cast<float*>(dw_part), static_cast<float*>(dw_up), rows, d, 2 * d_ff,
                   st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_atb(static_cast<const bf16*>(h), g_b,
                                     static_cast<float*>(dw_part), static_cast<float*>(dw_down),
                                     rows, d_ff, d, st));
}

KDT_DEFINE_ERROR_STRING
