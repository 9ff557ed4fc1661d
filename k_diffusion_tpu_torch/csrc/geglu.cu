// GEGLU feed-forward kernels: the HDiT FF block (two launches) and the whole
// mapping network (one launch), sharing the GEGLU block device code below.
//
// Replaces: k_diffusion_tpu/ops/pallas/fused_ffn.py:_ffn_kernel (the forward
// of fused_geglu_ffn) with ffn_up_kernel + ffn_down_kernel, and
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
//   2.4 MB (0.7 us), on an (8, 256) activation: bound by latency, one block.
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
// - mapping_kernel: one block holds the (<= 16, d) residual stream in f32
//   shared memory and runs every block of the network through the same
//   strip code (mma_strip, geglu_strip) with W read from L2.
#include "common.cuh"

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

// emb (b, d) bf16 with b <= 16; scales f32; norm_scales (n, d) f32;
// w_up (n, d, 2 d_ff) and w_down (n, d_ff, d) bf16; out (b, d) bf16.
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
  for (int i = threadIdx.x; i < STRIP * d; i += blockDim.x) {
    const int r = i / d, c = i % d;
    xs[r * ldx + c] = r < b ? to_f(emb[r * d + c]) : 0.f;
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
  for (int i = threadIdx.x; i < b * d; i += blockDim.x)
    out[i] = to_bf(xs[(i / d) * ldx + i % d]);
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
  mapping_kernel<<<1, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(emb), static_cast<const float*>(in_scale),
      static_cast<const float*>(out_scale), static_cast<const float*>(norm_scales),
      static_cast<const bf16*>(w_up), static_cast<const bf16*>(w_down), static_cast<bf16*>(out),
      b, d, d_ff, n_blocks, eps);
  return launch_status(attr);
}

KDT_DEFINE_ERROR_STRING
