// Fused attention prologue: AdaRMSNorm -> x @ W_qkv -> per-head cosine-sim
// scaling of q and k -> axial RoPE on q and k; packed (b, h, w, d) q, k, v.
// Forward (K1) and backward (K6).
//
// Replaces: k_diffusion_tpu/ops/pallas/fused_qkv.py:_fused_qkv_kernel (the
// forward of fused_qkv_prologue) and :_prologue_bwd_kernel (its backward).
//
// What bounds it on the H100, flagship eval shapes at batch 8: the product
// is 2 * tokens * d * 3d = 3.2 GFLOP at every level (3.3 us at the bf16
// tensor-core peak of 989 TFLOP/s), while the bytes are x in plus q, k, v
// out: 34 MB at level 0 (d = 128, 10 us at 3.35 TB/s) and 9.5 MB at level 2
// (d = 512, weights included, 2.8 us). So levels 0 and 1 are bound by
// memory and level 2 is balanced.
//
// Design: the raw projection never goes to device memory. A block owns 64
// token rows and one 64-column panel of W_qkv, i.e. one head of q, k or v
// (grid y). It first takes each row's RMS statistics, then walks K in
// chunks of 64: the normalised x chunk (bf16, rounded where the JAX package
// rounds) and the W chunk are staged in shared memory and each warp
// multiplies its 16 rows with wmma bf16 fragments into f32 accumulators.
// The epilogue applies the per-head cosine-sim scale (sum of squares over
// the head's 64 columns, kept in f32) and the half-split RoPE (pair
// distance 16 on the first 32 dims) and writes bf16 once. The RoPE angles
// arrive as cos/sin tables (tokens, heads * 16) that the wrapper builds from
// the positions the model passes. Staging is not double-buffered and the
// x tile is re-normalised for each of the 3 * heads panels: simple first.
#include "grad.cuh"

namespace kdt {
namespace {

constexpr int ROT = 16;  // RoPE pair distance: rotated dims are [0, 32)

__global__ void __launch_bounds__(THREADS)
fused_qkv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ nscale,
                 const bf16* __restrict__ w, const float* __restrict__ attn_scale,
                 const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                 bf16* __restrict__ q, bf16* __restrict__ k, bf16* __restrict__ v, long rows,
                 int tokens, int d, int n_heads, float eps, float cos_eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* s_a = reinterpret_cast<bf16*>(smem);
  bf16* s_b = s_a + BM * LDT;
  float* scratch = reinterpret_cast<float*>(s_b + PANEL * LDT);
  float* s_inv = scratch + WARPS * STRIP * LDF;
  int* s_img = reinterpret_cast<int*>(s_inv + BM);

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const long row0 = static_cast<long>(blockIdx.x) * BM;
  const int valid = static_cast<int>(rows - row0 < BM ? rows - row0 : BM);
  const int sec = blockIdx.y / n_heads, head = blockIdx.y % n_heads;  // sec 0/1/2: q/k/v
  const int n0 = sec * d + head * PANEL;
  const long ld_w = 3L * d;

  norm_stats(x, row0, valid, d, tokens, eps, s_inv, s_img);
  __syncthreads();

  FragC acc[4];
  zero(acc);
  for (int k0 = 0; k0 < d; k0 += PANEL) {
    load_norm_tile(s_a, x, row0, valid, d, k0, nscale, s_inv, s_img);
    load_tile(s_b, w + k0 * ld_w + n0, ld_w, PANEL, PANEL);
    __syncthreads();
    mma_strip(s_a + warp * STRIP * LDT, LDT, s_b, LDT, PANEL, acc);
    __syncthreads();
  }

  float* strip = scratch + warp * STRIP * LDF;
  store_strip(strip, LDF, acc);
  bf16* out = (sec == 0 ? q : (sec == 1 ? k : v)) + head * PANEL;
  const float root = sec < 2 ? sqrtf(attn_scale[head]) : 1.f;
  for (int r = 0; r < STRIP; ++r) {
    const long row = row0 + warp * STRIP + r;
    if (warp * STRIP + r >= valid) break;
    const float* a_r = strip + r * LDF;
    const float v0 = a_r[lane], v1 = a_r[lane + 32];
    bf16* o = out + row * d;
    if (sec == 2) {
      o[lane] = to_bf(v0);
      o[lane + 32] = to_bf(v1);
      continue;
    }
    const float s = root * rsqrtf(warp_sum(v0 * v0 + v1 * v1) + cos_eps);
    const long t = (row % tokens) * n_heads + head;
    const float cs = cos_t[t * ROT + (lane & 15)];
    const float sn = sin_t[t * ROT + (lane & 15)];
    const float partner = a_r[lane ^ 16];
    // y1 = x1 cos - x2 sin (lanes 0..15), y2 = x2 cos + x1 sin (16..31)
    const float y = lane < 16 ? v0 * cs - partner * sn : v0 * cs + partner * sn;
    o[lane] = to_bf(y * s);
    o[lane + 32] = to_bf(v1 * s);
  }
}

// K6, the backward. What bounds it on the H100, flagship training shapes
// at batch 32: the recomputed projection and the two VJP products are
// 3 * 2 * tokens * d * 3d FLOP, 38.7 GFLOP at each level (39 us at 989
// TFLOP/s), against x, gq, gk, gv and dx (5 * 33.5 MB at level 0, 50 us at
// 3.35 TB/s) plus, in this design, the bf16 dR (rows, 3d) and xn written
// and read back (2 * 134 MB at level 0, 80 us). So it is bound by memory.
//
// Design, three steps (the Pallas kernel keeps dR in VMEM; here it goes
// through device memory, which keeps each step a plain tiled product):
// 1. prologue_dr_kernel, grid (row tiles, 3 * heads panels): recomputes the
//    raw projection of one head panel exactly as the forward does, then per
//    row runs the RoPE VJP (the forward rotation with the sine's sign
//    flipped; the partner lane is i ^ 16) and the cosine-sim VJP (the
//    head's sums over its 64 lanes are warp sums), writing dR = (dq_raw,
//    dk_raw, gv) in bf16, the Pallas rounding point. Panel 0 also writes
//    xn, the bf16 normalised x. Per block it writes its sum of g * qn for
//    d(attn_scale), finished by reduce_kernel and a division by
//    2 * attn_scale in the wrapper.
// 2. norm_bwd_kernel (grad.cuh): dxn = dR @ W^T, the RMS-norm VJP -> dx and
//    the d(norm_scale) partials.
// 3. atb_partial_kernel (grad.cuh): dW_qkv = xn^T dR in f32 partials over
//    row chunks, summed in a fixed order.
__global__ void __launch_bounds__(THREADS)
prologue_dr_kernel(const bf16* __restrict__ x, const bf16* __restrict__ nscale,
                   const bf16* __restrict__ w, const float* __restrict__ attn_scale,
                   const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                   const bf16* __restrict__ gq, const bf16* __restrict__ gk,
                   const bf16* __restrict__ gv, bf16* __restrict__ dr, bf16* __restrict__ xn,
                   float* __restrict__ das_part, int tokens, int d, int n_heads, float eps,
                   float cos_eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* s_a = reinterpret_cast<bf16*>(smem);
  bf16* s_b = s_a + BM * LDT;
  float* scratch = reinterpret_cast<float*>(s_b + PANEL * LDT);
  float* s_inv = scratch + WARPS * STRIP * LDF;
  int* s_img = reinterpret_cast<int*>(s_inv + BM);
  __shared__ float s_das[WARPS];

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const RowTile t = row_tile(tokens);
  const int sec = blockIdx.y / n_heads, head = blockIdx.y % n_heads;  // sec 0/1/2: q/k/v
  const int n0 = sec * d + head * PANEL;
  const long ld_w = 3L * d;

  norm_stats(x, t.row0, t.valid, d, tokens, eps, s_inv, s_img);
  __syncthreads();

  FragC acc[4];
  zero(acc);
  for (int k0 = 0; k0 < d; k0 += PANEL) {
    load_norm_tile(s_a, x, t.row0, t.valid, d, k0, nscale, s_inv, s_img);
    load_tile(s_b, w + k0 * ld_w + n0, ld_w, PANEL, PANEL);
    __syncthreads();
    if (blockIdx.y == 0) {
      for (int i = threadIdx.x; i < t.valid * 8; i += blockDim.x) {
        const int r = i >> 3, c = (i & 7) * 8;
        *reinterpret_cast<uint4*>(xn + (t.row0 + r) * d + k0 + c) =
            *reinterpret_cast<const uint4*>(s_a + r * LDT + c);
      }
    }
    mma_strip(s_a + warp * STRIP * LDT, LDT, s_b, LDT, PANEL, acc);
    __syncthreads();
  }

  float* strip = scratch + warp * STRIP * LDF;
  store_strip(strip, LDF, acc);
  const bf16* g = sec == 0 ? gq : (sec == 1 ? gk : gv);
  const float root = sec < 2 ? sqrtf(attn_scale[head]) : 0.f;
  float das = 0.f;
  for (int r = 0; r < STRIP; ++r) {
    if (warp * STRIP + r >= t.valid) break;
    const long row = t.row0 + warp * STRIP + r;
    const bf16* g_r = g + row * d + head * PANEL;
    bf16* o = dr + row * ld_w + n0;
    const float g0 = to_f(g_r[lane]), g1 = to_f(g_r[lane + 32]);
    if (sec == 2) {
      o[lane] = to_bf(g0);
      o[lane + 32] = to_bf(g1);
      continue;
    }
    const float* a_r = strip + r * LDF;
    const float v0 = a_r[lane], v1 = a_r[lane + 32];
    const long tt = (row % tokens) * n_heads + head;
    const float cs = cos_t[tt * ROT + (lane & 15)];
    const float sn = sin_t[tt * ROT + (lane & 15)];
    const float partner = __shfl_xor_sync(0xffffffffu, g0, ROT);
    // the RoPE VJP: g1' = g1 cos + g2 sin (lanes 0..15), g2' = g2 cos - g1 sin
    const float gr0 = lane < 16 ? g0 * cs + partner * sn : g0 * cs - partner * sn;
    // the cosine-sim VJP: qn = raw * root / sqrt(ssq + eps)
    const float inv = rsqrtf(warp_sum(v0 * v0 + v1 * v1) + cos_eps);
    const float rho = root * inv;
    const float gsum = warp_sum(gr0 * v0 + g1 * v1);
    const float coef = rho * inv * inv * gsum;
    o[lane] = to_bf(rho * gr0 - v0 * coef);
    o[lane + 32] = to_bf(rho * g1 - v1 * coef);
    das += rho * gsum;  // sum of g * qn over the head's lanes
  }
  if (sec < 2) {
    if (lane == 0) s_das[warp] = das;
    __syncthreads();
    if (threadIdx.x == 0)
      das_part[static_cast<long>(blockIdx.x) * 2 * n_heads + sec * n_heads + head] =
          s_das[0] + s_das[1] + s_das[2] + s_das[3];
  }
}

}  // namespace
}  // namespace kdt

using namespace kdt;

// x (rows, d) bf16 with rows = images * tokens; nscale (images, d) bf16;
// w (d, 3d) bf16; attn_scale (heads,) f32; cos/sin (tokens, heads * 16) f32;
// q, k, v (rows, d) bf16. Needs d == 64 * heads.
extern "C" int kdt_fused_qkv(const void* x, const void* nscale, const void* w,
                             const void* attn_scale, const void* cos_t, const void* sin_t,
                             void* q, void* k, void* v, long rows, int tokens, int d,
                             int n_heads, float eps, float cos_eps, void* stream) {
  const size_t smem = (BM + PANEL) * LDT * sizeof(bf16) +
                      WARPS * STRIP * LDF * sizeof(float) + BM * (sizeof(float) + sizeof(int));
  const cudaError_t attr = allow_smem(fused_qkv_kernel, smem);
  const dim3 grid(static_cast<unsigned>((rows + BM - 1) / BM), 3 * n_heads);
  fused_qkv_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(nscale),
      static_cast<const bf16*>(w), static_cast<const float*>(attn_scale),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t), static_cast<bf16*>(q),
      static_cast<bf16*>(k), static_cast<bf16*>(v), rows, tokens, d, n_heads, eps, cos_eps);
  return launch_status(attr);
}

// The backward. x (rows, d) bf16 with rows = images * tokens; nscale
// (images, d) bf16; w (d, 3d) bf16; attn_scale (heads,) f32; cos/sin as the
// forward's; gq, gk, gv (rows, d) bf16. Writes dx (rows, d) bf16, dns
// (images, d) f32, dw (d, 3d) f32 and das_sums (2 * heads) f32, the sums of
// g * qn for q then k (the wrapper divides by 2 * attn_scale). Scratch: dr
// (rows, 3d) and xn (rows, d) bf16; das_part (images * tiles, 2 * heads),
// dns_part (images * tiles, d) and dw_part (chunks, d, 3d) f32, with tiles =
// ceil(tokens / 64) and chunks = ceil(rows / 2048).
extern "C" int kdt_fused_qkv_bwd(const void* x, const void* nscale, const void* w,
                                 const void* attn_scale, const void* cos_t, const void* sin_t,
                                 const void* gq, const void* gk, const void* gv, void* dx,
                                 void* dns, void* dw, void* das_sums, void* dr, void* xn,
                                 void* das_part, void* dns_part, void* dw_part, int images,
                                 int tokens, int d, int n_heads, float eps, float cos_eps,
                                 void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (BM + PANEL) * LDT * sizeof(bf16) +
                      WARPS * STRIP * LDF * sizeof(float) + BM * (sizeof(float) + sizeof(int));
  cudaError_t err = allow_smem(prologue_dr_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (tokens + BM - 1) / BM;
  const long rows = static_cast<long>(images) * tokens;
  prologue_dr_kernel<<<dim3(images * tiles, 3 * n_heads), THREADS, smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(nscale),
      static_cast<const bf16*>(w), static_cast<const float*>(attn_scale),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<const bf16*>(gq), static_cast<const bf16*>(gk), static_cast<const bf16*>(gv),
      static_cast<bf16*>(dr), static_cast<bf16*>(xn), static_cast<float*>(das_part), tokens, d,
      n_heads, eps, cos_eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_kernel<<<1, 256, 0, st>>>(static_cast<const float*>(das_part),
                                   static_cast<float*>(das_sums), 1, images * tiles,
                                   2 * n_heads);
  err = launch_norm_bwd(static_cast<const bf16*>(dr), static_cast<const bf16*>(w),
                        static_cast<const bf16*>(x), static_cast<const bf16*>(nscale), nullptr,
                        static_cast<bf16*>(dx), static_cast<float*>(dns_part),
                        static_cast<float*>(dns), images, tokens, d, 3 * d, eps, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_atb(static_cast<const bf16*>(xn),
                                     static_cast<const bf16*>(dr), static_cast<float*>(dw_part),
                                     static_cast<float*>(dw), rows, d, 3 * d, st));
}

KDT_DEFINE_ERROR_STRING
