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
// token rows and one 64-column panel of W_qkv, i.e. 64 / E heads of q, k
// or v (grid y). It first takes each row's RMS statistics, then walks K in
// chunks of 64: the normalised x chunk (bf16, rounded where the JAX package
// rounds) and the W chunk are staged in shared memory and each warp
// multiplies its 16 rows with wmma bf16 fragments into f32 accumulators.
// The epilogue applies the per-head cosine-sim scale (sum of squares over
// the head's E columns, kept in f32) and the half-split RoPE (pair distance
// E / 4 on the first E / 2 dims) and writes bf16 once. The RoPE angles
// arrive as cos/sin tables (tokens, heads * E / 4) that the wrapper builds
// from the positions the model passes. Staging is not double-buffered and
// the x tile is re-normalised for each of the 3 * d / 64 panels: simple
// first.
//
// The head dim E is a template parameter, 64 (the flagship) or 32
// (configs/config_test_tiny.json): a 64-column panel then holds 64 / E
// heads, and lane l's two columns l and l + 32 belong to heads
// panel * 64 / E + l / E and panel * 64 / E + (l + 32) / E.
#include "grad.cuh"

namespace kdt {
namespace {

// Where column col (lane or lane + 32) of a panel sits: its head, its dim
// within the head, and the RoPE pair distance E / 4.
template <int E>
struct PanelColumn {
  static constexpr int R = E / 4;
  int head, dim;
  __device__ PanelColumn(int panel, int col) : head(panel * (PANEL / E) + col / E), dim(col % E) {}
  __device__ bool rotated() const { return dim < 2 * R; }
  __device__ bool first_half() const { return dim < R; }
  __device__ long table(long token, int n_heads) const {
    return (token * n_heads + head) * R + dim % R;
  }
};

// Per-head sums over a row of a panel, lane l holding columns l and l + 32:
// one head (E == 64) sums both, two heads (E == 32) each their own.
template <int E>
__device__ __forceinline__ void head_sums(float a0, float a1, float (&out)[2]) {
  if constexpr (E == PANEL) {
    out[0] = out[1] = warp_sum(a0 + a1);
  } else {
    out[0] = warp_sum(a0);
    out[1] = warp_sum(a1);
  }
}

template <int E>
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
  const int panels = d / PANEL;
  const int sec = blockIdx.y / panels, panel = blockIdx.y % panels;  // sec 0/1/2: q/k/v
  const int n0 = sec * d + panel * PANEL;
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
  bf16* out = (sec == 0 ? q : (sec == 1 ? k : v)) + panel * PANEL;
  const PanelColumn<E> cols[2] = {PanelColumn<E>(panel, lane), PanelColumn<E>(panel, lane + 32)};
  for (int r = 0; r < STRIP; ++r) {
    const long row = row0 + warp * STRIP + r;
    if (warp * STRIP + r >= valid) break;
    const float* a_r = strip + r * LDF;
    const float vals[2] = {a_r[lane], a_r[lane + 32]};
    bf16* o = out + row * d;
    if (sec == 2) {
      o[lane] = to_bf(vals[0]);
      o[lane + 32] = to_bf(vals[1]);
      continue;
    }
    float ssq[2];
    head_sums<E>(vals[0] * vals[0], vals[1] * vals[1], ssq);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int col = lane + 32 * i;
      const PanelColumn<E>& pc = cols[i];
      const float s = sqrtf(attn_scale[pc.head]) * rsqrtf(ssq[i] + cos_eps);
      float y = vals[i];
      if (pc.rotated()) {
        const long t = pc.table(row % tokens, n_heads);
        const float cs = cos_t[t], sn = sin_t[t], partner = a_r[col ^ PanelColumn<E>::R];
        // y1 = x1 cos - x2 sin (first half), y2 = x2 cos + x1 sin
        y = pc.first_half() ? y * cs - partner * sn : y * cs + partner * sn;
      }
      o[col] = to_bf(y * s);
    }
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
//    flipped; the partner lane is i ^ (E / 4)) and the cosine-sim VJP (the
//    head's sums over its E columns are warp sums), writing dR = (dq_raw,
//    dk_raw, gv) in bf16, the Pallas rounding point. Panel 0 also writes
//    xn, the bf16 normalised x. Per block it writes its sum of g * qn for
//    d(attn_scale), finished by reduce_kernel and a division by
//    2 * attn_scale in the wrapper.
// 2. norm_bwd_kernel (grad.cuh): dxn = dR @ W^T, the RMS-norm VJP -> dx and
//    the d(norm_scale) partials.
// 3. atb_partial_kernel (grad.cuh): dW_qkv = xn^T dR in f32 partials over
//    row chunks, summed in a fixed order.
template <int E>
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
  __shared__ float s_das[WARPS][2];

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const RowTile t = row_tile(tokens);
  const int panels = d / PANEL;
  const int sec = blockIdx.y / panels, panel = blockIdx.y % panels;  // sec 0/1/2: q/k/v
  const int n0 = sec * d + panel * PANEL;
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
  const PanelColumn<E> cols[2] = {PanelColumn<E>(panel, lane), PanelColumn<E>(panel, lane + 32)};
  float das[2] = {0.f, 0.f};  // per head of the panel (one when E == 64)
  for (int r = 0; r < STRIP; ++r) {
    if (warp * STRIP + r >= t.valid) break;
    const long row = t.row0 + warp * STRIP + r;
    const bf16* g_r = g + row * d + panel * PANEL;
    bf16* o = dr + row * ld_w + n0;
    const float gs[2] = {to_f(g_r[lane]), to_f(g_r[lane + 32])};
    if (sec == 2) {
      o[lane] = to_bf(gs[0]);
      o[lane + 32] = to_bf(gs[1]);
      continue;
    }
    const float* a_r = strip + r * LDF;
    const float vals[2] = {a_r[lane], a_r[lane + 32]};
    float gr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const PanelColumn<E>& pc = cols[i];
      const float partner = __shfl_xor_sync(0xffffffffu, gs[i], PanelColumn<E>::R);
      gr[i] = gs[i];
      if (pc.rotated()) {
        const long tt = pc.table(row % tokens, n_heads);
        // the RoPE VJP: g1' = g1 cos + g2 sin (first half), g2' = g2 cos - g1 sin
        gr[i] = pc.first_half() ? gs[i] * cos_t[tt] + partner * sin_t[tt]
                                : gs[i] * cos_t[tt] - partner * sin_t[tt];
      }
    }
    // the cosine-sim VJP: qn = raw * root / sqrt(ssq + eps)
    float ssq[2], gsum[2];
    head_sums<E>(vals[0] * vals[0], vals[1] * vals[1], ssq);
    head_sums<E>(gr[0] * vals[0], gr[1] * vals[1], gsum);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float inv = rsqrtf(ssq[i] + cos_eps);
      const float rho = sqrtf(attn_scale[cols[i].head]) * inv;
      const float coef = rho * inv * inv * gsum[i];
      o[lane + 32 * i] = to_bf(rho * gr[i] - vals[i] * coef);
      // sum of g * qn over the head's lanes, once per head
      if (i == 0 || E != PANEL) das[i] += rho * gsum[i];
    }
  }
  if (sec < 2) {
    if (lane == 0) {
      s_das[warp][0] = das[0];
      s_das[warp][1] = das[1];
    }
    __syncthreads();
    if (threadIdx.x < PANEL / E) {
      const int i = threadIdx.x;
      das_part[static_cast<long>(blockIdx.x) * 2 * n_heads + sec * n_heads + cols[0].head + i] =
          s_das[0][i] + s_das[1][i] + s_das[2][i] + s_das[3][i];
    }
  }
}

}  // namespace
}  // namespace kdt

using namespace kdt;

namespace {

constexpr size_t SMEM = (BM + PANEL) * LDT * sizeof(bf16) + WARPS * STRIP * LDF * sizeof(float) +
                        BM * (sizeof(float) + sizeof(int));

template <int E>
int launch_fused_qkv(const void* x, const void* nscale, const void* w, const void* attn_scale,
                     const void* cos_t, const void* sin_t, void* q, void* k, void* v, long rows,
                     int tokens, int d, int n_heads, float eps, float cos_eps, cudaStream_t st) {
  const cudaError_t attr = allow_smem(fused_qkv_kernel<E>, SMEM);
  const dim3 grid(static_cast<unsigned>((rows + BM - 1) / BM), 3 * (d / PANEL));
  fused_qkv_kernel<E><<<grid, THREADS, SMEM, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(nscale),
      static_cast<const bf16*>(w), static_cast<const float*>(attn_scale),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t), static_cast<bf16*>(q),
      static_cast<bf16*>(k), static_cast<bf16*>(v), rows, tokens, d, n_heads, eps, cos_eps);
  return launch_status(attr);
}

template <int E>
int launch_prologue_bwd(const void* x, const void* nscale, const void* w, const void* attn_scale,
                        const void* cos_t, const void* sin_t, const void* gq, const void* gk,
                        const void* gv, void* dx, void* dns, void* dw, void* das_sums, void* dr,
                        void* xn, void* das_part, void* dns_part, void* dw_part, int images,
                        int tokens, int d, int n_heads, float eps, float cos_eps,
                        cudaStream_t st) {
  cudaError_t err = allow_smem(prologue_dr_kernel<E>, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (tokens + BM - 1) / BM;
  const long rows = static_cast<long>(images) * tokens;
  prologue_dr_kernel<E><<<dim3(images * tiles, 3 * (d / PANEL)), THREADS, SMEM, st>>>(
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

}  // namespace

// x (rows, d) bf16 with rows = images * tokens; nscale (images, d) bf16;
// w (d, 3d) bf16; attn_scale (heads,) f32; cos/sin (tokens, heads * e / 4)
// f32; q, k, v (rows, d) bf16. Needs d == e * heads with head dim e 32 or
// 64 and d % 64 == 0.
extern "C" int kdt_fused_qkv(const void* x, const void* nscale, const void* w,
                             const void* attn_scale, const void* cos_t, const void* sin_t,
                             void* q, void* k, void* v, long rows, int tokens, int d,
                             int n_heads, float eps, float cos_eps, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d % PANEL) return static_cast<int>(cudaErrorInvalidValue);
  switch (d / n_heads) {
    case 32:
      return launch_fused_qkv<32>(x, nscale, w, attn_scale, cos_t, sin_t, q, k, v, rows, tokens,
                                  d, n_heads, eps, cos_eps, st);
    case 64:
      return launch_fused_qkv<64>(x, nscale, w, attn_scale, cos_t, sin_t, q, k, v, rows, tokens,
                                  d, n_heads, eps, cos_eps, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The backward. x (rows, d) bf16 with rows = images * tokens; nscale
// (images, d) bf16; w (d, 3d) bf16; attn_scale (heads,) f32; cos/sin as the
// forward's; gq, gk, gv (rows, d) bf16. Writes dx (rows, d) bf16, dns
// (images, d) f32, dw (d, 3d) f32 and das_sums (2 * heads) f32, the sums of
// g * qn for q then k (the wrapper divides by 2 * attn_scale). Scratch: dr
// (rows, 3d) and xn (rows, d) bf16; das_part (images * tiles, 2 * heads),
// dns_part (images * tiles, d) and dw_part (chunks, d, 3d) f32, with tiles =
// ceil(tokens / 64) and chunks = ceil(rows / 2048). Head dims as the
// forward's.
extern "C" int kdt_fused_qkv_bwd(const void* x, const void* nscale, const void* w,
                                 const void* attn_scale, const void* cos_t, const void* sin_t,
                                 const void* gq, const void* gk, const void* gv, void* dx,
                                 void* dns, void* dw, void* das_sums, void* dr, void* xn,
                                 void* das_part, void* dns_part, void* dw_part, int images,
                                 int tokens, int d, int n_heads, float eps, float cos_eps,
                                 void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d % PANEL) return static_cast<int>(cudaErrorInvalidValue);
  switch (d / n_heads) {
    case 32:
      return launch_prologue_bwd<32>(x, nscale, w, attn_scale, cos_t, sin_t, gq, gk, gv, dx, dns,
                                     dw, das_sums, dr, xn, das_part, dns_part, dw_part, images,
                                     tokens, d, n_heads, eps, cos_eps, st);
    case 64:
      return launch_prologue_bwd<64>(x, nscale, w, attn_scale, cos_t, sin_t, gq, gk, gv, dx, dns,
                                     dw, das_sums, dr, xn, das_part, dns_part, dw_part, images,
                                     tokens, d, n_heads, eps, cos_eps, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

KDT_DEFINE_ERROR_STRING
