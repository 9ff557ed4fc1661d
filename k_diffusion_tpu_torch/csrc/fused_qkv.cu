// Fused attention prologue: AdaRMSNorm -> x @ W_qkv -> per-head cosine-sim
// scaling of q and k -> axial RoPE on q and k; packed (b, h, w, d) q, k, v.
// Forward (K1) and backward (K6).
//
// Replaces: k_diffusion_tpu/ops/pallas/fused_qkv.py:_fused_qkv_kernel (the
// forward of fused_qkv_prologue) and :_prologue_bwd_kernel (its backward).
//
// What bounds the forward on the H100, flagship eval shapes at batch 8: the
// product is 2 * tokens * d * 3d = 3.2 GFLOP at every level (3.3 us at the
// bf16 tensor-core peak of 989 TFLOP/s), while the bytes are x in plus q,
// k, v out: 34 MB at level 0 (d = 128, 10 us at 3.35 TB/s) and 9.5 MB at
// level 2 (d = 512, weights included, 2.8 us). So levels 0 and 1 are bound
// by memory and level 2 is balanced.
//
// Forward design: the raw projection never goes to device memory. A block
// owns 64 token rows and one 64-column panel of W_qkv, i.e. 64 / E heads of
// q, k or v (grid y). It first takes each row's RMS statistics, then walks
// K in chunks of 64: the normalised x chunk (bf16, rounded where the JAX
// package rounds) and the W chunk are staged in shared memory and each warp
// multiplies its 16 rows with wmma bf16 fragments into f32 accumulators.
// The epilogue applies the per-head cosine-sim scale (sum of squares over
// the head's E columns, kept in f32) and the half-split RoPE (pair distance
// E / 4 on the first E / 2 dims) and writes bf16 once. The RoPE angles
// arrive as cos/sin tables (tokens, heads * E / 4) that the wrapper builds
// from the positions the model passes. Staging is not double-buffered and
// the x tile is re-normalised for each of the 3 * d / 64 panels: simple
// first.
//
// K6, the backward. What bounds it on the H100, flagship training shapes
// at batch 32: the recomputed projection and the two VJP products are
// 3 * 2 * tokens * d * 3d FLOP, 38.7 GFLOP at each level (39 us at 989
// TFLOP/s), against x, gq, gk, gv and dx (5 * 33.5 MB at level 0, 50 us at
// 3.35 TB/s) plus, in this design, the bf16 (dq, dk) (rows, 2d) and xn
// written once and read back (2 * 100 MB at level 0, 60 us): bound by
// memory, and at batch 8 by latency. Three steps on gemm.cuh's pipelined
// wgmma core (the Pallas kernel keeps dR in VMEM; here it goes through
// device memory, which keeps each step a plain tiled product):
// (a) qkv_dr_kernel: the raw projection recomputed per row tile and group
//     of column panels, the x tile normalised once per block; the RoPE and
//     cosine-sim VJPs in registers write dR's q and k parts (v's is gv
//     itself) and the d(attn_scale) partials;
// (b) gemm::norm_vjp_kernel: dxn = dR W^T over K = 3d and the RMS-norm VJP
//     in its epilogue -> dx and the d(norm_scale) partials;
// (c) gemm::atb_kernel: dW_qkv = xn^T dR in f32 partials over row chunks,
//     summed in a fixed order.
//
// The head dim E is a template parameter, 64 (the flagship) or 32
// (configs/config_test_tiny.json): a 64-column panel then holds 64 / E
// heads, and lane l's two columns l and l + 32 belong to heads
// panel * 64 / E + l / E and panel * 64 / E + (l + 32) / E.
#include "gemm.cuh"

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

// K6's first kernel, on gemm.cuh's core. Grid (images * tiles, groups): a
// block owns one 64-row tile and the 64-column panels y, y + groups, ... of
// the 3d projection columns (q, k, then v). It normalises its x tile once
// into resident tiles (group 0 also writes xn and r) and streams per panel
// and 64-deep slab of d the W_qkv tile through the ring: the raw panel R =
// xn W (C = A B) in registers. The panel's cotangent tile (gq, gk or gv)
// rides with the panel's last slab. The epilogue of a q or k panel runs the
// RoPE VJP (the forward rotation with the sine's sign flipped; the partner
// column c ^ (E / 4) is read from the cotangent tile) and the cosine-sim VJP
// (a head's sums over its E columns are the thread's own columns plus two
// shuffles in its quad), writes bf16 dR into dqk (rows, 2d), the Pallas
// rounding point, staged through the step's own ring stage (its product is
// done) for 16-byte stores, and the tile's sums of g * qn per head into das_part
// (images * tiles, 2 * heads), finished by reduce_kernel and a division by
// 2 * attn_scale in the wrapper. Every panel, v's included, adds its
// bf16(dR) R to the block's per-row partial of dot_part (groups, rows) for
// the RMS-norm VJP (gemm.cuh's note); v's dR is gv itself, so a v panel
// writes nothing else.
template <int E>
__global__ void __launch_bounds__(gemm::THREADS)
qkv_dr_kernel(const bf16* __restrict__ x, const bf16* __restrict__ nscale,
              const bf16* __restrict__ w, const float* __restrict__ attn_scale,
              const float* __restrict__ cos_t, const float* __restrict__ sin_t,
              const bf16* __restrict__ gq, const bf16* __restrict__ gk,
              const bf16* __restrict__ gv, bf16* __restrict__ dqk, bf16* __restrict__ xn,
              float* __restrict__ r_out, float* __restrict__ dot_part,
              float* __restrict__ das_part, long n_rows, int tokens, int d, int n_heads,
              int groups, float eps, float cos_eps) {
  using namespace gemm;
  constexpr int R = E / 4, HP = PANEL / E;  // RoPE pair distance; heads a panel
  extern __shared__ unsigned char smem_raw[];
  const int kt = d / 64;
  bf16* s_xn = reinterpret_cast<bf16*>(aligned_smem(smem_raw));  // kt tiles
  bf16* s_ring = s_xn + kt * T;                                  // stage: the W tile
  bf16* s_g = s_ring + S * T;  // two cotangent tiles, one per panel in turn
  float* s_r = reinterpret_cast<float*>(s_g + 2 * T);
  __shared__ float s_das[4][HP];

  const RowTile t = row_tile(tokens);
  const int r0 = static_cast<int>(t.row0), end = r0 + t.valid;
  const int steps = (3 * kt - static_cast<int>(blockIdx.y) + groups - 1) / groups * kt;
  const long ld_w = 3L * d;
  auto panel = [&](int s) { return static_cast<int>(blockIdx.y) + s / kt * groups; };
  auto load = [&](int s, int st) {
    const int p = panel(s), k = s % kt;
    load_tile_async<64>(s_ring + st * T, w + 64 * p, ld_w, 64 * k, d);
    if (k == kt - 1) {
      const int sec = p / kt;
      const bf16* g = sec == 0 ? gq : (sec == 1 ? gk : gv);
      load_tile_async<64>(s_g + (s / kt % 2) * T, g + 64 * (p % kt), d, r0, end);
    }
  };
  load_x_tiles(x, t, d, s_xn);
  ring_start(steps, load);
  ring_arrive();
  const bool first = blockIdx.y == 0;
  norm_tiles(t, d, nscale + static_cast<long>(t.img) * d, eps, s_xn, s_r, first ? xn : nullptr,
             first ? r_out : nullptr);

  const int warp = threadIdx.x / 32, c = acc_col();
  float acc[1][32];
  zero(acc);
  float dot[2] = {0.f, 0.f};
  for (int s = 0; s < steps; ++s) {
    const int k = s % kt;
    ring_arrive();
    wgmma_fence();
    product<0, 1>(acc, s_xn + k * T, s_ring + (s % S) * T, k);
    wgmma_commit();
    if (k < kt - 1) {
      wgmma_wait<1>();
      ring_refill(s, steps, load);
      continue;
    }
    wgmma_wait<0>();
    fence_acc(acc);
    __syncthreads();  // this step's stage is free: it stages dR
    bf16* staged = s_ring + (s % S) * T;
    const float* raw = acc[0];
    const bf16* gt = s_g + (s / kt % 2) * T;
    const int p = panel(s), sec = p / kt, pp = p % kt;
    if (sec == 2) {  // v: dR = gv
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float2 gg = read_pair(gt, acc_row(hh), 8 * i + c);
          dot[hh] += gg.x * raw[4 * i + 2 * hh] + gg.y * raw[4 * i + 2 * hh + 1];
        }
    } else {
      // the RoPE VJP: g1' = g1 cos + g2 sin (first half), g2' = g2 cos - g1 sin
      float gr[32];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = acc_row(hh);
        const long token = row < t.valid ? t.tile * ROWS + row : 0;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int col = 8 * i + c, dim = col % E;
          float2 gg = read_pair(gt, row, col);
          if (dim < 2 * R) {
            const float2 partner = read_pair(gt, row, col ^ R);
            const long at = (token * n_heads + pp * HP + col / E) * R + dim % R;
            const float2 cs = *reinterpret_cast<const float2*>(cos_t + at);
            const float2 sn = *reinterpret_cast<const float2*>(sin_t + at);
            const float sign = dim < R ? 1.f : -1.f;
            gg = make_float2(gg.x * cs.x + sign * partner.x * sn.x,
                             gg.y * cs.y + sign * partner.y * sn.y);
          }
          gr[4 * i + 2 * hh] = gg.x;
          gr[4 * i + 2 * hh + 1] = gg.y;
        }
      }
      // the cosine-sim VJP per head: qn = raw * root / sqrt(ssq + eps)
      float ssq[HP][2] = {}, gsum[HP][2] = {};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int at = 4 * i + e, hs = 8 * i / E;
          ssq[hs][e / 2] += raw[at] * raw[at];
          gsum[hs][e / 2] += gr[at] * raw[at];
        }
      float rho[HP][2], coef[HP][2], das[HP];
#pragma unroll
      for (int hs = 0; hs < HP; ++hs) {
        const float root = sqrtf(attn_scale[pp * HP + hs]);
        das[hs] = 0.f;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float inv = rsqrtf(quad_sum(ssq[hs][hh]) + cos_eps);
          const float gs = quad_sum(gsum[hs][hh]);
          rho[hs][hh] = root * inv;
          coef[hs][hh] = rho[hs][hh] * inv * inv * gs;
          // the row's sum of g * qn over the head, once per quad
          if ((threadIdx.x & 3) == 0 && acc_row(hh) < t.valid) das[hs] += rho[hs][hh] * gs;
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int at = 4 * i + 2 * hh, hs = 8 * i / E, row = acc_row(hh);
          const __nv_bfloat162 v = __floats2bfloat162_rn(
              rho[hs][hh] * gr[at] - raw[at] * coef[hs][hh],
              rho[hs][hh] * gr[at + 1] - raw[at + 1] * coef[hs][hh]);
          dot[hh] += __low2float(v) * raw[at] + __high2float(v) * raw[at + 1];
          stage_pair(staged, row, 8 * i + c, v);
        }
#pragma unroll
      for (int hs = 0; hs < HP; ++hs) {
        const float v = warp_sum(das[hs]);
        if ((threadIdx.x & 31) == 0) s_das[warp][hs] = v;
      }
      __syncthreads();
      store_tile<64>(staged, dqk + t.row0 * 2 * d + sec * d + 64 * pp, 2L * d, t.valid);
      if (threadIdx.x < HP)
        das_part[static_cast<long>(blockIdx.x) * 2 * n_heads + sec * n_heads + pp * HP +
                 threadIdx.x] = s_das[0][threadIdx.x] + s_das[1][threadIdx.x] +
                                s_das[2][threadIdx.x] + s_das[3][threadIdx.x];
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

inline size_t qkv_dr_smem(int d) {
  return ((d / 64) + gemm::S + 2) * gemm::T * sizeof(bf16) + wg::ROWS * sizeof(float) + 1024;
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
                        const void* gv, void* dx, void* dns, void* dw, void* das_sums, void* dqk,
                        void* xn, void* r, void* dot_part, void* das_part, void* dns_part,
                        void* dw_part, int images, int tokens, int d, int n_heads, int groups,
                        int chunk_rows, float eps, float cos_eps, cudaStream_t st) {
  const size_t smem = qkv_dr_smem(d);
  cudaError_t err = gemm::allow_shared(qkv_dr_kernel<E>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (tokens + wg::ROWS - 1) / wg::ROWS;
  const int rows = images * tokens;
  const bf16 *x_b = static_cast<const bf16*>(x), *ns_b = static_cast<const bf16*>(nscale);
  const bf16 *w_b = static_cast<const bf16*>(w), *gv_b = static_cast<const bf16*>(gv);
  bf16 *dqk_b = static_cast<bf16*>(dqk), *xn_b = static_cast<bf16*>(xn);
  float *r_f = static_cast<float*>(r), *dot_f = static_cast<float*>(dot_part);
  qkv_dr_kernel<E><<<dim3(images * tiles, groups), gemm::THREADS, smem, st>>>(
      x_b, ns_b, w_b, static_cast<const float*>(attn_scale), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<const bf16*>(gq),
      static_cast<const bf16*>(gk), gv_b, dqk_b, xn_b, r_f, dot_f,
      static_cast<float*>(das_part), rows, tokens, d, n_heads, groups, eps, cos_eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = gemm::launch_reduce(static_cast<const float*>(das_part), static_cast<float*>(das_sums),
                            1, images * tiles, 2 * n_heads, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  // dR: (dq, dk) in dqk, then gv as given
  const gemm::Split dr{dqk_b, 2L * d, 2 * d, gv_b, d};
  err = gemm::launch_norm_vjp(dr, w_b, x_b, ns_b, nullptr, r_f, dot_f, groups,
                              static_cast<bf16*>(dx), static_cast<float*>(dns_part),
                              static_cast<float*>(dns), images, tokens, d, 3 * d, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(gemm::launch_atb(xn_b, d, dr, static_cast<float*>(dw_part),
                                           static_cast<float*>(dw), rows, d, 3 * d, chunk_rows,
                                           st));
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

// The backward (K6). x (rows, d) bf16 with rows = images * tokens; nscale
// (images, d) bf16; w (d, 3d) bf16; attn_scale (heads,) f32; cos/sin as the
// forward's; gq, gk, gv (rows, d) bf16. Writes dx (rows, d) bf16, dns
// (images, d) f32, dw (d, 3d) f32 and das_sums (2 * heads) f32, the sums of
// g * qn for q then k (the wrapper divides by 2 * attn_scale). Scratch: dqk
// (rows, 2d) and xn (rows, d) bf16; r (rows), dot_part (groups, rows),
// das_part (images * tiles, 2 * heads), dns_part (images * tiles, d) and
// dw_part (ceil(rows / chunk_rows), d, 3d) f32, with tiles = ceil(tokens /
// 64). The first kernel takes the 3d / 64 column panels in `groups` groups;
// chunk_rows, the rows per dW partial, is a multiple of 64. Head dims as the
// forward's.
extern "C" int kdt_fused_qkv_bwd(const void* x, const void* nscale, const void* w,
                                 const void* attn_scale, const void* cos_t, const void* sin_t,
                                 const void* gq, const void* gk, const void* gv, void* dx,
                                 void* dns, void* dw, void* das_sums, void* dqk, void* xn,
                                 void* r, void* dot_part, void* das_part, void* dns_part,
                                 void* dw_part, int images, int tokens, int d, int n_heads,
                                 int groups, int chunk_rows, float eps, float cos_eps,
                                 void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d % PANEL) return static_cast<int>(cudaErrorInvalidValue);
  switch (d / n_heads) {
    case 32:
      return launch_prologue_bwd<32>(x, nscale, w, attn_scale, cos_t, sin_t, gq, gk, gv, dx, dns,
                                     dw, das_sums, dqk, xn, r, dot_part, das_part, dns_part,
                                     dw_part, images, tokens, d, n_heads, groups, chunk_rows, eps,
                                     cos_eps, st);
    case 64:
      return launch_prologue_bwd<64>(x, nscale, w, attn_scale, cos_t, sin_t, gq, gk, gv, dx, dns,
                                     dw, das_sums, dqk, xn, r, dot_part, das_part, dns_part,
                                     dw_part, images, tokens, d, n_heads, groups, chunk_rows, eps,
                                     cos_eps, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

KDT_DEFINE_ERROR_STRING
