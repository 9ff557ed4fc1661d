// The fused attention prologue in float32: AdaRMSNorm -> x @ W_qkv ->
// per-head cosine-sim scaling of q and k -> axial RoPE on q and k; packed
// (b, h, w, d) f32 q, k, v. Forward (K1 in f32) and backward (K6 in f32),
// the kernels of --mixed-precision no, both on gemm_tf32_wg.cuh's TF32
// wgmma core.
//
// Replaces: k_diffusion_tpu/ops/pallas/fused_qkv.py:_fused_qkv_kernel (the
// forward of fused_qkv_prologue) and :_prologue_bwd_kernel (its backward)
// as they run on f32 operands (the JAX model built with dtype=float32):
// f32 dots with f32 accumulation. Here every product runs on the TF32
// tensor cores with f32 accumulation, as PyTorch's float32 training does
// with TF32 on; the norm, the cosine-sim scale, RoPE and their VJPs stay
// in f32.
//
// What bounds the forward on the H100, the flagship's eval shapes at batch
// 8: the product is 2 tokens d 3d = 3.2 GFLOP at every level (6.5 us at
// TF32's 494.7 TFLOP/s), while x in and q, k, v out are 67 MB at level 0
// (d = 128, 20 us at 3.35 TB/s) and 19 MB at level 2 (d = 512, weights
// included, 5.7 us): levels 0 and 1 are bound by memory, level 2 by
// operations and memory alike. The backward at batch-8 training shapes
// does 3x the products against x, gq, gk, gv and dx (and, in this design,
// dR and xn written once and read back).
//
// Forward design (qkv_f32_fwd_kernel), after W^T is copied rounded to TF32
// (tw::round_weights_kernel): a block stays on its SM and walks work
// items, each one 128-row tile that never spans two images and a group of
// three 64-column panels of the 3d projection columns (q, k, then v; 3d /
// 64 is a multiple of 3), so that x crosses L2 d / 64 times a row tile,
// where one panel an item read it 3d / 64 times. The product xn W = r (x
// nscale) W streams x's K-major box and the group's 192 rows of W^T
// through the TMA ring, x nscale formed and rounded at each A fragment,
// whose squares give the rows' norms r on the way (tw::Normed), r applied
// in the epilogue. The epilogue runs in registers per panel: a head's sum
// of squares is the thread's own columns plus two shuffles in its quad,
// and the RoPE partner column c ^ (E / 4) is accumulator block n ^ (E /
// 32) of the same thread (wgmma's accumulator is mma.sync's C layout
// repeated along N), so the rotation needs no exchange; q and k get the
// cosine-sim scale sqrt(attn_scale) / sqrt(ssq + eps) and the half-split
// RoPE (pair distance E / 4 on the first E / 2 dims), v passes as it is;
// the angles theta = pos * freq are formed there in f32 with sincosf, as
// K1's bf16 form does. Each warpgroup stages its 64 rows of the panel in
// shared memory and stores them in whole 16-byte words.
//
// K6 in f32, three steps (the bf16 form's, fused_qkv.cu) on
// gemm_tf32_wg.cuh's TF32 wgmma core, after W and W^T are copied rounded
// to TF32 (tw::round_weights_kernel):
// (a) qkv_f32_dr_kernel: the raw projection recomputed per row tile and
//     one or two panels; the RoPE and cosine-sim VJPs in registers
//     give dR's q and k parts (v's is gv itself), written rounded and
//     transposed, and the d(attn_scale) partials; every panel adds its dR R
//     to the per-row partial of dot_part for the RMS-norm VJP (gemm.cuh's
//     note: sum(g1 x) = sum_k dR_k R_k / r, here up to the TF32 rounding
//     of the products); panel 0 also writes xn and r;
// (b) tw::dxn_kernel: dxn = dR W^T over K = 3d and the RMS-norm VJP in its
//     epilogue -> dx and the d(norm_scale) partials;
// (c) tw::dw_kernel: dW_qkv = xn^T dR in f32 partials over row chunks;
//     every partial summed in a fixed order (gemm::reduce_kernel).
//
// The head dim E is a template parameter, 64 or 32 (config_test_tiny.json):
// a panel then holds 64 / E heads, accumulator blocks [8 hs E / 64, 8 (hs +
// 1) E / 64) holding head hs of the panel.
#include "gemm_tf32_wg.cuh"

namespace kdt {
namespace {

// The cosine-sim scale of the thread's two rows for each of the panel's HP
// heads: sqrt(attn_scale) / sqrt(sum of the head's R^2 + cos_eps), and the
// head's inverse norm 1 / sqrt(ssq + cos_eps) in inv.
template <int E>
__device__ __forceinline__ void cos_scale(const float (&raw)[8][4], const float* attn_scale,
                                          int head0, float cos_eps, float (&rho)[64 / E][2],
                                          float (&inv)[64 / E][2]) {
  constexpr int HP = 64 / E;
  float ssq[HP][2] = {};
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) ssq[8 * n / E][i / 2] += raw[n][i] * raw[n][i];
#pragma unroll
  for (int hs = 0; hs < HP; ++hs) {
    const float root = sqrtf(attn_scale[head0 + hs]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      inv[hs][h] = rsqrtf(gemm::quad_sum(ssq[hs][h]) + cos_eps);
      rho[hs][h] = root * inv[hs][h];
    }
  }
}

// cos and sin of the RoPE angle of accumulator element (n, h, e), n the
// first of a rotated pair: dim r = (8 n + 2 t + e) % E < E / 4 of head
// `head` at the token of row h, theta = pos[token, r / F] freqs[head, r %
// F], the f32 product of ops/rope.py's theta.
template <int E>
__device__ __forceinline__ void rope_angle(const float* pos, const float* freqs, long token,
                                           int head, int n, int e, float& sn, float& cs) {
  constexpr int F = E / 8;
  const int r = (8 * n + 2 * tw::lane_t() + e) % E;
  sincosf(pos[2 * token + r / F] * freqs[head * F + r % F], &sn, &cs);
}

// K1 in f32: a work item's panels, its stage and its staging tile (a
// panel's 128 rows at row stride QKV_LD floats, so that a quad's 8-byte
// writes fall in distinct banks).
constexpr int QKV_NP = 3;                          // panels an item
constexpr int QKV_B = QKV_NP * 64 * tw::BK * 4;    // their W^T rows, one box
constexpr int QKV_STAGE = tw::K_TILE + QKV_B;      // 40 KB: x's box and theirs
constexpr int QKV_LD = 64 + 8;
constexpr size_t QKV_SMEM = tw::S * QKV_STAGE + tw::ROWS * QKV_LD * 4 + 1024;

// The epilogue of one panel (sec: 0 q, 1 k, 2 v; pp its panel in the
// section) on R (raw, r applied): q and k scaled and rotated in place.
template <int E>
__device__ __forceinline__ void qkv_epilogue(float (&raw)[8][4], int sec, int pp,
                                             const tw::RowTile& t,
                                             const float* __restrict__ attn_scale,
                                             const float* __restrict__ pos,
                                             const float* __restrict__ freqs, float cos_eps) {
  constexpr int R = E / 4, HP = 64 / E;  // RoPE pair distance; heads a panel
  if (sec == 2) return;
  float rho[HP][2], inv[HP][2];
  cos_scale<E>(raw, attn_scale, pp * HP, cos_eps, rho, inv);
  float y[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) y[n][i] = raw[n][i];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = tw::acc_row(h);
    const long token = row < t.valid ? t.tile * static_cast<long>(tw::ROWS) + row : 0;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      if (8 * n % E >= R) continue;  // not the first of a rotated pair
      const int pn = n ^ (R / 8);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float sn, cs;
        rope_angle<E>(pos, freqs, token, pp * HP + 8 * n / E, n, e, sn, cs);
        const float x1 = raw[n][2 * h + e], x2 = raw[pn][2 * h + e];
        // y1 = x1 cos - x2 sin, y2 = x2 cos + x1 sin
        y[n][2 * h + e] = x1 * cs - x2 * sn;
        y[pn][2 * h + e] = x2 * cs + x1 * sn;
      }
    }
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) raw[n][i] = y[n][i] * rho[8 * n / E][i / 2];
}

// K1 in f32 on gemm_tf32_wg.cuh's core (the file's note). map_x: x (rows,
// d), boxes of 128 rows; map_wt: the rounded W^T (3d, d), boxes of 192
// rows. An item is row tile item / groups and panels [3 g, 3 g + 3) of the
// 3d columns, g = item % groups, groups = d / 64. nscale (images, d):
// image i's row at nscale + i * scale_stride.
template <int E>
__global__ void __launch_bounds__(tw::THREADS, 1)
qkv_f32_fwd_kernel(const __grid_constant__ CUtensorMap map_x,
                   const __grid_constant__ CUtensorMap map_wt, const float* __restrict__ nscale,
                   int scale_stride, const float* __restrict__ attn_scale,
                   const float* __restrict__ pos, const float* __restrict__ freqs,
                   float* __restrict__ q, float* __restrict__ k, float* __restrict__ v,
                   int images, int tokens, int d, float eps, float cos_eps) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ tw::Ring ring;
  unsigned char* smem = wg::aligned_smem(smem_raw);
  float* s_out = reinterpret_cast<float*>(smem + tw::S * QKV_STAGE);  // (ROWS, QKV_LD)
  float* s_ns = s_out + tw::ROWS * QKV_LD;
  tw::ring_init(ring);
  const int kt = d / 64, groups = kt, steps = d / tw::BK;
  const tw::Items span = tw::my_items(images * tw::tiles(tokens) * groups);
  if (tw::is_producer()) {
    tw::producer_regs();
    if (!tw::tma_thread()) return;
    tw::Producer p{ring, smem, 0, QKV_STAGE};
    for (int item = span.begin; item < span.end; ++item) {
      const tw::RowTile t = tw::row_tile(tokens, item / groups);
      const int c0 = 64 * QKV_NP * (item % groups);
      for (int kk = 0; kk < steps; ++kk) {
        uint64_t* bar;
        unsigned char* st = p.next(QKV_STAGE, bar);
        tw::tma(st, &map_x, tw::BK * kk, t.row0, bar);
        tw::tma(st + tw::K_TILE, &map_wt, tw::BK * kk, c0, bar);
      }
    }
    return;
  }
  tw::consumer_regs();
  tw::Consumer c{ring, smem};
  const int base = 64 * (threadIdx.x / 128), tid = threadIdx.x % 128;
  int staged = -1;  // the image whose scale s_ns holds
  for (int item = span.begin; item < span.end; ++item) {
    const tw::RowTile t = tw::row_tile(tokens, item / groups);
    const int grp = item % groups;
    if (t.img != staged)
      tw::stage_scale(nscale + static_cast<long>(t.img) * scale_stride, d, s_ns);
    staged = t.img;
    // R over the item's 192 columns: panels 0 and 1 in acc0 (N = 128), 2 in acc1
    float acc0[64], acc1[32];
    tw::Normed norm{s_ns};
    tw::stepwise(
        c, steps, QKV_STAGE,
        [&](const unsigned char* stage, int kk, uint32_t(&a)[4][4]) {
#pragma unroll
          for (int j = 0; j < 4; ++j) norm(stage, kk, j, a[j]);
        },
        [&](const unsigned char* stage, int kk, const uint32_t(&a)[4][4]) {
          const uint64_t b0 = tw::desc(stage + tw::K_TILE);
          const uint64_t b1 = tw::desc(stage + tw::K_TILE + 128 * tw::BK * 4);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            tw::mma<128>(acc0, a[j], b0 + 2 * j, kk > 0 || j > 0);
            tw::mma<64>(acc1, a[j], b1 + 2 * j, kk > 0 || j > 0);
          }
          wg::fence_regs(acc0);
          wg::fence_regs(acc1);
        });
    wg::fence_regs(acc0);  // read after the walk's last wait
    wg::fence_regs(acc1);
    float r[2];
    norm.norms(d, eps, r);
#pragma unroll
    for (int np = 0; np < QKV_NP; ++np) {
      const int p = QKV_NP * grp + np, sec = p / kt, pp = p % kt;
      // R of the panel: raw[n][2 h + e] at row h, column 8 n + 2 t + e
      float raw[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          raw[n][i] = (np < 2 ? acc0[(32 * np + 4 * n + i) & 63] : acc1[4 * n + i]) * r[i / 2];
      qkv_epilogue<E>(raw, sec, pp, t, attn_scale, pos, freqs, cos_eps);
      // the warpgroup's 64 rows staged, then stored in 16-byte words
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int n = 0; n < 8; ++n)
          *reinterpret_cast<float2*>(s_out + tw::acc_row(h) * QKV_LD + 8 * n +
                                     2 * tw::lane_t()) = make_float2(raw[n][2 * h],
                                                                      raw[n][2 * h + 1]);
      tw::warpgroup_sync();
      float* dst = (sec == 0 ? q : sec == 1 ? k : v) + 64 * pp;
      for (int i = tid; i < 64 * 16; i += 128) {
        const int row = base + i / 16, c4 = 4 * (i % 16);
        if (row < t.valid)
          *reinterpret_cast<float4*>(dst + (t.row0 + row) * d + c4) =
              *reinterpret_cast<const float4*>(s_out + row * QKV_LD + c4);
      }
      tw::warpgroup_sync();  // the staging tile is free again
    }
  }
}

// K6's first kernel in f32, on gemm_tf32_wg.cuh's core. An item is one row
// tile and NP 64-column panels of the 3d projection (NP 2 where d is a
// multiple of 128, so that an item's panels lie in one of q, k, v; else
// 1): the forward's product R = r ((x nscale) W) (N = 64 NP, B from the
// rounded W^T); then per panel, for a q or k panel the RoPE VJP (the
// forward rotation with the sine's sign flipped, the partner column in the
// same thread) and the cosine-sim VJP give dR, and the tile's sums of g *
// qn per head go to das_part (images * tiles, 2 * heads), finished by
// reduce_kernel and a division by 2 * attn_scale in the wrapper; for a v
// panel dR is gv itself. dR goes out rounded to TF32 and transposed into
// drt (3d, ld), the A operand of dxn and the B of dW_qkv; every panel adds
// dR R over its columns, unrounded, to its per-row partial of dot_part (3d
// / 64, rows). Panel 0 writes xn and r.
template <int E, int NP>
__global__ void __launch_bounds__(tw::THREADS, 1)
qkv_f32_dr_kernel(const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_wt, const float* __restrict__ x,
                  const float* __restrict__ nscale, const float* __restrict__ attn_scale,
                  const float* __restrict__ pos, const float* __restrict__ freqs,
                  const float* __restrict__ gq, const float* __restrict__ gk,
                  const float* __restrict__ gv, float* __restrict__ drt, long ld,
                  float* __restrict__ xn, float* __restrict__ r_out,
                  float* __restrict__ dot_part, float* __restrict__ das_part, long n_rows,
                  int images, int tokens, int d, int n_heads, float eps, float cos_eps) {
  constexpr int R = E / 4, HP = 64 / E;
  extern __shared__ unsigned char smem_raw[];
  __shared__ tw::Ring ring;
  __shared__ float s_r[tw::ROWS];
  __shared__ float s_das[4 * tw::CONSUMERS][HP];
  unsigned char* smem = wg::aligned_smem(smem_raw);
  float* s_ns = reinterpret_cast<float*>(smem + tw::S * tw::STAGE);
  float* s_t = s_ns + d;  // a panel's dR^T, staged
  tw::ring_init(ring);
  const int groups = 3 * d / (64 * NP), kt = d / 64, steps = d / tw::BK;
  const tw::Items span = tw::my_items(images * tw::tiles(tokens) * groups);
  if (tw::is_producer()) {
    tw::producer_regs();
    if (!tw::tma_thread()) return;
    tw::Producer p{ring, smem};
    for (int item = span.begin; item < span.end; ++item) {
      const tw::RowTile t = tw::row_tile(tokens, item / groups);
      const int c0 = 64 * NP * (item % groups);
      for (int k = 0; k < steps; ++k) {
        uint64_t* bar;
        unsigned char* st = p.next(tw::K_TILE + NP * tw::B_BYTES / 2, bar);
        tw::tma(st, &map_x, tw::BK * k, t.row0, bar);
#pragma unroll
        for (int j = 0; j < NP; ++j)
          tw::tma(st + tw::A_BYTES + j * tw::B_BYTES / 2, &map_wt, tw::BK * k, c0 + 64 * j, bar);
      }
    }
    return;
  }
  tw::consumer_regs();
  tw::Consumer cons{ring, smem};
  const int c = 2 * tw::lane_t(), warp = tw::warp();
  int staged = -1;  // the image whose scale s_ns holds
  for (int item = span.begin; item < span.end; ++item) {
    const int rt = item / groups;
    const tw::RowTile t = tw::row_tile(tokens, rt);
    if (t.img != staged) tw::stage_scale(nscale + static_cast<long>(t.img) * d, d, s_ns);
    staged = t.img;
    float acc[32 * NP];
    tw::zero(acc);
    tw::Normed norm{s_ns};
    tw::product<64 * NP>(acc, cons, steps, norm);
    float r[2];
    norm.norms(d, eps, r);
    bool ok[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) ok[h] = tw::acc_row(h) < t.valid;
#pragma unroll
    for (int np = 0; np < NP; ++np) {
      const int p = NP * (item % groups) + np, sec = p / kt, pp = p % kt;
      // R of the panel: raw[n][2 h + e] at row h, column 8 n + c + e
      float raw[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) raw[n][i] = acc[32 * np + 4 * n + i] * r[i / 2];
      // the cotangent at the thread's elements (zero on rows past the tile's end)
      const float* g = (sec == 0 ? gq : sec == 1 ? gk : gv) + 64 * pp + c;
      float gr[8][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float2 gg = ok[h] ? *reinterpret_cast<const float2*>(
                                        g + (t.row0 + tw::acc_row(h)) * d + 8 * n)
                                  : make_float2(0.f, 0.f);
          gr[n][2 * h] = gg.x;
          gr[n][2 * h + 1] = gg.y;
        }
      float dot[2] = {0.f, 0.f};
      // dR, rounded, staged as the panel's rows of dR^T at the thread's rows
      float* st = s_t + c * tw::ST_LD;
      if (sec == 2) {  // v: dR = gv
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              dot[h] += gr[n][2 * h + e] * raw[n][2 * h + e];
              st[(8 * n + e) * tw::ST_LD + tw::acc_row(h)] =
                  tw::round_tf32(gr[n][2 * h + e]);
            }
      } else {
        // the RoPE VJP: g1' = g1 cos + g2 sin, g2' = g2 cos - g1 sin
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long token = ok[h] ? t.tile * static_cast<long>(tw::ROWS) + tw::acc_row(h) : 0;
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            if (8 * n % E >= R) continue;
            const int pn = n ^ (R / 8);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float sn, cs;
              rope_angle<E>(pos, freqs, token, pp * HP + 8 * n / E, n, e, sn, cs);
              const float g1 = gr[n][2 * h + e], g2 = gr[pn][2 * h + e];
              gr[n][2 * h + e] = g1 * cs + g2 * sn;
              gr[pn][2 * h + e] = g2 * cs - g1 * sn;
            }
          }
        }
        // the cosine-sim VJP per head: qn = raw rho, rho = root / sqrt(ssq + eps)
        float rho[HP][2], inv[HP][2], gsum[HP][2] = {};
        cos_scale<E>(raw, attn_scale, pp * HP, cos_eps, rho, inv);
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) gsum[8 * n / E][i / 2] += gr[n][i] * raw[n][i];
        float coef[HP][2], das[HP];
#pragma unroll
        for (int hs = 0; hs < HP; ++hs) {
          das[hs] = 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float gs = gemm::quad_sum(gsum[hs][h]);
            coef[hs][h] = rho[hs][h] * inv[hs][h] * inv[hs][h] * gs;
            // the row's sum of g * qn over the head, once per quad
            if (tw::lane_t() == 0 && ok[h]) das[hs] += rho[hs][h] * gs;
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            const int hs = 8 * n / E;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float v = rho[hs][h] * gr[n][2 * h + e] - raw[n][2 * h + e] * coef[hs][h];
              dot[h] += v * raw[n][2 * h + e];
              st[(8 * n + e) * tw::ST_LD + tw::acc_row(h)] = tw::round_tf32(v);
            }
          }
#pragma unroll
        for (int hs = 0; hs < HP; ++hs) {
          const float s = warp_sum(das[hs]);
          if ((threadIdx.x & 31) == 0) s_das[warp][hs] = s;
        }
      }
      tw::consumers_sync();
      if (sec < 2 && threadIdx.x < HP) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < 4 * tw::CONSUMERS; ++w) s += s_das[w][threadIdx.x];  // warp order
        das_part[static_cast<long>(rt) * 2 * n_heads + sec * n_heads + pp * HP + threadIdx.x] =
            s;
      }
      tw::store_t(s_t, drt + static_cast<long>(p) * 64 * ld + t.row0, ld, t.valid);
      tw::consumers_sync();  // s_t and s_das are free again
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float s = gemm::quad_sum(dot[h]);
        if (tw::lane_t() == 0 && ok[h]) dot_part[p * n_rows + t.row0 + tw::acc_row(h)] = s;
      }
      if (p == 0) tw::write_xn(x, t, d, s_ns, r, s_r, xn, r_out);
    }
  }
}

template <int E>
cudaError_t launch_fwd(const CUtensorMap& map_x, const CUtensorMap& map_wt, const float* nscale,
                       int scale_stride, const float* attn_scale, const float* pos,
                       const float* freqs, float* q, float* k, float* v, int images,
                       int tokens, int d, float eps, float cos_eps, cudaStream_t st) {
  const size_t smem = QKV_SMEM + d * sizeof(float);
  const cudaError_t err = allow_smem(qkv_f32_fwd_kernel<E>, smem);
  if (err != cudaSuccess) return err;
  const long items = static_cast<long>(images) * tw::tiles(tokens) * (d / 64);
  qkv_f32_fwd_kernel<E><<<tw::grid(items), tw::THREADS, smem, st>>>(
      map_x, map_wt, nscale, scale_stride, attn_scale, pos, freqs, q, k, v, images, tokens, d,
      eps, cos_eps);
  return cudaGetLastError();
}

template <int E, int NP>
cudaError_t launch_dr(const CUtensorMap& map_x, const CUtensorMap& map_wt, const float* x,
                      const float* nscale, const float* attn_scale, const float* pos,
                      const float* freqs, const float* gq, const float* gk, const float* gv,
                      float* drt, long ld, float* xn, float* r, float* dot_part,
                      float* das_part, int images, int tokens, int d, int n_heads, float eps,
                      float cos_eps, cudaStream_t st) {
  const size_t smem = tw::RING_SMEM + d * sizeof(float) + tw::STAGING;
  const cudaError_t err = allow_smem(qkv_f32_dr_kernel<E, NP>, smem);
  if (err != cudaSuccess) return err;
  const long items = static_cast<long>(images) * tw::tiles(tokens) * (3 * d / (64 * NP));
  qkv_f32_dr_kernel<E, NP><<<tw::grid(items), tw::THREADS, smem, st>>>(
      map_x, map_wt, x, nscale, attn_scale, pos, freqs, gq, gk, gv, drt, ld, xn, r, dot_part,
      das_part, static_cast<long>(images) * tokens, images, tokens, d, n_heads, eps, cos_eps);
  return cudaGetLastError();
}

template <int E>
int launch_bwd(const float* x, const float* nscale, const float* w, const float* attn_scale,
               const float* pos, const float* freqs, const float* gq, const float* gk,
               const float* gv, float* dx, float* dns, float* dw, float* das_sums, float* wt,
               float* w_r, float* drt, float* xn, float* r, float* dot_part, float* das_part,
               float* dns_part, float* dw_part, int images, int tokens, int d, int n_heads,
               long ld, long chunk_rows, float eps, float cos_eps, cudaStream_t st) {
  const long rows = static_cast<long>(images) * tokens;
  const int tiles = tw::tiles(tokens);
  cudaError_t err = tw::launch_round(w, d, 3 * d, w_r, wt, st);
  CUtensorMap map_x, map_wt;
  if (err == cudaSuccess) err = tw::map_f32(&map_x, x, rows, d, d, tw::ROWS);
  if (err == cudaSuccess) err = tw::map_f32(&map_wt, wt, 3 * d, d, d, 64);
  if (err != cudaSuccess) return static_cast<int>(err);
  // two panels an item where they lie in one of q, k, v and the items still
  // come to two rounds of blocks
  const bool pairs =
      d % 128 == 0 && static_cast<long>(images) * tiles * (3 * d / 128) >= 2 * tw::sm_count();
  err = pairs ? launch_dr<E, 2>(map_x, map_wt, x, nscale, attn_scale, pos, freqs, gq, gk,
                                gv, drt, ld, xn, r, dot_part, das_part, images, tokens, d,
                                n_heads, eps, cos_eps, st)
              : launch_dr<E, 1>(map_x, map_wt, x, nscale, attn_scale, pos, freqs, gq, gk,
                                gv, drt, ld, xn, r, dot_part, das_part, images, tokens, d,
                                n_heads, eps, cos_eps, st);
  if (err == cudaSuccess)
    err = gemm::launch_reduce(das_part, das_sums, 1, images * tiles, 2 * n_heads, st);
  if (err == cudaSuccess)
    err = tw::launch_dxn(drt, ld, w_r, x, nscale, nullptr, r, dot_part, 3 * d / 64, dx, dns_part,
                         dns, images, tokens, d, 3 * d, st);
  if (err == cudaSuccess)
    err = tw::launch_dw(xn, drt, ld, dw_part, dw, false, rows, d, 3 * d, chunk_rows, st);
  return static_cast<int>(err);
}

}  // namespace
}  // namespace kdt

using namespace kdt;

// K1 in f32. x (rows, d) f32 with rows = images * tokens; nscale (images,
// d) f32, image i's row at nscale + i * scale_stride (scale_stride >= d, a
// multiple of 4: a column block of a condcache row, read in place); w (d,
// 3d) f32; attn_scale (heads,) f32; pos (tokens, 2) f32; freqs (heads, e /
// 8) f32; q, k, v (rows, d) f32. Scratch: wt (3d, d) f32, the rounded W^T.
// Needs d == e * heads with head dim e 32 or 64 and d % 64 == 0.
extern "C" int kdt_fused_qkv_f32(const void* x, const void* nscale, const void* w,
                                 const void* attn_scale, const void* pos, const void* freqs,
                                 void* q, void* k, void* v, void* wt, int images, int tokens,
                                 int d, int n_heads, int scale_stride, float eps, float cos_eps,
                                 void* stream) {
  if (d % 64 || n_heads < 1 || d % n_heads || scale_stride < d || scale_stride % 4 ||
      (d / n_heads != 32 && d / n_heads != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  const long rows = static_cast<long>(images) * tokens;
  cudaError_t err = tw::launch_round(f(w), d, 3 * d, nullptr, o(wt), st);
  CUtensorMap map_x, map_wt;
  if (err == cudaSuccess) err = tw::map_f32(&map_x, f(x), rows, d, d, tw::ROWS);
  if (err == cudaSuccess) err = tw::map_f32(&map_wt, o(wt), 3 * d, d, d, 64 * QKV_NP);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = d / n_heads == 32
            ? launch_fwd<32>(map_x, map_wt, f(nscale), scale_stride, f(attn_scale), f(pos),
                             f(freqs), o(q), o(k), o(v), images, tokens, d, eps, cos_eps, st)
            : launch_fwd<64>(map_x, map_wt, f(nscale), scale_stride, f(attn_scale), f(pos),
                             f(freqs), o(q), o(k), o(v), images, tokens, d, eps, cos_eps, st);
  return static_cast<int>(err);
}

// K6 in f32. x (rows, d) f32; nscale (images, d) f32; w (d, 3d) f32;
// attn_scale (heads,) f32; pos and freqs as the forward's; gq, gk, gv
// (rows, d) f32. Writes dx (rows, d), dns (images, d), dw (d, 3d) and
// das_sums (2 * heads) f32, the sums of g * qn for q then k (the wrapper
// divides by 2 * attn_scale). Scratch f32: the rounded weights wt (3d, d)
// and w_r (d, 3d); drt (3d, ld), xn (rows, d), r (rows), dot_part (3d / 64,
// rows), das_part (images * tiles, 2 * heads), dns_part (images * tiles, d)
// and dw_part (ceil(rows / chunk_rows), d, 3d), tiles = ceil(tokens /
// tw::ROWS), the count the caller sized das_part and dns_part for (refused
// if it differs); ld >= rows, a multiple of 4; chunk_rows, the rows per dW
// partial, a multiple of 32. Head dims as the forward's.
extern "C" int kdt_fused_qkv_bwd_f32(const void* x, const void* nscale, const void* w,
                                     const void* attn_scale, const void* pos, const void* freqs,
                                     const void* gq, const void* gk, const void* gv, void* dx,
                                     void* dns, void* dw, void* das_sums, void* wt, void* w_r,
                                     void* drt, void* xn, void* r, void* dot_part,
                                     void* das_part, void* dns_part, void* dw_part, int images,
                                     int tokens, int tiles, int d, int n_heads, long ld,
                                     long chunk_rows, float eps, float cos_eps, void* stream) {
  if (d % 64 || n_heads < 1 || d % n_heads || chunk_rows < 1 || chunk_rows % 32 ||
      tiles != tw::tiles(tokens) || ld < static_cast<long>(images) * tokens || ld % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
#define KDT_QKV_BWD_F32(E)                                                                      \
  return launch_bwd<E>(f(x), f(nscale), f(w), f(attn_scale), f(pos), f(freqs), f(gq), f(gk), \
                       f(gv), o(dx), o(dns), o(dw), o(das_sums), o(wt), o(w_r), o(drt), o(xn), \
                       o(r), o(dot_part), o(das_part), o(dns_part), o(dw_part), images, tokens, \
                       d, n_heads, ld, chunk_rows, eps, cos_eps, st)
  switch (d / n_heads) {
    case 32: KDT_QKV_BWD_F32(32);
    case 64: KDT_QKV_BWD_F32(64);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef KDT_QKV_BWD_F32
}

KDT_DEFINE_ERROR_STRING
