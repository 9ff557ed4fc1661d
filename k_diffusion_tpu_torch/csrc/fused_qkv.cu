// Fused attention prologue: AdaRMSNorm -> x @ W_qkv -> per-head cosine-sim
// scaling of q and k -> axial RoPE on q and k; packed (b, h, w, d) q, k, v.
// Forward (K1) and backward (K6), both on gemm.cuh's pipelined wgmma core.
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
// Forward design (qkv_fwd_kernel), the twin of K6's first kernel below: the
// raw projection never goes to device memory. Each warpgroup owns a 64-row
// tile that never spans two images, and its block the step units y, y +
// groups, ... of NP 64-column panels of W_qkv (q, k, then v); a warpgroup
// normalises its x tile once into resident tiles, and the block streams the
// panels' W tiles, one 64-deep slab of d a step, through gemm.cuh's
// 3-stage ring by the Tensor Memory Accelerator into each warpgroup's NP
// accumulator sets. The epilogue runs in registers: a head's sum of
// squares is the thread's own columns plus two shuffles in its quad, and
// the RoPE partner column c ^ (E / 4) is accumulator slice i ^ (E / 32) of
// the same thread, so the rotation needs no exchange; q and k get the
// cosine-sim scale sqrt(attn_scale) / sqrt(ssq + eps) and the half-split
// RoPE (pair distance E / 4 on the first E / 2 dims), v passes as it is, and
// bf16 is written once, staged through finished ring stages for 16-byte
// stores. The RoPE angles are formed there too, theta = pos * freq in f32
// and sincosf, from the positions the model passes and the fixed
// frequencies: no table is built per call. A block is two warpgroups over
// two row tiles sharing every W tile, which halves the weight traffic from
// L2; the grid splits the step units so that the blocks fill the SMs in as
// few rounds as the occupancy allows.
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

// K1 on gemm.cuh's core. A block is two warpgroups, each over its own
// 64-row tile (row tiles 2 x and 2 x + 1 over all images; a warpgroup past
// the last one has no rows), sharing every W tile. Grid (ceil(images *
// tiles / 2), groups): block y takes the step units y, y + groups, ... of
// NP panels each; a unit's kt = d / 64 steps accumulate its NP raw panels
// R = xn W (C = A B) and the last one runs the epilogue: for a q or k panel
// per head and row, y = RoPE(R) sqrt(attn_scale[head]) / sqrt(sum R^2 +
// cos_eps), for a v panel y = R, each rounded to bf16 once. Warpgroup g
// stages its outputs in the ring stage of step s - g, both free then.
template <int E, int NP>
__global__ void __launch_bounds__(2 * gemm::THREADS, 2)
qkv_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ nscale,
               const __grid_constant__ CUtensorMap map_w, const float* __restrict__ attn_scale,
               const float* __restrict__ pos, const float* __restrict__ freqs,
               bf16* __restrict__ q, bf16* __restrict__ k, bf16* __restrict__ v, int images,
               int tokens, int d, int n_heads, int groups, int scale_stride, float eps,
               float cos_eps) {
  using namespace gemm;
  // RoPE pair distance; heads a panel; frequencies a head and axis
  constexpr int R = E / 4, HP = 64 / E, F = E / 8;
  extern __shared__ unsigned char smem_raw[];
  const int kt = d / 64;
  bf16* s_x = reinterpret_cast<bf16*>(aligned_smem(smem_raw));  // kt tiles a warpgroup
  bf16* s_ring = s_x + 2 * kt * T;                              // stage: NP W tiles
  // the row norms wait in the ring's last stage, which no copy fills before
  // the first refill
  float* s_r = reinterpret_cast<float*>(s_ring + (S - 1) * NP * T);
  __shared__ uint64_t full[S];  // a stage's tiles have landed
  tma_init(full);

  const int wgi = threadIdx.x / gemm::THREADS, tid = threadIdx.x % gemm::THREADS;
  const int tiles = (tokens + ROWS - 1) / ROWS;
  RowTile rt[2];
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int index = 2 * blockIdx.x + g;
    rt[g] = index < images * tiles ? row_tile(tokens, index) : RowTile{0, 0, 0, 0};
  }
  const RowTile t = rt[wgi];
  bf16* xt = s_x + wgi * kt * T;  // this warpgroup's x tiles
  const int steps = (3 * kt / NP - static_cast<int>(blockIdx.y) + groups - 1) / groups * kt;
  auto panel = [&](int s) { return NP * (static_cast<int>(blockIdx.y) + s / kt * groups); };
  // thread 0: step s's W tiles into stage st
  auto load = [&](int s, int st) {
    const int p = panel(s);
#pragma unroll
    for (int j = 0; j < NP; ++j)
      tma_tile(s_ring + (st * NP + j) * T, &map_w, 64 * (p + j), 64 * (s % kt), &full[st]);
    mbar_arrive(&full[st]);
  };
#pragma unroll
  for (int g = 0; g < 2; ++g) load_x_tiles(x, rt[g], d, s_x + g * kt * T);
  cp_async_commit();
  tma_start(steps, load);
  cp_async_wait<0>();
  __syncthreads();
  norm_tiles(t, d, nscale + static_cast<long>(t.img) * scale_stride, eps, xt, s_r + wgi * ROWS,
             nullptr, nullptr, tid, gemm::THREADS);

  const int c = acc_col();
  float acc[NP][32];
  zero(acc);
  for (int s = 0; s < steps; ++s) {
    const int kk = s % kt;
    tma_step(s, steps, full, load);
    bf16* stage = s_ring + (s % S) * NP * T;
    wgmma_fence();
    product<0, 1>(acc, xt + kk * T, stage, kk);
    wgmma_commit();
    if (kk < kt - 1) {
      wgmma_wait<1>();
      continue;
    }
    wgmma_wait<0>();
    fence_acc(acc);
    __syncthreads();  // the stages of steps s and s - 1 are free: they stage the outputs
    const int p0 = panel(s);
    bf16* own = s_ring + ((s + S - wgi) % S) * NP * T;
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const float* raw = acc[j];
      bf16* staged = own + j * T;
      const int sec = (p0 + j) / kt, pp = (p0 + j) % kt;
      if (sec == 2) {  // v
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            stage_pair(staged, acc_row(hh), 8 * i + c,
                       __floats2bfloat162_rn(raw[4 * i + 2 * hh], raw[4 * i + 2 * hh + 1]));
        continue;
      }
      // the cosine-sim scale per head and row: a head's columns of the row
      // are this thread's slices of it and the other three lanes' of its quad
      float ssq[HP][2] = {};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) ssq[8 * i / E][e / 2] += raw[4 * i + e] * raw[4 * i + e];
      float scale[HP][2];
#pragma unroll
      for (int hs = 0; hs < HP; ++hs) {
        const float root = sqrtf(attn_scale[pp * HP + hs]);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          scale[hs][hh] = root * rsqrtf(quad_sum(ssq[hs][hh]) + cos_eps);
      }
      // the half-split RoPE: dim r < R of a head and its partner r + R (slice
      // i ^ (R / 8) of this thread) turn by theta = pos[token, r / F] *
      // freqs[head, r % F], the f32 product of ops/rope.py's theta
      float y[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) y[i] = raw[i];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = acc_row(hh);
        const long token = row < t.valid ? t.tile * ROWS + row : 0;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (8 * i % E >= R) continue;  // not the first of a rotated pair
          const int pi = i ^ (R / 8), head = pp * HP + 8 * i / E;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = (8 * i + c + e) % E;
            float sn, cs;
            sincosf(pos[2 * token + r / F] * freqs[head * F + r % F], &sn, &cs);
            const int a1 = 4 * i + 2 * hh + e, a2 = 4 * pi + 2 * hh + e;
            // y1 = x1 cos - x2 sin, y2 = x2 cos + x1 sin
            y[a1] = raw[a1] * cs - raw[a2] * sn;
            y[a2] = raw[a2] * cs + raw[a1] * sn;
          }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float sc = scale[8 * i / E][hh];
          stage_pair(staged, row, 8 * i + c,
                     __floats2bfloat162_rn(y[4 * i + 2 * hh] * sc, y[4 * i + 2 * hh + 1] * sc));
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < 2; ++g)
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        const int sec = (p0 + j) / kt;
        bf16* dst = sec == 0 ? q : (sec == 1 ? k : v);
        store_tile<64>(s_ring + (((s + S - g) % S) * NP + j) * T,
                       dst + rt[g].row0 * d + 64 * ((p0 + j) % kt), d, rt[g].valid);
      }
    // the staged stages take copies again: plain accesses before the copy's
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
}

// x tiles of both warpgroups, the ring (NP tiles a stage) and the slack to
// align them; the row norms live inside.
inline size_t qkv_fwd_smem(int d, int np) {
  return (2 * (d / 64) + gemm::S * np) * gemm::T * sizeof(bf16) + 1024;
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
             first ? r_out : nullptr, threadIdx.x, blockDim.x);

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

// The launch of K1; with `blocks`, it is not launched and the number of
// its blocks that fit on one SM at once goes there instead.
template <int E, int NP>
int launch_fused_qkv(const void* x, const void* nscale, const void* w, const void* attn_scale,
                     const void* pos, const void* freqs, void* q, void* k, void* v, int images,
                     int tokens, int d, int n_heads, int groups, int scale_stride, float eps,
                     float cos_eps, cudaStream_t st, int* blocks) {
  const size_t smem = qkv_fwd_smem(d, NP);
  const cudaError_t attr = gemm::allow_shared(qkv_fwd_kernel<E, NP>, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (blocks != nullptr)
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, qkv_fwd_kernel<E, NP>, 2 * gemm::THREADS, smem));
  CUtensorMap map_w;
  const cudaError_t map_err = gemm::tile_map(&map_w, w, d, 3 * d);
  if (map_err != cudaSuccess) return static_cast<int>(map_err);
  const int tiles = (tokens + wg::ROWS - 1) / wg::ROWS;
  qkv_fwd_kernel<E, NP><<<dim3((images * tiles + 1) / 2, groups), 2 * gemm::THREADS, smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(nscale), map_w,
      static_cast<const float*>(attn_scale), static_cast<const float*>(pos),
      static_cast<const float*>(freqs), static_cast<bf16*>(q), static_cast<bf16*>(k),
      static_cast<bf16*>(v), images, tokens, d, n_heads, groups, scale_stride, eps, cos_eps);
  return static_cast<int>(cudaGetLastError());
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

// x (rows, d) bf16 with rows = images * tokens; nscale (images, d) bf16,
// image i's row at nscale + i * scale_stride (scale_stride >= d: a column
// block of a condcache row, read in place, as the Pallas kernel's BlockSpec
// reads its lane block); w (d, 3d) bf16; attn_scale (heads,) f32; pos
// (tokens, 2) f32 (the axial positions); freqs (heads, e / 8) f32 (the RoPE frequencies, ops/
// rope.py's axial_rope_freqs); q, k, v (rows, d) bf16. Needs d == e * heads with head dim e 32 or
// 64 and d % 64 == 0. A ring step takes step_panels (1, or 2 where d % 128
// == 0) 64-column panels of W_qkv; the 3d / (64 step_panels) step units
// split over `groups` blocks a pair of row tiles. With `blocks` not null
// nothing is launched: the number of blocks that fit on one SM at once is
// written there.
extern "C" int kdt_fused_qkv(const void* x, const void* nscale, const void* w,
                             const void* attn_scale, const void* pos, const void* freqs,
                             void* q, void* k, void* v, int images, int tokens, int d,
                             int n_heads, int step_panels, int groups, int scale_stride,
                             float eps, float cos_eps, void* stream, int* blocks) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d % 64 || n_heads < 1 || (step_panels != 1 && step_panels != 2) ||
      (3 * d / 64) % step_panels || groups < 1 || groups > 3 * d / 64 / step_panels ||
      scale_stride < d || scale_stride % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int e = d / n_heads;
  if (e * n_heads != d) return static_cast<int>(cudaErrorInvalidValue);
#define KDT_FUSED_QKV(E, NP)                                                                 \
  if (e == E && step_panels == NP)                                                           \
    return launch_fused_qkv<E, NP>(x, nscale, w, attn_scale, pos, freqs, q, k, v, images,  \
                                   tokens, d, n_heads, groups, scale_stride, eps, cos_eps, st, \
                                   blocks);
  KDT_FUSED_QKV(32, 1)
  KDT_FUSED_QKV(32, 2)
  KDT_FUSED_QKV(64, 1)
  KDT_FUSED_QKV(64, 2)
#undef KDT_FUSED_QKV
  return static_cast<int>(cudaErrorInvalidValue);
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
