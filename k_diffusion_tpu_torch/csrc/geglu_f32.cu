// The GEGLU kernels in float32, the kernels of --mixed-precision no: the
// HDiT feed-forward block, forward (K4 in f32) and backward (K10 in f32),
// and the whole mapping network (K5 in f32): the forwards on
// gemm_tf32.cuh's TF32 mma.sync core, the backward on gemm_tf32_wg.cuh's
// TF32 wgmma core.
//
// Replaces: k_diffusion_tpu/ops/pallas/fused_ffn.py:_ffn_kernel (the
// forward of fused_geglu_ffn), :_ffn_bwd_kernel (its backward) and
// k_diffusion_tpu/ops/pallas/fused_mapping.py:_mapping_kernel (the forward
// of fused_mapping), as they run on f32 operands (the JAX model built with
// dtype=float32): f32 dots with f32 accumulation. Here every product runs
// on the TF32 tensor cores with f32 accumulation, as PyTorch's float32
// training does with TF32 on; the norms, the exact-erf GELU, its
// derivative, the residuals and h stay in f32.
//
// What bounds them on the H100, the shifted-window config's shapes:
// - FF block (eval, batch 8): 6 tokens d d_ff = 9.7 GFLOP at every level
//   (20 us at TF32's 494.7 TFLOP/s) against x in and out, 34 MB at level 0
//   (10 us at 3.35 TB/s): bound by the tensor cores.
// - FF backward at batch-8 training shapes: the recomputed up projection
//   and four VJP products, 16 tokens d d_ff FLOP, 2.7x the forward's.
// - Mapping network (batch 8, d 256, d_ff 768, 2 blocks): 4.7 MB of f32
//   weights (1.4 us at 3.35 TB/s) on an (8, 256) activation: bound by
//   latency, and by how many SMs share the weight reads.
//
// Design: two kernels on gemm_tf32.cuh's core, the norm folded into the up
// product (Normed), and the core's shared steps.
// - ffn_f32_up_kernel: per 128-row tile (never spanning two images) and 64
//   hidden units, a | gate = r (x nscale) W_up[value, gate columns] in two
//   accumulator sets, then h = a gelu(gate) (exact erf) in f32.
// - ffn_f32_down_kernel: per 128-row tile and 64 output columns, out = res
//   + h W_down (A K-major, B MN-major).
// K4 in f32 is the two, one after the other: h (rows, d_ff) goes through
// device memory, where the bf16 form keeps it in registers; a simple
// design first (PERF.md).
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
// K5 in f32 runs the network as these kernels on the (b, d) activation, the
// batch one "image" whose scale is the block's own norm scale (a row
// stride of 0): rms_rows_kernel (x = RMSNorm(emb, in_scale)), per block
// ffn_f32_up_kernel and ffn_f32_down_kernel (x += GEGLU(RMSNorm(x, ns)
// W_up) W_down, the down product's depth split in chunks of 256 hidden
// units, whose partials add_parts_kernel sums with the residual),
// rms_rows_kernel (the out norm); 2 + 3 n kernels. It
// takes any width, d and d_ff multiples of 64: nothing is resident, where
// the bf16 form keeps each layer's share in a thread block cluster's
// shared memory.
#include "gemm_tf32.cuh"
#include "gemm_tf32_wg.cuh"

namespace kdt {
namespace {

constexpr float INV_SQRT_2PI = 0.3989422804014327f;
// hidden units of a chunk of K5's split down product
constexpr int MAP_CHUNK = 256;

// gelu(g) and d gelu(g) / dg for the exact (erf) GELU, one erf for both
__device__ __forceinline__ void gelu_erf_both(float g, float& gelu, float& grad) {
  const float cdf = 0.5f * (1.0f + erff(g * 0.70710678118654752440f));
  gelu = g * cdf;
  grad = cdf + g * INV_SQRT_2PI * __expf(-0.5f * g * g);
}

// h = a gelu(gate) for one row tile and 64 hidden units. Grid (images *
// tiles, d_ff / 64). nscale (images, d): image i's row at nscale + i *
// scale_stride (0: one scale for every row).
__global__ void __launch_bounds__(tg::THREADS)
ffn_f32_up_kernel(const float* __restrict__ x, const float* __restrict__ nscale, int scale_stride,
                  const float* __restrict__ w_up, float* __restrict__ h, int tokens, int d,
                  int d_ff, float eps) {
  extern __shared__ __align__(16) float smem[];
  float* s_ns = smem;
  const tg::RowTile t = tg::row_tile(tokens);
  const int u0 = 64 * blockIdx.y;
  tg::load_scale(nscale + static_cast<long>(t.img) * scale_stride, d, s_ns);
  float acc[2][8][4];
  tg::zero(acc);
  const int b0[2] = {u0, d_ff + u0};
  tg::Normed norm{s_ns};
  tg::mainloop<2>(acc, smem + d + tg::ROWS, x, d, t.row0, t.row0 + t.valid, w_up, 2L * d_ff, b0,
                  0, d, norm);
  float rows_r[2];
  tg::row_norms(norm, d, eps, rows_r);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = tg::acc_row(hh);
    if (row >= t.valid) continue;
    float* out = h + (t.row0 + row) * d_ff + u0 + 2 * tg::lane_t();
    const float r = rows_r[hh];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float a0 = acc[0][n][2 * hh] * r, a1 = acc[0][n][2 * hh + 1] * r;
      const float g0 = acc[1][n][2 * hh] * r, g1 = acc[1][n][2 * hh + 1] * r;
      *reinterpret_cast<float2*>(out + 8 * n) = make_float2(a0 * gelu_erf(g0), a1 * gelu_erf(g1));
    }
  }
}

// out = res + a W for one 128-row tile of a (rows, k_dim) and 64 columns of
// W (k_dim, n), rows = images * tokens. Grid (images * tiles, n / 64,
// splits): with part not null, block z takes the depth [z k_chunk, (z + 1)
// k_chunk) and writes its partial to part (splits, rows, n) instead, for
// add_parts_kernel (the mapping network's few rows: a split of the depth
// gives it more blocks than n / 64).
__global__ void __launch_bounds__(tg::THREADS)
ffn_f32_down_kernel(const float* __restrict__ a, const float* __restrict__ w,
                    const float* __restrict__ res, float* __restrict__ out,
                    float* __restrict__ part, int tokens, int k_dim, int n, int k_chunk) {
  extern __shared__ __align__(16) float smem[];
  const tg::RowTile t = tg::row_tile(tokens);
  const int n0 = 64 * blockIdx.y;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = k_begin + k_chunk < k_dim ? k_begin + k_chunk : k_dim;
  float acc[1][8][4];
  tg::zero(acc);
  const int b0[1] = {n0};
  tg::mainloop<1>(acc, smem, a, k_dim, t.row0, t.row0 + t.valid, w, n, b0, k_begin, k_end,
                  tg::Plain{});
  const long rows = static_cast<long>(gridDim.x / tg::tiles(tokens)) * tokens;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = tg::acc_row(hh);
    if (row >= t.valid) continue;
    const long at = (t.row0 + row) * n + n0 + 2 * tg::lane_t();
#pragma unroll
    for (int nn = 0; nn < 8; ++nn) {
      const float2 v = make_float2(acc[0][nn][2 * hh], acc[0][nn][2 * hh + 1]);
      if (part != nullptr) {
        *reinterpret_cast<float2*>(part + blockIdx.z * rows * n + at + 8 * nn) = v;
      } else {
        const float2 rv = *reinterpret_cast<const float2*>(res + at + 8 * nn);
        *reinterpret_cast<float2*>(out + at + 8 * nn) = make_float2(rv.x + v.x, rv.y + v.y);
      }
    }
  }
}

// out = res + the sum of the `splits` partials (splits, count), in split
// order: no atomics, a rerun is bit-equal.
__global__ void add_parts_kernel(const float* __restrict__ res, const float* __restrict__ part,
                                 float* __restrict__ out, long count, int splits) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = res[i];
  for (int z = 0; z < splits; ++z) s += part[z * count + i];
  out[i] = s;
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

// out (rows, d) = x * (scale / rms(x)), a warp a row.
__global__ void rms_rows_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                                float* __restrict__ out, int rows, int d, float eps) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32, lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* xr = x + static_cast<long>(row) * d;
  float ss = 0.f;
  for (int c = lane; c < d; c += 32) ss += xr[c] * xr[c];
  const float r = rsqrtf(warp_sum(ss) / d + eps);
  for (int c = lane; c < d; c += 32) out[static_cast<long>(row) * d + c] = xr[c] * (scale[c] * r);
}

cudaError_t launch_up(const float* x, const float* nscale, int scale_stride, const float* w_up,
                      float* h, int images, int tokens, int d, int d_ff, float eps,
                      cudaStream_t st) {
  const size_t smem = tg::normed_smem<2>(d);
  const cudaError_t err = allow_smem(ffn_f32_up_kernel, smem);
  if (err != cudaSuccess) return err;
  ffn_f32_up_kernel<<<dim3(images * tg::tiles(tokens), d_ff / 64), tg::THREADS, smem, st>>>(
      x, nscale, scale_stride, w_up, h, tokens, d, d_ff, eps);
  return cudaGetLastError();
}

// out = res + a W; with part, the depth splits in chunks of k_chunk (a
// multiple of 32), partials in part, summed by add_parts_kernel.
cudaError_t launch_down(const float* a, const float* w, const float* res, float* out, int images,
                        int tokens, int k_dim, int n, cudaStream_t st, float* part = nullptr,
                        int k_chunk = 0) {
  cudaError_t err = allow_smem(ffn_f32_down_kernel, tg::RING_BYTES<1>);
  if (err != cudaSuccess) return err;
  const int splits = part == nullptr ? 1 : (k_dim + k_chunk - 1) / k_chunk;
  ffn_f32_down_kernel<<<dim3(images * tg::tiles(tokens), n / 64, splits), tg::THREADS,
                        tg::RING_BYTES<1>, st>>>(a, w, res, out, part, tokens, k_dim, n,
                                                 part == nullptr ? k_dim : k_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess || part == nullptr) return err;
  const long count = static_cast<long>(images) * tokens * n;
  add_parts_kernel<<<static_cast<unsigned>((count + 255) / 256), 256, 0, st>>>(res, part, out,
                                                                              count, splits);
  return cudaGetLastError();
}

cudaError_t launch_rms_rows(const float* x, const float* scale, float* out, int rows, int d,
                            float eps, cudaStream_t st) {
  rms_rows_kernel<<<(rows + 7) / 8, 256, 0, st>>>(x, scale, out, rows, d, eps);
  return cudaGetLastError();
}

}  // namespace
}  // namespace kdt

using namespace kdt;

// K4 in f32. x (rows, d) f32 with rows = images * tokens; nscale (images,
// d) f32, image i's row at nscale + i * scale_stride (scale_stride >= d, a
// multiple of 4: a condcache row's block, read in place); w_up (d, 2 d_ff),
// w_down (d_ff, d) f32; out (rows, d) f32; h (rows, d_ff) f32 scratch.
// Needs d, d_ff % 64 == 0.
extern "C" int kdt_ffn_fwd_f32(const void* x, const void* nscale, const void* w_up,
                               const void* w_down, void* out, void* h, int images, int tokens,
                               int d, int d_ff, int scale_stride, float eps, void* stream) {
  if (d % 64 || d_ff % 64 || scale_stride < d || scale_stride % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* hf = static_cast<float*>(h);
  cudaError_t err = launch_up(xf, static_cast<const float*>(nscale), scale_stride,
                              static_cast<const float*>(w_up), hf, images, tokens, d, d_ff, eps,
                              st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_down(hf, static_cast<const float*>(w_down), xf,
                                      static_cast<float*>(out), images, tokens, d_ff, d, st));
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

// K5 in f32. emb (b, d) f32; in_scale, out_scale (d,) f32; weights: 3 n
// pointers, each block's norm scale (d,), W_up (d, 2 d_ff) and W_down
// (d_ff, d), all f32; out (b, d) f32. Scratch f32: xa, xb (b, d), h (b,
// d_ff) and part (ceil(d_ff / MAP_CHUNK), b, d), the down product's
// partials over chunks of MAP_CHUNK hidden units. Needs d, d_ff % 64 == 0
// and 1 <= n.
extern "C" int kdt_mapping_f32(const void* emb, const void* in_scale, const void* out_scale,
                               const void* const* weights, void* out, void* xa, void* xb,
                               void* h, void* part, int b, int d, int d_ff, int n_blocks,
                               float eps, void* stream) {
  if (d % 64 || d_ff % 64 || n_blocks < 1 || b < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float *x = static_cast<float*>(xa), *y = static_cast<float*>(xb), *hf = static_cast<float*>(h);
  float* parts = static_cast<float*>(part);
  cudaError_t err = launch_rms_rows(static_cast<const float*>(emb),
                                    static_cast<const float*>(in_scale), x, b, d, eps, st);
  for (int l = 0; l < n_blocks && err == cudaSuccess; ++l) {
    const float* ns = static_cast<const float*>(weights[3 * l]);
    const float* up = static_cast<const float*>(weights[3 * l + 1]);
    const float* down = static_cast<const float*>(weights[3 * l + 2]);
    err = launch_up(x, ns, 0, up, hf, 1, b, d, d_ff, eps, st);
    if (err == cudaSuccess)
      err = launch_down(hf, down, x, y, 1, b, d_ff, d, st, parts, MAP_CHUNK);
    float* swap = x;
    x = y;
    y = swap;
  }
  if (err == cudaSuccess)
    err = launch_rms_rows(x, static_cast<const float*>(out_scale), static_cast<float*>(out), b, d,
                          eps, st);
  return static_cast<int>(err);
}

KDT_DEFINE_ERROR_STRING
