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
// - Mapping network: 2 blocks of (256 x 1536) + (768 x 256) weights, 2.4
//   MB in bf16 or 4.7 MB as the model's f32 params (1.4 us at 3.35 TB/s),
//   on an (8, 256) activation (19 MFLOP): bound by latency, and by how many
//   SMs share the weight reads.
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
// - mapping_kernel (K5), one launch: a thread block cluster per 16 batch
//   rows spreads the weights over up to 16 SMs (below). Products by wmma
//   (16 x 16 x 16): a batch of 8 would fill 8 of a wgmma tile's 64 rows,
//   and 64-row tiles of xn, h and the partials would leave no room for the
//   weights, every layer of which stays resident. What it replaced: one
//   block per 16 rows (one SM at batch 8) took its B fragments straight
//   from device memory panel after panel, nothing in flight, after the
//   wrapper had stacked and cast the weights on every call.
#include <cooperative_groups.h>

#include <type_traits>

#include "gemm.cuh"

namespace kdt {
namespace {

// K5, the mapping network, on a thread block cluster (mapping_kernel). A
// cluster of `ranks` blocks owns a strip of 16 batch rows (rows past b are
// zero and never stored); every block of it holds the strip's whole f32
// residual stream x. The hidden units split into panels of 16, wmma's N,
// and rank r owns panels [P r / ranks, P (r + 1) / ranks) of P = d_ff / 16:
// the value and gate columns of W_up and the rows of W_down that meet them.
// Per block of the network each rank forms its panels' a | gate = xn W_up
// (the depth split over the warps its panels leave idle), h = bf16(a
// gelu(gate)) (exact erf) and the split-K partial h W_down[its rows] of the
// (16, d) output; after a cluster barrier each rank takes the rows it owns
// (r, r + ranks, ...), sums every rank's partial of them in a fixed order
// (no atomics: reruns are bit-equal), adds x, forms the next block's xn =
// bf16(RMSNorm(x)) (after the last block, the output) and writes x and xn
// into every rank's copy (distributed shared memory); a second barrier
// publishes them. The
// weights are the model's own tensors, one pointer each (MapLayers), f32
// or bf16 (F32W), rounded to bf16 where they land in shared memory, as the
// plain version's .to(bf16) rounds them. Every layer's share is resident
// (`buffers` layers, all of them when they fit; else layer l + buffers
// starts once layer l is done with its buffer) and starts copying at the
// top: bf16 by cp.async, one commit group a layer, so that a layer waits
// only for its own; f32 through registers, eight 16-byte loads in flight a
// thread before their rounded stores. The norm scales and the emb rows come
// first, in a group of their own. Chunk indices step without divisions
// (ChunkWalk): with one division per chunk, the index arithmetic took
// longer than the copies.
// The wrapper chooses `ranks` from the work (fused_mapping.cluster_size):
// the most of 16, 12, 8, ... that does not exceed the panels and that the
// device can place, since more ranks read fewer weight bytes an SM. Past 8
// a cluster is not portable (cudaFuncAttributeNonPortableClusterSizeAllowed;
// an H100 takes 16). At the flagship's d = 256, d_ff = 768 that is 16 ranks
// of 3 panels: 295 KB of f32 weights an SM, and both layers' shares, 157 KB
// in bf16, resident together. A cluster lives on one GPC, so the weights
// reach it through one GPC's share of the L2 bandwidth: on an H100 the f32
// weights took about 10 us to arrive (PERF.md), not the 1.4 us the card's
// whole memory rate would give.
constexpr int MAP_THREADS = 256;  // 8 warps
constexpr int MAP_MAX_DEPTH = 8;  // blocks of the network a launch takes
constexpr int MAP_UNIT = 16;      // hidden units of a panel
constexpr int MAP_FLY = 8;        // f32 loads in flight a thread
constexpr size_t MAP_SMEM_MAX = 232448 - 1024;  // an H100 block's, less static room

// Each block of the network: its norm scale (d,) f32, W_up (d, 2 d_ff) and
// W_down (d_ff, d), f32 or bf16, row-major.
struct MapLayers {
  const float* scale[MAP_MAX_DEPTH];
  const void* up[MAP_MAX_DEPTH];
  const void* down[MAP_MAX_DEPTH];
};

// The shared memory of one rank: x (16, d) f32 (row stride ldx), the
// partial (16, d) or the up product's f32 scratch (16, 256 or ur; ldp), xn
// (16, d) and h (16, ur) bf16, the n + 2 norm scales (in, out, each
// block's) f32, then `buffers` layer shares: W_up's value and gate columns
// (d, 2 ur) and W_down's rows (ur, d), bf16. Row strides are padded by 8
// bf16 or 4 floats, and every offset is a multiple of 32 bytes (wmma's
// alignment) and of 16 (cp.async's).
struct MapLayout {
  int ur;  // hidden units a rank holds at most, a multiple of 16
  int ldx, ldp, ldn, ldh, ldu, ldd;
  size_t fixed, up_bytes, layer_bytes;
  __host__ __device__ MapLayout(int d, int d_ff, int ranks, int n) {
    const int panels = d_ff / MAP_UNIT;
    ur = (panels + ranks - 1) / ranks * MAP_UNIT;
    ldx = d + 4;
    ldp = (d > 256 ? (d > ur ? d : ur) : (ur > 256 ? ur : 256)) + 4;
    ldn = d + 8;
    ldh = ur + 8;
    ldu = 2 * ur + 8;
    ldd = d + 8;
    fixed = (STRIP * (ldx + ldp) + (n + 2) * d) * sizeof(float) +
            STRIP * (ldn + ldh) * sizeof(bf16);
    up_bytes = static_cast<size_t>(d) * ldu * sizeof(bf16);
    layer_bytes = up_bytes + static_cast<size_t>(ur) * ldd * sizeof(bf16);
  }
  // how many of n layer shares fit (0: not one)
  __host__ __device__ int buffers(int n) const {
    const size_t room = MAP_SMEM_MAX > fixed ? (MAP_SMEM_MAX - fixed) / layer_bytes : 0;
    return static_cast<int>(room < static_cast<size_t>(n) ? room : n);
  }
  __host__ __device__ size_t smem(int buffers) const { return fixed + buffers * layer_bytes; }
};

// Thread t's walk over the chunks of a rows x cpr region, t, t + T, ... in
// row-major order (T threads), stepping its row and column without a
// division past the first.
struct ChunkWalk {
  int r, c, dr, dc, cpr;
  __device__ ChunkWalk(int cpr_)
      : r(threadIdx.x / cpr_), c(threadIdx.x % cpr_), dr(blockDim.x / cpr_),
        dc(blockDim.x % cpr_), cpr(cpr_) {}
  __device__ void step() {
    r += dr;
    c += dc;
    if (c >= cpr) {
      c -= cpr;
      ++r;
    }
  }
};

// RMS-normalises the 16 rows of the f32 stream xs (row stride ldx) with
// scale (d,) f32 in shared memory, as the Pallas kernel does: bf16(bf16(x)
// * bf16(scale / rms)); f(r, c, y) takes each result. A warp a row.
template <class F>
__device__ __forceinline__ void map_rms(const float* xs, int ldx, const float* scale, int d,
                                        float eps, const F& f) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31, warps = blockDim.x / 32;
  for (int r = warp; r < STRIP; r += warps) {
    const float* xr = xs + r * ldx;
    float ss = 0.f;
#pragma unroll 8
    for (int c = lane; c < d; c += 32) ss += xr[c] * xr[c];
    const float inv = rsqrtf(warp_sum(ss) / d + eps);
#pragma unroll 8
    for (int c = lane; c < d; c += 32) f(r, c, to_bf(bf_round(xr[c]) * bf_round(scale[c] * inv)));
  }
}

// Waits until at most n (<= MAP_MAX_DEPTH) of this thread's cp.async groups
// are in flight.
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: wg::cp_async_wait<0>(); break;
    case 1: wg::cp_async_wait<1>(); break;
    case 2: wg::cp_async_wait<2>(); break;
    case 3: wg::cp_async_wait<3>(); break;
    case 4: wg::cp_async_wait<4>(); break;
    case 5: wg::cp_async_wait<5>(); break;
    case 6: wg::cp_async_wait<6>(); break;
    case 7: wg::cp_async_wait<7>(); break;
    default: wg::cp_async_wait<8>(); break;
  }
}

// emb (b, d) bf16; in_scale, out_scale (d,) f32; out (b, d) bf16. Grid:
// one cluster of `ranks` blocks per 16 batch rows.
template <bool F32W>
__global__ void __launch_bounds__(MAP_THREADS, 1)
mapping_kernel(const bf16* __restrict__ emb, const float* __restrict__ in_scale,
               const float* __restrict__ out_scale, const MapLayers layers,
               bf16* __restrict__ out, int b, int d, int d_ff, int n_blocks, int buffers,
               float eps) {
  namespace cg = cooperative_groups;
  using W = typename std::conditional<F32W, float, bf16>::type;
  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const MapLayout L(d, d_ff, ranks, n_blocks);
  const int panels = d_ff / MAP_UNIT;
  const int p0 = panels * rank / ranks, np = panels * (rank + 1) / ranks - p0;
  const int u0 = p0 * MAP_UNIT, nu = np * MAP_UNIT;  // this rank's hidden units
  const int warp = threadIdx.x / 32, warps = blockDim.x / 32;
  // the up product's depth splits in ks parts over the warps its panels
  // leave idle (ks np <= warps, d / 16 a multiple of ks): at the flagship's
  // 3 panels a rank, 2 parts, 6 warps
  int ks = 1;
  while (2 * ks * np <= warps && (d / MAP_UNIT) % (2 * ks) == 0) ks *= 2;
  const int r0 = static_cast<int>(blockIdx.x) / ranks * STRIP;  // this cluster's rows
  const int rows = b - r0 < STRIP ? b - r0 : STRIP;

  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  float* part = xs + STRIP * L.ldx;
  float* scales = part + STRIP * L.ldp;  // in, out, then each block's
  bf16* xn = reinterpret_cast<bf16*>(scales + (n_blocks + 2) * d);
  bf16* hs = xn + STRIP * L.ldn;
  unsigned char* shares = reinterpret_cast<unsigned char*>(hs + STRIP * L.ldh);
  auto share_up = [&](int l) {
    return reinterpret_cast<bf16*>(shares + (l % buffers) * L.layer_bytes);
  };
  auto share_down = [&](int l) {
    return reinterpret_cast<bf16*>(shares + (l % buffers) * L.layer_bytes + L.up_bytes);
  };

  // the first group: the scales and this cluster's emb rows (into xn; rows
  // past b zero-filled)
  for (ChunkWalk k(d / 4); k.r < n_blocks + 2; k.step()) {
    const float* src = k.r == 0 ? in_scale : k.r == 1 ? out_scale : layers.scale[k.r - 2];
    wg::cp_async16(wg::smem_u32(scales + k.r * d + 4 * k.c), src + 4 * k.c, true);
  }
  for (ChunkWalk k(d / 8); k.r < STRIP; k.step())
    wg::cp_async16(wg::smem_u32(xn + k.r * L.ldn + 8 * k.c),
                   emb + static_cast<long>(r0 + (k.r < rows ? k.r : 0)) * d + 8 * k.c,
                   k.r < rows);
  wg::cp_async_commit();

  // layer l's share in 16-byte chunks of V elements: W_up's rows of cu
  // value then cu gate chunks, and W_down's rows of cd chunks
  constexpr int V = 16 / sizeof(W);
  const int cu = nu / V, cd = d / V;
  auto up_src = [&](int l, const ChunkWalk& k) {
    return static_cast<const W*>(layers.up[l]) + static_cast<long>(k.r) * 2 * d_ff + u0 +
           (k.c < cu ? k.c * V : d_ff + (k.c - cu) * V);
  };
  auto up_dst = [&](int l, const ChunkWalk& k) {
    return share_up(l) + k.r * L.ldu + (k.c < cu ? k.c * V : L.ur + (k.c - cu) * V);
  };
  auto down_src = [&](int l, const ChunkWalk& k) {
    return static_cast<const W*>(layers.down[l]) + static_cast<long>(u0 + k.r) * d + k.c * V;
  };
  auto down_dst = [&](int l, const ChunkWalk& k) {
    return share_down(l) + k.r * L.ldd + k.c * V;
  };
  // f32: MAP_FLY loads in flight, then their rounded stores
  auto copy_f32 = [&](int region_rows, int cpr, const auto& src, const auto& dst) {
    ChunkWalk k(cpr);
    while (k.r < region_rows) {
      float4 v[MAP_FLY];
      uint32_t to[MAP_FLY];
      int n = 0;
#pragma unroll
      for (int f = 0; f < MAP_FLY; ++f)
        if (k.r < region_rows) {
          v[f] = __ldg(reinterpret_cast<const float4*>(src(k)));
          to[f] = wg::smem_u32(dst(k));
          n = f + 1;
          k.step();
        }
#pragma unroll
      for (int f = 0; f < MAP_FLY; ++f)
        if (f < n)
          asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(to[f]),
                       "r"(wg::pack_bf16(v[f].x, v[f].y)), "r"(wg::pack_bf16(v[f].z, v[f].w)));
    }
  };
  auto load_layer = [&](int l) {
    if constexpr (!F32W) {
      for (ChunkWalk k(2 * cu); k.r < d; k.step())
        wg::cp_async16(wg::smem_u32(up_dst(l, k)), up_src(l, k), true);
      for (ChunkWalk k(cd); k.r < nu; k.step())
        wg::cp_async16(wg::smem_u32(down_dst(l, k)), down_src(l, k), true);
      wg::cp_async_commit();
    } else {
      copy_f32(d, 2 * cu, [&](const ChunkWalk& k) { return up_src(l, k); },
               [&](const ChunkWalk& k) { return up_dst(l, k); });
      copy_f32(nu, cd, [&](const ChunkWalk& k) { return down_src(l, k); },
               [&](const ChunkWalk& k) { return down_dst(l, k); });
    }
  };
  const int first = n_blocks < buffers ? n_blocks : buffers;
  for (int l = 0; l < first; ++l) load_layer(l);

  // x = RMSNorm(emb), f32
  cp_async_wait_n(F32W ? 0 : first);  // the first group has landed
  __syncthreads();
#pragma unroll
  for (int r = 0; r < STRIP; ++r)
    for (int c = threadIdx.x; c < d; c += blockDim.x) xs[r * L.ldx + c] = to_f(xn[r * L.ldn + c]);
  __syncthreads();
  map_rms(xs, L.ldx, scales, d, eps, [&](int r, int c, bf16 y) { xs[r * L.ldx + c] = to_f(y); });
  __syncthreads();
  map_rms(xs, L.ldx, scales + 2 * d, d, eps, [&](int r, int c, bf16 y) { xn[r * L.ldn + c] = y; });

  // Rank r owns rows r, r + ranks, ... of the stream. For each, a quad of
  // threads a float4 of the row: x += the sum of every rank's partial
  // (thread q sums the partials of ranks [q quarter, (q + 1) quarter) in
  // rank order, and the quad's four sums meet in order: a fixed order, so
  // reruns are bit-equal), then the row's RMS norm with `scale`: xn =
  // bf16(bf16(x) * bf16(scale / rms)), the next block's input, into every
  // rank's copy with x (thread q writing ranks q, q + 4, ...), or, after
  // the last block, out.
  __shared__ float s_ss[MAP_THREADS / 32];
  auto exchange = [&](const float* scale, bool last) {
    const int quarter = (ranks + 3) / 4, q = threadIdx.x & 3, quad = threadIdx.x / 4;
    const int lead = (threadIdx.x & 31) & ~3, quads = blockDim.x / 4;
    for (int row = rank; row < STRIP; row += ranks) {
      float ss = 0.f;
      for (int c = 4 * quad; c < d; c += 4 * quads) {
        float4 p[4];
#pragma unroll
        for (int g = 0; g < 4; ++g)
          if (g < quarter && q * quarter + g < ranks)
            p[g] = *reinterpret_cast<const float4*>(
                cluster.map_shared_rank(part, q * quarter + g) + row * L.ldp + c);
        float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int g = 0; g < 4; ++g)
          if (g < quarter && q * quarter + g < ranks) {
            sum[0] += p[g].x;
            sum[1] += p[g].y;
            sum[2] += p[g].z;
            sum[3] += p[g].w;
          }
        float* at = xs + row * L.ldx + c;
        const float4 x = *reinterpret_cast<const float4*>(at);
        float y[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float total = 0.f;
#pragma unroll
          for (int t = 0; t < 4; ++t) total += __shfl_sync(0xffffffffu, sum[e], lead + t);
          y[e] += total;
          ss += q == 0 ? y[e] * y[e] : 0.f;
        }
        const float4 v = make_float4(y[0], y[1], y[2], y[3]);
        __syncwarp();  // the quad has read x
        if (last) {
          if (q == 0) *reinterpret_cast<float4*>(at) = v;
        } else {
          for (int g = q; g < ranks; g += 4)
            *reinterpret_cast<float4*>(cluster.map_shared_rank(xs, g) + row * L.ldx + c) = v;
        }
      }
      ss = warp_sum(ss);
      if ((threadIdx.x & 31) == 0) s_ss[threadIdx.x / 32] = ss;
      __syncthreads();  // the row's x and its partial sums of squares are in place
      float total = 0.f;
      for (int w = 0; w < warps; ++w) total += s_ss[w];
      const float inv = rsqrtf(total / d + eps);
      for (int c = 4 * quad; c < d; c += 4 * quads) {
        const float4 x = *reinterpret_cast<const float4*>(xs + row * L.ldx + c);
        const float xv[4] = {x.x, x.y, x.z, x.w};
        bf16 yv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) yv[e] = to_bf(bf_round(xv[e]) * bf_round(scale[c + e] * inv));
        const uint2 packed = *reinterpret_cast<const uint2*>(yv);
        if (last) {
          if (q == 0 && row < rows)
            *reinterpret_cast<uint2*>(out + static_cast<long>(r0 + row) * d + c) = packed;
        } else {
          for (int g = q; g < ranks; g += 4)
            *reinterpret_cast<uint2*>(cluster.map_shared_rank(xn, g) + row * L.ldn + c) = packed;
        }
      }
      __syncthreads();  // s_ss is free for the next row
    }
  };

  for (int l = 0; l < n_blocks; ++l) {
    if constexpr (!F32W) {
      const int later = n_blocks - 1 - l < buffers - 1 ? n_blocks - 1 - l : buffers - 1;
      cp_async_wait_n(later);  // layer l's share has landed; later layers may be in flight
    }
    __syncthreads();  // and xn is in place
    const bf16* su = share_up(l);
    const bf16* sd = share_down(l);
    // a | gate of panel j over the depth's part kh of ks: warp w takes
    // (j, kh) = (w % np, w / np); with ks = 1 a gelu(gate) in f32 into part,
    // else each part's a and gate, summed in kh order below
    for (int w = warp; w < np * ks; w += warps) {
      const int j = w % np, kh = w / np;
      FragC a, g;
      wmma::fill_fragment(a, 0.f);
      wmma::fill_fragment(g, 0.f);
#pragma unroll 4
      for (int k0 = kh * (d / ks); k0 < (kh + 1) * (d / ks); k0 += 16) {
        FragA fa;
        FragB fv, fg;
        wmma::load_matrix_sync(fa, xn + k0, L.ldn);
        wmma::load_matrix_sync(fv, su + k0 * L.ldu + MAP_UNIT * j, L.ldu);
        wmma::load_matrix_sync(fg, su + k0 * L.ldu + L.ur + MAP_UNIT * j, L.ldu);
        wmma::mma_sync(a, fa, fv, a);
        wmma::mma_sync(g, fa, fg, g);
      }
      if (ks == 1) {
        // a and gate share the fragment layout: the GEGLU is elementwise
#pragma unroll
        for (int t = 0; t < a.num_elements; ++t) a.x[t] *= gelu_erf(g.x[t]);
        wmma::store_matrix_sync(part + MAP_UNIT * j, a, L.ldp, wmma::mem_row_major);
      } else {
        float* at = part + 2 * MAP_UNIT * (kh * np + j);
        wmma::store_matrix_sync(at, a, L.ldp, wmma::mem_row_major);
        wmma::store_matrix_sync(at + MAP_UNIT, g, L.ldp, wmma::mem_row_major);
      }
    }
    __syncthreads();
    // h = bf16(a gelu(gate)), the Pallas rounding point
    for (ChunkWalk k(nu); k.r < STRIP; k.step()) {
      const float* row = part + k.r * L.ldp;
      float v;
      if (ks == 1) {
        v = row[k.c];
      } else {
        const int j = k.c / MAP_UNIT, c = k.c % MAP_UNIT;
        float a = 0.f, g = 0.f;
        for (int kh = 0; kh < ks; ++kh) {
          a += row[2 * MAP_UNIT * (kh * np + j) + c];
          g += row[2 * MAP_UNIT * (kh * np + j) + MAP_UNIT + c];
        }
        v = a * gelu_erf(g);
      }
      hs[k.r * L.ldh + k.c] = to_bf(v);
    }
    __syncthreads();
    // this rank's split-K partial h W_down[its rows] of the (16, d) output
    for (int n0 = MAP_UNIT * warp; n0 < d; n0 += MAP_UNIT * warps) {
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
      for (int k0 = 0; k0 < nu; k0 += 16) {
        FragA fa;
        FragB fb;
        wmma::load_matrix_sync(fa, hs + k0, L.ldh);
        wmma::load_matrix_sync(fb, sd + k0 * L.ldd + n0, L.ldd);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(part + n0, acc, L.ldp, wmma::mem_row_major);
    }
    if (l + buffers < n_blocks) {
      __syncthreads();  // layer l's buffer is free
      load_layer(l + buffers);
    }
    cluster.sync();  // every rank's partial is in place
    exchange(l + 1 < n_blocks ? scales + (l + 3) * d : scales + d, l + 1 == n_blocks);
    cluster.sync();  // every rank holds the new x and xn; the partials may be overwritten
  }
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
               int d, int d_ff, int scale_stride, float eps) {
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
  norm_tiles(t, d, nscale + static_cast<long>(t.img) * scale_stride, eps, s_x, s_r, nullptr,
             nullptr, threadIdx.x, blockDim.x);

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
                           int d_ff, int groups, int scale_stride, float eps, cudaStream_t st,
                           int* clusters) {
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
                            d, d_ff, scale_stride, eps);
}

// The launch of K5 with the hidden panels over clusters of `ranks` blocks;
// with `clusters`, it is not launched and the number of clusters that fit
// on the device at once goes there instead. cudaErrorInvalidValue, before
// any CUDA call, where not one layer's share fits in shared memory.
template <bool F32W>
cudaError_t launch_mapping(const bf16* emb, const float* in_scale, const float* out_scale,
                           const MapLayers& layers, bf16* out, int b, int d, int d_ff, int n,
                           int ranks, float eps, cudaStream_t st, int* clusters) {
  const MapLayout layout(d, d_ff, ranks, n);
  const int buffers = layout.buffers(n);
  if (buffers < 1) return cudaErrorInvalidValue;
  const size_t smem = layout.smem(buffers);
  cudaError_t err = gemm::allow_shared(mapping_kernel<F32W>, smem);
  if (err == cudaSuccess && ranks > 8)  // 16 at most on an H100, not portable
    err = cudaFuncSetAttribute(mapping_kernel<F32W>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = ranks;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((b + STRIP - 1) / STRIP * ranks);
  cfg.blockDim = dim3(MAP_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  if (clusters != nullptr) {
    err = cudaOccupancyMaxActiveClusters(clusters, mapping_kernel<F32W>, &cfg);
    if (err != cudaSuccess) cudaGetLastError();  // a size the device refuses: no cluster fits
    return err;
  }
  return cudaLaunchKernelEx(&cfg, mapping_kernel<F32W>, emb, in_scale, out_scale, layers, out, b,
                            d, d_ff, n, buffers, eps);
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
// tokens; nscale (images, d) bf16, image i's row at nscale + i *
// scale_stride (scale_stride >= d: a column block of a condcache row, read
// in place, as the Pallas kernel's BlockSpec reads its lane block); w_up
// (d, 2 d_ff), w_down (d_ff, d) bf16.
// A block is `warpgroups` warpgroups holding out_tiles 64-column tiles of
// the output (one warpgroup: 1, 2 or 4 tiles; two: 2, 6 or 8; out_tiles
// divides d / 64); the hidden panels split over clusters of `groups`
// blocks (1 to 8, at most d_ff / 64). With `clusters` not null nothing is launched: the number of
// clusters that fit on the device at once is written there. Needs d, d_ff
// % 64 == 0.
extern "C" int kdt_ffn_fwd(const void* x, const void* nscale, const void* w_up,
                           const void* w_down, void* out, int images, int tokens, int d,
                           int d_ff, int warpgroups, int out_tiles, int groups, int scale_stride,
                           float eps, void* stream, int* clusters) {
  if (d % 64 || d_ff % 64 || out_tiles < 1 || (d / 64) % out_tiles || groups < 1 ||
      groups > 8 || groups > d_ff / 64 || scale_stride < d || scale_stride % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const bf16 *x_b = static_cast<const bf16*>(x), *ns_b = static_cast<const bf16*>(nscale);
  const bf16 *up_b = static_cast<const bf16*>(w_up), *down_b = static_cast<const bf16*>(w_down);
  bf16* out_b = static_cast<bf16*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define KDT_FFN_FWD(WG, NB)                                                                \
  if (warpgroups == WG && out_tiles == NB)                                                 \
    return static_cast<int>(launch_ffn_fwd<WG, NB>(x_b, ns_b, up_b, down_b, out_b, images, \
                                                   tokens, d, d_ff, groups, scale_stride, eps, \
                                                   st, clusters));
  KDT_FFN_FWD(1, 1)
  KDT_FFN_FWD(1, 2)
  KDT_FFN_FWD(1, 4)
  KDT_FFN_FWD(2, 2)
  KDT_FFN_FWD(2, 6)
  KDT_FFN_FWD(2, 8)
#undef KDT_FFN_FWD
  return static_cast<int>(cudaErrorInvalidValue);
}

// K5, the mapping network: out = RMSNorm(n x (x + GEGLU(RMSNorm(x) W_up)
// W_down) of x = RMSNorm(emb)), emb and out (b, d) bf16, in_scale and
// out_scale (d,) f32. `weights` holds 3 n host pointers, each block's norm
// scale (d,) f32, W_up (d, 2 d_ff) and W_down (d_ff, d), all f32 when
// f32_weights is 1, else all bf16. The hidden panels split over clusters
// of `ranks` blocks (1 to 16, at most d_ff / 16), one cluster per 16 rows.
// With `clusters` not null nothing is launched: the number of clusters
// that fit on the device at once is written there. Needs d, d_ff % 64 == 0
// and 1 <= n <= MAP_MAX_DEPTH.
extern "C" int kdt_mapping(const void* emb, const void* in_scale, const void* out_scale,
                           const void* const* weights, void* out, int b, int d, int d_ff,
                           int n_blocks, int f32_weights, int ranks, float eps, void* stream,
                           int* clusters) {
  if (d % 64 || d_ff % 64 || n_blocks < 1 || n_blocks > MAP_MAX_DEPTH || ranks < 1 ||
      ranks > 16 || ranks > d_ff / MAP_UNIT)
    return static_cast<int>(cudaErrorInvalidValue);
  MapLayers layers = {};
  for (int l = 0; l < n_blocks && weights != nullptr; ++l) {
    layers.scale[l] = static_cast<const float*>(weights[3 * l]);
    layers.up[l] = weights[3 * l + 1];
    layers.down[l] = weights[3 * l + 2];
  }
  const bf16* e = static_cast<const bf16*>(emb);
  const float *si = static_cast<const float*>(in_scale), *so = static_cast<const float*>(out_scale);
  bf16* o = static_cast<bf16*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      f32_weights ? launch_mapping<true>(e, si, so, layers, o, b, d, d_ff, n_blocks, ranks, eps,
                                         st, clusters)
                  : launch_mapping<false>(e, si, so, layers, o, b, d, d_ff, n_blocks, ranks, eps,
                                          st, clusters));
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
