// Channel-packed 2-D neighborhood attention, forward: each query attends to
// exactly ks x ks keys, its window start clamp(i - (ks - 1) / 2, 0, n - ks)
// on each axis (NATTEN's contract).
//
// Replaces: k_diffusion_tpu/ops/pallas/na2d.py:_na_packed_fwd_kernel (the
// forward of na2d_packed).
//
// What bounds it on the H100, flagship eval shapes at batch 8 (k = 7): the
// useful work is 2 * 2 * 49 * 64 FLOP per query and head, 0.82 GFLOP at
// level 0 (64 x 64, 2 heads) and 0.41 at level 1 (32 x 32, 4 heads), while
// q, k, v and the output are 34 MB at level 0 (10 us at 3.35 TB/s) and 17 MB
// at level 1. So the floor is memory; in this design the softmax over each
// query's masked logits on the CUDA cores is the likelier limit.
//
// Design: no halo gather and no mask tables. A block owns an 8 x 8 query
// tile of one head of one image and loads the clamped union of its windows,
// at most 14 x 14 keys, for k and v into shared memory (zeros outside the
// map). A warp owns two query rows (16 queries); their windows lie within 8
// consecutive halo rows, i.e. 112 consecutive halo keys, so the warp
// computes the 16 x 112 logits with wmma bf16 fragments (f32 accumulate),
// masks each query to its own window from the coordinates, takes the
// softmax with the running max subtracted, and multiplies the bf16
// probabilities by the same 112 values rows of v. Heads are a grid
// dimension: no head-masked matmuls.
#include "common.cuh"

namespace kdt {
namespace {

constexpr int E = 64;
constexpr int TQ = 8;                  // query tile edge
constexpr int HALO = 14;               // halo edge: TQ + 7 - 1
constexpr int NKEYS = HALO * HALO;     // halo keys
constexpr int NKEYS_ALLOC = 208;       // rounded up to 16
constexpr int WKEYS = 8 * HALO;        // keys a warp's 2 query rows can see
constexpr int LDK = E + 8;
constexpr int LDS = WKEYS + 4;

// Is halo key j (of the warp's 112) in the window of the warp's query m?
struct WindowMask {
  int qy0, qx0;  // the warp's first query
  int ky0, kx0;  // map coordinates of the warp's first key
  int h, w, ks, r;
  __device__ bool operator()(int m, int j) const {
    const int qy = qy0 + (m >> 3), qx = qx0 + (m & 7);
    const int ky = ky0 + j / HALO, kx = kx0 + j % HALO;
    const int wy = clampi(qy - r, 0, h - ks), wx = clampi(qx - r, 0, w - ks);
    return static_cast<unsigned>(ky - wy) < static_cast<unsigned>(ks) &&
           static_cast<unsigned>(kx - wx) < static_cast<unsigned>(ks);
  }
};

__global__ void __launch_bounds__(THREADS)
na2d_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
            bf16* __restrict__ out, int h, int w, int n_heads, int ks, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* s_q = reinterpret_cast<bf16*>(smem);
  bf16* s_k = s_q + TQ * TQ * LDK;
  bf16* s_v = s_k + NKEYS_ALLOC * LDK;
  float* s_s = reinterpret_cast<float*>(s_v + NKEYS_ALLOC * LDK);

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int tiles_w = w / TQ;
  const int y0 = (blockIdx.x / tiles_w) * TQ, x0 = (blockIdx.x % tiles_w) * TQ;
  const int head = blockIdx.y;
  const long c = static_cast<long>(n_heads) * E;
  const long img = static_cast<long>(blockIdx.z) * h * w * c + head * E;
  const int r = (ks - 1) / 2;
  const int hr0 = clampi(y0 - r, 0, h - ks), hc0 = clampi(x0 - r, 0, w - ks);

  for (int i = threadIdx.x; i < TQ * TQ * 8; i += blockDim.x) {
    const int qi = i >> 3, cv = (i & 7) * 8;
    const long src = img + ((y0 + qi / TQ) * static_cast<long>(w) + x0 + qi % TQ) * c + cv;
    *reinterpret_cast<uint4*>(s_q + qi * LDK + cv) = *reinterpret_cast<const uint4*>(q + src);
  }
  for (int i = threadIdx.x; i < NKEYS * 8; i += blockDim.x) {
    const int kj = i >> 3, cv = (i & 7) * 8;
    const int y = hr0 + kj / HALO, xx = hc0 + kj % HALO;
    uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
    if (y < h && xx < w) {
      const long src = img + (y * static_cast<long>(w) + xx) * c + cv;
      kv = *reinterpret_cast<const uint4*>(k + src);
      vv = *reinterpret_cast<const uint4*>(v + src);
    }
    *reinterpret_cast<uint4*>(s_k + kj * LDK + cv) = kv;
    *reinterpret_cast<uint4*>(s_v + kj * LDK + cv) = vv;
  }
  __syncthreads();

  // the warp's queries: rows qy0, qy0 + 1 of the tile, all 8 columns; their
  // windows start at halo row kr or kr + 1 and span at most 8 rows
  const int qy0 = y0 + 2 * warp;
  const int kr = clampi(qy0 - r, 0, h - ks) - hr0;
  const bf16* keys_k = s_k + kr * HALO * LDK;
  const bf16* keys_v = s_v + kr * HALO * LDK;
  const bf16* a = s_q + warp * STRIP * LDK;
  float* strip = s_s + warp * STRIP * LDS;

  FragC acc[WKEYS / 16];
  zero(acc);
  for (int k0 = 0; k0 < E; k0 += 16) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + k0, LDK);
#pragma unroll
    for (int j = 0; j < WKEYS / 16; ++j) {
      FragBt fb;
      wmma::load_matrix_sync(fb, keys_k + 16 * j * LDK + k0, LDK);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < WKEYS / 16; ++j)
    wmma::store_matrix_sync(strip + 16 * j, acc[j], LDS, wmma::mem_row_major);
  __syncwarp();

  softmax_strip(strip, LDS, WKEYS, scale,
                WindowMask{qy0, x0, hr0 + kr, hc0, h, w, ks, r});

  FragC o[4];
  zero(o);
  mma_strip(reinterpret_cast<const bf16*>(strip), 2 * LDS, keys_v, LDK, WKEYS, o);
  __syncwarp();  // every lane is done reading the probabilities
  store_strip(strip, LDS, o);
  for (int m = 0; m < STRIP; ++m) {
    const long dst = img + ((qy0 + m / TQ) * static_cast<long>(w) + x0 + m % TQ) * c;
    const int cc = 2 * lane;
    *reinterpret_cast<__nv_bfloat162*>(out + dst + cc) =
        __floats2bfloat162_rn(strip[m * LDS + cc], strip[m * LDS + cc + 1]);
  }
}

}  // namespace
}  // namespace kdt

using namespace kdt;

// q, k, v, out (b, h, w, heads * 64) bf16. Needs h % 8 == w % 8 == 0 and
// 1 <= ks <= min(7, h, w).
extern "C" int kdt_na2d_packed(const void* q, const void* k, const void* v, void* out, int b,
                               int h, int w, int n_heads, int ks, float scale, void* stream) {
  const size_t smem = (TQ * TQ + 2 * NKEYS_ALLOC) * LDK * sizeof(bf16) +
                      WARPS * STRIP * LDS * sizeof(float);
  const cudaError_t attr = allow_smem(na2d_kernel, smem);
  const dim3 grid((h / TQ) * (w / TQ), n_heads, b);
  na2d_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), h, w, n_heads, ks, scale);
  return launch_status(attr);
}

KDT_DEFINE_ERROR_STRING
