// Exact global softmax attention on channel-packed (b, s, heads * 64) maps:
// forward (K3) and backward (K9).
//
// Replaces: k_diffusion_tpu/ops/pallas/global_packed.py:_fwd_kernel (the
// forward of packed_global_attention) and :_bwd_kernel (its backward).
//
// What bounds it on the H100, flagship eval shape at batch 8 (s = 256 mid
// level tokens, 8 heads): 4 * s^2 * 64 FLOP per image and head, 1.1 GFLOP
// (1.1 us at 989 TFLOP/s), against 8.4 MB of q, k, v and output (2.5 us at
// 3.35 TB/s). So it is bound by memory and, at 256 blocks, by latency.
//
// Design: a block owns 64 queries of one head of one image; heads are a
// grid dimension, so no head-masked matmuls. Each warp computes its 16
// queries' logits against all s keys with wmma bf16 fragments (f32
// accumulate) into shared memory; the whole row fits, so the softmax is
// exact and two-pass with the max subtracted, no online rescaling. k is then
// overwritten by v in shared memory, and the bf16 probabilities, written in
// place over the logits, multiply v. Takes s <= 512. In training it also
// writes each query's logsumexp for the backward.
#include "common.cuh"

namespace kdt {
namespace {

constexpr int E = 64;
constexpr int LDK = E + 8;

// Float row stride of a warp's strip: it holds the s logits, then the
// 64-column output, so it is at least 64 wide.
__host__ __device__ inline int logit_stride(int s) { return (s > PANEL ? s : PANEL) + 4; }

// Loads rows [0, n) of one head's (s, 64) slice of a packed map (row
// stride c) into shared memory (stride LDK); rows at or past `valid` are 0.
__device__ __forceinline__ void load_head_rows(bf16* dst, const bf16* src, long c, int n,
                                               int valid) {
  for (int i = threadIdx.x; i < n * 8; i += blockDim.x) {
    const int r = i >> 3, cv = (i & 7) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + r * c + cv);
    *reinterpret_cast<uint4*>(dst + r * LDK + cv) = val;
  }
}

__global__ void __launch_bounds__(THREADS)
global_packed_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     float* __restrict__ lse, int s, int n_heads, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lds = logit_stride(s);
  bf16* s_q = reinterpret_cast<bf16*>(smem);
  bf16* s_kv = s_q + BM * LDK;
  float* s_s = reinterpret_cast<float*>(s_kv + s * LDK);

  const int warp = threadIdx.x / 32;
  const int q0 = blockIdx.x * BM;
  const int valid = s - q0 < BM ? s - q0 : BM;
  const long c = static_cast<long>(n_heads) * E;
  const long img = static_cast<long>(blockIdx.z) * s * c + blockIdx.y * E;

  load_head_rows(s_q, q + img + q0 * c, c, BM, valid);
  load_head_rows(s_kv, k + img, c, s, s);
  __syncthreads();

  const bf16* a = s_q + warp * STRIP * LDK;
  float* strip = s_s + warp * STRIP * lds;
  for (int n0 = 0; n0 < s; n0 += 16) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int k0 = 0; k0 < E; k0 += 16) {
      FragA fa;
      FragBt fb;
      wmma::load_matrix_sync(fa, a + k0, LDK);
      wmma::load_matrix_sync(fb, s_kv + n0 * LDK + k0, LDK);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(strip + n0, acc, lds, wmma::mem_row_major);
  }
  __syncthreads();  // every warp is done with k
  load_head_rows(s_kv, v + img, c, s, s);
  __syncwarp();
  __shared__ float s_lse[BM];
  softmax_strip(strip, lds, s, scale, AllValid{}, s_lse + warp * STRIP);
  __syncthreads();  // v is loaded
  if (lse != nullptr && threadIdx.x < valid)
    lse[(static_cast<long>(blockIdx.z) * n_heads + blockIdx.y) * s + q0 + threadIdx.x] =
        s_lse[threadIdx.x];

  FragC o[4];
  zero(o);
  mma_strip(reinterpret_cast<const bf16*>(strip), 2 * lds, s_kv, LDK, s, o);
  __syncwarp();  // every lane is done reading the probabilities
  store_strip(strip, lds, o);
  const int r0 = warp * STRIP;
  write_strip(strip, lds, out + img + (q0 + r0) * c, c, nullptr, valid - r0);
}


// K9, the backward. What bounds it on the H100, flagship training shape at
// batch 32 (s = 256, 8 heads): 5 products of 2 * s^2 * 64 FLOP per image
// and head, 5.4 GFLOP (5.4 us at 989 TFLOP/s), against q, k, v, out, dout,
// dq, dk, dv (8 * 8.4 MB, 20 us at 3.35 TB/s): bound by memory and, at 256
// blocks of each kernel, by latency.
//
// Design, the two-kernel split of FlashAttention-2's backward, with p
// recomputed from the forward's logsumexp:
// - global_dq_kernel: a block owns 64 queries of one head, as the forward.
//   A warp computes its 16 queries' logits against every key, turns them
//   into p = exp(s - lse) in place, then dP = dout v^T one 16-key block at
//   a time into ds = p (dP - delta), delta = rowsum(dout * out), which it
//   also writes out for the second kernel. ds in bf16 (in place) times k
//   gives dq. Shared memory holds k or v (one at a time, reloaded), the
//   logit strips and q, dout: 228 KB at s = 512, 125 KB at s = 256.
// - global_dkv_kernel: a block owns 64 keys of one head and walks the
//   queries in 64-row chunks; a warp forms p^T and ds^T for its 16 keys
//   and accumulates dv += p^T dout and dk += ds^T q in registers. Any s.
__global__ void __launch_bounds__(THREADS)
global_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ o,
                 const bf16* __restrict__ dout, const float* __restrict__ lse,
                 float* __restrict__ delta, bf16* __restrict__ dq, int s, int n_heads,
                 float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lds = logit_stride(s);
  bf16* s_q = reinterpret_cast<bf16*>(smem);
  bf16* s_do = s_q + BM * LDK;
  bf16* s_kv = s_do + BM * LDK;
  float* s_s = reinterpret_cast<float*>(s_kv + s * LDK);
  float* s_tmp = s_s + WARPS * STRIP * lds;
  __shared__ float s_lse[BM], s_delta[BM];

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * BM;
  const int valid = s - q0 < BM ? s - q0 : BM;
  const long c = static_cast<long>(n_heads) * E;
  const long img = static_cast<long>(blockIdx.z) * s * c + blockIdx.y * E;
  const long row0 = (static_cast<long>(blockIdx.z) * n_heads + blockIdx.y) * s + q0;

  load_head_rows(s_q, q + img + q0 * c, c, BM, valid);
  load_head_rows(s_do, dout + img + q0 * c, c, BM, valid);
  load_head_rows(s_kv, k + img, c, s, s);
  if (threadIdx.x < BM) s_lse[threadIdx.x] = threadIdx.x < valid ? lse[row0 + threadIdx.x] : 0.f;
  for (int m = 0; m < STRIP; ++m) {
    const int r = warp * STRIP + m;
    float dsum = 0.f;
    if (r < valid) {
      const long src = img + (q0 + r) * c + 2 * lane;
      const float2 ov = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o + src));
      const float2 dv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dout + src));
      dsum = ov.x * dv.x + ov.y * dv.y;
    }
    dsum = warp_sum(dsum);
    if (lane == 0) {
      s_delta[r] = dsum;
      if (r < valid) delta[row0 + r] = dsum;
    }
  }
  __syncthreads();

  const bf16* a = s_q + warp * STRIP * LDK;
  float* strip = s_s + warp * STRIP * lds;
  for (int n0 = 0; n0 < s; n0 += 16) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int k0 = 0; k0 < E; k0 += 16) {
      FragA fa;
      FragBt fb;
      wmma::load_matrix_sync(fa, a + k0, LDK);
      wmma::load_matrix_sync(fb, s_kv + n0 * LDK + k0, LDK);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(strip + n0, acc, lds, wmma::mem_row_major);
  }
  __syncthreads();  // every warp is done with k
  load_head_rows(s_kv, v + img, c, s, s);
  __syncwarp();
  for (int m = 0; m < STRIP; ++m) {
    const int r = warp * STRIP + m;
    for (int j = lane; j < s; j += 32)
      strip[m * lds + j] = r < valid ? __expf(strip[m * lds + j] * scale - s_lse[r]) : 0.f;
  }
  __syncthreads();  // v is loaded

  const bf16* ad = s_do + warp * STRIP * LDK;
  float* tmp = s_tmp + warp * STRIP * 16;
  for (int n0 = 0; n0 < s; n0 += 16) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int k0 = 0; k0 < E; k0 += 16) {
      FragA fa;
      FragBt fb;
      wmma::load_matrix_sync(fa, ad + k0, LDK);
      wmma::load_matrix_sync(fb, s_kv + n0 * LDK + k0, LDK);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(tmp, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int i = lane; i < STRIP * 16; i += 32) {
      const int m = i / 16, j = n0 + i % 16;
      strip[m * lds + j] *= tmp[i] - s_delta[warp * STRIP + m];
    }
    __syncwarp();
  }
  strip_to_bf16(strip, lds, s);
  __syncthreads();  // every warp is done with v
  load_head_rows(s_kv, k + img, c, s, s);
  __syncthreads();

  FragC acc[4];
  zero(acc);
  mma_strip(reinterpret_cast<const bf16*>(strip), 2 * lds, s_kv, LDK, s, acc);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    for (int t = 0; t < acc[j].num_elements; ++t) acc[j].x[t] *= scale;
  __syncwarp();  // every lane is done reading ds
  store_strip(strip, lds, acc);
  const int r0 = warp * STRIP;
  write_strip(strip, lds, dq + img + (q0 + r0) * c, c, nullptr, valid - r0);
}

__global__ void __launch_bounds__(THREADS)
global_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  bf16* __restrict__ dk, bf16* __restrict__ dv, int s, int n_heads,
                  float scale) {
  __shared__ __align__(128) bf16 s_k[BM * LDK], s_v[BM * LDK], s_q[BM * LDK], s_do[BM * LDK];
  extern __shared__ __align__(128) unsigned char smem[];
  float* s_pt = reinterpret_cast<float*>(smem);
  float* s_dst = s_pt + WARPS * STRIP * LDF;
  __shared__ float s_lse[BM], s_delta[BM];

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int k0 = blockIdx.x * BM;
  const int kvalid = s - k0 < BM ? s - k0 : BM;
  const long c = static_cast<long>(n_heads) * E;
  const long img = static_cast<long>(blockIdx.z) * s * c + blockIdx.y * E;
  const long lrow = (static_cast<long>(blockIdx.z) * n_heads + blockIdx.y) * s;

  load_head_rows(s_k, k + img + k0 * c, c, BM, kvalid);
  load_head_rows(s_v, v + img + k0 * c, c, BM, kvalid);
  float* pt = s_pt + warp * STRIP * LDF;
  float* dst = s_dst + warp * STRIP * LDF;
  FragC acc_dk[4], acc_dv[4];
  zero(acc_dk);
  zero(acc_dv);
  for (int q0 = 0; q0 < s; q0 += BM) {
    const int qvalid = s - q0 < BM ? s - q0 : BM;
    load_head_rows(s_q, q + img + q0 * c, c, BM, qvalid);
    load_head_rows(s_do, dout + img + q0 * c, c, BM, qvalid);
    if (threadIdx.x < BM) {
      const bool ok = threadIdx.x < qvalid;
      s_lse[threadIdx.x] = ok ? lse[lrow + q0 + threadIdx.x] : 0.f;
      s_delta[threadIdx.x] = ok ? delta[lrow + q0 + threadIdx.x] : 0.f;
    }
    __syncthreads();
    {
      FragC acc_s[4], acc_dp[4];
      zero(acc_s);
      zero(acc_dp);
#pragma unroll
      for (int kk = 0; kk < E; kk += 16) {
        FragA fk, fv;
        wmma::load_matrix_sync(fk, s_k + warp * STRIP * LDK + kk, LDK);
        wmma::load_matrix_sync(fv, s_v + warp * STRIP * LDK + kk, LDK);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          FragBt fb;
          wmma::load_matrix_sync(fb, s_q + 16 * j * LDK + kk, LDK);
          wmma::mma_sync(acc_s[j], fk, fb, acc_s[j]);
          wmma::load_matrix_sync(fb, s_do + 16 * j * LDK + kk, LDK);
          wmma::mma_sync(acc_dp[j], fv, fb, acc_dp[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::store_matrix_sync(pt + 16 * j, acc_s[j], LDF, wmma::mem_row_major);
        wmma::store_matrix_sync(dst + 16 * j, acc_dp[j], LDF, wmma::mem_row_major);
      }
    }
    __syncwarp();
    // rows: this warp's 16 keys; columns: the chunk's 64 queries
    for (int i = lane; i < STRIP * BM; i += 32) {
      const int m = i / BM, j = i % BM;
      const bool ok = k0 + warp * STRIP + m < s && j < qvalid;
      const float p = ok ? __expf(pt[m * LDF + j] * scale - s_lse[j]) : 0.f;
      pt[m * LDF + j] = p;
      dst[m * LDF + j] = p * (dst[m * LDF + j] - s_delta[j]);
    }
    __syncwarp();
    strip_to_bf16(pt, LDF, BM);
    strip_to_bf16(dst, LDF, BM);
    mma_strip(reinterpret_cast<const bf16*>(pt), 2 * LDF, s_do, LDK, BM, acc_dv);
    mma_strip(reinterpret_cast<const bf16*>(dst), 2 * LDF, s_q, LDK, BM, acc_dk);
    __syncthreads();  // before the next chunk overwrites q and dout
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    for (int t = 0; t < acc_dk[j].num_elements; ++t) acc_dk[j].x[t] *= scale;
  const int r0 = warp * STRIP;
  store_strip(pt, LDF, acc_dk);
  write_strip(pt, LDF, dk + img + (k0 + r0) * c, c, nullptr, kvalid - r0);
  store_strip(pt, LDF, acc_dv);
  write_strip(pt, LDF, dv + img + (k0 + r0) * c, c, nullptr, kvalid - r0);
}

}  // namespace
}  // namespace kdt

using namespace kdt;

// q, k, v, out (b, s, heads * 64) bf16; lse (b, heads, s) f32, or null when
// no backward follows. Needs s % 16 == 0 and s <= 512.
extern "C" int kdt_global_packed(const void* q, const void* k, const void* v, void* out,
                                 void* lse, int b, int s, int n_heads, float scale,
                                 void* stream) {
  const size_t smem =
      (BM + s) * LDK * sizeof(bf16) + WARPS * STRIP * logit_stride(s) * sizeof(float);
  const cudaError_t attr = allow_smem(global_packed_kernel, smem);
  const dim3 grid((s + BM - 1) / BM, n_heads, b);
  global_packed_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), static_cast<float*>(lse), s, n_heads, scale);
  return launch_status(attr);
}

// K9: q, k, v, out, dout (b, s, heads * 64) bf16; lse (b, heads, s) f32
// from the forward. Writes dq, dk, dv (b, s, heads * 64) bf16; delta
// (b, heads, s) f32 is scratch. Needs s % 16 == 0 and s <= 512.
extern "C" int kdt_global_packed_bwd(const void* q, const void* k, const void* v, const void* out,
                                     const void* dout, const void* lse, void* delta, void* dq,
                                     void* dk, void* dv, int b, int s, int n_heads, float scale,
                                     void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem_dq = (2 * BM + s) * LDK * sizeof(bf16) +
                         WARPS * STRIP * (logit_stride(s) + 16) * sizeof(float);
  cudaError_t attr = allow_smem(global_dq_kernel, smem_dq);
  const dim3 grid((s + BM - 1) / BM, n_heads, b);
  global_dq_kernel<<<grid, THREADS, smem_dq, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(delta), static_cast<bf16*>(dq), s,
      n_heads, scale);
  const int status = launch_status(attr);
  if (status != 0) return status;
  const size_t smem_dkv = 2 * WARPS * STRIP * LDF * sizeof(float);
  attr = allow_smem(global_dkv_kernel, smem_dkv);
  global_dkv_kernel<<<grid, THREADS, smem_dkv, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), s,
      n_heads, scale);
  return launch_status(attr);
}

KDT_DEFINE_ERROR_STRING
