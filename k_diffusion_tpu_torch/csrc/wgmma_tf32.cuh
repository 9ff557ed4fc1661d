// The TF32 wgmma products of the float32 backwards, shared by the GEMM core
// of K6-f32 and K10-f32 (gemm_tf32_wg.cuh) and the attention backward of
// K14-f32, K9-f32, K7-f32 and K12-f32 (attn_tf32_bwd.cuh):
// - a .tf32 operand is the f32 bit pattern with its low 13 bits ignored,
//   so every operand is rounded to nearest (cvt.rna) first: to_tf32 where
//   an A fragment is read into registers, round_tf32 where a value is
//   written for wgmma to read as B;
// - B comes from shared memory K-major only: rows of 32 f32 depths (128
//   bytes, one 128-byte swizzle atom), 8-row groups 1024 bytes apart
//   (desc); k8 slice kk of a row is the descriptor's start 32 kk bytes on;
// - A comes from registers (the RS form), whose fragment is mma.sync
//   m16n8k8's: a thread holds rows g and g + 8 of its warp's 16 at depths
//   t and t + 4 of a k8 slice (g = lane / 4, t = lane % 4), so an A tile
//   may lie either way in shared memory;
// - the m64nN f32 accumulator is mma.sync's m16n8 C layout repeated along
//   N: element 4 i + 2 h + e of a thread lies at row 16 w + g + 8 h (w the
//   warp of the warpgroup) and column 8 i + 2 t + e.
#pragma once

#include <cstdint>

#include "wgmma.cuh"

namespace kdt {
namespace tw {

using wg::smem_u32;


__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// x rounded to TF32 (10 mantissa bits, to nearest), as an f32
__device__ __forceinline__ float round_tf32(float x) { return __uint_as_float(to_tf32(x)); }

// The descriptor of a K-major B tile at `tile` (1024-aligned): rows of 128
// bytes in the 128-byte swizzle, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc(const void* tile) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// d (64 x N, f32) = or += A (64 x 8, TF32 in registers) B (8 x N), B K-major
// in shared memory at descriptor b; acc 0 overwrites d.
template <int N>
__device__ __forceinline__ void mma(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                    int acc);

template <>
__device__ __forceinline__ void mma<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                        int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void mma<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}


}  // namespace tw
}  // namespace kdt
