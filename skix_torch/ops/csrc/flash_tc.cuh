// The tensor-core pieces of the attention kernels: shared-memory matrix
// descriptors, the wgmma instructions, TF32 rounding and the hi/lo split,
// cp.async, and the forward core of K1 (flash_fwd.cu) and K2
// (flash_fwd_single_tile.cu). The backward core (flash_bwd_tc.cuh) builds
// on the same pieces.
//
// Operand layout. Every operand a wgmma reads from shared memory is stored
// K-major without swizzle: "core matrices" of 8 rows x 16 bytes (4 f32 or
// 8 bf16 along the reduction axis K), each 128 contiguous bytes. Core
// matrices adjacent along K are 128 bytes apart (the descriptor's leading
// byte offset, LBO); 8-row groups are one whole row of core matrices apart
// (the stride byte offset, SBO = 8 * row bytes). One k-step of a wgmma
// (k8 for tf32, k16 for bf16: 32 bytes) reads two core matrices along K,
// so the next k-step starts 256 bytes further. tf32 wgmma takes K-major
// operands only; bf16 also takes an MN-major B (mnmajor_off).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace skix {

// byte offset of element (r, c) of a K-major operand with C elements of E
// bytes along K
template <int C, int E> __device__ __forceinline__ int kmajor_off(int r, int c) {
  return (r >> 3) * (C * E * 8) + ((c * E) >> 4) * 128 + (r & 7) * 16 + ((c * E) & 15);
}

// byte offset of element (n, k) of an MN-major bf16 B operand with N rows
// along MN: core matrices of 8 k-rows x 8 n-elements, 128 bytes apart along
// N (the descriptor's SBO), N * 16 bytes apart along K (its LBO)
template <int N> __device__ __forceinline__ int mnmajor_off(int n, int k) {
  return (n >> 3) * 128 + (k >> 3) * (N * 16) + (k & 7) * 16 + (n & 7) * 2;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// a wgmma shared-memory matrix descriptor, no swizzle (layout type 0)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// generic-proxy stores to shared memory made visible to wgmma's async proxy
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keep the compiler from moving accesses of registers an async wgmma owns
template <int R> __device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// x rounded to tf32, round to nearest with ties away (the low 13 bits 0)
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(u) : "f"(x));
  return u;
}
// split-TF32: x = hi + lo + O(2^-22 |x|), hi = tf32(x), lo = tf32(x - hi)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(x);
  lo = tf32_bits(x - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);  // .x = a: the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
// the same, 16 zero bytes where !valid (src is then not read)
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// wgmma m64nNk8 (tf32) and m64nNk16 (bf16), f32 accumulators d, at the
// widths the cores use (S: N = 32 or 64 rows; P.V and the gradients:
// N = D); ss: A and B from shared memory by descriptor; rs: A from
// registers (the fragment of the accumulator layout). acc 0 overwrites d,
// 1 adds to it. TB 1: B is MN-major (bf16 only).
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile("{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile("{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}
template <int TB>
__device__ __forceinline__ void wgmma_bf16_ss(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile("{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, %19;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc), "n"(TB));
}
template <int TB>
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile("{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
}

__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile("{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile("{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}
template <int TB>
__device__ __forceinline__ void wgmma_bf16_ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile("{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc), "n"(TB));
}
template <int TB>
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile("{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
}

__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile("{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}
template <int TB>
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int acc) {
  asm volatile("{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
}


// ---------------------------------------------------------------------------
// The forward core of K1 (flash_fwd.cu) and K2 (flash_fwd_single_tile.cu)
// ---------------------------------------------------------------------------

// K2's compile-time variants, the probes of window_probe.py. Every
// production launch of K1 and K2 is V_FULL.
enum Variant : int {
  V_FULL = 0,    // the production chain
  V_FIXEDMAX,    // the fixed bound compiled in: no row max, no rescaling
  V_NOSOFTMAX,   // p = s: no max, exp2, row sum or division
  V_SCORESONLY,  // the score products only; the first key tile's D columns stored
  V_PBF16,       // f32 inputs: p and v rounded to bf16, P.V one bf16 wgmma
  V_VMN,         // bf16: V read MN-major from its row-major tile (no transpose)
  V_HEADS2,      // two heads per CTA, one after the other
};

struct FwdParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;        // (B, H, Sq) f32, contiguous, or null
  int H, Sq, Sk;     // q and k come roped from the rope pass (rope_rows_kernel)
  long long sqb, sqh, sqs, skb, skh, sks, svb, svh, svs, sob, soh, sos;
  float scale_log2;  // sm_scale * log2(e), rounded to f32
  int fixed;         // fixed-max mode
  float max_log2;    // fixed_max * log2(e), rounded to f32
};

// The CTA's tiles and its shared memory (bytes). NWG warpgroups of 128
// threads own 64 q rows each; key tiles of BK rows. Q, K and the
// transposed V are held as wgmma operands (f32: a tf32 hi and a lo copy
// each); the raw K and V tiles arrive by cp.async in a ring of NS stages,
// rows padded by 16 bytes so that the staging reads are conflict-free.
template <typename T, int D, int VAR> struct Tiles {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int NWG = (F32 && D == 128) ? 1 : 2;
  static constexpr int BK = (F32 && D == 128) ? 32 : 64;
  static constexpr int BQ = 64 * NWG, NT = 128 * NWG;
  static constexpr bool PV_TF32 = F32 && VAR != V_PBF16;
  static constexpr int QE = F32 ? 4 : 2;  // bytes of a Q or K operand element
  static constexpr int VE = PV_TF32 ? 4 : 2;
  static constexpr int NQ = F32 ? 2 : 1;  // operand copies: hi (and lo)
  static constexpr int NV = PV_TF32 ? 2 : 1;
  static constexpr int NS = VAR == V_VMN ? 3 : 2;  // V_VMN: P.V reads the raw stage
  static constexpr int Q_BYTES = BQ * D * QE;
  static constexpr int K_BYTES = BK * D * QE;
  static constexpr int V_BYTES = BK * D * VE;
  static constexpr int RAW_LD = D * (int)sizeof(T) + 16;
  static constexpr int RAW_BYTES = BK * RAW_LD;
  static constexpr int K_OFF = NQ * Q_BYTES;
  static constexpr int V_OFF = K_OFF + NQ * K_BYTES;
  static constexpr int RAW_OFF = V_OFF + NV * V_BYTES;
  static constexpr int SMEM = RAW_OFF + NS * 2 * RAW_BYTES;  // [stage][k | v]
};

// Whether the wgmma core takes these q, k, v: 16-byte aligned bases and
// (batch, head, row) strides, as its 16-byte loads and cp.async need.
inline bool operands_aligned(const FwdParams& p, int item) {
  const void* ptrs[3] = {p.q, p.k, p.v};
  const long long strides[9] = {p.sqb, p.sqh, p.sqs, p.skb, p.skh, p.sks, p.svb, p.svh, p.svs};
  for (const void* x : ptrs)
    if (reinterpret_cast<uintptr_t>(x) % 16 != 0) return false;
  for (long long st : strides)
    if ((st * item) % 16 != 0) return false;
  return true;
}

// CH = 16 / sizeof(T) consecutive elements of a row, as f32
template <typename T, int CH>
__device__ __forceinline__ void load_chunk(float (&x)[CH], const T* __restrict__ src) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  if constexpr (sizeof(T) == 4) {
    x[0] = __uint_as_float(u.x), x[1] = __uint_as_float(u.y);
    x[2] = __uint_as_float(u.z), x[3] = __uint_as_float(u.w);
  } else {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
      x[2 * i] = __low2float(v);
      x[2 * i + 1] = __high2float(v);
    }
  }
}

// Store CH values, each already a value of T, as one 16-byte operand chunk:
// bf16; or tf32 hi at dst and lo at dst + lo_off (split_tf32).
template <typename T, int CH>
__device__ __forceinline__ void store_operand(unsigned char* dst, int lo_off, const float (&x)[CH]) {
  if constexpr (sizeof(T) == 4) {
    uint32_t h[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(x[i], h[i], l[i]);
    *reinterpret_cast<uint4*>(dst) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(dst + lo_off) = make_uint4(l[0], l[1], l[2], l[3]);
  } else {
    *reinterpret_cast<uint4*>(dst) = make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]),
                                                pack_bf16(x[4], x[5]), pack_bf16(x[6], x[7]));
  }
}

// x = x*cos + rot(x)*sin in f32 for elements c0..c0+CH-1 of one row, the
// rope of K1's and K2's rope pass (rope_rows_kernel); the _rn intrinsics
// keep nvcc from contracting it into FMAs, so the values equal the plain
// version's. cos, sin and rotate-half's partners are read as 16-byte
// vectors (the partners of a chunk are one chunk D/4 away: CH divides
// D/4); TB true, the code table of rot_at, read per element.
template <typename T, int D, bool TB, int CH>
__device__ __forceinline__ void rope_chunk(float (&x)[CH], const T* __restrict__ row, int c0,
                                           const float* __restrict__ cos_row,
                                           const float* __restrict__ sin_row,
                                           const int* __restrict__ rot) {
  static_assert((D / 4) % CH == 0, "a chunk lies in one quarter of the row");
  float cs[CH], sn[CH], pr[CH];
#pragma unroll
  for (int i = 0; i < CH; i += 4) {
    load_chunk<float, 4>(*reinterpret_cast<float(*)[4]>(cs + i), cos_row + c0 + i);
    load_chunk<float, 4>(*reinterpret_cast<float(*)[4]>(sn + i), sin_row + c0 + i);
  }
  if constexpr (!TB) {
    constexpr int Q4 = D / 4;
    const bool lo = (c0 % (D / 2)) < Q4;
    load_chunk<T, CH>(pr, row + (lo ? c0 + Q4 : c0 - Q4));
#pragma unroll
    for (int i = 0; i < CH; ++i) pr[i] = lo ? -pr[i] : pr[i];
  } else {
#pragma unroll
    for (int i = 0; i < CH; ++i) pr[i] = rot_at<D, TB>(row, rot, c0 + i);
  }
#pragma unroll
  for (int i = 0; i < CH; ++i) x[i] = __fadd_rn(__fmul_rn(x[i], cs[i]), __fmul_rn(pr[i], sn[i]));
}

// Stage elements c0..c0+CH-1 of one q or k row as a wgmma operand chunk:
// with mul_on times mul (q: sm_scale*log2e) and rounded to T, as the TPU
// kernel casts the scaled tile back to the input type. `row` is the row in
// device or shared memory, already roped by the rope pass.
template <typename T, int CH>
__device__ __forceinline__ void stage_chunk(unsigned char* dst, int lo_off, const T* __restrict__ row,
                                            int c0, bool mul_on, float mul) {
  float x[CH];
  load_chunk<T, CH>(x, row + c0);
  if (mul_on) {
#pragma unroll
    for (int i = 0; i < CH; ++i) x[i] = round_to<T>(__fmul_rn(x[i], mul));
  }
  store_operand<T, CH>(dst, lo_off, x);
}

template <typename T, int CH> __device__ __forceinline__ void zero_chunk(unsigned char* dst, int lo_off) {
  float x[CH];
#pragma unroll
  for (int i = 0; i < CH; ++i) x[i] = 0.f;
  store_operand<T, CH>(dst, lo_off, x);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One CTA's work: q rows [qt * BQ, +BQ) of head h, batch row b, over all Sk
// keys. Online softmax in base 2 over key tiles of BK: S = Q K^T by wgmma
// from shared memory into f32 registers, the row max and row sum on the
// accumulator fragment (thread: rows g and g + 8 of its warp's 16, columns
// 8j + 2t, +1), p rounded to v's type and fed back as wgmma's register A
// operand for P V, whose tile sums are added to the f32 output rows in
// registers. f32: split-TF32, three tf32 wgmmas per product (lo*hi + hi*lo
// + hi*hi, the dropped lo*lo is below 2^-22 relative). The
// tf32 A fragment holds columns t and t + 4 of each 8-key step where the
// accumulator holds 2t and 2t + 1, so the transposed V stores each 8-key
// group in the order 0, 2, 4, 6, 1, 3, 5, 7 and the fragment is taken as is.
//
// Per key tile, with one tile of cp.async lookahead: the V tile is staged
// (transposed, split) while S runs, the next K tile (split) while P.V
// runs. q and k come roped and rounded from the rope pass
// (rope_rows_kernel), once per call: roping each K tile in every CTA that
// reads it cost K2 a quarter of its time in float32 and half in bfloat16
// (the norope probe, PERF.md).
template <typename T, int D, int VAR>
__device__ __forceinline__ void attend(const FwdParams& p, int qt, int h, int b,
                                       unsigned char* smem) {
  using L = Tiles<T, D, VAR>;
  constexpr int BK = L::BK, BQ = L::BQ, NT = L::NT, NS = L::NS, CH = 16 / (int)sizeof(T);
  constexpr int CPR = D / CH;  // 16-byte chunks per q, k or v row
  constexpr bool SOFTMAX = VAR != V_NOSOFTMAX && VAR != V_SCORESONLY;
  constexpr bool HAS_V = VAR != V_SCORESONLY;
  static_assert(VAR != V_SCORESONLY || BK == D, "scoresonly stores one key tile as the output");
  static_assert(VAR != V_VMN || !L::F32, "tf32 wgmma takes K-major operands only");
  static_assert(VAR != V_PBF16 || L::F32, "p_bf16 is a variant of the f32 path");
  const bool fixed = VAR == V_FIXEDMAX || p.fixed != 0;

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32;
  const int lane = tid % 32, g = lane / 4, t = lane % 4;
  const int q0 = qt * BQ, Sq = p.Sq, Sk = p.Sk;
  const T* qh = static_cast<const T*>(p.q) + b * p.sqb + h * p.sqh;
  const T* kh = static_cast<const T*>(p.k) + b * p.skb + h * p.skh;
  const T* vh = static_cast<const T*>(p.v) + b * p.svb + h * p.svh;
  T* oh = static_cast<T*>(p.o) + b * p.sob + h * p.soh;
  unsigned char* sQ = smem;
  unsigned char* sK = smem + L::K_OFF;
  unsigned char* sV = smem + L::V_OFF;
  unsigned char* raw = smem + L::RAW_OFF;
  const int nt = (Sk + BK - 1) / BK;

  // cp.async of key tile j into raw stage j % NS (V_VMN: V in the MN-major
  // operand layout, its rows past Sk zeroed, since P.V reads it directly)
  auto issue = [&](int j) {
    unsigned char* rk = raw + (j % NS) * 2 * L::RAW_BYTES;
    unsigned char* rv = rk + L::RAW_BYTES;
    const int k0 = j * BK, kr = min(BK, Sk - k0);
    for (int idx = threadIdx.x; idx < BK * CPR; idx += NT) {
      const int r = idx / CPR, c = idx % CPR;
      const long long row = k0 + min(r, kr - 1);
      if (r < kr) cp_async16(rk + r * L::RAW_LD + c * 16, kh + row * p.sks + c * CH);
      if constexpr (VAR == V_VMN)
        cp_async16_zfill(rv + mnmajor_off<D>(c * 8, r), vh + row * p.svs + c * CH, r < kr);
      else if (HAS_V && r < kr)
        cp_async16(rv + r * L::RAW_LD + c * 16, vh + row * p.svs + c * CH);
    }
    cp_async_commit();
  };

  issue(0);
  // Q: times sm_scale*log2e, rounded to T, as the A operand
  for (int idx = threadIdx.x; idx < BQ * CPR; idx += NT) {
    const int r = (idx & 7) + 8 * (idx / (8 * CPR)), c = (idx / 8) % CPR;
    unsigned char* dst = sQ + kmajor_off<D, L::QE>(r, c * CH);
    const int row = q0 + r;
    if (row < Sq)
      stage_chunk<T, CH>(dst, L::Q_BYTES, qh + (long long)row * p.sqs, c * CH, true,
                         p.scale_log2);
    else
      zero_chunk<T, CH>(dst, L::Q_BYTES);
  }

  // The tensor cores add into their f32 accumulator with truncation, an
  // error of up to one unit in the last place of the accumulator's
  // magnitude per wgmma. So no accumulator is summed over long: o, the
  // output rows, is summed in registers with round-to-nearest adds of ot,
  // one key tile's P.V; and the score tile's f32 hi*hi pass is split over
  // two accumulators, s (the corrections and the even k-steps) and e (the
  // odd ones), added in registers: at |s| ~ 50 this halves the error
  // against the exact scores. s then holds p.
  float o[D / 2], ot[D / 2], s[BK / 2], e[BK / 2], m[2], l[2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = ot[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = e[i] = 0.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = fixed ? p.max_log2 : -INFINITY;
    l[r] = 0.f;
  }
  // p as wgmma A fragments: tf32 hi/lo per 8-key step, or bf16 per 16
  constexpr int PSTEPS = L::PV_TF32 ? BK / 8 : BK / 16;
  uint32_t pf[PSTEPS][4], pl[L::PV_TF32 ? PSTEPS : 1][4];
#pragma unroll
  for (int k = 0; k < PSTEPS; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) pf[k][i] = pl[k % (L::PV_TF32 ? PSTEPS : 1)][i] = 0u;

  const uint32_t qa = smem_addr(sQ) + wg * (64 * D * L::QE), ka = smem_addr(sK),
                 va = smem_addr(sV);
  constexpr uint32_t SBO_QK = D * L::QE * 8, SBO_V = BK * L::VE * 8;

  // K of tile j as the B operand of S, from raw stage j % NS
  auto stage_k = [&](int j) {
    const unsigned char* rk = raw + (j % NS) * 2 * L::RAW_BYTES;
    const int k0 = j * BK, kr = min(BK, Sk - k0);
    for (int idx = threadIdx.x; idx < BK * CPR; idx += NT) {
      const int r = (idx & 7) + 8 * (idx / (8 * CPR)), c = (idx / 8) % CPR;
      unsigned char* dst = sK + kmajor_off<D, L::QE>(r, c * CH);
      if (r < kr)
        stage_chunk<T, CH>(dst, L::K_BYTES, reinterpret_cast<const T*>(rk + r * L::RAW_LD),
                           c * CH, false, 1.f);
      else
        zero_chunk<T, CH>(dst, L::K_BYTES);
    }
    fence_async_smem();
  };

  cp_async_wait<0>();
  __syncthreads();  // tile 0 landed
  if (nt > 1) issue(1);
  stage_k(0);
  __syncthreads();  // sK holds tile 0

  // Per tile j: S = Q K^T while V_j is staged; the softmax; P.V while
  // K_{j+1} is staged; cp.async one tile ahead of that. Each wgmma group
  // is waited inside its iteration: a group left in flight across the
  // loop's back edge makes ptxas serialize every wgmma of the kernel.
  for (int j = 0; j < nt; ++j) {
    const int k0 = j * BK, kr = min(BK, Sk - k0);
    unsigned char* rv = raw + (j % NS) * 2 * L::RAW_BYTES + L::RAW_BYTES;

    // S = Q K^T (base-2 logits)
    fence_regs(s);
    fence_regs(e);
    wgmma_fence();
    if constexpr (L::F32) {
#pragma unroll
      for (int k = 0; k < D / 8; ++k)
        wgmma_tf32_ss(s, smem_desc(qa + L::Q_BYTES + 256 * k, 128, SBO_QK),
                      smem_desc(ka + 256 * k, 128, SBO_QK), k > 0);
#pragma unroll
      for (int k = 0; k < D / 8; ++k)
        wgmma_tf32_ss(s, smem_desc(qa + 256 * k, 128, SBO_QK),
                      smem_desc(ka + L::K_BYTES + 256 * k, 128, SBO_QK), 1);
#pragma unroll
      for (int k = 0; k < D / 8; ++k) {
        if (k % 2 == 0)
          wgmma_tf32_ss(s, smem_desc(qa + 256 * k, 128, SBO_QK),
                        smem_desc(ka + 256 * k, 128, SBO_QK), 1);
        else
          wgmma_tf32_ss(e, smem_desc(qa + 256 * k, 128, SBO_QK),
                        smem_desc(ka + 256 * k, 128, SBO_QK), k > 1);
      }
    } else {
#pragma unroll
      for (int k = 0; k < D / 16; ++k)
        wgmma_bf16_ss<0>(s, smem_desc(qa + 256 * k, 128, SBO_QK),
                         smem_desc(ka + 256 * k, 128, SBO_QK), k > 0);
    }
    wgmma_commit();

    // V, transposed, as the B operand of P.V, while S runs
    if constexpr (HAS_V && L::PV_TF32) {
      for (int idx = threadIdx.x; idx < D * (BK / 4); idx += NT) {
        const int d = idx % D, qc = idx / D, j8 = qc >> 1, odd = qc & 1;
        float x[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 8 * j8 + 2 * i + odd;
          x[i] = r < kr ? to_f32(reinterpret_cast<const T*>(rv + r * L::RAW_LD)[d]) : 0.f;
        }
        store_operand<float, 4>(sV + kmajor_off<BK, 4>(d, 8 * j8 + 4 * odd), L::V_BYTES, x);
      }
    } else if constexpr (HAS_V && VAR != V_VMN) {
      for (int idx = threadIdx.x; idx < D * (BK / 8); idx += NT) {
        const int d = idx % D, j8 = idx / D;
        float x[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = 8 * j8 + i;
          x[i] = r < kr ? to_f32(reinterpret_cast<const T*>(rv + r * L::RAW_LD)[d]) : 0.f;
        }
        store_operand<__nv_bfloat16, 8>(sV + kmajor_off<BK, 2>(d, 8 * j8), 0, x);
      }
    }
    fence_async_smem();
    wgmma_wait<0>();
    fence_regs(s);
    if constexpr (L::F32) {
      fence_regs(e);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] += e[i];
    }

    if constexpr (VAR == V_SCORESONLY) {
      if (j == 0) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) o[i] = s[i];
      }
    } else {
      if constexpr (SOFTMAX) {
        float alpha[2] = {1.f, 1.f};
        if (!fixed) {
          float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
          for (int i = 0; i < BK / 2; ++i)
            if (8 * (i / 4) + 2 * t + (i & 1) < kr) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float mn = fmaxf(m[r], quad_max(mx[r]));
            alpha[r] = exp2f(m[r] - mn);
            m[r] = mn;
          }
        }
        float rs[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int r = (i >> 1) & 1;
          const float x = 8 * (i / 4) + 2 * t + (i & 1) < kr ? exp2f(s[i] - m[r]) : 0.f;
          s[i] = x;
          rs[r] += x;
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + rs[r];
        if (!fixed) {
#pragma unroll
          for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
        }
      }
      // p rounded to v's type, as A fragments
      if constexpr (L::PV_TF32) {
#pragma unroll
        for (int k = 0; k < PSTEPS; ++k) {
          split_tf32(s[4 * k + 0], pf[k][0], pl[k][0]);  // (g,     key 8k + 2t)
          split_tf32(s[4 * k + 2], pf[k][1], pl[k][1]);  // (g + 8, key 8k + 2t)
          split_tf32(s[4 * k + 1], pf[k][2], pl[k][2]);  // (g,     key 8k + 2t + 1)
          split_tf32(s[4 * k + 3], pf[k][3], pl[k][3]);  // (g + 8, key 8k + 2t + 1)
        }
      } else {
#pragma unroll
        for (int k = 0; k < PSTEPS; ++k)
#pragma unroll
          for (int i = 0; i < 4; ++i) pf[k][i] = pack_bf16(s[8 * k + 2 * i], s[8 * k + 2 * i + 1]);
      }
    }
    __syncthreads();  // sV staged; every S of tile j is done: sK is free

    if constexpr (HAS_V) {
      // ot = P V
      fence_regs(ot);
      wgmma_fence();
      if constexpr (L::PV_TF32) {
#pragma unroll
        for (int k = 0; k < PSTEPS; ++k)
          wgmma_tf32_rs(ot, pl[k], smem_desc(va + 256 * k, 128, SBO_V), k > 0);
#pragma unroll
        for (int k = 0; k < PSTEPS; ++k)
          wgmma_tf32_rs(ot, pf[k], smem_desc(va + L::V_BYTES + 256 * k, 128, SBO_V), 1);
#pragma unroll
        for (int k = 0; k < PSTEPS; ++k)
          wgmma_tf32_rs(ot, pf[k], smem_desc(va + 256 * k, 128, SBO_V), 1);
      } else if constexpr (VAR == V_VMN) {
        const uint32_t rva = smem_addr(rv);
#pragma unroll
        for (int k = 0; k < PSTEPS; ++k)
          wgmma_bf16_rs<1>(ot, pf[k], smem_desc(rva + k * 2 * D * 16, D * 16, 128), k > 0);
      } else {
#pragma unroll
        for (int k = 0; k < PSTEPS; ++k)
          wgmma_bf16_rs<0>(ot, pf[k], smem_desc(va + 256 * k, 128, SBO_V), k > 0);
      }
      wgmma_commit();
    }
    if (j + 1 < nt) {
      cp_async_wait<0>();
      __syncthreads();  // tile j + 1 landed
      if (j + 2 < nt) issue(j + 2);
      stage_k(j + 1);
    }
    wgmma_wait<0>();  // this warpgroup's P.V of tile j
    if constexpr (HAS_V) {
      fence_regs(ot);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] += ot[i];
    }
    __syncthreads();  // sK holds tile j + 1; every P.V of tile j is done: sV is free
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 64 * wg + 16 * warp + g + 8 * r;
    const float lt = quad_sum(l[r]);
    if (row >= Sq) continue;
    const float div = (SOFTMAX && lt != 0.f) ? lt : 1.f;
    T* orow = oh + (long long)row * p.sos;
#pragma unroll
    for (int k = 0; k < D / 8; ++k) {
      const float a = o[4 * k + 2 * r] / div, c = o[4 * k + 2 * r + 1] / div;
      const int col = 8 * k + 2 * t;
      if constexpr (sizeof(T) == 4)
        *reinterpret_cast<float2*>(orow + col) = make_float2(a, c);
      else
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(a, c);
    }
    if (SOFTMAX && p.lse != nullptr && t == 0)
      p.lse[((long long)b * p.H + h) * Sq + row] = lt > 0.f ? m[r] + log2f(lt) : 0.f;
  }
}

// K1's and K2's rope pass: out = x*cos + rot(x)*sin in f32 (rope_chunk),
// times mul where mul_on (q: sm_scale*log2e), rounded to T: the roundings
// the TPU kernels apply to a roped q and k. x: (B, H, S, D) with element
// strides (b, h, s), 16-byte aligned; out: contiguous (B, H, S, D). One
// thread per 16-byte chunk; grid (chunks / 256, H, B). Bound by bytes.
template <typename T, int D, bool TB>
__global__ void __launch_bounds__(256) rope_rows_kernel(const T* __restrict__ x, T* __restrict__ out,
                                                        const float* __restrict__ cos,
                                                        const float* __restrict__ sin,
                                                        const int* __restrict__ rot, int H, int S,
                                                        long long sb, long long sh, long long ss,
                                                        int mul_on, float mul) {
  constexpr int CH = 16 / (int)sizeof(T), CPR = D / CH;
  const long long idx = (long long)blockIdx.x * 256 + threadIdx.x;
  if (idx >= (long long)S * CPR) return;
  const int srow = (int)(idx / CPR), c0 = (int)(idx % CPR) * CH, h = blockIdx.y, b = blockIdx.z;
  const T* row = x + b * sb + h * sh + srow * ss;
  float v[CH];
  load_chunk<T, CH>(v, row + c0);
  rope_chunk<T, D, TB, CH>(v, row, c0, cos + (long long)srow * D, sin + (long long)srow * D, rot);
#pragma unroll
  for (int i = 0; i < CH; ++i) v[i] = round_to<T>(mul_on ? __fmul_rn(v[i], mul) : v[i]);
  T* dst = out + (((long long)b * H + h) * S + srow) * D + c0;
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<uint4*>(dst) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                                pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
  }
}

}  // namespace skix
