// The tensor-core attention backward: the two CTA roles of flash_bwd.cu
// (K3 and K4, one launch each) and flash_bwd_single_tile.cu (K5, one
// launch whose CTAs take either role), on the wgmma pieces of flash_tc.cuh.
//
// What they compute is the TPU kernels' (skix/ops/attention.py:558-751),
// with their roundings:
//   q_r = rope(q) in f32 rounded to T (q itself without rope), k_r likewise;
//   q_s = q_r * (sm_scale*log2e) in f32, rounded to T;
//   s = q_s.k_r in f32 (base-2 logits), p = exp2(s - lse), 0 past Sq or Sk;
//   dV = round_T(p)^T.dO;  dP = dO.V^T;  dS = round_T(p * (dP - di));
//   dK = sm_scale * dS^T.q_r;  dQ = sm_scale * dS.k_r;
// q_r and k_r come from the forward's rope pass (rope_rows_kernel), run by
// the wrapper once per backward call, so the core never ropes; q_s is
// formed where q_r is staged. With rope, dK and dQ are un-rotated at the
// store as x*cos - rot(x)*sin, rot the style's signed permutation (rot_at),
// whose transpose is its negative for every style; that is the rope's true
// gradient for a pair-symmetric sin table (sin[s, j] == sin[s, partner(j)]),
// which every table builder of the port makes.
//
// Roles. One warpgroup (128 threads) per CTA owns 64 rows and streams the
// other axis in tiles of BN rows (32 at D = 128 and in float32 at D = 64,
// else 64):
//   dkv: 64 keys. K and V stay as wgmma A operands (in float32 up to
//        D = 64 K's hi copy as register fragments). Per q tile:
//        S^T = K.Q_s^T and dP^T = V.dO^T with the keys as wgmma's M,
//        so p^T and dS^T land in the accumulator fragment and feed
//        dV += P^T.dO and dK += dS^T.Q_r as register-A (rs) wgmmas: no
//        trip through shared memory. Their B operands are dO and q_r
//        staged a second time, transposed, with the q rows along K.
//   dq:  64 q rows. Q_s and dO stay as A operands (in float32 up to
//        D = 64 their hi copies as register fragments, so that two of each
//        product's three passes read only B from shared memory); per
//        key tile S = Q_s.K^T and dP = dO.V^T, dS in registers, and
//        dQ += dS.K_r as an rs wgmma on K_r staged transposed.
// Every gradient element is written once, by one CTA: no atomics, so the
// result is deterministic.
//
// Arithmetic. float32 is split-TF32: x = hi + lo, hi = tf32_rna(x), lo =
// tf32(x - hi), each product the three tf32 wgmmas lo*hi + hi*lo + hi*hi
// (the dropped lo*lo is below 2^-22 |a||b|); bf16 one wgmma. The tensor
// cores add into their f32 accumulator with truncation, so no accumulator
// sums over long: each tile's dV, dK or dQ product goes into a fresh
// accumulator, added to the f32 total in registers (the float32 dkv role
// at D = 64 keeps dV's total in shared memory, each thread its own
// elements).
//
// Pipeline per streamed tile j (raw rows arrive by cp.async one tile
// ahead): stage the phase-1 B operands (Q_s, dO; or K_r, V) from the raw
// rows (the dQ role stages tile j + 1's while its dQ product of tile j
// runs); issue S and dP; stage the phase-2 B operands (the transposed
// copies) while they run, then prefetch tile j + 1; p and dS on the
// fragment; the rs products. Each wgmma group is waited in its iteration:
// a group in flight across the loop's back edge makes ptxas serialize
// every wgmma. Where the phase-2 operands take phase 1's memory (ALIAS:
// D = 128, and the float32 dkv role at D = 64) they are staged after S
// and dP; at D = 128 the dkv role runs its q loop twice, dV in the first
// pass and dK in the second, to stay within 255 registers.

#pragma once

#include "flash_tc.cuh"

namespace skix {

constexpr int BWD_NT = 128;   // threads per CTA: one warpgroup

struct BwdParams {
  const void* q;      // q_r: roped and rounded (q without rope)
  const void* k;      // k_r likewise
  const void* v;
  const void* dout;
  const float* lse;   // (B, H, Sq) f32, contiguous, base 2
  const float* di;    // (B, H, Sq) f32, contiguous: sum_d o*dO
  void* dq;
  void* dk;
  void* dv;
  const float* cos;   // (S, D) f32 or null: un-rotate dQ and dK at the store
  const float* sin;
  const int* rot;     // (D,) rotation codes of the rope's style; null: rotate-half
  int H, Sq, Sk;
  // (b, h, s) element strides of q, k, v, dO, dQ, dK, dV, in that order
  long long st[21];
  float sm_scale;     // sm_scale rounded to f32
  float scale_log2;   // sm_scale * log2(e) rounded to f32
};

// A role's tiles and shared memory (bytes): the two resident A operands
// (dkv: K, V; dq: Q_s, dO), the phase-1 B operands (Q_s, dO; or K_r, V),
// the phase-2 transposed B operands (dO^T, Q_r^T; or K_r^T), each as a
// tf32 hi and lo copy in f32, then the raw stage (two tensors' rows and,
// for dkv, the tile's lse and di in two slots, by tile parity, since the
// next tile's land while this tile's are read). In float32 up to D = 64
// the first RH resident operands keep their hi copy in registers only
// (dq: Q_s and dO; dkv: K, since V's as well would leave too few
// registers), the streamed tiles are 32 rows at D = 64, and the dkv role
// there stages phase 2 over phase 1 (ALIAS): a CTA then takes at most
// 115,712 bytes, so that two CTAs share an SM and each one's staging,
// softmax and waits run under the other's products.
constexpr int max3(int a, int b, int c) { return a > b ? (a > c ? a : c) : (b > c ? b : c); }

template <typename T, int D, bool DKV> struct BwdTiles {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int E = sizeof(T), NC = F32 ? 2 : 1;
  static constexpr int RH = (F32 && D <= 64) ? (DKV ? 1 : 2) : 0;
  static constexpr int BN = (D == 128 || (F32 && D == 64)) ? 32 : 64;
  static constexpr bool ALIAS = D == 128 || (F32 && DKV && D == 64);
  static constexpr int NPASS = (DKV && D == 128) ? 2 : 1;
  static constexpr int RES = 64 * D * E;   // one copy of a resident operand
  // copies in shared memory of the first and second resident operand
  static constexpr int RC0 = RH >= 1 ? 1 : NC, RC1 = RH >= 2 ? 1 : NC;
  static constexpr int OPN = BN * D * E;   // one copy of a streamed operand
  static constexpr int RAW_LD = D * E;     // raw rows, chunks swizzled (raw_off)
  static constexpr int RAW_ROWS = BN * RAW_LD;
  static constexpr int PH1_OFF = (RC0 + RC1) * RES;
  static constexpr int PH1_BYTES = 2 * NC * OPN;
  static constexpr int PH2_BYTES = (DKV ? 2 : 1) * NC * OPN;
  static constexpr int PH2_OFF = ALIAS ? PH1_OFF : PH1_OFF + PH1_BYTES;
  static constexpr int RAW_OFF =
      ALIAS ? PH1_OFF + (PH1_BYTES > PH2_BYTES ? PH1_BYTES : PH2_BYTES) : PH2_OFF + PH2_BYTES;
  // the float32 dkv role at D = 64 keeps its dV total in shared memory
  // (each thread its own elements), for registers
  static constexpr bool DV_SMEM = DKV && F32 && D == 64;
  static constexpr int DV_OFF = RAW_OFF + 2 * RAW_ROWS + (DKV ? 4 * BN * 4 : 0);
  static constexpr int SMEM_RAW = DV_OFF + (DV_SMEM ? 64 * D * 4 : 0);
  static constexpr int STAGE_LD = D + 8;   // f32 output staging, rows of the 64
  static constexpr int STAGE = 64 * STAGE_LD * 4;
  // the resident rows land in the phase area first (as raw rows); the
  // first raw tile flies with them where they fit there
  static constexpr int RES_RAW = 2 * 64 * RAW_LD;
  static constexpr bool EARLY = RES_RAW <= RAW_OFF - PH1_OFF;
  static constexpr int SMEM = max3(SMEM_RAW, STAGE, PH1_OFF + RES_RAW);
  static_assert(SMEM <= 232448, "a block's shared memory");
  static_assert(!(F32 && D <= 64) || SMEM <= 115712, "two CTAs per SM");
};

template <typename T, int D> constexpr int bwd_single_tile_smem() {
  return BwdTiles<T, D, true>::SMEM > BwdTiles<T, D, false>::SMEM ? BwdTiles<T, D, true>::SMEM
                                                                   : BwdTiles<T, D, false>::SMEM;
}

__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

template <int R> __device__ __forceinline__ void zero(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.f;
}

template <int K> __device__ __forceinline__ void fence_frags(uint32_t (&f)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(f[k][i])::"memory");
}

// Byte offset of 16-byte chunk c of row r in raw rows of D elements: the
// chunks of row r permuted by c ^ (r mod 8) (mod CPR where a row has
// fewer than 8), so that the staging reads, 8 rows at one chunk or one
// row across its chunks, fall in distinct banks without padding.
template <typename T, int D> __device__ __forceinline__ int raw_off(int r, int c) {
  constexpr int CPR = D * (int)sizeof(T) / 16, SW = CPR < 8 ? CPR : 8;
  return r * (D * (int)sizeof(T)) + ((c ^ (r & (SW - 1))) << 4);
}
template <typename T, int D>
__device__ __forceinline__ float raw_at(const unsigned char* raw, int r, int d) {
  constexpr int CH = 16 / (int)sizeof(T);
  return to_f32(*reinterpret_cast<const T*>(raw + raw_off<T, D>(r, d / CH) +
                                            (d % CH) * (int)sizeof(T)));
}

// cp.async of rows [r0, r0 + R) of one (S, D) head slice into raw rows,
// zeros past `rows` (> 0)
template <typename T, int D, int R>
__device__ __forceinline__ void issue_rows(unsigned char* dst, const T* __restrict__ src,
                                           long long stride, int r0, int rows) {
  constexpr int CH = 16 / (int)sizeof(T), CPR = D / CH;
  static_assert(R * CPR % BWD_NT == 0, "whole chunks per thread");
#pragma unroll 4  // a full unroll keeps every chunk's offsets live across the tile loop
  for (int n = 0; n < R * CPR / BWD_NT; ++n) {
    const int idx = n * BWD_NT + threadIdx.x, r = idx / CPR, c = idx % CPR;
    const long long row = r0 + min(r, rows - 1);
    cp_async16_zfill(dst + raw_off<T, D>(r, c), src + row * stride + c * CH, r < rows);
  }
}

// raw rows [0, R) as a K-major operand along D (hi at dst, lo at dst +
// lo_off; LO: the f32 lo copy alone, at dst), times mul rounded to T
// where mul_on. The loops of the staging helpers are unrolled by 4 so
// that a thread's shared memory reads are in flight together: a CTA is
// one warpgroup, one warp per scheduler, so the thread's own independent
// work hides latency where the other CTA on the SM does not. A full
// unroll spills at D = 64 in float32.
template <typename T, int D, int R, bool LO = false>
__device__ __forceinline__ void stage_kmajor(unsigned char* dst, int lo_off,
                                             const unsigned char* raw, bool mul_on, float mul) {
  constexpr int CH = 16 / (int)sizeof(T), CPR = D / CH;
  static_assert(R * CPR % BWD_NT == 0, "whole chunks per thread");
  static_assert(!LO || sizeof(T) == 4, "a lo copy is split-TF32's");
#pragma unroll 4
  for (int n = 0; n < R * CPR / BWD_NT; ++n) {
    const int idx = n * BWD_NT + threadIdx.x;
    const int r = (idx & 7) + 8 * (idx / (8 * CPR)), c = (idx / 8) % CPR;
    float x[CH];
    load_chunk<T, CH>(x, reinterpret_cast<const T*>(raw + raw_off<T, D>(r, c)));
    if (mul_on) {
#pragma unroll
      for (int i = 0; i < CH; ++i) x[i] = round_to<T>(__fmul_rn(x[i], mul));
    }
    unsigned char* out = dst + kmajor_off<D, (int)sizeof(T)>(r, c * CH);
    if constexpr (LO) {
      uint32_t h, l[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(x[i], h, l[i]);
      *reinterpret_cast<uint4*>(out) = make_uint4(l[0], l[1], l[2], l[3]);
    } else {
      store_operand<T, CH>(out, lo_off, x);
    }
  }
}

// The tf32 hi copy of 64 raw rows along D (times mul rounded to T where
// mul_on) as wgmma A fragments: thread rows 16*warp + g and + 8, columns
// 8k + t and + 4 of each k-step k
template <int D>
__device__ __forceinline__ void load_afrags(uint32_t (&a)[D / 8][4], const unsigned char* raw,
                                            bool mul_on, float mul) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int k = 0; k < D / 8; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float x = raw_at<float, D>(raw, 16 * warp + g + 8 * (i & 1), 8 * k + t + 4 * (i >> 1));
      if (mul_on) x = __fmul_rn(x, mul);
      a[k][i] = tf32_bits(x);
    }
}

// rows [0, R) of `raw` transposed: a K-major operand [d][row] with the R
// rows along K. f32: each 8-row group in the order 0, 2, 4, 6, 1, 3, 5, 7,
// since the tf32 A fragment holds k t and t + 4 where the accumulator
// holds columns 2t and 2t + 1 (bf16's fragment matches the accumulator).
template <typename T, int D, int R>
__device__ __forceinline__ void stage_trans(unsigned char* dst, int lo_off,
                                            const unsigned char* raw) {
  if constexpr (sizeof(T) == 4) {
    static_assert(D * (R / 4) % BWD_NT == 0, "whole chunks per thread");
#pragma unroll 4
    for (int n = 0; n < D * (R / 4) / BWD_NT; ++n) {
      const int idx = n * BWD_NT + threadIdx.x;
      const int d = idx % D, qc = idx / D, j8 = qc >> 1, odd = qc & 1;
      float x[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        x[i] = raw_at<float, D>(raw, 8 * j8 + 2 * i + odd, d);
      store_operand<float, 4>(dst + kmajor_off<R, 4>(d, 8 * j8 + 4 * odd), lo_off, x);
    }
  } else {
    static_assert(D * (R / 8) % BWD_NT == 0, "whole chunks per thread");
#pragma unroll 4
    for (int n = 0; n < D * (R / 8) / BWD_NT; ++n) {
      const int idx = n * BWD_NT + threadIdx.x, d = idx % D, j8 = idx / D;
      float x[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = raw_at<T, D>(raw, 8 * j8 + i, d);
      store_operand<T, 8>(dst + kmajor_off<R, 2>(d, 8 * j8), 0, x);
    }
  }
}

// d = A.B^T over KD, A (64 rows) and B (the tile's rows) K-major along KD
// in shared memory, hi at a / b and lo at a + a_lo / b + b_lo: f32 the
// three tf32 passes lo*hi + hi*lo + hi*hi, bf16 one. d starts fresh.
template <typename T, int KD, int NA>
__device__ __forceinline__ void mma_ss(float (&d)[NA], uint32_t a, uint32_t a_lo, uint32_t b,
                                       uint32_t b_lo) {
  constexpr uint32_t SBO = KD * sizeof(T) * 8;
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int k = 0; k < KD / 8; ++k)
      wgmma_tf32_ss(d, smem_desc(a + a_lo + 256 * k, 128, SBO), smem_desc(b + 256 * k, 128, SBO),
                    k > 0);
#pragma unroll
    for (int k = 0; k < KD / 8; ++k)
      wgmma_tf32_ss(d, smem_desc(a + 256 * k, 128, SBO), smem_desc(b + b_lo + 256 * k, 128, SBO),
                    1);
#pragma unroll
    for (int k = 0; k < KD / 8; ++k)
      wgmma_tf32_ss(d, smem_desc(a + 256 * k, 128, SBO), smem_desc(b + 256 * k, 128, SBO), 1);
  } else {
#pragma unroll
    for (int k = 0; k < KD / 16; ++k)
      wgmma_bf16_ss<0>(d, smem_desc(a + 256 * k, 128, SBO), smem_desc(b + 256 * k, 128, SBO),
                       k > 0);
  }
}

// d = A.B^T over KD in float32 as mma_ss, with A's hi copy from registers
// (a) for the hi*lo and hi*hi passes: two of the three passes read only B
// from shared memory. A's lo copy at a_lo, B's hi at b and lo at b + b_lo.
template <int KD, int NA>
__device__ __forceinline__ void mma_ss_rhi(float (&d)[NA], const uint32_t (&a)[KD / 8][4],
                                           uint32_t a_lo, uint32_t b, uint32_t b_lo) {
  constexpr uint32_t SBO = KD * 4 * 8;
#pragma unroll
  for (int k = 0; k < KD / 8; ++k)
    wgmma_tf32_ss(d, smem_desc(a_lo + 256 * k, 128, SBO), smem_desc(b + 256 * k, 128, SBO), k > 0);
#pragma unroll
  for (int k = 0; k < KD / 8; ++k)
    wgmma_tf32_rs(d, a[k], smem_desc(b + b_lo + 256 * k, 128, SBO), 1);
#pragma unroll
  for (int k = 0; k < KD / 8; ++k) wgmma_tf32_rs(d, a[k], smem_desc(b + 256 * k, 128, SBO), 1);
}

// d = A.B over KR rows: A the fragments of an accumulator tile (hi f, lo
// l), B [n][row] K-major along the rows (hi at b, lo at b + b_lo). d
// starts fresh.
template <typename T, int KR, int NA, int KS, int KL>
__device__ __forceinline__ void mma_rs(float (&d)[NA], const uint32_t (&f)[KS][4],
                                       const uint32_t (&l)[KL][4], uint32_t b, uint32_t b_lo) {
  constexpr uint32_t SBO = KR * sizeof(T) * 8;
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int k = 0; k < KS; ++k) wgmma_tf32_rs(d, l[k], smem_desc(b + 256 * k, 128, SBO), k > 0);
#pragma unroll
    for (int k = 0; k < KS; ++k) wgmma_tf32_rs(d, f[k], smem_desc(b + b_lo + 256 * k, 128, SBO), 1);
#pragma unroll
    for (int k = 0; k < KS; ++k) wgmma_tf32_rs(d, f[k], smem_desc(b + 256 * k, 128, SBO), 1);
  } else {
#pragma unroll
    for (int k = 0; k < KS; ++k) wgmma_bf16_rs<0>(d, f[k], smem_desc(b + 256 * k, 128, SBO), k > 0);
  }
}

// An accumulator tile of NA values (each already a value of T) as wgmma A
// fragments: tf32 hi/lo per 8-column step, or bf16 per 16
template <typename T, int NA, int KS, int KL>
__device__ __forceinline__ void to_frags(const float (&x)[NA], uint32_t (&f)[KS][4],
                                         uint32_t (&l)[KL][4]) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      split_tf32(x[4 * k + 0], f[k][0], l[k][0]);  // (g,     column 8k + 2t)
      split_tf32(x[4 * k + 2], f[k][1], l[k][1]);  // (g + 8, column 8k + 2t)
      split_tf32(x[4 * k + 1], f[k][2], l[k][2]);  // (g,     column 8k + 2t + 1)
      split_tf32(x[4 * k + 3], f[k][3], l[k][3]);  // (g + 8, column 8k + 2t + 1)
    }
  } else {
#pragma unroll
    for (int k = 0; k < KS; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i) f[k][i] = pack_bf16(x[8 * k + 2 * i], x[8 * k + 2 * i + 1]);
  }
}

// tt = X.B over KR rows, fresh, X an accumulator tile of the streamed rows
// (p^T, dS^T or dS) taken as A fragments, B [n][row] K-major along the
// rows (hi at b, lo at b + b_lo); the caller adds tt to its total.
// `during` runs while the products run.
template <typename T, int KR, int NA, int NX, int KS, int KL, typename F>
__device__ __forceinline__ void mma_rs_tile(float (&tt)[NA], const float (&x)[NX],
                                            uint32_t (&f)[KS][4], uint32_t (&l)[KL][4],
                                            uint32_t b, uint32_t b_lo, F&& during) {
  zero(tt);
  to_frags<T>(x, f, l);
  wgmma_fence();
  mma_rs<T, KR>(tt, f, l, b, b_lo);
  wgmma_commit();
  during();
  wgmma_wait<0>();
  fence_regs(tt);
  fence_frags(f);
  fence_frags(l);
}

template <int N> __device__ __forceinline__ void add_to(float (&tot)[N], const float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) tot[i] += x[i];
}

// Rows [row0, row0 + rows) of a 64-row accumulator tile (thread: rows
// 16*warp + g and + 8, columns 8j + 2t and + 1) to dst as T
template <typename T, int D>
__device__ __forceinline__ void store_acc(T* __restrict__ dst, long long stride,
                                          const float (&acc)[D / 2], int row0, int rows) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * warp + g + 8 * r;
    if (row >= rows) continue;
    T* out = dst + (long long)(row0 + row) * stride;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float a = acc[4 * j + 2 * r], c = acc[4 * j + 2 * r + 1];
      if constexpr (sizeof(T) == 4)
        *reinterpret_cast<float2*>(out + 8 * j + 2 * t) = make_float2(a, c);
      else
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * j + 2 * t) = __floats2bfloat162_rn(a, c);
    }
  }
}

// The same times mul through shared memory (`stage`, 64 rows of D + 8
// f32; the caller has synchronised its last readers), un-rotated with
// rope as x*cos - rot(x)*sin (rot reads the partner column, another
// thread's, from the staged row), written as 16-byte chunks of T
template <typename T, int D, bool TB>
__device__ __forceinline__ void store_staged(T* __restrict__ dst, long long stride,
                                             const float (&acc)[D / 2], float mul, int row0,
                                             int rows, const float* __restrict__ cos,
                                             const float* __restrict__ sin,
                                             const int* __restrict__ rot, float* stage) {
  constexpr int LS = D + 8, CH = 16 / (int)sizeof(T), CPR = D / CH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(stage + (16 * warp + g + 8 * r) * LS + 8 * j + 2 * t) =
          make_float2(__fmul_rn(acc[4 * j + 2 * r], mul), __fmul_rn(acc[4 * j + 2 * r + 1], mul));
  __syncthreads();
  for (int idx = threadIdx.x; idx < 64 * CPR; idx += BWD_NT) {
    const int r = idx / CPR, c0 = (idx % CPR) * CH;
    if (r >= rows) continue;
    const float* srow = stage + r * LS;
    const long long row = row0 + r;
    float x[CH];
#pragma unroll
    for (int i = 0; i < CH; ++i) x[i] = srow[c0 + i];
    if (cos != nullptr) {
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const long long tix = row * D + c0 + i;
        x[i] = __fsub_rn(__fmul_rn(x[i], cos[tix]),
                         __fmul_rn(rot_at<D, TB>(srow, rot, c0 + i), sin[tix]));
      }
    }
    T* out = dst + row * stride + c0;
    if constexpr (sizeof(T) == 4)
      *reinterpret_cast<float4*>(out) = make_float4(x[0], x[1], x[2], x[3]);
    else
      *reinterpret_cast<uint4*>(out) = make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]),
                                                  pack_bf16(x[4], x[5]), pack_bf16(x[6], x[7]));
  }
}

// dK and dV of keys [tile*64, tile*64 + 64) of head (b, h), over all q rows.
template <typename T, int D, bool TB>
__device__ __forceinline__ void bwd_dkv(const BwdParams& p, unsigned char* smem, int tile, int h,
                                        int b) {
  using L = BwdTiles<T, D, true>;
  constexpr int BN = L::BN, NC = L::NC, KS = L::F32 ? BN / 8 : BN / 16;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const long long* st = p.st;
  const T* qh = static_cast<const T*>(p.q) + b * st[0] + h * st[1];
  const T* kh = static_cast<const T*>(p.k) + b * st[3] + h * st[4];
  const T* vh = static_cast<const T*>(p.v) + b * st[6] + h * st[7];
  const T* oh = static_cast<const T*>(p.dout) + b * st[9] + h * st[10];
  const long long row_stat = ((long long)b * p.H + h) * p.Sq;
  const float* lse = p.lse + row_stat;
  const float* di = p.di + row_stat;
  const int Sq = p.Sq, k0 = tile * 64, kr = min(64, p.Sk - k0), nt = (Sq + BN - 1) / BN;

  unsigned char* sK = smem;                   // K hi, lo (RH: lo); V hi, lo
  unsigned char* sV = sK + L::RC0 * L::RES;
  unsigned char* sQs = smem + L::PH1_OFF;     // Q_s hi, lo; dO hi, lo
  unsigned char* sdO = sQs + NC * L::OPN;
  unsigned char* sdOT = smem + L::PH2_OFF;    // dO^T hi, lo; Q_r^T hi, lo
  unsigned char* sQT = sdOT + NC * L::OPN;
  unsigned char* raw = smem + L::RAW_OFF;     // q_r rows, dO rows, then lse, di
  float* rld = reinterpret_cast<float*>(raw + 2 * L::RAW_ROWS);  // [slot][lse | di][BN]

  // cp.async of iteration it's q tile: q_r and dO rows, lse and di (slot it % 2)
  auto issue = [&](int it) {
    const int q0 = (it % nt) * BN, qr = min(BN, Sq - q0);
    float* sl = rld + (it % 2) * 2 * BN;
    issue_rows<T, D, BN>(raw, qh, st[2], q0, qr);
    issue_rows<T, D, BN>(raw + L::RAW_ROWS, oh, st[11], q0, qr);
    if (tid < BN)
      cp_async4_zfill(sl + tid, lse + q0 + min(tid, qr - 1), tid < qr);
    else if (tid < 2 * BN)
      cp_async4_zfill(sl + tid, di + q0 + min(tid - BN, qr - 1), tid - BN < qr);
    cp_async_commit();
  };
  // the phase-1 B operands from the raw rows: Q_s = q_r * scale_log2
  // rounded to T, and dO
  auto stage_ph1 = [&]() {
    stage_kmajor<T, D, BN>(sQs, L::OPN, raw, true, p.scale_log2);
    stage_kmajor<T, D, BN>(sdO, L::OPN, raw + L::RAW_ROWS, false, 1.f);
    fence_async_smem();
  };
  // the phase-2 B operands: dO and q_r transposed, the q rows along K
  auto stage_ph2 = [&]() {
    stage_trans<T, D, BN>(sdOT, L::OPN, raw + L::RAW_ROWS);
    stage_trans<T, D, BN>(sQT, L::OPN, raw);
    fence_async_smem();
  };

  // K and V of the tile as the resident A operands (their rows land in the
  // phase area first)
  unsigned char* rres = smem + L::PH1_OFF;
  issue_rows<T, D, 64>(rres, kh, st[5], k0, kr);
  issue_rows<T, D, 64>(rres + L::RES_RAW / 2, vh, st[8], k0, kr);
  cp_async_commit();
  if constexpr (L::EARLY) issue(0);
  cp_async_wait<L::EARLY ? 1 : 0>();
  __syncthreads();
  // RH: the hi copy of K as register A fragments, its lo in shared memory
  uint32_t ka[L::RH ? D / 8 : 1][4];
  if constexpr (L::RH) {
    stage_kmajor<T, D, 64, true>(sK, 0, rres, false, 1.f);
    load_afrags<D>(ka, rres, false, 1.f);
  } else {
    stage_kmajor<T, D, 64>(sK, L::RES, rres, false, 1.f);
  }
  stage_kmajor<T, D, 64>(sV, L::RES, rres + L::RES_RAW / 2, false, 1.f);
  fence_async_smem();
  __syncthreads();  // the resident operands staged, the phase area free
  if constexpr (!L::EARLY) issue(0);

  // the dK total, and the dV total: in registers, in shared memory
  // (DV_SMEM: float4 v of thread tid at v*128 + tid), or, with two
  // passes, in tk during the dV pass
  constexpr bool DV_REG = !L::DV_SMEM && L::NPASS == 1;
  float tk[D / 2], tv[DV_REG ? D / 2 : 1], tt[D / 2], s[BN / 2], dp[BN / 2];
  float4* sdv = reinterpret_cast<float4*>(smem + L::DV_OFF) + tid;
  uint32_t pf[KS][4], pl[L::F32 ? KS : 1][4];
  zero(tk);
  zero(tv);
  zero(tt);
  if constexpr (L::DV_SMEM) {
#pragma unroll
    for (int v = 0; v < D / 8; ++v) sdv[v * BWD_NT] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  auto add_dv = [&]() {
    if constexpr (L::DV_SMEM) {
#pragma unroll
      for (int v = 0; v < D / 8; ++v) {
        float4 a = sdv[v * BWD_NT];
        a.x += tt[4 * v], a.y += tt[4 * v + 1], a.z += tt[4 * v + 2], a.w += tt[4 * v + 3];
        sdv[v * BWD_NT] = a;
      }
    } else if constexpr (DV_REG) {
      add_to(tv, tt);
    } else {
      add_to(tk, tt);
    }
  };
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
  for (int k = 0; k < KS; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) pf[k][i] = pl[L::F32 ? k : 0][i] = 0u;

  const uint32_t aK = smem_addr(sK), aV = smem_addr(sV), aQs = smem_addr(sQs),
                 adO = smem_addr(sdO), adOT = smem_addr(sdOT), aQT = smem_addr(sQT);
  const int n_it = L::NPASS * nt;

  // iterations [it0, it1) of the q loop, computing dV and/or dK
  auto q_loop = [&](auto dv_tag, auto dk_tag, int it0, int it1) {
    constexpr bool do_dv = decltype(dv_tag)::value, do_dk = decltype(dk_tag)::value;
    for (int it = it0; it < it1; ++it) {
      const int q0 = (it % nt) * BN;
      const bool next = it + 1 < n_it;
      const float* sl = rld + (it % 2) * 2 * BN;  // this tile's lse, then di
      cp_async_wait<0>();
      __syncthreads();  // tile it landed; every reader of the phase area is done
      stage_ph1();
      __syncthreads();

      // S^T = K Q_s^T and dP^T = V dO^T, the keys as M (accumulators zeroed,
      // not fenced: a fence would keep the last tile's values live)
      zero(s);
      zero(dp);
      wgmma_fence();
      if constexpr (L::RH)
        mma_ss_rhi<D>(s, ka, aK, aQs, L::OPN);
      else
        mma_ss<T, D>(s, aK, L::RES, aQs, L::OPN);
      if constexpr (do_dk) mma_ss<T, D>(dp, aV, L::RES, adO, L::OPN);
      wgmma_commit();
      if constexpr (!L::ALIAS) {  // the transposed B operands while S and dP run
        stage_ph2();
        __syncthreads();  // tile it's raw rows consumed
        if (next) issue(it + 1);
      }
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      // p and dS on the fragment: row key 16*warp + g (+ 8), column q row
      // 8(i/4) + 2t (+ 1); s then holds round_T(p), dp dS
#pragma unroll
      for (int c = 0; c < BN / 8; ++c) {
        const float2 lc = *reinterpret_cast<const float2*>(sl + 8 * c + 2 * t);
        const float2 dc = *reinterpret_cast<const float2*>(sl + BN + 8 * c + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * c + e, col = 8 * c + 2 * t + (e & 1);
          const int key = k0 + 16 * warp + g + 8 * (e >> 1);
          const bool ok = key < p.Sk && q0 + col < Sq;
          const float pv = ok ? exp2f(__fsub_rn(s[i], (e & 1) ? lc.y : lc.x)) : 0.f;
          s[i] = round_to<T>(pv);
          dp[i] = round_to<T>(__fmul_rn(pv, __fsub_rn(dp[i], (e & 1) ? dc.y : dc.x)));
        }
      }
      if constexpr (L::ALIAS) {
        __syncthreads();  // every warp's S and dP done: the phase area is free
        stage_ph2();
        __syncthreads();
        if (next) issue(it + 1);
      }

      // dV += P^T dO and dK += dS^T Q_r, each tile's product fresh
      if constexpr (do_dv) {
        mma_rs_tile<T, BN>(tt, s, pf, pl, adOT, L::OPN, [] {});
        add_dv();
      }
      if constexpr (do_dk) {
        mma_rs_tile<T, BN>(tt, dp, pf, pl, aQT, L::OPN, [] {});
        add_to(tk, tt);
      }
    }
  };

  T* dvh = static_cast<T*>(p.dv) + b * st[18] + h * st[19];
  if constexpr (L::NPASS == 1) {
    q_loop(std::true_type{}, std::true_type{}, 0, n_it);
  } else {  // the dV pass, then the dK pass
    q_loop(std::true_type{}, std::false_type{}, 0, nt);
    store_acc<T, D>(dvh, st[20], tk, k0, kr);
    zero(tk);
    q_loop(std::false_type{}, std::true_type{}, nt, n_it);
  }
  if constexpr (L::DV_SMEM) {
#pragma unroll
    for (int v = 0; v < D / 8; ++v) {
      const float4 a = sdv[v * BWD_NT];
      tt[4 * v] = a.x, tt[4 * v + 1] = a.y, tt[4 * v + 2] = a.z, tt[4 * v + 3] = a.w;
    }
    store_acc<T, D>(dvh, st[20], tt, k0, kr);
  } else if constexpr (DV_REG) {
    store_acc<T, D>(dvh, st[20], tv, k0, kr);
  }
  __syncthreads();  // every wgmma done: the shared memory is free
  store_staged<T, D, TB>(static_cast<T*>(p.dk) + b * st[15] + h * st[16], st[17], tk,
                         p.sm_scale, k0, kr, p.cos, p.sin, p.rot, reinterpret_cast<float*>(smem));
}

// dQ of q rows [tile*64, tile*64 + 64) of head (b, h), over all keys.
template <typename T, int D, bool TB>
__device__ __forceinline__ void bwd_dq(const BwdParams& p, unsigned char* smem, int tile, int h,
                                       int b) {
  using L = BwdTiles<T, D, false>;
  constexpr int BN = L::BN, NC = L::NC, KS = L::F32 ? BN / 8 : BN / 16;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const long long* st = p.st;
  const T* qh = static_cast<const T*>(p.q) + b * st[0] + h * st[1];
  const T* kh = static_cast<const T*>(p.k) + b * st[3] + h * st[4];
  const T* vh = static_cast<const T*>(p.v) + b * st[6] + h * st[7];
  const T* oh = static_cast<const T*>(p.dout) + b * st[9] + h * st[10];
  const long long row_stat = ((long long)b * p.H + h) * p.Sq;
  const int Sq = p.Sq, Sk = p.Sk, q0 = tile * 64, qr = min(64, Sq - q0), nt = (Sk + BN - 1) / BN;

  unsigned char* sQs = smem;                  // Q_s hi, lo; dO hi, lo (RH: lo; lo)
  unsigned char* sdO = sQs + L::RC0 * L::RES;
  unsigned char* sK = smem + L::PH1_OFF;      // K_r hi, lo; V hi, lo
  unsigned char* sV = sK + NC * L::OPN;
  unsigned char* sKT = smem + L::PH2_OFF;     // K_r^T hi, lo
  unsigned char* raw = smem + L::RAW_OFF;     // k_r rows, v rows

  // cp.async of key tile j: k_r and v rows
  auto issue = [&](int j) {
    const int k0 = j * BN, kr = min(BN, Sk - k0);
    issue_rows<T, D, BN>(raw, kh, st[5], k0, kr);
    issue_rows<T, D, BN>(raw + L::RAW_ROWS, vh, st[8], k0, kr);
    cp_async_commit();
  };
  auto stage_ph1 = [&]() {  // K_r and V
    stage_kmajor<T, D, BN>(sK, L::OPN, raw, false, 1.f);
    stage_kmajor<T, D, BN>(sV, L::OPN, raw + L::RAW_ROWS, false, 1.f);
    fence_async_smem();
  };
  auto stage_ph2 = [&]() {  // K_r transposed, the keys along K
    stage_trans<T, D, BN>(sKT, L::OPN, raw);
    fence_async_smem();
  };

  // Q_s and dO of the tile as the resident A operands
  unsigned char* rres = smem + L::PH1_OFF;
  issue_rows<T, D, 64>(rres, qh, st[2], q0, qr);
  issue_rows<T, D, 64>(rres + L::RES_RAW / 2, oh, st[11], q0, qr);
  cp_async_commit();
  if constexpr (L::EARLY) issue(0);
  float lr[2], dr[2];  // lse and di of this thread's rows 16*warp + g (+ 8)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * warp + g + 8 * r;
    lr[r] = row < Sq ? p.lse[row_stat + row] : 0.f;
    dr[r] = row < Sq ? p.di[row_stat + row] : 0.f;
  }
  cp_async_wait<L::EARLY ? 1 : 0>();
  __syncthreads();
  // RH: the hi copies of Q_s and dO as register A fragments, lo in shared
  // memory
  uint32_t qa[L::RH ? D / 8 : 1][4], oa[L::RH ? D / 8 : 1][4];
  if constexpr (L::RH) {
    stage_kmajor<T, D, 64, true>(sQs, 0, rres, true, p.scale_log2);
    stage_kmajor<T, D, 64, true>(sdO, 0, rres + L::RES_RAW / 2, false, 1.f);
    load_afrags<D>(qa, rres, true, p.scale_log2);
    load_afrags<D>(oa, rres + L::RES_RAW / 2, false, 1.f);
  } else {
    stage_kmajor<T, D, 64>(sQs, L::RES, rres, true, p.scale_log2);
    stage_kmajor<T, D, 64>(sdO, L::RES, rres + L::RES_RAW / 2, false, 1.f);
  }
  fence_async_smem();
  __syncthreads();
  if constexpr (!L::EARLY) issue(0);
  if constexpr (!L::ALIAS) {  // tile 0's phase 1; later tiles' during dQ
    cp_async_wait<0>();
    __syncthreads();
    stage_ph1();
    __syncthreads();
  }

  float tot[D / 2], tt[D / 2], s[BN / 2], dp[BN / 2];
  uint32_t pf[KS][4], pl[L::F32 ? KS : 1][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) tot[i] = tt[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
  for (int k = 0; k < KS; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) pf[k][i] = pl[L::F32 ? k : 0][i] = 0u;

  const uint32_t aQs = smem_addr(sQs), adO = smem_addr(sdO), aK = smem_addr(sK),
                 aV = smem_addr(sV), aKT = smem_addr(sKT);

  for (int j = 0; j < nt; ++j) {
    const int k0 = j * BN;
    const bool next = j + 1 < nt;
    if constexpr (L::ALIAS) {
      cp_async_wait<0>();
      __syncthreads();  // tile j landed; every reader of the phase area is done
      stage_ph1();
      __syncthreads();
    }

    // S = Q_s K_r^T and dP = dO V^T
    zero(s);
    zero(dp);
    wgmma_fence();
    if constexpr (L::RH) {
      mma_ss_rhi<D>(s, qa, aQs, aK, L::OPN);
      mma_ss_rhi<D>(dp, oa, adO, aV, L::OPN);
    } else {
      mma_ss<T, D>(s, aQs, L::RES, aK, L::OPN);
      mma_ss<T, D>(dp, adO, L::RES, aV, L::OPN);
    }
    wgmma_commit();
    if constexpr (!L::ALIAS) {  // K_r^T while S and dP run
      stage_ph2();
      __syncthreads();  // tile j's raw rows consumed
      if (next) issue(j + 1);
    }
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // dS on the fragment: row 16*warp + g (+ 8), column key 8(i/4) + 2t (+ 1)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int r = (i >> 1) & 1;
      const int key = k0 + 8 * (i / 4) + 2 * t + (i & 1);
      const bool ok = key < Sk && q0 + 16 * warp + g + 8 * r < Sq;
      const float pv = ok ? exp2f(__fsub_rn(s[i], lr[r])) : 0.f;
      dp[i] = round_to<T>(__fmul_rn(pv, __fsub_rn(dp[i], dr[r])));
    }
    if constexpr (L::ALIAS) {
      __syncthreads();  // every warp's S and dP done: the phase area is free
      stage_ph2();
      __syncthreads();
      if (next) issue(j + 1);
    }

    // dQ += dS K_r, each tile's product fresh; the next tile's phase-1
    // operands are staged while it runs
    mma_rs_tile<T, BN>(tt, dp, pf, pl, aKT, L::OPN, [&] {
      if constexpr (!L::ALIAS) {
        if (next) {
          cp_async_wait<0>();
          __syncthreads();  // tile j + 1 landed; every warp's S and dP done
          stage_ph1();
        }
      }
    });
    add_to(tot, tt);
    if constexpr (!L::ALIAS) __syncthreads();  // phase 1 staged; phase 2 free
  }

  __syncthreads();  // every wgmma done: the shared memory is free
  store_staged<T, D, TB>(static_cast<T*>(p.dq) + b * st[12] + h * st[13], st[14], tot, p.sm_scale,
                         q0, qr, p.cos, p.sin, p.rot, reinterpret_cast<float*>(smem));
}

// The dynamic shared memory of a kernel, set once per instantiation
// before its launch.
template <typename K> __host__ cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Unpack the arguments of the C entry points into BwdParams; false for
// arguments no backward kernel takes: among them bases and (b, h, s)
// strides of q, k, v, dO and the gradients that are not 16-byte aligned,
// as the core's cp.async and 16-byte stores need.
__host__ inline bool bwd_params(BwdParams& p, const void* q, const void* k, const void* v,
                                const void* dout, const float* lse, const float* di, void* dq,
                                void* dk, void* dv, const float* cos, const float* sin,
                                const int* rot, int B, int H, int Sq, int Sk, int item,
                                const long long* strides, float sm_scale, float scale_log2) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || B > 65535 || H > 65535) return false;
  if ((cos == nullptr) != (sin == nullptr) || (cos == nullptr && rot != nullptr)) return false;
  if (cos != nullptr && Sq != Sk) return false;
  if (lse == nullptr || di == nullptr || strides == nullptr) return false;
  const void* ptrs[7] = {q, k, v, dout, dq, dk, dv};
  for (const void* x : ptrs)
    if (reinterpret_cast<uintptr_t>(x) % 16 != 0) return false;
  for (int i = 0; i < 21; ++i)
    if ((strides[i] * item) % 16 != 0) return false;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = lse;
  p.di = di;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.cos = cos;
  p.sin = sin;
  p.rot = rot;
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  for (int i = 0; i < 21; ++i) p.st[i] = strides[i];
  p.sm_scale = sm_scale;
  p.scale_log2 = scale_log2;
  return true;
}

}  // namespace skix
