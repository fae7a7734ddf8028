// The two CTA bodies of the attention backward, shared by flash_bwd.cu
// (K3 and K4, one launch each) and flash_bwd_single_tile.cu (K5, one launch
// whose CTAs take either role).
//
// What they compute is the TPU kernels' (skix/ops/attention.py:558-751),
// with their roundings:
//   q_r = rope(q) in f32 rounded to T (q itself without rope), k_r likewise;
//   q_s = q_r * (sm_scale*log2e) in f32, rounded to T;
//   s = q_s.k_r in f32 (base-2 logits), p = exp2(s - lse), 0 past Sq or Sk;
//   dV = round_T(p)^T.dO;  dP = dO.V^T;  dS = round_T(p * (dP - di));
//   dK = sm_scale * dS^T.q_r;  dQ = sm_scale * dS.k_r;
// accumulators in f32; with rope, dK and dQ are un-rotated at the store as
// x*cos - rot(x)*sin, rot the style's signed permutation (rot_at: by index
// for rotate-half, else one code per column), whose transpose is its
// negative for every style. That
// equals the true gradient of the rope only for a pair-symmetric sin table
// (sin[s, j] == sin[s, partner(j)]), which every table builder of the port
// makes.
//
// Roles. dkv_tile: one CTA per (64-key tile, head, batch row) holds its
// roped k and its v tile (f32, transposed) and the f32 dK, dV accumulators
// in registers, and streams q and dO in BQ-row tiles with their lse and di.
// dq_tile: one CTA per (64-row q tile, head, batch row) holds its scaled q
// and dO (transposed) and the f32 dQ accumulator, and streams k and v in
// 64-row tiles. Every product runs as an f32 FMA loop over tiles in shared
// memory; no atomics, so the gradients are deterministic.

#pragma once

#include "flash_common.cuh"

namespace skix {

constexpr int BWD_BK = 64;    // keys per tile
constexpr int BWD_NT = 256;   // threads per CTA: 16 row groups x 16 column groups

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;   // (B, H, Sq) f32, contiguous, base 2
  const float* di;    // (B, H, Sq) f32, contiguous: sum_d o*dO
  void* dq;
  void* dk;
  void* dv;
  const float* cos;   // (S, D) f32 or null
  const float* sin;
  const int* rot;     // (D,) rotation codes of the rope's style; null: rotate-half
  int H, Sq, Sk;
  // (b, h, s) element strides of q, k, v, dO, dQ, dK, dV, in that order
  long long st[21];
  float sm_scale;     // sm_scale rounded to f32
  float scale_log2;   // sm_scale * log2(e) rounded to f32
};

// Rows [row0, row0 + R) of one (S, D) head slice into shared memory as f32,
// zero past `rows`: transposed (dst[d * LD + r]) or row-major (dst[r * LD +
// d]). With rope, x*cos + rot(x)*sin in f32 (rot_at) rounded to T; then, with
// `scale_on`, times `scale` rounded to T again (the backward kernels cast
// the roped tile and the scaled tile separately). The _rn intrinsics keep
// nvcc from contracting the products into FMAs.
template <typename T, int D, int R, int LD, bool TRANS, bool TB>
__device__ __forceinline__ void bwd_load(float* __restrict__ dst, const T* __restrict__ src,
                                         long long stride_s, int row0, int rows,
                                         const float* __restrict__ cos,
                                         const float* __restrict__ sin,
                                         const int* __restrict__ rot, bool scale_on,
                                         float scale) {
  for (int idx = threadIdx.x; idx < R * D; idx += BWD_NT) {
    const int r = idx / D, d = idx % D;
    float x = 0.f;
    if (r < rows) {
      const T* row = src + (long long)(row0 + r) * stride_s;
      x = to_f32(row[d]);
      if (cos != nullptr) {
        const long long t = (long long)(row0 + r) * D + d;
        x = round_to<T>(__fadd_rn(__fmul_rn(x, cos[t]), __fmul_rn(rot_at<D, TB>(row, rot, d), sin[t])));
      }
      if (scale_on) x = round_to<T>(__fmul_rn(x, scale));
    }
    dst[TRANS ? d * LD + r : r * LD + d] = x;
  }
}

// Write the f32 tile `acc` (the CTA's rows [row0, row0 + 64), thread
// (rg, cg) holding rows rg*4..+3 and columns out_col<D>(cg, j)) times
// `mul` to `dst` as T, rows past `rows` skipped. With rope, each value is
// un-rotated as x*cos - rot(x)*sin, which needs the partner column held by
// another thread (the next column, for interleaved pairs): the scaled tile
// goes through `stage` ([64][D + 4] f32) and rot reads it there.
template <typename T, int D, bool TB>
__device__ __forceinline__ void bwd_store(T* __restrict__ dst, long long stride_s,
                                          const float (&acc)[4][D / 16], float mul, int row0,
                                          int rows, const float* __restrict__ cos,
                                          const float* __restrict__ sin,
                                          const int* __restrict__ rot,
                                          float* __restrict__ stage) {
  constexpr int CPT = D / 16, LV = D + 4;
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
  if (cos == nullptr) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg * 4 + i;
      if (r >= rows) continue;
      T* out = dst + (long long)(row0 + r) * stride_s;
#pragma unroll
      for (int j = 0; j < CPT; ++j) out[out_col<D>(cg, j)] = from_f32<T>(__fmul_rn(acc[i][j], mul));
    }
    return;
  }
  __syncthreads();  // every reader of the stage's memory is done
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      stage[(rg * 4 + i) * LV + out_col<D>(cg, j)] = __fmul_rn(acc[i][j], mul);
  __syncthreads();
  for (int idx = threadIdx.x; idx < BWD_BK * D; idx += BWD_NT) {
    const int r = idx / D, d = idx % D;
    if (r >= rows) continue;
    const float* srow = stage + r * LV;
    const long long t = (long long)(row0 + r) * D + d;
    dst[(long long)(row0 + r) * stride_s + d] = from_f32<T>(
        __fsub_rn(__fmul_rn(srow[d], cos[t]), __fmul_rn(rot_at<D, TB>(srow, rot, d), sin[t])));
  }
}

// Rows per streamed q tile of the dK/dV role: 64, or 32 at D = 128 to stay
// inside one block's shared memory.
template <int D> __host__ __device__ constexpr int dkv_bq() { return D == 128 ? 32 : 64; }

template <int D> __host__ __device__ constexpr size_t dkv_smem_floats() {
  constexpr int BQ = dkv_bq<D>();
  return 2 * (size_t)D * (BWD_BK + 4)   // Kt, Vt
         + 2 * (size_t)D * (BQ + 4)     // Qst, dOt
         + 2 * (size_t)BQ * (D + 4)     // Qr, dOr
         + 2 * (size_t)BQ * (BWD_BK + 4)  // Ps, dSs
         + 2 * (size_t)BQ;              // lse, di
}

template <int D> __host__ __device__ constexpr size_t dq_smem_floats() {
  return 4 * (size_t)D * (BWD_BK + 4)   // Qst, dOt, Kt, Vt
         + (size_t)BWD_BK * (D + 4)     // Kr
         + (size_t)BWD_BK * (BWD_BK + 4)  // dSt
         + 2 * (size_t)BWD_BK;          // lse, di
}

// dK and dV of keys [tile*64, tile*64 + 64) of head (b, h), over all q rows.
template <typename T, int D, bool TB>
__device__ void dkv_tile(const BwdParams& p, float* smem, int tile, int h, int b) {
  constexpr int BQ = dkv_bq<D>(), RQ = BQ / 16, CPT = D / 16;
  constexpr int LT = BWD_BK + 4, LQ = BQ + 4, LV = D + 4, LP = BWD_BK + 4;
  float* Kt = smem;              // [D][LT]  roped k, transposed
  float* Vt = Kt + D * LT;       // [D][LT]  v, transposed
  float* Qst = Vt + D * LT;      // [D][LQ]  scaled q, transposed
  float* dOt = Qst + D * LQ;     // [D][LQ]  dO, transposed
  float* Qr = dOt + D * LQ;      // [BQ][LV] roped q
  float* dOr = Qr + BQ * LV;     // [BQ][LV] dO
  float* Ps = dOr + BQ * LV;     // [BQ][LP] p rounded to T
  float* dSs = Ps + BQ * LP;     // [BQ][LP] dS rounded to T
  float* Ls = dSs + BQ * LP;     // [BQ]
  float* Ds = Ls + BQ;           // [BQ]

  const int tid = threadIdx.x, rg = tid / 16, cg = tid % 16;
  const long long* st = p.st;
  const T* qh = static_cast<const T*>(p.q) + b * st[0] + h * st[1];
  const T* kh = static_cast<const T*>(p.k) + b * st[3] + h * st[4];
  const T* vh = static_cast<const T*>(p.v) + b * st[6] + h * st[7];
  const T* oh = static_cast<const T*>(p.dout) + b * st[9] + h * st[10];
  const long long row_stat = ((long long)b * p.H + h) * p.Sq;
  const int k0 = tile * BWD_BK, kr = min(BWD_BK, p.Sk - k0);

  bwd_load<T, D, BWD_BK, LT, true, TB>(Kt, kh, st[5], k0, kr, p.cos, p.sin, p.rot, false, 1.f);
  bwd_load<T, D, BWD_BK, LT, true, TB>(Vt, vh, st[8], k0, kr, nullptr, nullptr, nullptr, false,
                                   1.f);

  float adk[4][CPT], adv[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) adk[i][j] = adv[i][j] = 0.f;

  for (int q0 = 0; q0 < p.Sq; q0 += BQ) {
    const int qr = min(BQ, p.Sq - q0);
    __syncthreads();  // the previous tile's readers are done
    bwd_load<T, D, BQ, LV, false, TB>(Qr, qh, st[2], q0, qr, p.cos, p.sin, p.rot, false, 1.f);
    bwd_load<T, D, BQ, LV, false, TB>(dOr, oh, st[11], q0, qr, nullptr, nullptr, nullptr, false,
                                  1.f);
    bwd_load<T, D, BQ, LQ, true, TB>(dOt, oh, st[11], q0, qr, nullptr, nullptr, nullptr, false,
                                 1.f);
    for (int r = tid; r < BQ; r += BWD_NT) {
      Ls[r] = r < qr ? p.lse[row_stat + q0 + r] : 0.f;
      Ds[r] = r < qr ? p.di[row_stat + q0 + r] : 0.f;
    }
    __syncthreads();
    for (int idx = tid; idx < BQ * D; idx += BWD_NT) {
      const int r = idx / D, d = idx % D;
      Qst[d * LQ + r] = round_to<T>(__fmul_rn(Qr[r * LV + d], p.scale_log2));
    }
    __syncthreads();

    // scores and dP: thread owns q rows rg*RQ..+RQ-1, keys cg*4..+3
    float s[RQ][4], dp[RQ][4];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float av[RQ], ov[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        av[i] = Qst[d * LQ + rg * RQ + i];
        ov[i] = dOt[d * LQ + rg * RQ + i];
      }
      const float4 c = *reinterpret_cast<const float4*>(&Kt[d * LT + cg * 4]);
      const float4 w = *reinterpret_cast<const float4*>(&Vt[d * LT + cg * 4]);
      const float cv[4] = {c.x, c.y, c.z, c.w};
      const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(av[i], cv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], wv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = rg * RQ + i;
      float pr[4], dsr[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = r < qr && cg * 4 + j < kr;
        const float pij = ok ? exp2f(s[i][j] - Ls[r]) : 0.f;
        pr[j] = round_to<T>(pij);
        dsr[j] = round_to<T>(pij * (dp[i][j] - Ds[r]));
      }
      *reinterpret_cast<float4*>(&Ps[r * LP + cg * 4]) = make_float4(pr[0], pr[1], pr[2], pr[3]);
      *reinterpret_cast<float4*>(&dSs[r * LP + cg * 4]) =
          make_float4(dsr[0], dsr[1], dsr[2], dsr[3]);
    }
    __syncthreads();

    // dV += P^T dO, dK += dS^T q_r: thread owns keys rg*4..+3, columns
    // out_col<D>(cg, .)
#pragma unroll 2
    for (int r = 0; r < qr; ++r) {
      const float4 pa = *reinterpret_cast<const float4*>(&Ps[r * LP + rg * 4]);
      const float4 da = *reinterpret_cast<const float4*>(&dSs[r * LP + rg * 4]);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
      const float sv[4] = {da.x, da.y, da.z, da.w};
      pv_update<D, 4>(adv, pv, &dOr[r * LV], cg);
      pv_update<D, 4>(adk, sv, &Qr[r * LV], cg);
    }
  }

  // dV as it is, dK times sm_scale, un-rotated with rope (stage: Kt, Vt)
  bwd_store<T, D, TB>(static_cast<T*>(p.dv) + b * st[18] + h * st[19], st[20], adv, 1.f, k0, kr,
                  nullptr, nullptr, nullptr, nullptr);
  bwd_store<T, D, TB>(static_cast<T*>(p.dk) + b * st[15] + h * st[16], st[17], adk, p.sm_scale,
                  k0, kr, p.cos, p.sin, p.rot, Kt);
}

// dQ of q rows [tile*64, tile*64 + 64) of head (b, h), over all keys.
template <typename T, int D, bool TB>
__device__ void dq_tile(const BwdParams& p, float* smem, int tile, int h, int b) {
  constexpr int BQ = 64, CPT = D / 16;
  constexpr int LT = BWD_BK + 4, LV = D + 4;
  float* Kt = smem;              // [D][LT]  roped k, transposed
  float* Vt = Kt + D * LT;       // [D][LT]  v, transposed
  float* Qst = Vt + D * LT;      // [D][LT]  scaled q, transposed
  float* dOt = Qst + D * LT;     // [D][LT]  dO, transposed
  float* Kr = dOt + D * LT;      // [BK][LV] roped k
  float* dSt = Kr + BWD_BK * LV;   // [BK][LT] dS rounded to T, transposed
  float* Ls = dSt + BWD_BK * LT;   // [BQ]
  float* Ds = Ls + BQ;           // [BQ]

  const int tid = threadIdx.x, rg = tid / 16, cg = tid % 16;
  const long long* st = p.st;
  const T* qh = static_cast<const T*>(p.q) + b * st[0] + h * st[1];
  const T* kh = static_cast<const T*>(p.k) + b * st[3] + h * st[4];
  const T* vh = static_cast<const T*>(p.v) + b * st[6] + h * st[7];
  const T* oh = static_cast<const T*>(p.dout) + b * st[9] + h * st[10];
  const long long row_stat = ((long long)b * p.H + h) * p.Sq;
  const int q0 = tile * BQ, qr = min(BQ, p.Sq - q0);

  // q roped and rounded, then scaled and rounded again (two casts)
  bwd_load<T, D, BQ, LT, true, TB>(Qst, qh, st[2], q0, qr, p.cos, p.sin, p.rot, true,
                               p.scale_log2);
  bwd_load<T, D, BQ, LT, true, TB>(dOt, oh, st[11], q0, qr, nullptr, nullptr, nullptr, false, 1.f);
  for (int r = tid; r < BQ; r += BWD_NT) {
    Ls[r] = r < qr ? p.lse[row_stat + q0 + r] : 0.f;
    Ds[r] = r < qr ? p.di[row_stat + q0 + r] : 0.f;
  }

  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < p.Sk; k0 += BWD_BK) {
    const int kr = min(BWD_BK, p.Sk - k0);
    __syncthreads();  // the previous tile's readers are done
    bwd_load<T, D, BWD_BK, LT, true, TB>(Kt, kh, st[5], k0, kr, p.cos, p.sin, p.rot, false, 1.f);
    bwd_load<T, D, BWD_BK, LV, false, TB>(Kr, kh, st[5], k0, kr, p.cos, p.sin, p.rot, false, 1.f);
    bwd_load<T, D, BWD_BK, LT, true, TB>(Vt, vh, st[8], k0, kr, nullptr, nullptr, nullptr, false,
                                     1.f);
    __syncthreads();

    // scores and dP: thread owns q rows rg*4..+3, keys cg*4..+3
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qst[d * LT + rg * 4]);
      const float4 o = *reinterpret_cast<const float4*>(&dOt[d * LT + rg * 4]);
      const float4 c = *reinterpret_cast<const float4*>(&Kt[d * LT + cg * 4]);
      const float4 w = *reinterpret_cast<const float4*>(&Vt[d * LT + cg * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float ov[4] = {o.x, o.y, o.z, o.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
      const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(av[i], cv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], wv[j], dp[i][j]);
        }
    }
    // dS stored transposed: dSt[key][q]
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float dsr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rg * 4 + i;
        const bool ok = r < qr && cg * 4 + j < kr;
        const float pij = ok ? exp2f(s[i][j] - Ls[r]) : 0.f;
        dsr[i] = round_to<T>(pij * (dp[i][j] - Ds[r]));
      }
      *reinterpret_cast<float4*>(&dSt[(cg * 4 + j) * LT + rg * 4]) =
          make_float4(dsr[0], dsr[1], dsr[2], dsr[3]);
    }
    __syncthreads();

    // dQ += dS k_r: thread owns q rows rg*4..+3, columns out_col<D>(cg, .)
#pragma unroll 4
    for (int kk = 0; kk < kr; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&dSt[kk * LT + rg * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      pv_update<D, 4>(acc, av, &Kr[kk * LV], cg);
    }
  }

  // dQ times sm_scale, un-rotated with rope (stage: Kt, Vt)
  bwd_store<T, D, TB>(static_cast<T*>(p.dq) + b * st[12] + h * st[13], st[14], acc, p.sm_scale,
                  q0, qr, p.cos, p.sin, p.rot, Kt);
}

// Launch helpers: the dynamic shared memory of a kernel, set once per
// instantiation before its launch.
template <typename K>
__host__ cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Unpack the arguments of the C entry points into BwdParams; false for
// arguments no backward kernel takes.
__host__ inline bool bwd_params(BwdParams& p, const void* q, const void* k, const void* v,
                                const void* dout, const float* lse, const float* di, void* dq,
                                void* dk, void* dv, const float* cos, const float* sin,
                                const int* rot, int B, int H, int Sq, int Sk,
                                const long long* strides, float sm_scale, float scale_log2) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || B > 65535 || H > 65535) return false;
  if ((cos == nullptr) != (sin == nullptr) || (cos == nullptr && rot != nullptr)) return false;
  if (cos != nullptr && Sq != Sk) return false;
  if (lse == nullptr || di == nullptr || strides == nullptr) return false;
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
