// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel K1, `_fwd_kernel` in skix/ops/attention.py:184:
// softmax(scale * Q K^T) V with an online softmax in base 2, f32 statistics
// (m, l) and f32 accumulator, a ragged-edge mask, an optional fixed logit
// bound (no running max), an optional rope fused from (S, D) cos/sin tables
// in any of skix's three styles (rotate-half by index; interleaved pairs and
// rotate-half per segment by a (D,) code table; flash_common.cuh rot_at),
// and an optional
// base-2 log-partition output
// lse = m + log2(l) (0 where l == 0), as the TPU kernel's residual store
// (attention.py:297-305) computes it, one f32 per row.
//
// Design. One CTA of 256 threads per (64-row q tile, head, batch). The CTA
// loops over 64-row kv tiles in shared memory. Every tile is held as f32 in
// shared memory after the roundings the TPU kernel applies (q roped in f32,
// times scale*log2e, rounded to the input type; k roped in f32, rounded),
// so the products of the f32 FMA loops are exact and the sums are f32.
// Thread t owns a 4x4 block of the 64x64 score tile: rows 4*(t/16)..+3,
// columns 4*(t%16)..+3; the 16 threads of one row group are one half-warp,
// so row max and row sum are five shuffles. P is rounded to v's type,
// written transposed to shared memory, and P.V runs as a second f32 FMA
// loop into a 4 x (D/16) accumulator per thread (out_col: D 32, 64, 128).
// Strides are per (batch, head, row), so a q shared by every batch row (the
// memory tracker's first layer) comes in with batch stride 0, uncopied.
//
// Bound. At the VGGT shapes (S = 1374 and 2748, D = 64), the ViT-Det global
// blocks (S = 5184) and the memory tracker (15876 x 63504) the work is
// 4*B*H*Sq*Sk*D operations on at most a few hundred MB of input, so the
// kernel is bound by operations. These loops run on the f32 FMA units, not
// the tensor cores: the simple first version. wgmma with TMA-fed tiles is
// the later step.

#include "flash_common.cuh"

namespace {

using namespace skix;

constexpr int BQ = 64;        // q rows per CTA
constexpr int BK = 64;        // kv rows per tile
constexpr int NT = 256;       // threads per CTA: 16 row groups x 16 column groups
constexpr int LT = BQ + 4;    // row length (floats) of the transposed q, k, p tiles

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;        // (B, H, Sq) f32, contiguous, or null
  const float* cos;  // (Sq, D) or null
  const float* sin;
  const int* rot;    // (D,) rotation codes of the rope's style; null: rotate-half
  int H, Sq, Sk;
  long long sqb, sqh, sqs, skb, skh, sks, svb, svh, svs, sob, soh, sos;
  float scale_log2;  // sm_scale * log2(e), rounded to f32
  int fixed;         // fixed-max mode
  float max_log2;    // fixed_max * log2(e), rounded to f32
};

template <typename T, int D, bool TB>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(const Params p) {
  constexpr int LV = D + 4;     // row length (floats) of the v tile
  constexpr int CPT = D / 16;   // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;             // [D][LT]  q tile, transposed
  float* Kt = Qt + D * LT;      // [D][LT]  k tile, transposed
  float* Vs = Kt + D * LT;      // [BK][LV] v tile
  float* Pt = Vs + BK * LV;     // [BK][LT] p tile, transposed

  const int tid = threadIdx.x;
  const int rg = tid / 16, cg = tid % 16;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const T* qh = static_cast<const T*>(p.q) + b * p.sqb + h * p.sqh;
  const T* kh = static_cast<const T*>(p.k) + b * p.skb + h * p.skh;
  const T* vh = static_cast<const T*>(p.v) + b * p.svb + h * p.svh;
  T* oh = static_cast<T*>(p.o) + b * p.sob + h * p.soh;

  load_rows_t<T, D, BQ, LT, NT, TB>(Qt, qh, p.sqs, q0, min(BQ, p.Sq - q0), p.cos, p.sin, p.rot, true,
                                p.scale_log2);

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = p.fixed ? p.max_log2 : -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < p.Sk; k0 += BK) {
    const int kr = min(BK, p.Sk - k0);
    __syncthreads();  // the previous tile's readers are done
    load_rows_t<T, D, BK, LT, NT, TB>(Kt, kh, p.sks, k0, kr, p.cos, p.sin, p.rot, false, 1.f);
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int r = idx / D, d = idx % D;
      Vs[r * LV + d] = r < kr ? to_f32(vh[(long long)(k0 + r) * p.svs + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qt[d * LT + rg * 4]);
      const float4 c = *reinterpret_cast<const float4*>(&Kt[d * LT + cg * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    bool valid[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) valid[j] = cg * 4 + j < kr;

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mi = m[i];
      float alpha = 1.f;
      if (!p.fixed) {
        float mc = -INFINITY;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (valid[j]) mc = fmaxf(mc, s[i][j]);
        mc = fmaxf(mi, half_warp_max(mc));
        alpha = exp2f(mi - mc);
        mi = mc;
        m[i] = mc;
      }
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = valid[j] ? exp2f(s[i][j] - mi) : 0.f;
        rs += s[i][j];
      }
      rs = half_warp_sum(rs);
      l[i] = alpha * l[i] + rs;
      if (!p.fixed) {
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
      }
    }
    // p rounded to v's type, stored transposed: Pt[col][row]
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 pv = make_float4(round_to<T>(s[0][j]), round_to<T>(s[1][j]),
                                    round_to<T>(s[2][j]), round_to<T>(s[3][j]));
      *reinterpret_cast<float4*>(&Pt[(cg * 4 + j) * LT + rg * 4]) = pv;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kr; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&Pt[kk * LT + rg * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      pv_update<D, 4>(acc, av, &Vs[kk * LV], cg);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg * 4 + i;
    if (row >= p.Sq) continue;
    const float inv_l = l[i] == 0.f ? 1.f : l[i];
    T* orow = oh + (long long)row * p.sos;
#pragma unroll
    for (int j = 0; j < CPT; ++j) orow[out_col<D>(cg, j)] = from_f32<T>(acc[i][j] / inv_l);
    if (p.lse != nullptr && cg == 0)
      p.lse[((long long)b * p.H + h) * p.Sq + row] = l[i] > 0.f ? m[i] + log2f(l[i]) : 0.f;
  }
}

template <typename T, int D, bool TB>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * (2 * D * LT + BK * (D + 4) + BK * LT);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D, TB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, B);
  flash_fwd_kernel<T, D, TB><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const Params& p, int B, int D, cudaStream_t s) {
  if (D == 32) return p.rot != nullptr ? launch<T, 32, true>(p, B, s)
                          : launch<T, 32, false>(p, B, s);
  if (D == 64) return p.rot != nullptr ? launch<T, 64, true>(p, B, s)
                          : launch<T, 64, false>(p, B, s);
  if (D == 128) return p.rot != nullptr ? launch<T, 128, true>(p, B, s)
                          : launch<T, 128, false>(p, B, s);
  return static_cast<cudaError_t>(1000);
}

}  // namespace

extern "C" {

// q, k, v, o: (B, H, S, D) with element strides (b, h, s) and unit stride
// along D; lse: null or a contiguous (B, H, Sq) f32 output; cos, sin, rot:
// all null, or the rope's (Sq, D) f32 tables with rot null for rotate-half
// or the (D,) int32 rotation codes sign * (partner + 1) of another style;
// dtype 0 =
// float32, 1 = bfloat16; D 32, 64 or 128. Returns a cudaError_t (0 on
// success); 1000 for arguments the kernel does not take.
int skix_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                   const float* cos, const float* sin, const int* rot, int B, int H,
                   int Sq, int Sk, int D,
                   int dtype, long long sqb, long long sqh, long long sqs, long long skb,
                   long long skh, long long sks, long long svb, long long svh, long long svs,
                   long long sob, long long soh, long long sos, float scale_log2, int fixed,
                   float max_log2, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || B > 65535 || H > 65535) return 1000;
  if ((cos == nullptr) != (sin == nullptr) || (cos == nullptr && rot != nullptr)) return 1000;
  const Params p{q,   k,   v,   o,   lse, cos, sin, rot, H,   Sq,         Sk,    sqb,     sqh,
                 sqs, skb, skh, sks, svb, svh, svs, sob, soh, sos, scale_log2, fixed, max_log2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(p, B, D, s);
  if (dtype == 1) return launch_d<__nv_bfloat16>(p, B, D, s);
  return 1000;
}

const char* skix_cuda_error_string(int err) {
  if (err == 1000) return "flash_fwd: unsupported arguments";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
