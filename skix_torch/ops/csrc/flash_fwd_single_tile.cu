// Single-tile attention forward for Hopper (sm_90a), plain C interface for
// ctypes.
//
// Replaces the TPU kernel K2, `_fwd_kernel_single_tile` in
// skix/ops/attention.py:313, which the dispatcher picks (:459-464) when the
// whole sequence is one tile with no padding: the ViT-Det window blocks,
// 9 windows x 16 heads x 576 tokens x 64 per frame, 28 of the 32 blocks. It
// computes the same function, not the TPU's blocking: an EXACT one-pass
// softmax in base 2, no online rescaling. For each q row the whole score
// row over all Sk keys is formed, then its max (or the fixed bound
// fixed_max*log2e), then p = exp2(s - m), l = sum(p) in f32, then P.V with
// p rounded to v's type, and the output is acc / l (l == 0 guarded). The
// roundings repeat the TPU kernel's: rope in f32, q times sm_scale*log2e,
// both rounded to the input type. An optional base-2 log-partition
// lse = m + log2(l) (0 where l == 0) is written as one f32 per row.
//
// Design. A (576, 576) f32 score tile is 1.3 MB, far above the 227 KB of
// shared memory a block may hold, so the q rows are tiled: one CTA of 256
// threads per (32-row q tile, head, batch) keeps the 32 x Sk f32 score rows
// in shared memory (74 KB at Sk = 576, ~100 KB in all, two CTAs per SM).
// Phase 1 streams K through shared memory in 64-key chunks (roped and
// rounded as it is loaded) and writes the scores; thread t owns rows
// 2*(t/16)..+1 and columns 4*(t%16)..+3 of each 32 x 64 chunk. Phase 2 is
// one warp per 4 rows: row max, exp2, row sum, p rounded in place. Phase 3
// streams V in 64-row chunks and accumulates P.V into a 2 x (D/16) f32
// accumulator per thread. The TPU version's G heads per grid cell and its
// VMEM budget (:463-482) are TPU blocking and are dropped.
//
// Bound. At the window shape the work is 4*B*H*S*S*D = 12.2 GFLOP on
// 4*9*16*576*64*4 B = 85 MB of f32 input and output: 0.18 ms of f32
// operations at 67 TFLOP/s against 0.025 ms of bytes, so operations bound
// it. The products run on the f32 FMA units; wgmma is the later step.

#include "flash_common.cuh"

namespace {

using namespace skix;

constexpr int BQ = 32;        // q rows per CTA
constexpr int BK = 64;        // keys (and v rows) per streamed chunk
constexpr int NT = 256;       // threads per CTA
constexpr int NW = NT / 32;   // warps per CTA
constexpr int LQ = BQ + 4;    // row length (floats) of the transposed q tile
constexpr int LK = BK + 4;    // row length (floats) of the transposed k chunk

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;        // (B, H, Sq) f32, contiguous, or null
  const float* cos;  // (S, D) or null
  const float* sin;
  const int* rot;    // (D,) rotation codes of the rope's style; null: rotate-half
  int H, Sq, Sk, LS;  // LS: row length (floats) of the score rows
  long long sqb, sqh, sqs, skb, skh, sks, svb, svh, svs, sob, soh, sos;
  float scale_log2;  // sm_scale * log2(e), rounded to f32
  int fixed;         // fixed-max mode
  float max_log2;    // fixed_max * log2(e), rounded to f32
};

template <int D> __host__ __device__ constexpr int chunk_floats() {
  return (D * LK > BK * (D + 4)) ? D * LK : BK * (D + 4);
}

template <typename T, int D, bool TB>
__global__ void __launch_bounds__(NT) single_tile_kernel(const Params p) {
  constexpr int LV = D + 4;     // row length (floats) of the v chunk
  constexpr int CPT = D / 16;   // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                      // [D][LQ]   q tile, transposed
  float* KV = Qt + D * LQ;               // [D][LK] k chunk, transposed | [BK][LV] v chunk
  float* Ss = KV + chunk_floats<D>();    // [BQ][LS]  scores, then p
  float* Ls = Ss + BQ * p.LS;            // [BQ]      row sums

  const int tid = threadIdx.x;
  const int rg = tid / 16, cg = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int qrows = min(BQ, p.Sq - q0);
  const T* qh = static_cast<const T*>(p.q) + b * p.sqb + h * p.sqh;
  const T* kh = static_cast<const T*>(p.k) + b * p.skb + h * p.skh;
  const T* vh = static_cast<const T*>(p.v) + b * p.svb + h * p.svh;
  T* oh = static_cast<T*>(p.o) + b * p.sob + h * p.soh;

  load_rows_t<T, D, BQ, LQ, NT, TB>(Qt, qh, p.sqs, q0, qrows, p.cos, p.sin, p.rot, true, p.scale_log2);

  // phase 1: scores s = q.k (base-2 logits) for all Sk keys
  for (int k0 = 0; k0 < p.Sk; k0 += BK) {
    const int kr = min(BK, p.Sk - k0);
    __syncthreads();  // the previous chunk's readers are done
    load_rows_t<T, D, BK, LK, NT, TB>(KV, kh, p.sks, k0, kr, p.cos, p.sin, p.rot, false, 1.f);
    __syncthreads();
    float s[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float2 a = *reinterpret_cast<const float2*>(&Qt[d * LQ + rg * 2]);
      const float4 c = *reinterpret_cast<const float4*>(&KV[d * LK + cg * 4]);
      const float av[2] = {a.x, a.y};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float4*>(&Ss[(rg * 2 + i) * p.LS + k0 + cg * 4]) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
  }
  __syncthreads();

  // phase 2: exact softmax statistics, one warp per BQ / NW rows
  for (int r = warp; r < BQ; r += NW) {
    float* row = Ss + r * p.LS;
    float m = p.max_log2;
    if (!p.fixed) {
      m = -INFINITY;
      for (int c = lane; c < p.Sk; c += 32) m = fmaxf(m, row[c]);
      m = warp_max(m);
    }
    float l = 0.f;
    for (int c = lane; c < p.Sk; c += 32) {
      const float e = exp2f(row[c] - m);
      l += e;
      row[c] = round_to<T>(e);  // p rounded to v's type for P.V
    }
    l = warp_sum(l);
    if (lane == 0) {
      Ls[r] = l;
      const int qrow = q0 + r;
      if (p.lse != nullptr && r < qrows)
        p.lse[((long long)b * p.H + h) * p.Sq + qrow] = l > 0.f ? m + log2f(l) : 0.f;
    }
  }

  // phase 3: P.V over 64-row chunks of v
  float acc[2][CPT];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  for (int v0 = 0; v0 < p.Sk; v0 += BK) {
    const int vr = min(BK, p.Sk - v0);
    __syncthreads();  // phase 2, or the previous chunk's readers, are done
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int r = idx / D, d = idx % D;
      KV[r * LV + d] = r < vr ? to_f32(vh[(long long)(v0 + r) * p.svs + d]) : 0.f;
    }
    __syncthreads();
    const float* p0 = Ss + (rg * 2) * p.LS + v0;
#pragma unroll 4
    for (int kk = 0; kk < vr; ++kk) {
      const float a[2] = {p0[kk], p0[p.LS + kk]};
      pv_update<D, 2>(acc, a, &KV[kk * LV], cg);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = rg * 2 + i;
    if (r >= qrows) continue;
    const float l = Ls[r];
    const float div = l == 0.f ? 1.f : l;
    T* orow = oh + (long long)(q0 + r) * p.sos;
#pragma unroll
    for (int j = 0; j < CPT; ++j) orow[out_col<D>(cg, j)] = from_f32<T>(acc[i][j] / div);
  }
}

template <int D> size_t smem_bytes(int LS) {
  return sizeof(float) * ((size_t)D * LQ + chunk_floats<D>() + (size_t)BQ * LS + BQ);
}

template <typename T, int D, bool TB>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(p.LS);
  cudaError_t err = cudaFuncSetAttribute(single_tile_kernel<T, D, TB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, B);
  single_tile_kernel<T, D, TB><<<grid, NT, smem, stream>>>(p);
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

// Shared memory (bytes) one CTA needs for Sk keys at head dim D; the
// wrapper refuses a call above the card's per-block limit.
long long skix_single_tile_smem_bytes(int Sk, int D) {
  const int LS = ((Sk + BK - 1) / BK) * BK + 4;
  if (D == 32) return (long long)smem_bytes<32>(LS);
  if (D == 64) return (long long)smem_bytes<64>(LS);
  if (D == 128) return (long long)smem_bytes<128>(LS);
  return -1;
}

// q: (B, H, Sq, D), k, v: (B, H, Sk, D), o like q, each with element
// strides (b, h, s) and unit stride along D; lse: null or a contiguous
// (B, H, Sq) f32 output; dtype 0 = float32, 1 = bfloat16; D 32, 64 or 128;
// rope: all null, or (S, D) f32 cos/sin tables (Sq == Sk) and rot (as
// skix_flash_fwd). Returns a cudaError_t (0 on success);
// 1000 for arguments the kernel does not take.
int skix_flash_fwd_single_tile(const void* q, const void* k, const void* v, void* o, float* lse,
                               const float* cos, const float* sin, const int* rot, int B, int H,
                               int Sq, int Sk, int D, int dtype, long long sqb, long long sqh, long long sqs,
                               long long skb, long long skh, long long sks, long long svb,
                               long long svh, long long svs, long long sob, long long soh,
                               long long sos, float scale_log2, int fixed, float max_log2,
                               void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || B > 65535 || H > 65535) return 1000;
  if ((cos == nullptr) != (sin == nullptr) || (cos == nullptr && rot != nullptr)) return 1000;
  if (cos != nullptr && Sq != Sk) return 1000;
  const int LS = ((Sk + BK - 1) / BK) * BK + 4;
  const Params p{q,   k,   v,   o,   lse, cos, sin, rot, H,   Sq,  Sk,         LS,    sqb,     sqh,
                 sqs, skb, skh, sks, svb, svh, svs, sob, soh, sos, scale_log2, fixed, max_log2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(p, B, D, s);
  if (dtype == 1) return launch_d<__nv_bfloat16>(p, B, D, s);
  return 1000;
}

const char* skix_single_tile_error_string(int err) {
  if (err == 1000) return "flash_fwd_single_tile: unsupported arguments";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
