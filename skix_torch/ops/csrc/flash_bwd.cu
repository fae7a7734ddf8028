// Flash-attention backward for Hopper (sm_90a), plain C interface for
// ctypes: two kernels, launched one after the other on the same stream.
//
// Replaces the TPU kernels
//   K3 `_bwd_dkv_kernel` (skix/ops/attention.py:558, launched at :897):
//      dK, dV per kv tile, looping over the q tiles;
//   K4 `_bwd_dq_kernel` (:631, launched at :930): dQ per q tile, looping
//      over the kv tiles;
// the VJP of the flash forward (K1) for every sequence that is not one
// tile: the ViT-Det global blocks (S = 5184, rope) and the fusion
// encoder's self-attention (S = 5184, D = 32) in training. di = sum_d o*dO
// (f32, one per q row) is computed by the caller, as skix does at :821,
// and q and k come roped and rounded from the forward's rope pass.
//
// Design: the tensor-core core of flash_bwd_tc.cuh. K3 is a grid of its
// dkv role, one warpgroup per (64-key tile, head, batch row): K and V held
// as wgmma A operands (in float32 up to D = 64 K's tf32 hi copy in
// registers), q and dO streamed by cp.async in tiles of 32 rows (64 at
// D = 32 and in bf16 up to D = 64); S^T and dP^T with the keys as M, so
// p^T and dS^T feed dV and dK as register operands; each tile's dV and dK
// added to f32 totals (dV's in shared memory in float32 at D = 64). K4 is
// a grid of its dq role, one warpgroup per (64-row q tile, head, batch
// row): Q_s and dO held (in float32 up to D = 64 their hi copies in
// registers), k and v streamed. No atomics: each gradient element is
// written once, so the result is deterministic. Ragged S on either axis
// is masked (p = 0 past Sq and past Sk); nothing is padded in memory. dK
// and dQ are scaled at the store and, with rope, un-rotated there.
//
// Bound. K3 does 8*B*H*Sq*Sk*D operations (S^T, dP^T, dV, dK), K4 6*...
// (S, dP, dQ) on a few tens of MB of input: at S = 5184 operations bound
// both. In split-TF32 (three tf32 products at 495 TFLOP/s) that is 5.34 ms
// (K3) and 4.00 ms (K4) at the global blocks' shape (4, 16, 5184, 64), and
// in bf16 one product at 989 TFLOP/s. A CTA stages every streamed tile
// (the hi/lo split, a transposed copy) in lockstep with its products, and
// shared-memory bandwidth bounds its ss products (A and B both read from
// it; hence the resident hi copies in registers). In float32 up to D = 64
// a CTA takes at most 115,712 bytes of shared memory and 255 registers, so
// two share an SM and each one's staging, softmax and waits run under the
// other's products.

#include "flash_bwd_tc.cuh"

namespace {

using namespace skix;

template <typename T, int D, bool TB>
__global__ void __launch_bounds__(BWD_NT, 2) flash_bwd_dkv_kernel(const BwdParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bwd_dkv<T, D, TB>(p, smem, blockIdx.x, blockIdx.y, blockIdx.z);
}

template <typename T, int D, bool TB>
__global__ void __launch_bounds__(BWD_NT, 2) flash_bwd_dq_kernel(const BwdParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bwd_dq<T, D, TB>(p, smem, blockIdx.x, blockIdx.y, blockIdx.z);
}

template <typename T, int D, bool TB>
cudaError_t launch(const BwdParams& p, int B, bool dkv, cudaStream_t stream) {
  if (dkv) {
    constexpr int smem = BwdTiles<T, D, true>::SMEM;
    cudaError_t err = set_smem(flash_bwd_dkv_kernel<T, D, TB>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.Sk + 63) / 64, p.H, B);
    flash_bwd_dkv_kernel<T, D, TB><<<grid, BWD_NT, smem, stream>>>(p);
  } else {
    constexpr int smem = BwdTiles<T, D, false>::SMEM;
    cudaError_t err = set_smem(flash_bwd_dq_kernel<T, D, TB>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.Sq + 63) / 64, p.H, B);
    flash_bwd_dq_kernel<T, D, TB><<<grid, BWD_NT, smem, stream>>>(p);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const BwdParams& p, int B, int D, bool dkv, cudaStream_t s) {
  if (D == 32) return p.rot != nullptr ? launch<T, 32, true>(p, B, dkv, s)
                          : launch<T, 32, false>(p, B, dkv, s);
  if (D == 64) return p.rot != nullptr ? launch<T, 64, true>(p, B, dkv, s)
                          : launch<T, 64, false>(p, B, dkv, s);
  if (D == 128) return p.rot != nullptr ? launch<T, 128, true>(p, B, dkv, s)
                          : launch<T, 128, false>(p, B, dkv, s);
  return static_cast<cudaError_t>(1000);
}

int entry(bool dkv, const void* q, const void* k, const void* v, const void* dout,
          const float* lse, const float* di, void* dq, void* dk, void* dv, const float* cos,
          const float* sin, const int* rot, int B, int H, int Sq, int Sk, int D, int dtype,
          const long long* strides, float sm_scale, float scale_log2, void* stream) {
  if (dtype != 0 && dtype != 1) return 1000;
  BwdParams p;
  if (!bwd_params(p, q, k, v, dout, lse, di, dq, dk, dv, cos, sin, rot, B, H, Sq, Sk,
                  dtype == 0 ? 4 : 2, strides, sm_scale, scale_log2))
    return 1000;
  if (dkv ? (dk == nullptr || dv == nullptr) : dq == nullptr) return 1000;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(p, B, D, dkv, s);
  return launch_d<__nv_bfloat16>(p, B, D, dkv, s);
}

}  // namespace

extern "C" {

// q, dO, dq: (B, H, Sq, D); k, v, dk, dv: (B, H, Sk, D); each with element
// strides (b, h, s) in `strides` (21 values: q, k, v, dO, dq, dk, dv) and
// unit stride along D, bases and strides 16-byte aligned. q and k are the
// roped q and k rounded to the dtype (the rope pass, skix_rope_rows), or
// q and k themselves without rope. lse, di: contiguous (B, H, Sq) f32, lse
// in base 2 as the forward wrote it. dtype 0 = float32, 1 = bfloat16; D
// 32, 64 or 128; cos/sin: null, or the (S, D) f32 rope tables (Sq == Sk)
// that un-rotate dq and dk at the store, with rot null for rotate-half or
// the (D,) int32 rotation codes of another style (flash_common.cuh
// rot_at). K3 writes dk and dv (dq unused), K4 writes dq (dk, dv unused).
// Returns a cudaError_t (0 on success); 1000 for arguments the kernels do
// not take.
int skix_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* di, void* dq, void* dk, void* dv,
                       const float* cos, const float* sin, const int* rot, int B, int H,
                       int Sq, int Sk, int D, int dtype, const long long* strides,
                       float sm_scale, float scale_log2, void* stream) {
  return entry(true, q, k, v, dout, lse, di, dq, dk, dv, cos, sin, rot, B, H, Sq, Sk, D, dtype,
               strides, sm_scale, scale_log2, stream);
}

int skix_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* di, void* dq, void* dk, void* dv,
                      const float* cos, const float* sin, const int* rot, int B, int H,
                      int Sq, int Sk, int D, int dtype, const long long* strides,
                      float sm_scale, float scale_log2, void* stream) {
  return entry(false, q, k, v, dout, lse, di, dq, dk, dv, cos, sin, rot, B, H, Sq, Sk, D, dtype,
               strides, sm_scale, scale_log2, stream);
}

// Dynamic shared memory (bytes) of one CTA of K3 (dkv 1) or K4 (dkv 0) at
// head dim D and dtype (0 = float32, 1 = bfloat16); -1 otherwise.
long long skix_flash_bwd_smem_bytes(int D, int dtype, int dkv) {
  if (dtype == 0) {
    if (D == 32) return dkv ? BwdTiles<float, 32, true>::SMEM : BwdTiles<float, 32, false>::SMEM;
    if (D == 64) return dkv ? BwdTiles<float, 64, true>::SMEM : BwdTiles<float, 64, false>::SMEM;
    if (D == 128) return dkv ? BwdTiles<float, 128, true>::SMEM : BwdTiles<float, 128, false>::SMEM;
  } else if (dtype == 1) {
    using H = __nv_bfloat16;
    if (D == 32) return dkv ? BwdTiles<H, 32, true>::SMEM : BwdTiles<H, 32, false>::SMEM;
    if (D == 64) return dkv ? BwdTiles<H, 64, true>::SMEM : BwdTiles<H, 64, false>::SMEM;
    if (D == 128) return dkv ? BwdTiles<H, 128, true>::SMEM : BwdTiles<H, 128, false>::SMEM;
  }
  return -1;
}

const char* skix_flash_bwd_error_string(int err) {
  if (err == 1000) return "flash_bwd: unsupported arguments";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
