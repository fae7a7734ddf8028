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
// (f32, one per q row) is computed by the caller, as skix does at :821.
//
// Design (flash_bwd_common.cuh). K3: one CTA of 256 threads per (64-key
// tile, head, batch row) holds the roped k and the v tile in shared memory
// and the f32 dK, dV accumulators in registers (thread: 4 keys x D/16
// columns of each), and streams q and dO in 64-row tiles (32 at D = 128):
// scores and dP as two f32 FMA loops over D, p and dS formed in registers
// and written to shared memory, then dV += P^T dO and dK += dS^T q as FMA
// loops over the tile's rows. K4: one CTA per (64-row q tile, head, batch
// row) holds its scaled q and dO, streams k and v in 64-row tiles, and
// accumulates dQ += dS k the same way. Ragged S on either axis is masked
// (p = 0 past Sq and past Sk); nothing is padded in memory. dK and dQ are
// scaled at the store and, with rope, un-rotated there.
//
// Bound. K3 does 8*B*H*Sq*Sk*D operations (four products), K4 6*... (three)
// on a few tens of MB of input: at S = 5184 operations bound both, 13.1 ms
// (K3) and 9.9 ms (K4) at the global blocks' shape at 67 TFLOP/s f32. The
// loops run on the FMA units, not the tensor cores; wgmma is a later step.

#include "flash_bwd_common.cuh"

namespace {

using namespace skix;

template <typename T, int D>
__global__ void __launch_bounds__(BWD_NT) flash_bwd_dkv_kernel(const BwdParams p) {
  extern __shared__ __align__(16) float smem[];
  dkv_tile<T, D>(p, smem, blockIdx.x, blockIdx.y, blockIdx.z);
}

template <typename T, int D>
__global__ void __launch_bounds__(BWD_NT) flash_bwd_dq_kernel(const BwdParams p) {
  extern __shared__ __align__(16) float smem[];
  dq_tile<T, D>(p, smem, blockIdx.x, blockIdx.y, blockIdx.z);
}

template <typename T, int D>
cudaError_t launch(const BwdParams& p, int B, bool dkv, cudaStream_t stream) {
  if (dkv) {
    const size_t smem = sizeof(float) * dkv_smem_floats<D>();
    cudaError_t err = set_smem(flash_bwd_dkv_kernel<T, D>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.Sk + BWD_BK - 1) / BWD_BK, p.H, B);
    flash_bwd_dkv_kernel<T, D><<<grid, BWD_NT, smem, stream>>>(p);
  } else {
    const size_t smem = sizeof(float) * dq_smem_floats<D>();
    cudaError_t err = set_smem(flash_bwd_dq_kernel<T, D>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.Sq + 63) / 64, p.H, B);
    flash_bwd_dq_kernel<T, D><<<grid, BWD_NT, smem, stream>>>(p);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const BwdParams& p, int B, int D, bool dkv, cudaStream_t s) {
  if (D == 32) return launch<T, 32>(p, B, dkv, s);
  if (D == 64) return launch<T, 64>(p, B, dkv, s);
  if (D == 128) return launch<T, 128>(p, B, dkv, s);
  return static_cast<cudaError_t>(1000);
}

int entry(bool dkv, const void* q, const void* k, const void* v, const void* dout,
          const float* lse, const float* di, void* dq, void* dk, void* dv, const float* cos,
          const float* sin, int B, int H, int Sq, int Sk, int D, int dtype,
          const long long* strides, float sm_scale, float scale_log2, void* stream) {
  BwdParams p;
  if (!bwd_params(p, q, k, v, dout, lse, di, dq, dk, dv, cos, sin, B, H, Sq, Sk, strides,
                  sm_scale, scale_log2))
    return 1000;
  if (dkv ? (dk == nullptr || dv == nullptr) : dq == nullptr) return 1000;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(p, B, D, dkv, s);
  if (dtype == 1) return launch_d<__nv_bfloat16>(p, B, D, dkv, s);
  return 1000;
}

}  // namespace

extern "C" {

// q, dO, dq: (B, H, Sq, D); k, v, dk, dv: (B, H, Sk, D); each with element
// strides (b, h, s) in `strides` (21 values: q, k, v, dO, dq, dk, dv) and
// unit stride along D. lse, di: contiguous (B, H, Sq) f32, lse in base 2 as
// the forward wrote it. dtype 0 = float32, 1 = bfloat16; D 32, 64 or 128;
// rope tables (S, D) f32 need Sq == Sk. K3 writes dk and dv (dq unused), K4
// writes dq (dk, dv unused). Returns a cudaError_t (0 on success); 1000 for
// arguments the kernels do not take.
int skix_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* di, void* dq, void* dk, void* dv,
                       const float* cos, const float* sin, int B, int H, int Sq, int Sk, int D,
                       int dtype, const long long* strides, float sm_scale, float scale_log2,
                       void* stream) {
  return entry(true, q, k, v, dout, lse, di, dq, dk, dv, cos, sin, B, H, Sq, Sk, D, dtype,
               strides, sm_scale, scale_log2, stream);
}

int skix_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* di, void* dq, void* dk, void* dv,
                      const float* cos, const float* sin, int B, int H, int Sq, int Sk, int D,
                      int dtype, const long long* strides, float sm_scale, float scale_log2,
                      void* stream) {
  return entry(false, q, k, v, dout, lse, di, dq, dk, dv, cos, sin, B, H, Sq, Sk, D, dtype,
               strides, sm_scale, scale_log2, stream);
}

const char* skix_flash_bwd_error_string(int err) {
  if (err == 1000) return "flash_bwd: unsupported arguments";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
