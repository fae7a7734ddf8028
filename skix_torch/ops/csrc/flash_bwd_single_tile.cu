// Single-tile attention backward for Hopper (sm_90a), plain C interface
// for ctypes.
//
// Replaces the TPU kernel K5, `_bwd_kernel_single_tile` in
// skix/ops/attention.py:691 (launched by `_flash_backward_single_tile`,
// :784): dQ, dK and dV of a sequence that is one tile, in one kernel. Its
// user is the backward of the ViT-Det window blocks, 36 windows x 16 heads
// x 576 tokens x 64 at batch 4, 28 of the 32 blocks. The port launches it
// wherever the forward launched K2 (the single-tile forward), so every
// window block's backward is one launch.
//
// Design. On the TPU the whole (576, 576) tile, q, k, v and dO sit in VMEM
// and one program computes all three gradients. A block of the card holds
// 227 KB: q, k, v and dO are 147 KB each in f32, and dK, dV accumulators
// for 576 keys 295 KB. So one grid holds CTAs of two roles, chosen by
// blockIdx.x (flash_bwd_common.cuh): the first ceil(Sk/64) take a 64-key
// chunk and compute its dK and dV over all q rows; the next ceil(Sq/64)
// take a 64-row chunk and compute its dQ over all keys. 576 = 9*64, so no
// tile is padded (the TPU kernel exists to avoid padding the window to the
// generic kernels' 512-row blocks). No atomics: every gradient element is
// written once, by one CTA, so the result is deterministic.
//
// Bound. 10*B*H*S^2*D operations (five products: s and dP twice, dV, dK,
// dQ) = 1.83 ms at the window shape at 67 TFLOP/s f32, on ~170 MB of f32
// input and output (0.05 ms at 3.35 TB/s): bound by operations. FMA loops,
// as K3 and K4; wgmma is a later step.

#include "flash_bwd_common.cuh"

namespace {

using namespace skix;

template <typename T, int D>
__global__ void __launch_bounds__(BWD_NT) bwd_single_tile_kernel(const BwdParams p, int nk) {
  extern __shared__ __align__(16) float smem[];
  if ((int)blockIdx.x < nk) {
    dkv_tile<T, D>(p, smem, blockIdx.x, blockIdx.y, blockIdx.z);
  } else {
    dq_tile<T, D>(p, smem, blockIdx.x - nk, blockIdx.y, blockIdx.z);
  }
}

template <typename T, int D>
cudaError_t launch(const BwdParams& p, int B, cudaStream_t stream) {
  const size_t a = dkv_smem_floats<D>(), b = dq_smem_floats<D>();
  const size_t smem = sizeof(float) * (a > b ? a : b);
  cudaError_t err = set_smem(bwd_single_tile_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const int nk = (p.Sk + BWD_BK - 1) / BWD_BK, nq = (p.Sq + 63) / 64;
  const dim3 grid(nk + nq, p.H, B);
  bwd_single_tile_kernel<T, D><<<grid, BWD_NT, smem, stream>>>(p, nk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const BwdParams& p, int B, int D, cudaStream_t s) {
  if (D == 32) return launch<T, 32>(p, B, s);
  if (D == 64) return launch<T, 64>(p, B, s);
  if (D == 128) return launch<T, 128>(p, B, s);
  return static_cast<cudaError_t>(1000);
}

}  // namespace

extern "C" {

// Arguments as skix_flash_bwd_dkv (flash_bwd.cu); writes dq, dk and dv.
int skix_flash_bwd_single_tile(const void* q, const void* k, const void* v, const void* dout,
                               const float* lse, const float* di, void* dq, void* dk, void* dv,
                               const float* cos, const float* sin, int B, int H, int Sq, int Sk,
                               int D, int dtype, const long long* strides, float sm_scale,
                               float scale_log2, void* stream) {
  BwdParams p;
  if (!bwd_params(p, q, k, v, dout, lse, di, dq, dk, dv, cos, sin, B, H, Sq, Sk, strides,
                  sm_scale, scale_log2))
    return 1000;
  if (dq == nullptr || dk == nullptr || dv == nullptr) return 1000;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(p, B, D, s);
  if (dtype == 1) return launch_d<__nv_bfloat16>(p, B, D, s);
  return 1000;
}

const char* skix_bwd_single_tile_error_string(int err) {
  if (err == 1000) return "flash_bwd_single_tile: unsupported arguments";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
