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
// 227 KB: q, k, v and dO are 147 KB each in f32, and the dK, dV
// accumulators of 576 keys 295 KB. So one grid holds CTAs of the two roles
// of the tensor-core core (flash_bwd_tc.cuh), chosen by blockIdx.x: the
// first ceil(Sk/64) take 64 keys and compute their dK and dV over all q
// rows (K and V held, q and dO streamed; p^T and dS^T from the
// accumulator fragment feed dV and dK as register operands); the next
// ceil(Sq/64) take 64 q rows and compute their dQ over all keys. S and dP
// are formed by both roles. 576 = 9*64, so no tile is padded. No atomics:
// every gradient element is written once, by one CTA, so the result is
// deterministic.
//
// Bound. 10*B*H*S^2*D operations (five products: S, dP, dV, dK, dQ) =
// 1.22e11 at the window shape: 0.741 ms in split-TF32 (three tf32
// products at 495 TFLOP/s), on ~170 MB of f32 input and output (0.05 ms at
// 3.35 TB/s): bound by operations. The two roles form S and dP twice, 14
// of the 10 product units, and stage each streamed tile in lockstep with
// its products; in float32 at D = 64 both roles fit two CTAs to an SM,
// which hide each other's staging (flash_bwd.cu).

#include "flash_bwd_tc.cuh"

namespace {

using namespace skix;

template <typename T, int D, bool TB>
__global__ void __launch_bounds__(BWD_NT, 2) bwd_single_tile_kernel(const BwdParams p, int nk) {
  extern __shared__ __align__(128) unsigned char smem[];
  if ((int)blockIdx.x < nk) {
    bwd_dkv<T, D, TB>(p, smem, blockIdx.x, blockIdx.y, blockIdx.z);
  } else {
    bwd_dq<T, D, TB>(p, smem, blockIdx.x - nk, blockIdx.y, blockIdx.z);
  }
}

template <typename T, int D, bool TB>
cudaError_t launch(const BwdParams& p, int B, cudaStream_t stream) {
  constexpr int smem = bwd_single_tile_smem<T, D>();
  cudaError_t err = set_smem(bwd_single_tile_kernel<T, D, TB>, smem);
  if (err != cudaSuccess) return err;
  const int nk = (p.Sk + 63) / 64, nq = (p.Sq + 63) / 64;
  const dim3 grid(nk + nq, p.H, B);
  bwd_single_tile_kernel<T, D, TB><<<grid, BWD_NT, smem, stream>>>(p, nk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const BwdParams& p, int B, int D, cudaStream_t s) {
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

// Arguments as skix_flash_bwd_dkv (flash_bwd.cu); writes dq, dk and dv.
int skix_flash_bwd_single_tile(const void* q, const void* k, const void* v, const void* dout,
                               const float* lse, const float* di, void* dq, void* dk, void* dv,
                               const float* cos, const float* sin, const int* rot, int B, int H,
                               int Sq, int Sk, int D, int dtype, const long long* strides,
                               float sm_scale, float scale_log2, void* stream) {
  if (dtype != 0 && dtype != 1) return 1000;
  BwdParams p;
  if (!bwd_params(p, q, k, v, dout, lse, di, dq, dk, dv, cos, sin, rot, B, H, Sq, Sk,
                  dtype == 0 ? 4 : 2, strides, sm_scale, scale_log2))
    return 1000;
  if (dq == nullptr || dk == nullptr || dv == nullptr) return 1000;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(p, B, D, s);
  return launch_d<__nv_bfloat16>(p, B, D, s);
}

// Dynamic shared memory (bytes) of one CTA of K5 at head dim D and dtype
// (0 = float32, 1 = bfloat16); -1 otherwise.
long long skix_bwd_single_tile_smem_bytes(int D, int dtype) {
  if (dtype == 0) {
    if (D == 32) return bwd_single_tile_smem<float, 32>();
    if (D == 64) return bwd_single_tile_smem<float, 64>();
    if (D == 128) return bwd_single_tile_smem<float, 128>();
  } else if (dtype == 1) {
    if (D == 32) return bwd_single_tile_smem<__nv_bfloat16, 32>();
    if (D == 64) return bwd_single_tile_smem<__nv_bfloat16, 64>();
    if (D == 128) return bwd_single_tile_smem<__nv_bfloat16, 128>();
  }
  return -1;
}

const char* skix_bwd_single_tile_error_string(int err) {
  if (err == 1000) return "flash_bwd_single_tile: unsupported arguments";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
