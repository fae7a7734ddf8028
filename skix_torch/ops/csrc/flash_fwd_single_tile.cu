// Single-tile attention forward for Hopper (sm_90a), plain C interface for
// ctypes.
//
// Replaces the TPU kernel K2, `_fwd_kernel_single_tile` in
// skix/ops/attention.py:313, which the dispatcher picks (:459-464) when the
// whole sequence is one tile with no padding: the ViT-Det window blocks,
// 9 windows x 16 heads x 576 tokens x 64 per frame, 28 of the 32 blocks. It
// computes the same function with the same roundings as the TPU kernel
// (rope in f32, q times sm_scale*log2e, both rounded to the input type; p
// rounded to v's type before P.V; f32 statistics), with an optional
// base-2 log-partition lse = m + log2(l) (0 where l == 0), one f32 per row.
//
// Design: K1's rope pass and tensor-core core (flash_tc.cuh `attend`:
// wgmma products, P from registers, cp.async-fed K and V tiles, split-TF32
// for float32: lo*hi + hi*lo + hi*hi). It runs the online softmax over the
// window's 9 tiles of 64 keys, not the TPU kernel's exact one-pass softmax:
// a (576, 576) f32 score tile is 1.3 MB, far above a block's 227 KB, and
// holding 128 q rows of scores (295 KB) does not fit either, so the exact
// form would have to form the scores twice. The two forms differ only by
// rounding (the rescaling by exp2(m_old - m_new)) and are held to the same
// tolerances against the plain version. K2 keeps its own entry, launch key
// and dispatch. The TPU version's G heads per grid cell and its VMEM budget
// (:463-482) are TPU blocking and are dropped; the probe variant V_HEADS2
// measures two heads per CTA.
//
// Probes. `skix_window_probe` launches K2 with one compile-time Variant
// (flash_tc.cuh) at D = 64: the card's counterparts of the TPU timing
// probes scripts/bench_window_decomp{,2..6}.py and bench_window_ktrans_ab.py
// (skix_torch/ops/window_probe.py).
//
// Bound. At the window shape the work is 4*B*H*S*S*D = 12.2 GFLOP on
// 4*9*16*576*64*4 B = 85 MB of f32 input and output: in split-TF32 (three
// tf32 products at 495 TFLOP/s) 0.074 ms of operations against 0.025 ms of
// bytes, so operations bound it.

#include "flash_tc.cuh"

namespace {

using namespace skix;

template <typename T, int D, int VAR>
__global__ void __launch_bounds__(Tiles<T, D, VAR>::NT, 1) single_tile_kernel(const FwdParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  if constexpr (VAR == V_HEADS2) {
#pragma unroll 1
    for (int i = 0; i < 2; ++i) {
      const int h = 2 * blockIdx.y + i;
      if (h >= p.H) break;
      if (i > 0) __syncthreads();
      attend<T, D, VAR>(p, blockIdx.x, h, blockIdx.z, smem);
    }
  } else {
    attend<T, D, VAR>(p, blockIdx.x, blockIdx.y, blockIdx.z, smem);
  }
}

template <typename T, int D, int VAR>
cudaError_t launch(const FwdParams& p, int B, cudaStream_t stream) {
  using L = Tiles<T, D, VAR>;
  cudaError_t err = cudaFuncSetAttribute(single_tile_kernel<T, D, VAR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return err;
  const int heads = VAR == V_HEADS2 ? (p.H + 1) / 2 : p.H;
  const dim3 grid((p.Sq + L::BQ - 1) / L::BQ, heads, B);
  single_tile_kernel<T, D, VAR><<<grid, L::NT, L::SMEM, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const FwdParams& p, int B, int D, cudaStream_t s) {
  if (D == 32) return launch<T, 32, V_FULL>(p, B, s);
  if (D == 64) return launch<T, 64, V_FULL>(p, B, s);
  if (D == 128) return launch<T, 128, V_FULL>(p, B, s);
  return static_cast<cudaError_t>(1000);
}

// the probe variants at D = 64
template <typename T>
cudaError_t launch_variant(const FwdParams& p, int B, int variant, cudaStream_t s) {
  switch (variant) {
    case V_FULL: return launch<T, 64, V_FULL>(p, B, s);
    case V_FIXEDMAX: return launch<T, 64, V_FIXEDMAX>(p, B, s);
    case V_NOSOFTMAX: return launch<T, 64, V_NOSOFTMAX>(p, B, s);
    case V_SCORESONLY: return launch<T, 64, V_SCORESONLY>(p, B, s);
    case V_HEADS2: return launch<T, 64, V_HEADS2>(p, B, s);
    default: break;
  }
  if constexpr (sizeof(T) == 4) {
    if (variant == V_PBF16) return launch<T, 64, V_PBF16>(p, B, s);
  } else {
    if (variant == V_VMN) return launch<T, 64, V_VMN>(p, B, s);
  }
  return static_cast<cudaError_t>(1000);
}

int check(const FwdParams& p, int B, int D, int dtype, bool rope) {
  if (B <= 0 || p.H <= 0 || p.Sq <= 0 || p.Sk <= 0 || B > 65535 || p.H > 65535) return 1000;
  if (rope) return 1000;
  if (dtype != 0 && dtype != 1) return 1000;
  if (D != 32 && D != 64 && D != 128) return 1000;
  if (!operands_aligned(p, dtype == 0 ? 4 : 2)) return 1000;
  return 0;
}

}  // namespace

extern "C" {

// q: (B, H, Sq, D), k, v: (B, H, Sk, D), o like q, each with element
// strides (b, h, s) and unit stride along D, bases and strides 16-byte
// aligned; lse: null or a contiguous (B, H, Sq) f32 output; dtype 0 =
// float32, 1 = bfloat16; D 32, 64 or 128; cos, sin, rot: null (the rope
// pass, skix_rope_rows of flash_fwd.cu, ropes q and k first, as for
// skix_flash_fwd). Returns a cudaError_t (0 on success); 1000 for
// arguments the kernel does not take.
int skix_flash_fwd_single_tile(const void* q, const void* k, const void* v, void* o, float* lse,
                               const float* cos, const float* sin, const int* rot, int B, int H,
                               int Sq, int Sk, int D, int dtype, long long sqb, long long sqh, long long sqs,
                               long long skb, long long skh, long long sks, long long svb,
                               long long svh, long long svs, long long sob, long long soh,
                               long long sos, float scale_log2, int fixed, float max_log2,
                               void* stream) {
  const FwdParams p{q,   k,   v,   o,   lse, H,   Sq,  Sk,         sqb,   sqh,     sqs,
                    skb, skh, sks, svb, svh, svs, sob, soh, sos, scale_log2, fixed, max_log2};
  if (const int bad = check(p, B, D, dtype, cos || sin || rot)) return bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(p, B, D, s);
  return launch_d<__nv_bfloat16>(p, B, D, s);
}

// K2 with one probe Variant (flash_tc.cuh; 0 is the production chain), the
// arguments as skix_flash_fwd_single_tile's after `variant`, D = 64.
// V_FIXEDMAX takes its bound from max_log2.
int skix_window_probe(int variant, const void* q, const void* k, const void* v, void* o,
                      float* lse, const float* cos, const float* sin, const int* rot, int B,
                      int H, int Sq, int Sk, int D, int dtype, long long sqb, long long sqh,
                      long long sqs, long long skb, long long skh, long long sks, long long svb,
                      long long svh, long long svs, long long sob, long long soh, long long sos,
                      float scale_log2, int fixed, float max_log2, void* stream) {
  const FwdParams p{q,   k,   v,   o,   lse, H,   Sq,  Sk,         sqb,   sqh,     sqs,
                    skb, skh, sks, svb, svh, svs, sob, soh, sos, scale_log2, fixed, max_log2};
  if (const int bad = check(p, B, D, dtype, cos || sin || rot)) return bad;
  if (D != 64) return 1000;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_variant<float>(p, B, variant, s);
  return launch_variant<__nv_bfloat16>(p, B, variant, s);
}

const char* skix_single_tile_error_string(int err) {
  if (err == 1000) return "flash_fwd_single_tile: unsupported arguments";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
