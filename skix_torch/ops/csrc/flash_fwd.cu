// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel K1, `_fwd_kernel` in skix/ops/attention.py:184:
// softmax(scale * Q K^T) V with an online softmax in base 2, f32 statistics
// (m, l) and f32 accumulator, a ragged-edge mask, an optional fixed logit
// bound (no running max), an optional rope fused from (S, D) cos/sin tables
// in any of skix's three styles (rotate-half by index; interleaved pairs and
// rotate-half per segment by a (D,) code table; flash_common.cuh rot_at),
// and an optional base-2 log-partition output lse = m + log2(l) (0 where
// l == 0), as the TPU kernel's residual store (attention.py:297-305)
// computes it, one f32 per row.
//
// Design: the rope pass (rope_rows_kernel, skix_rope_rows) ropes and
// rounds q and k once per call; then the tensor-core core of flash_tc.cuh
// (`attend`). One CTA of two
// warpgroups per (128-row q tile, head, batch) (f32 at D = 128: one
// warpgroup and 32-key tiles, for shared memory); S = Q K^T and O += P V
// run on wgmma, P from registers; K and V tiles arrive by cp.async one tile
// ahead and are roped, rounded and laid out as wgmma operands in shared
// memory. The roundings are the TPU kernel's: q roped in f32, times
// scale*log2e, rounded to the input type; k roped in f32, rounded; p rounded
// to v's type before P.V; m, l and acc in f32. Strides are per (batch,
// head, row), so a q shared by every batch row (the memory tracker's first
// layer) comes in with batch stride 0, uncopied, and the output may be
// token-major.
//
// float32 runs as split-TF32: each operand x = hi + lo with hi = tf32(x)
// and lo = tf32(x - hi), each product the three tf32 wgmmas lo*hi + hi*lo +
// hi*hi, summed in f32; the dropped lo*lo term is below 2^-22 of |a||b|.
// Emulated on the CPU (tests/test_torch_attention_tc.py) this split holds
// o and lse within 1e-5 of the plain version at the tracker's 4096+ keys;
// on the card the largest max |kernel - plain| of chip_smoke.py's float32
// cases is in PERF.md (kernel table).
//
// Bound. At the VGGT shapes (S = 1374 and 2748, D = 64), the ViT-Det global
// blocks (S = 5184) and the memory tracker (15876 x 63504) the work is
// 4*B*H*Sq*Sk*D operations on at most a few hundred MB of input, so the
// kernel is bound by operations: 989 TFLOP/s in bf16, 495 / 3 in split-TF32.

#include "flash_tc.cuh"

namespace {

using namespace skix;

template <typename T, int D>
__global__ void __launch_bounds__(Tiles<T, D, V_FULL>::NT, 1) flash_fwd_kernel(const FwdParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  attend<T, D, V_FULL>(p, blockIdx.x, blockIdx.y, blockIdx.z, smem);
}

template <typename T, int D>
cudaError_t launch(const FwdParams& p, int B, cudaStream_t stream) {
  using L = Tiles<T, D, V_FULL>;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + L::BQ - 1) / L::BQ, p.H, B);
  flash_fwd_kernel<T, D><<<grid, L::NT, L::SMEM, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const FwdParams& p, int B, int D, cudaStream_t s) {
  if (D == 32) return launch<T, 32>(p, B, s);
  if (D == 64) return launch<T, 64>(p, B, s);
  if (D == 128) return launch<T, 128>(p, B, s);
  return static_cast<cudaError_t>(1000);
}

template <typename T, int D>
cudaError_t rope_d(const T* x, T* out, const float* cos, const float* sin, const int* rot, int B,
                   int H, int S, long long sb, long long sh, long long ss, int mul_on, float mul,
                   cudaStream_t stream) {
  const long long chunks = (long long)S * (D / (16 / (int)sizeof(T)));
  const dim3 grid((unsigned)((chunks + 255) / 256), H, B);
  if (rot != nullptr)
    rope_rows_kernel<T, D, true><<<grid, 256, 0, stream>>>(x, out, cos, sin, rot, H, S, sb, sh, ss,
                                                           mul_on, mul);
  else
    rope_rows_kernel<T, D, false><<<grid, 256, 0, stream>>>(x, out, cos, sin, rot, H, S, sb, sh,
                                                            ss, mul_on, mul);
  return cudaGetLastError();
}

template <typename T>
cudaError_t rope_t(const void* x, void* out, const float* cos, const float* sin, const int* rot,
                   int B, int H, int S, int D, long long sb, long long sh, long long ss, int mul_on,
                   float mul, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (D == 32) return rope_d<T, 32>(xt, ot, cos, sin, rot, B, H, S, sb, sh, ss, mul_on, mul, s);
  if (D == 64) return rope_d<T, 64>(xt, ot, cos, sin, rot, B, H, S, sb, sh, ss, mul_on, mul, s);
  if (D == 128) return rope_d<T, 128>(xt, ot, cos, sin, rot, B, H, S, sb, sh, ss, mul_on, mul, s);
  return static_cast<cudaError_t>(1000);
}

}  // namespace

extern "C" {

// q, k, v, o: (B, H, S, D) with element strides (b, h, s) and unit stride
// along D, base and strides 16-byte aligned; lse: null or a contiguous
// (B, H, Sq) f32 output; cos, sin, rot: null (a roped q and k come from
// skix_rope_rows first, q then already times sm_scale*log2e and
// scale_log2 1); dtype 0 = float32, 1 = bfloat16; D 32, 64 or 128. Returns
// a cudaError_t (0 on success); 1000 for arguments the kernel does not
// take.
int skix_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                   const float* cos, const float* sin, const int* rot, int B, int H,
                   int Sq, int Sk, int D,
                   int dtype, long long sqb, long long sqh, long long sqs, long long skb,
                   long long skh, long long sks, long long svb, long long svh, long long svs,
                   long long sob, long long soh, long long sos, float scale_log2, int fixed,
                   float max_log2, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || B > 65535 || H > 65535) return 1000;
  if (cos || sin || rot) return 1000;
  const FwdParams p{q,   k,   v,   o,   lse, H,   Sq,  Sk,         sqb,   sqh,     sqs,
                    skb, skh, sks, svb, svh, svs, sob, soh, sos, scale_log2, fixed, max_log2};
  if (dtype != 0 && dtype != 1) return 1000;
  if (!operands_aligned(p, dtype == 0 ? 4 : 2)) return 1000;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(p, B, D, s);
  if (dtype == 1) return launch_d<__nv_bfloat16>(p, B, D, s);
  return 1000;
}

// The rope pass of K1 and K2 (rope_rows_kernel): out = x*cos + rot(x)*sin
// in f32, times mul where mul_on, rounded to the dtype; x (B, H, S, D) with
// element strides (b, h, s), 16-byte aligned, out contiguous; cos, sin (S,
// D) f32, rot null for rotate-half or the (D,) int32 codes of another
// style. Returns a cudaError_t (0 on success); 1000 for arguments it does
// not take.
int skix_rope_rows(const void* x, void* out, const float* cos, const float* sin, const int* rot,
                   int B, int H, int S, int D, int dtype, long long sb, long long sh, long long ss,
                   int mul_on, float mul, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || B > 65535 || H > 65535) return 1000;
  if (cos == nullptr || sin == nullptr) return 1000;
  const int item = dtype == 0 ? 4 : 2;
  const void* ptrs[4] = {x, out, cos, sin};
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return 1000;
  if ((sb * item) % 16 != 0 || (sh * item) % 16 != 0 || (ss * item) % 16 != 0) return 1000;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return rope_t<float>(x, out, cos, sin, rot, B, H, S, D, sb, sh, ss, mul_on, mul, s);
  if (dtype == 1)
    return rope_t<__nv_bfloat16>(x, out, cos, sin, rot, B, H, S, D, sb, sh, ss, mul_on, mul, s);
  return 1000;
}

// Dynamic shared memory (bytes) of one CTA of K1 (and of K2, the same
// core) at head dim D and dtype (0 = float32, 1 = bfloat16); -1 otherwise.
long long skix_flash_fwd_smem_bytes(int D, int dtype) {
  if (dtype == 0) {
    if (D == 32) return Tiles<float, 32, V_FULL>::SMEM;
    if (D == 64) return Tiles<float, 64, V_FULL>::SMEM;
    if (D == 128) return Tiles<float, 128, V_FULL>::SMEM;
  } else if (dtype == 1) {
    if (D == 32) return Tiles<__nv_bfloat16, 32, V_FULL>::SMEM;
    if (D == 64) return Tiles<__nv_bfloat16, 64, V_FULL>::SMEM;
    if (D == 128) return Tiles<__nv_bfloat16, 128, V_FULL>::SMEM;
  }
  return -1;
}

const char* skix_cuda_error_string(int err) {
  if (err == 1000) return "flash_fwd: unsupported arguments";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
