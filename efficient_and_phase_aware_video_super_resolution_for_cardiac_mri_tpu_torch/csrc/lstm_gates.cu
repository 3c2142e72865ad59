// ConvLSTM gate tail for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu/ops/pallas/lstm_gates.py::_kernel
// (launched through pl.pallas_call by _pallas_gates_2d).
//
// gates is viewed as (outer, 4F, inner); c, h' and c' as (outer, F, inner):
//   channels-last (M, 4F):  outer = M, inner = 1
//   NCHW (N, 4F, H, W):     outer = N, inner = H*W
// Gate k of element (o, f, i) lives at o*4F*inner + (k*F + f)*inner + i, in
// the order (i, f, o, g):
//   c' = sigmoid(f)*c + sigmoid(i)*tanh(g)
//   h' = sigmoid(o)*tanh(c')
//
// Bound.  The pass reads gates and c once and writes h' and c' once: M*7F
// elements, with M = outer*inner rows.  At the main path's F = 64 and
// M = 1*64*64 = 4096 in fp32 that is 7.34 MB, about 2.2 us at the 3.35 TB/s
// of an H100 SXM (recompute at the card's own rate for a PCIe part).  About
// 15 operations per output element put the arithmetic two orders of
// magnitude below the card's fp32 rate, so the kernel is bound by bytes.
//
// Design, simple first: one thread per output element, 256 threads a block,
// a masked tail for the ragged last block.  Neighbouring threads read
// neighbouring addresses of each gate plane, so loads coalesce in both
// layouts.  Arithmetic is fp32; stores are in the input type (fp32 or bf16).
// A later version should vectorise to 16-byte loads (4 fp32 or 8 bf16 a
// thread) and, beyond that, fuse the tail into the gate conv's epilogue so
// the gates never reach device memory.
//
// Backward (lstm_gates_bwd_kernel).  Replaces the JAX package's _fused_bwd
// (ops/pallas/lstm_gates.py:103-106): jax.vjp of the plain gate tail,
// recomputed from the saved (gates, c), which XLA fuses into one pass.  Here
// that pass is one kernel: it reads gates (4F), c, dh and dc' (F each),
// recomputes i, f, o, g and tc = tanh(c'), and writes dgates (4F) and dc (F):
//   dct = dc' + dh*o*(1 - tc^2)
//   dgi = dct*g*(1 - i)*i    dgf = dct*c*(1 - f)*f
//   dgo = dh*tc*(1 - o)*o    dgg = dct*i*(1 - g^2)    dc = dct*f
// It moves M*12F elements (50.3 MB at the training shape, M = 16*32*32,
// F = 64, fp32: 15.0 us at 3.35 TB/s) for about 35 operations per element,
// so it too is bound by bytes.  Same layout, thread mapping and fp32
// arithmetic as the forward; the activations are recomputed, not saved, so
// the forward writes nothing extra for the backward to read.
//
// The kernels run on the caller's stream and allocate nothing.  Each entry
// point returns cudaGetLastError(), so a refused launch is reported.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

template <typename T, typename Index>
__global__ void __launch_bounds__(256) lstm_gates_kernel(
    const T* __restrict__ gates, const T* __restrict__ c,
    T* __restrict__ h_out, T* __restrict__ c_out,
    Index n, Index F, Index inner) {
  const Index idx = static_cast<Index>(blockIdx.x) * static_cast<Index>(blockDim.x) +
                    static_cast<Index>(threadIdx.x);
  if (idx >= n) return;
  const Index i = idx % inner;
  const Index of = idx / inner;  // o * F + f
  const Index f = of % F;
  const Index o = of / F;
  const Index plane = F * inner;
  const T* g = gates + o * 4 * plane + f * inner + i;
  const float gi = load_f(g);
  const float gf = load_f(g + plane);
  const float go = load_f(g + 2 * plane);
  const float gg = load_f(g + 3 * plane);
  const float c_next = sigmoid_f(gf) * load_f(c + idx) + sigmoid_f(gi) * tanhf(gg);
  store_f(h_out + idx, sigmoid_f(go) * tanhf(c_next));
  store_f(c_out + idx, c_next);
}

template <typename T, typename Index>
__global__ void __launch_bounds__(256) lstm_gates_bwd_kernel(
    const T* __restrict__ gates, const T* __restrict__ c,
    const T* __restrict__ dh, const T* __restrict__ dc_next,
    T* __restrict__ dgates, T* __restrict__ dc,
    Index n, Index F, Index inner) {
  const Index idx = static_cast<Index>(blockIdx.x) * static_cast<Index>(blockDim.x) +
                    static_cast<Index>(threadIdx.x);
  if (idx >= n) return;
  const Index i = idx % inner;
  const Index of = idx / inner;  // o * F + f
  const Index f = of % F;
  const Index o = of / F;
  const Index plane = F * inner;
  const Index goff = o * 4 * plane + f * inner + i;
  const float si = sigmoid_f(load_f(gates + goff));
  const float sf = sigmoid_f(load_f(gates + goff + plane));
  const float so = sigmoid_f(load_f(gates + goff + 2 * plane));
  const float tg = tanhf(load_f(gates + goff + 3 * plane));
  const float cv = load_f(c + idx);
  const float tc = tanhf(sf * cv + si * tg);
  const float dhv = load_f(dh + idx);
  const float dct = load_f(dc_next + idx) + dhv * so * (1.0f - tc * tc);
  // products in the order of the plain version (autograd's sigmoid and tanh
  // rules: grad * (1 - y) * y, grad * (1 - y^2))
  store_f(dgates + goff, dct * tg * (1.0f - si) * si);
  store_f(dgates + goff + plane, dct * cv * (1.0f - sf) * sf);
  store_f(dgates + goff + 2 * plane, dhv * tc * (1.0f - so) * so);
  store_f(dgates + goff + 3 * plane, dct * si * (1.0f - tg * tg));
  store_f(dc + idx, dct * sf);
}

template <typename T>
int launch(const void* gates, const void* c, void* h_out, void* c_out,
           int64_t outer, int64_t F, int64_t inner, void* stream) {
  const int64_t n = outer * F * inner;
  if (n == 0) return static_cast<int>(cudaSuccess);
  const int threads = 256;
  const unsigned int blocks = static_cast<unsigned int>((n + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* g = static_cast<const T*>(gates);
  const T* cc = static_cast<const T*>(c);
  T* h = static_cast<T*>(h_out);
  T* co = static_cast<T*>(c_out);
  if (4 * n <= INT32_MAX) {  // every gate offset fits in 32 bits
    lstm_gates_kernel<T, int32_t><<<blocks, threads, 0, s>>>(
        g, cc, h, co, static_cast<int32_t>(n), static_cast<int32_t>(F),
        static_cast<int32_t>(inner));
  } else {
    lstm_gates_kernel<T, int64_t><<<blocks, threads, 0, s>>>(g, cc, h, co, n, F, inner);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* gates, const void* c, const void* dh, const void* dc_next,
               void* dgates, void* dc, int64_t outer, int64_t F, int64_t inner, void* stream) {
  const int64_t n = outer * F * inner;
  if (n == 0) return static_cast<int>(cudaSuccess);
  const int threads = 256;
  const unsigned int blocks = static_cast<unsigned int>((n + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* g = static_cast<const T*>(gates);
  const T* cc = static_cast<const T*>(c);
  const T* dhh = static_cast<const T*>(dh);
  const T* dcn = static_cast<const T*>(dc_next);
  T* dg = static_cast<T*>(dgates);
  T* dco = static_cast<T*>(dc);
  if (4 * n <= INT32_MAX) {  // every gate offset fits in 32 bits
    lstm_gates_bwd_kernel<T, int32_t><<<blocks, threads, 0, s>>>(
        g, cc, dhh, dcn, dg, dco, static_cast<int32_t>(n), static_cast<int32_t>(F),
        static_cast<int32_t>(inner));
  } else {
    lstm_gates_bwd_kernel<T, int64_t><<<blocks, threads, 0, s>>>(
        g, cc, dhh, dcn, dg, dco, n, F, inner);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lstm_gates_f32(const void* gates, const void* c, void* h_out, void* c_out,
                              int64_t outer, int64_t F, int64_t inner, void* stream) {
  return launch<float>(gates, c, h_out, c_out, outer, F, inner, stream);
}

extern "C" int lstm_gates_bf16(const void* gates, const void* c, void* h_out, void* c_out,
                               int64_t outer, int64_t F, int64_t inner, void* stream) {
  return launch<__nv_bfloat16>(gates, c, h_out, c_out, outer, F, inner, stream);
}

extern "C" int lstm_gates_bwd_f32(const void* gates, const void* c, const void* dh,
                                  const void* dc_next, void* dgates, void* dc, int64_t outer,
                                  int64_t F, int64_t inner, void* stream) {
  return launch_bwd<float>(gates, c, dh, dc_next, dgates, dc, outer, F, inner, stream);
}

extern "C" int lstm_gates_bwd_bf16(const void* gates, const void* c, const void* dh,
                                   const void* dc_next, void* dgates, void* dc, int64_t outer,
                                   int64_t F, int64_t inner, void* stream) {
  return launch_bwd<__nv_bfloat16>(gates, c, dh, dc_next, dgates, dc, outer, F, inner, stream);
}
