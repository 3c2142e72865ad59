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
// The kernel runs on the caller's stream and allocates nothing.  Each entry
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

}  // namespace

extern "C" int lstm_gates_f32(const void* gates, const void* c, void* h_out, void* c_out,
                              int64_t outer, int64_t F, int64_t inner, void* stream) {
  return launch<float>(gates, c, h_out, c_out, outer, F, inner, stream);
}

extern "C" int lstm_gates_bf16(const void* gates, const void* c, void* h_out, void* c_out,
                               int64_t outer, int64_t F, int64_t inner, void* stream) {
  return launch<__nv_bfloat16>(gates, c, h_out, c_out, outer, F, inner, stream);
}
