// ConvLSTM gate tail for Hopper (sm_90a), with the gate conv's bias fused in.
//
// Replaces the TPU kernel
//   efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu/ops/pallas/lstm_gates.py::_kernel
// (launched through pl.pallas_call by _pallas_gates_2d) and, for the
// gradient, that file's _fused_bwd (the backward rule of its custom_vjp).
//
// gates is the gate conv's raw output (no bias), viewed as (outer, 4F, inner);
// c, h' and c' as (outer, F, inner):
//   channels-last (M, 4F), or NCHW-shaped in torch.channels_last:
//                           outer = M, inner = 1
//   NCHW (N, 4F, H, W):     outer = N, inner = H*W
// Gate k of element (o, f, i) lives at o*4F*inner + (k*F + f)*inner + i, in
// the order (i, f, o, g), and takes bias[k*F + f] (a null bias adds 0):
//   c' = sigmoid(f)*c + sigmoid(i)*tanh(g)
//   h' = sigmoid(o)*tanh(c')
// Every sum and activation is in fp32 (accurate functions for fp32
// operands, fast intrinsics for bf16 ones, see Act); each output is rounded
// once, at its store, to the operand type (fp32 or bf16).
//
// Bound.  The pass reads gates, c and the bias once and writes h' and c' once:
// M*7F + 4F elements, M = outer*inner.  At the main path's F = 64, M = 4096
// (eval) that is 3.67 MB in bf16, 1.10 us at the 3.35 TB/s of an H100 SXM;
// M = 16*32*32 (training) 14.7 MB, 4.38 us.  ~19 operations an element of c
// put the arithmetic far below the card's fp32 rate: the kernel is bound by
// bytes.  The eval problem is small enough (one wave of loads, ~27 KB an SM
// in bf16) that latency, not the rate, is what remains.
//
// Design:
//   * 16-byte vectors (8 bf16 or 4 fp32 elements) along the contiguous axis:
//     F in the channels-last layout (needs F % vec == 0), H*W in NCHW (needs
//     H*W % vec == 0); every gate plane of a vector then lies in one row.
//   * one vector a thread; each thread issues all its loads (gates i, f, o,
//     g, c and the bias; the backward also dh and dc') before any arithmetic;
//   * the loads of gates, c, dh and dc' are streaming (ld.global.cs): they
//     are read once.  The bias is read through the read-only cache into
//     registers: every thread of a row reads the same 4F values, so they stay
//     in L1 and L2.  The stores are plain: the next step reads h' and c' at
//     once, from L2;
//   * one division (two in NCHW) a vector, not four an element, to find the
//     gate offsets;
//   * 128 threads a block and a grid of at most (threads an SM / 128) blocks
//     an SM, from the SM count, looping over what remains.
// Widths that are not a multiple of the vector, and base pointers that are not
// 16-byte aligned, take the same kernels at one element a vector.
//
// Backward (lstm_gates_bwd_kernel).  The VJP of the tail, recomputed from the
// saved (gates, c) and the bias, as the JAX package's _fused_bwd recomputes
// from (gates, c).  It reads gates (4F), c, dh and dc' (F each), recomputes
// i, f, o, g and tc = tanh(c'), and writes dgates (4F) and dc (F):
//   dct = dc' + dh*o*(1 - tc^2)
//   dgi = dct*g*(1 - i)*i    dgf = dct*c*(1 - f)*f
//   dgo = dh*tc*(1 - o)*o    dgg = dct*i*(1 - g^2)    dc = dct*f
// M*12F + 4F elements (25.2 MB at the training shape in bf16, 7.51 us), ~40
// operations an element: bound by bytes too.  Same vectors, loads, grid and
// scalar path as the forward.  dbias (dgates summed over all but the channel
// axis) is left to the caller: a reduction across blocks.
//
// The kernels run on the caller's stream and allocate nothing.  Each entry
// point returns cudaGetLastError(), so a refused launch is reported.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

// N consecutive elements of T moved as one access: 16 bytes, or one element.
// load() streams (read once), load_cached() keeps the line (the bias).
template <typename T, int N> struct Pack;

template <> struct Pack<float, 4> {
  using Raw = float4;
  __device__ static Raw load(const float* p) { return __ldcs(reinterpret_cast<const float4*>(p)); }
  __device__ static Raw load_cached(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ static void store(float* p, const float* x) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  }
  __device__ static void unpack(const Raw& r, float* x) {
    x[0] = r.x; x[1] = r.y; x[2] = r.z; x[3] = r.w;
  }
};

template <> struct Pack<__nv_bfloat16, 8> {
  using Raw = uint4;
  __device__ static Raw load(const __nv_bfloat16* p) {
    return __ldcs(reinterpret_cast<const uint4*>(p));
  }
  __device__ static Raw load_cached(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ static void store(__nv_bfloat16* p, const float* x) {
    uint4 r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(x[2 * j], x[2 * j + 1]);
    *reinterpret_cast<uint4*>(p) = r;
  }
  __device__ static void unpack(const Raw& r, float* x) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      x[2 * j] = f.x;
      x[2 * j + 1] = f.y;
    }
  }
};

template <> struct Pack<float, 1> {
  using Raw = float;
  __device__ static Raw load(const float* p) { return __ldcs(p); }
  __device__ static Raw load_cached(const float* p) { return __ldg(p); }
  __device__ static void store(float* p, const float* x) { *p = x[0]; }
  __device__ static void unpack(const Raw& r, float* x) { x[0] = r; }
};

template <> struct Pack<__nv_bfloat16, 1> {
  using Raw = unsigned short;
  __device__ static Raw load(const __nv_bfloat16* p) {
    return __ldcs(reinterpret_cast<const unsigned short*>(p));
  }
  __device__ static Raw load_cached(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  __device__ static void store(__nv_bfloat16* p, const float* x) { *p = __float2bfloat16(x[0]); }
  __device__ static void unpack(const Raw& r, float* x) {
    x[0] = __bfloat162float(__ushort_as_bfloat16(r));
  }
};

// The activations, in fp32.  For fp32 operands the accurate library
// functions and IEEE division (an ulp or two); for bf16 operands, whose
// results keep 8 significant bits, the fast intrinsics (errors ~1e-6
// relative): half the instructions, which the bf16 problems, at half the
// bytes, cannot hide behind their loads.
template <typename T> struct Act;

template <> struct Act<float> {
  __device__ static float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }
  __device__ static float tanh(float x) { return tanhf(x); }
};

template <> struct Act<__nv_bfloat16> {
  __device__ static float sigmoid(float x) { return __fdividef(1.0f, 1.0f + __expf(-x)); }
  __device__ static float tanh(float x) { return 1.0f - __fdividef(2.0f, 1.0f + __expf(2.0f * x)); }
};

// One vector of the problem: V elements of c from c_off, its four gate
// vectors from g_off + k*plane, and each gate's biases as fp32.  In rows
// (channels-last) the V lanes are V channels, each with its own bias; in
// planes (NCHW) they are V pixels of one channel, which share one.
template <typename T, int V, bool kRows, typename Index>
struct Slot {
  using P = Pack<T, V>;
  Index c_off, g_off, plane, f_off;  // f_off: the lanes' first channel (rows) or their channel
  typename P::Raw gate[4];
  typename Pack<T, kRows ? V : 1>::Raw braw[4];

  __device__ Slot(Index v, Index F, Index inner) : c_off(v * V), plane(F * inner) {
    const Index o = c_off / plane;
    g_off = c_off + 3 * o * plane;
    const Index rest = c_off - o * plane;  // f*inner + i
    f_off = kRows ? rest : rest / inner;
  }

  // Issue the gate and bias loads (the caller adds its own).
  __device__ void load(const T* __restrict__ gates, const T* __restrict__ bias, Index F) {
#pragma unroll
    for (int k = 0; k < 4; ++k) gate[k] = P::load(gates + g_off + k * plane);
    if (bias != nullptr) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        braw[k] = Pack<T, kRows ? V : 1>::load_cached(bias + k * F + f_off);
      }
    }
  }

  // gates + bias, lane by lane, in fp32.
  __device__ void biased(const T* bias, float (&g)[4][V]) const {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      P::unpack(gate[k], g[k]);
      float b[kRows ? V : 1] = {};
      if (bias != nullptr) Pack<T, kRows ? V : 1>::unpack(braw[k], b);
#pragma unroll
      for (int j = 0; j < V; ++j) g[k][j] += b[kRows ? j : 0];
    }
  }
};

template <typename T, int V, bool kRows, typename Index>
__global__ void __launch_bounds__(kThreads) lstm_gates_kernel(
    const T* __restrict__ gates, const T* __restrict__ c, const T* __restrict__ bias,
    T* __restrict__ h_out, T* __restrict__ c_out, Index nvec, Index F, Index inner) {
  using P = Pack<T, V>;
  using A = Act<T>;
  const Index stride = static_cast<Index>(gridDim.x) * kThreads;
  for (Index v = static_cast<Index>(blockIdx.x) * kThreads + threadIdx.x; v < nvec; v += stride) {
    Slot<T, V, kRows, Index> s(v, F, inner);
    s.load(gates, bias, F);  // every load before any arithmetic
    const typename P::Raw rc = P::load(c + s.c_off);
    float g[4][V], cv[V], h[V], cn[V];
    s.biased(bias, g);
    P::unpack(rc, cv);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      cn[j] = A::sigmoid(g[1][j]) * cv[j] + A::sigmoid(g[0][j]) * A::tanh(g[3][j]);
      h[j] = A::sigmoid(g[2][j]) * A::tanh(cn[j]);
    }
    P::store(h_out + s.c_off, h);
    P::store(c_out + s.c_off, cn);
  }
}

template <typename T, int V, bool kRows, typename Index>
__global__ void __launch_bounds__(kThreads) lstm_gates_bwd_kernel(
    const T* __restrict__ gates, const T* __restrict__ c, const T* __restrict__ bias,
    const T* __restrict__ dh, const T* __restrict__ dc_next,
    T* __restrict__ dgates, T* __restrict__ dc, Index nvec, Index F, Index inner) {
  using P = Pack<T, V>;
  using A = Act<T>;
  const Index stride = static_cast<Index>(gridDim.x) * kThreads;
  for (Index v = static_cast<Index>(blockIdx.x) * kThreads + threadIdx.x; v < nvec; v += stride) {
    Slot<T, V, kRows, Index> s(v, F, inner);
    s.load(gates, bias, F);  // every load before any arithmetic
    const typename P::Raw rc = P::load(c + s.c_off);
    const typename P::Raw rdh = P::load(dh + s.c_off);
    const typename P::Raw rdc = P::load(dc_next + s.c_off);
    float g[4][V], cv[V], dhv[V], dcn[V], dg[4][V], dcv[V];
    s.biased(bias, g);
    P::unpack(rc, cv);
    P::unpack(rdh, dhv);
    P::unpack(rdc, dcn);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float si = A::sigmoid(g[0][j]);
      const float sf = A::sigmoid(g[1][j]);
      const float so = A::sigmoid(g[2][j]);
      const float tg = A::tanh(g[3][j]);
      const float tc = A::tanh(sf * cv[j] + si * tg);
      const float dct = dcn[j] + dhv[j] * so * (1.0f - tc * tc);
      // products in the order of the plain version (autograd's sigmoid and
      // tanh rules: grad * (1 - y) * y, grad * (1 - y^2))
      dg[0][j] = dct * tg * (1.0f - si) * si;
      dg[1][j] = dct * cv[j] * (1.0f - sf) * sf;
      dg[2][j] = dhv[j] * tc * (1.0f - so) * so;
      dg[3][j] = dct * si * (1.0f - tg * tg);
      dcv[j] = dct * sf;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) P::store(dgates + s.g_off + k * s.plane, dg[k]);
    P::store(dc + s.c_off, dcv);
  }
}

// A launch's operands: the pointers (null where a kernel takes fewer) and
// the (outer, F, inner) view.
struct Args {
  const void *gates, *c, *bias, *dh, *dc_next;
  void *out0, *out1;  // forward: h', c'; backward: dgates, dc
  int64_t n, F, inner;
  void* stream;
};

// Elements a vector for this problem: 16 bytes' worth when the contiguous
// axis is a multiple of that and every pointer is 16-byte aligned, else 1.
int vector_width(int64_t F, int64_t inner, int64_t element_size, bool aligned) {
  const int64_t vec = 16 / element_size;
  return aligned && (inner == 1 ? F : inner) % vec == 0 ? static_cast<int>(vec) : 1;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Blocks for nvec vectors: enough to cover them, at most what the SMs hold.
unsigned int grid_for(int64_t nvec) {
  int device = 0, sms = 132, threads_per_sm = 2048;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaDeviceGetAttribute(&threads_per_sm, cudaDevAttrMaxThreadsPerMultiProcessor, device);
  const int64_t need = (nvec + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * (threads_per_sm / kThreads);
  return static_cast<unsigned int>(need < cap ? need : cap);
}

struct Fwd {
  template <typename T, int V, bool kRows, typename Index>
  static void run(const Args& a) {
    lstm_gates_kernel<T, V, kRows, Index>
        <<<grid_for(a.n / V), kThreads, 0, static_cast<cudaStream_t>(a.stream)>>>(
            static_cast<const T*>(a.gates), static_cast<const T*>(a.c),
            static_cast<const T*>(a.bias), static_cast<T*>(a.out0), static_cast<T*>(a.out1),
            static_cast<Index>(a.n / V), static_cast<Index>(a.F), static_cast<Index>(a.inner));
  }
};

struct Bwd {
  template <typename T, int V, bool kRows, typename Index>
  static void run(const Args& a) {
    lstm_gates_bwd_kernel<T, V, kRows, Index>
        <<<grid_for(a.n / V), kThreads, 0, static_cast<cudaStream_t>(a.stream)>>>(
            static_cast<const T*>(a.gates), static_cast<const T*>(a.c),
            static_cast<const T*>(a.bias), static_cast<const T*>(a.dh),
            static_cast<const T*>(a.dc_next), static_cast<T*>(a.out0), static_cast<T*>(a.out1),
            static_cast<Index>(a.n / V), static_cast<Index>(a.F), static_cast<Index>(a.inner));
  }
};

template <typename K, typename T, int V, bool kRows>
void by_index(const Args& a) {
  if (4 * a.n <= INT32_MAX) {  // every gate offset fits in 32 bits
    K::template run<T, V, kRows, uint32_t>(a);
  } else {
    K::template run<T, V, kRows, uint64_t>(a);
  }
}

template <typename K, typename T, int V>
void by_layout(const Args& a) {
  if (a.inner == 1) {
    by_index<K, T, V, true>(a);
  } else {
    by_index<K, T, V, false>(a);
  }
}

// Launch kernel K for the problem a on operands of type T: 16-byte vectors
// or one element a vector, rows (channels-last) or planes (NCHW), 32- or
// 64-bit offsets.
template <typename K, typename T>
int dispatch(const Args& a) {
  if (a.n == 0) return static_cast<int>(cudaSuccess);
  const bool aligned = aligned16(a.gates) && aligned16(a.c) && aligned16(a.bias) &&
                       aligned16(a.dh) && aligned16(a.dc_next) && aligned16(a.out0) &&
                       aligned16(a.out1);
  if (vector_width(a.F, a.inner, sizeof(T), aligned) > 1) {
    by_layout<K, T, 16 / sizeof(T)>(a);
  } else {
    by_layout<K, T, 1>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lstm_gates_f32(const void* gates, const void* c, const void* bias, void* h_out,
                              void* c_out, int64_t outer, int64_t F, int64_t inner, void* stream) {
  return dispatch<Fwd, float>(
      {gates, c, bias, nullptr, nullptr, h_out, c_out, outer * F * inner, F, inner, stream});
}

extern "C" int lstm_gates_bf16(const void* gates, const void* c, const void* bias, void* h_out,
                               void* c_out, int64_t outer, int64_t F, int64_t inner, void* stream) {
  return dispatch<Fwd, __nv_bfloat16>(
      {gates, c, bias, nullptr, nullptr, h_out, c_out, outer * F * inner, F, inner, stream});
}

extern "C" int lstm_gates_bwd_f32(const void* gates, const void* c, const void* bias,
                                  const void* dh, const void* dc_next, void* dgates, void* dc,
                                  int64_t outer, int64_t F, int64_t inner, void* stream) {
  return dispatch<Bwd, float>(
      {gates, c, bias, dh, dc_next, dgates, dc, outer * F * inner, F, inner, stream});
}

extern "C" int lstm_gates_bwd_bf16(const void* gates, const void* c, const void* bias,
                                   const void* dh, const void* dc_next, void* dgates, void* dc,
                                   int64_t outer, int64_t F, int64_t inner, void* stream) {
  return dispatch<Bwd, __nv_bfloat16>(
      {gates, c, bias, dh, dc_next, dgates, dc, outer * F * inner, F, inner, stream});
}

// The elements a vector that a launch with these operands takes (1: the
// scalar path); the kernels choose by the same rule.
extern "C" int lstm_gates_vector_width(int64_t F, int64_t inner, int64_t element_size,
                                       int aligned) {
  return vector_width(F, inner, element_size, aligned != 0);
}
