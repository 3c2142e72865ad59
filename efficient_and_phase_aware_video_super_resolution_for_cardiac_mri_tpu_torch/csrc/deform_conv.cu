// Deformable convolution (DCNv1/v2) for Hopper (sm_90a): the im2col and its
// two backward passes.
//
// Replaces XLA code of the JAX package, not a Pallas kernel:
//   efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu/ops/deform_conv.py
//     _bilinear_group_sample (:28), deform_conv2d (:62),
//     deform_conv2d_windowed (:141)
// which compute the reference's CUDA extension (deform_conv_cuda_kernel.cu:
// modulated_deformable_im2col, col2im, col2im_coord) as gathers, shifted
// products and one contraction.  The contraction stays a GEMM of the caller
// (weight (Cout, C*K) @ col), as it is an einsum there.
//
// Layouts (NCHW, K = kh*kw, tap = i*kw + j, Cg = C / dg, P = Ho*Wo,
// p = ho*Wo + wo):
//   x        (B, C, H, W)          T
//   offset   (B, dg*2K, Ho, Wo)    float; channel g*2K + 2*tap is y, +1 is x
//   mask     (B, dg*K, Ho, Wo)     T, or null (DCNv1: 1)
//   col      (B, C*K, P)           T; row c*K + tap
// Sample of (b, c, tap, p), c in group g = c / Cg:
//   py = ho*stride - pad + i*dil + offset_y,  px likewise
//   col = mask * bilinear(x[b, c], py, px), 0 unless -1 < py < H, -1 < px < W
// Each of the four corners adds weight * x at (y0 + {0,1}, x0 + {0,1}) when it
// lies inside the image.  Exact path (R < 0): y0 = floor(py), the fraction
// py - y0.  Windowed path (R >= 0, the JAX package's max_offset): y0 = base +
// floor(oy), the fraction oy - floor(oy), and a corner whose displacement
// floor(oy) + {0,1} (or x's) lies outside [-R, R] is dropped.  Coordinates
// and sums are fp32 whatever T; a result is rounded once, at its store.
//
// Kernels (one simple design each; a thread per output element, a
// grid-stride loop, 256 threads a block):
//   deform_im2col        thread per (b, c, p), loops over the K taps: reads
//                        the tap's offsets and mask (coalesced along p) and
//                        up to 4 corners of x, writes col (coalesced).
//   deform_col2im        thread per (b, c, p), loops over the taps: scatters
//                        grad_col * mask * corner weight onto d_x (fp32) with
//                        atomicAdd, so the order of the sums, and the last
//                        bits of d_x, change from run to run.
//   deform_col2im_coord  thread per (b, g, tap, p): sums over the group's Cg
//                        channels d_mask = sum grad_col * sample and
//                        d_off_{y,x} = mask * sum grad_col * d sample/d p{y,x},
//                        the derivative through the fraction only (a dropped
//                        corner and a sample outside add nothing), writes fp32.
//
// Bound, per launch: im2col reads x, the offsets and the mask once and writes
// col; col (C*K*P elements an image) dominates.  At EDVR's serving L1 shape
// (B 1, C 128, 64x64, dg 8, K 9) col is 18.9 MB in fp32: the kernel is bound
// by the bytes it writes (~19 operations an element of col).
//
// The kernels run on the caller's stream, allocate nothing and assume
// contiguous operands; each entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Geom {
  int64_t B, C, H, W, Ho, Wo;
  int64_t kh, kw, stride, pad, dil, dg, R;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// The four corners of one sample: flat index into the H*W plane, weight and
// its derivatives in py and px, all 0 for a dropped corner.
struct Corners {
  int64_t idx[4];
  float w[4], wy[4], wx[4];
  bool any;  // the sample passes the outer test
};

__device__ __forceinline__ void corners(const Geom& g, int64_t ho, int64_t wo, int64_t tap,
                                        float oy, float ox, Corners& c) {
  const int64_t i = tap / g.kw, j = tap % g.kw;
  const float by = static_cast<float>(ho * g.stride - g.pad + i * g.dil);
  const float bx = static_cast<float>(wo * g.stride - g.pad + j * g.dil);
  const float py = by + oy, px = bx + ox;
  const float H = static_cast<float>(g.H), W = static_cast<float>(g.W);
  c.any = py > -1.f && px > -1.f && py < H && px < W;
  float y0, x0, fy, fx, fly = 0.f, flx = 0.f;
  if (g.R < 0) {
    y0 = floorf(py);
    x0 = floorf(px);
    fy = py - y0;
    fx = px - x0;
  } else {
    fly = floorf(oy);
    flx = floorf(ox);
    fy = oy - fly;
    fx = ox - flx;
    y0 = by + fly;
    x0 = bx + flx;
  }
  const float R = static_cast<float>(g.R);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int dy = k >> 1, dx = k & 1;
    const float yc = y0 + dy, xc = x0 + dx;
    bool ok = c.any && yc >= 0.f && yc <= H - 1.f && xc >= 0.f && xc <= W - 1.f;
    if (g.R >= 0) ok = ok && fabsf(fly + dy) <= R && fabsf(flx + dx) <= R;
    const float ay = dy ? fy : 1.f - fy, ax = dx ? fx : 1.f - fx;
    c.w[k] = ok ? ay * ax : 0.f;
    c.wy[k] = ok ? (dy ? ax : -ax) : 0.f;
    c.wx[k] = ok ? (dx ? ay : -ay) : 0.f;
    c.idx[k] = ok ? static_cast<int64_t>(yc) * g.W + static_cast<int64_t>(xc) : -1;
  }
}

int grid_for(int64_t n) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * 16;
  return static_cast<int>(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
deform_im2col_kernel(const T* __restrict__ x, const float* __restrict__ offset,
                     const T* __restrict__ mask, T* __restrict__ col, Geom g) {
  const int64_t P = g.Ho * g.Wo, K = g.kh * g.kw, Cg = g.C / g.dg;
  const int64_t n = g.B * g.C * P;
  for (int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; t < n;
       t += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t p = t % P, bc = t / P, c = bc % g.C, b = bc / g.C, grp = c / Cg;
    const int64_t ho = p / g.Wo, wo = p % g.Wo;
    const T* xp = x + bc * g.H * g.W;
    const float* op = offset + (b * g.dg + grp) * 2 * K * P + p;
    const T* mp = mask ? mask + (b * g.dg + grp) * K * P + p : nullptr;
    T* cp = col + bc * K * P + p;
    for (int64_t tap = 0; tap < K; ++tap) {
      Corners cr;
      corners(g, ho, wo, tap, op[2 * tap * P], op[(2 * tap + 1) * P], cr);
      float v = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (cr.idx[k] >= 0) v += cr.w[k] * to_f(xp[cr.idx[k]]);
      if (mp) v *= to_f(mp[tap * P]);
      cp[tap * P] = from_f<T>(v);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
deform_col2im_kernel(const T* __restrict__ grad_col, const float* __restrict__ offset,
                     const T* __restrict__ mask, float* __restrict__ grad_x, Geom g) {
  const int64_t P = g.Ho * g.Wo, K = g.kh * g.kw, Cg = g.C / g.dg;
  const int64_t n = g.B * g.C * P;
  for (int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; t < n;
       t += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t p = t % P, bc = t / P, c = bc % g.C, b = bc / g.C, grp = c / Cg;
    const int64_t ho = p / g.Wo, wo = p % g.Wo;
    float* dxp = grad_x + bc * g.H * g.W;
    const float* op = offset + (b * g.dg + grp) * 2 * K * P + p;
    const T* mp = mask ? mask + (b * g.dg + grp) * K * P + p : nullptr;
    const T* gp = grad_col + bc * K * P + p;
    for (int64_t tap = 0; tap < K; ++tap) {
      Corners cr;
      corners(g, ho, wo, tap, op[2 * tap * P], op[(2 * tap + 1) * P], cr);
      if (!cr.any) continue;
      float gv = to_f(gp[tap * P]);
      if (mp) gv *= to_f(mp[tap * P]);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (cr.idx[k] >= 0) atomicAdd(dxp + cr.idx[k], gv * cr.w[k]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
deform_col2im_coord_kernel(const T* __restrict__ grad_col, const T* __restrict__ x,
                           const float* __restrict__ offset, const T* __restrict__ mask,
                           float* __restrict__ grad_offset, float* __restrict__ grad_mask,
                           Geom g) {
  const int64_t P = g.Ho * g.Wo, K = g.kh * g.kw, Cg = g.C / g.dg;
  const int64_t n = g.B * g.dg * K * P;
  for (int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; t < n;
       t += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t p = t % P, r = t / P, tap = r % K, bg = r / K, grp = bg % g.dg,
                  b = bg / g.dg;
    const int64_t ho = p / g.Wo, wo = p % g.Wo;
    const float* op = offset + bg * 2 * K * P + p;
    float* dop = grad_offset + bg * 2 * K * P + p;
    Corners cr;
    corners(g, ho, wo, tap, op[2 * tap * P], op[(2 * tap + 1) * P], cr);
    float dm = 0.f, dy = 0.f, dx = 0.f;
    if (cr.any) {
      const int64_t c0 = b * g.C + grp * Cg;
      for (int64_t cg = 0; cg < Cg; ++cg) {
        const float gv = to_f(grad_col[((c0 + cg) * K + tap) * P + p]);
        const T* xp = x + (c0 + cg) * g.H * g.W;
        float s = 0.f, sy = 0.f, sx = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (cr.idx[k] >= 0) {
            const float v = to_f(xp[cr.idx[k]]);
            s += cr.w[k] * v;
            sy += cr.wy[k] * v;
            sx += cr.wx[k] * v;
          }
        }
        dm += gv * s;
        dy += gv * sy;
        dx += gv * sx;
      }
    }
    const float m = mask ? to_f(mask[bg * K * P + tap * P + p]) : 1.f;
    dop[2 * tap * P] = dy * m;
    dop[(2 * tap + 1) * P] = dx * m;
    if (grad_mask) grad_mask[bg * K * P + tap * P + p] = dm;
  }
}

Geom geom_of(const int64_t* v) {
  return Geom{v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7], v[8], v[9], v[10], v[11], v[12]};
}

template <typename T>
int im2col(const void* x, const void* offset, const void* mask, void* col, const int64_t* gv,
           void* stream) {
  const Geom g = geom_of(gv);
  const int64_t n = g.B * g.C * g.Ho * g.Wo;
  if (n == 0) return static_cast<int>(cudaSuccess);
  deform_im2col_kernel<T><<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(offset), static_cast<const T*>(mask),
      static_cast<T*>(col), g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int col2im(const void* grad_col, const void* offset, const void* mask, void* grad_x,
           const int64_t* gv, void* stream) {
  const Geom g = geom_of(gv);
  const int64_t n = g.B * g.C * g.Ho * g.Wo;
  if (n == 0) return static_cast<int>(cudaSuccess);
  deform_col2im_kernel<T><<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(grad_col), static_cast<const float*>(offset),
      static_cast<const T*>(mask), static_cast<float*>(grad_x), g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int col2im_coord(const void* grad_col, const void* x, const void* offset, const void* mask,
                 void* grad_offset, void* grad_mask, const int64_t* gv, void* stream) {
  const Geom g = geom_of(gv);
  const int64_t n = g.B * g.dg * g.kh * g.kw * g.Ho * g.Wo;
  if (n == 0) return static_cast<int>(cudaSuccess);
  deform_col2im_coord_kernel<T>
      <<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(grad_col), static_cast<const T*>(x),
          static_cast<const float*>(offset), static_cast<const T*>(mask),
          static_cast<float*>(grad_offset), static_cast<float*>(grad_mask), g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int deform_im2col_f32(const void* x, const void* offset, const void* mask, void* col,
                                 const int64_t* geom, void* stream) {
  return im2col<float>(x, offset, mask, col, geom, stream);
}

extern "C" int deform_im2col_bf16(const void* x, const void* offset, const void* mask, void* col,
                                  const int64_t* geom, void* stream) {
  return im2col<__nv_bfloat16>(x, offset, mask, col, geom, stream);
}

extern "C" int deform_col2im_f32(const void* grad_col, const void* offset, const void* mask,
                                 void* grad_x, const int64_t* geom, void* stream) {
  return col2im<float>(grad_col, offset, mask, grad_x, geom, stream);
}

extern "C" int deform_col2im_bf16(const void* grad_col, const void* offset, const void* mask,
                                  void* grad_x, const int64_t* geom, void* stream) {
  return col2im<__nv_bfloat16>(grad_col, offset, mask, grad_x, geom, stream);
}

extern "C" int deform_col2im_coord_f32(const void* grad_col, const void* x, const void* offset,
                                       const void* mask, void* grad_offset, void* grad_mask,
                                       const int64_t* geom, void* stream) {
  return col2im_coord<float>(grad_col, x, offset, mask, grad_offset, grad_mask, geom, stream);
}

extern "C" int deform_col2im_coord_bf16(const void* grad_col, const void* x, const void* offset,
                                        const void* mask, void* grad_offset, void* grad_mask,
                                        const int64_t* geom, void* stream) {
  return col2im_coord<__nv_bfloat16>(grad_col, x, offset, mask, grad_offset, grad_mask, geom,
                                     stream);
}
