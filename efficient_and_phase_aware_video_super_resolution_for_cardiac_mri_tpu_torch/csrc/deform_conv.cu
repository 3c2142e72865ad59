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
// Layouts (K = kh*kw, tap = i*kw + j, Cg = C / dg, P = Ho*Wo, p = ho*Wo + wo):
//   x        (B, C, H, W)          T (the gathers read it as (B, H, W, C))
//   offset   (B, dg*2K, Ho, Wo)    float; channel g*2K + 2*tap is y, +1 is x
//   mask     (B, dg*K, Ho, Wo)     T, or null (DCNv1: 1)
//   col      (B, C*K, P)           T; row c*K + tap
//   d_x      (B, C, H, W)          float
// Sample of (b, c, tap, p), c in group g = c / Cg:
//   py = ho*stride - pad_h + i*dil + offset_y,  px = wo*stride - pad_w + ...
// pad_h is a row origin: it may differ from pad_w and be negative (a band of
// a frame's rows with its neighbours' rows attached, or the gathered frame
// read from a band's first row), and Ho is the caller's.
//   col = mask * bilinear(x[b, c], py, px), 0 unless -1 < py < H, -1 < px < W
// Each of the four corners adds weight * x at (y0 + {0,1}, x0 + {0,1}) when it
// lies inside the image.  Exact path (R < 0): y0 = floor(py), the fraction
// py - y0.  Windowed path (R >= 0, the JAX package's max_offset): y0 = base +
// floor(oy), the fraction oy - floor(oy), and a corner whose displacement
// floor(oy) + {0,1} (or x's) lies outside [-R, R] is dropped.  Coordinates
// and sums are fp32 whatever T; a result is rounded once, at its store.
//
// What bounds them.  im2col writes col (C*K*P elements an image, 18.9 MB in
// fp32 at EDVR's serving L1 shape) and reads x, the offsets and the mask
// once: it is bound by bytes.  col2im reads as many bytes of grad_col and
// adds 4 corners a sample onto d_x; col2im_coord reads grad_col and x and
// writes 3 fp32 values a (b, group, tap, p), bound by bytes too.  The first
// designs of im2col and col2im (a thread per (b, c, p),
// 64-bit index arithmetic) ran at 4-17% of that bound: they computed every
// sample's corners again for each of a group's Cg channels, gathered x one
// plane a channel (neighbouring threads shared no sector), and col2im sent
// one scalar fp32 atomic a corner a channel to a different sector of d_x
// (~19 M at the serving L1 shape, ~100 G a second on an H100).
//
// The designs.  A block takes 16 (fp32) or 32 (bf16) consecutive
// positions of one (b, group, chunk of 16 channels), all K taps: it reads
// each sample's offsets and mask once, coalesced, and computes its corners
// once for all the chunk's channels (32-bit arithmetic; the wrapper refuses
// shapes whose element counts reach 2^31) into a table in shared memory.
// Then lanes walk the channels with the corners in channels-last layout,
// where a corner's 16 channels are one 64 B (fp32) or 32 B (bf16) run:
//   deform_im2col        4 (fp32) or 2 (bf16) lanes a sample, one 16-byte
//                        load a corner each; a warp covers neighbouring
//                        positions of one tap, so its col stores fill 32-byte
//                        sectors of 4 or 8 rows.  The table is all the shared
//                        memory a block takes (5 KB), which leaves L1 to the
//                        gathers: neighbouring samples share corners.  A
//                        first version staged the block's col rows in shared
//                        memory for 16-byte stores; it measured slower, its
//                        31 KB a block crowding L1.
//                        x comes channels-last: the entry point first
//                        transposes (and casts) an NCHW x through shared
//                        memory (transpose_kernel), unless the caller's x is
//                        channels-last already.
//   deform_col2im        4 lanes a sample, 4 channels a lane: grad_col loads
//                        fill sectors as im2col's stores do, and each kept
//                        corner is one float4 atomicAdd (sm_90's vector
//                        reduction in L2)
//                        into a zeroed channels-last fp32 d_x, which the
//                        entry point then transposes to NCHW.  4x fewer
//                        atomics than the first design's, and a warp's 8
//                        samples touch 16 sectors an instruction where its
//                        32 lanes touched 32.
//                        Kept against the design of an output tile summed in
//                        a shared-memory footprint and flushed once: sm_90
//                        has no native shared-memory fp32 atomic add (the
//                        compiler emits an ATOMS.CAST.SPIN compare-and-swap
//                        loop), and every footprint design tried measured
//                        slower at both of EDVR's L1 shapes.  Atomics
//                        keep a run-to-run summation order, so the last bits
//                        of d_x change from run to run.
//   deform_col2im_coord  a block takes 32 positions of one (b, group), all K
//                        taps, and walks all the group's channels itself, in
//                        chunks of 16, so the sum over Cg ends inside the
//                        block: no atomics, no zeroed output, the same bits
//                        from run to run.  Its table keeps each sample's two
//                        fractions in place of the weights.  Lanes as
//                        col2im's (fp32: 4 a sample, 4 channels a lane; bf16:
//                        2 and 8; 16-byte loads of a channels-last x, which
//                        the entry point transposes as im2col's does; a lane
//                        a channel when Cg is not a multiple of the vector):
//                        a lane keeps one dot product a corner, D_k = sum_c
//                        grad_col * x at corner k, across its chunks,
//                        __shfl_xor_sync sums them over the sample's lanes,
//                        and one lane writes d_mask = sum_k w_k D_k and
//                        d_off_{y,x} = mask * sum_k dw_k/dp{y,x} D_k, fp32
//                        (the derivative through the fraction only: a
//                        dropped corner and a sample outside add nothing).
//                        grad_col comes straight from device memory: a
//                        warp's loads fill 32-byte sectors of 4 (fp32) or 2
//                        (bf16) rows, and 32 positions make 128-byte fp32
//                        rows a block.  9 warps: at 3x3 taps a block has
//                        9 * 32 samples, so every pass over them is full.
//                        Measured against this design (PERF.md section 6):
//                        16 positions, grad_col staged in shared memory by
//                        cp.async while the table is built, 6 warps, 32
//                        registers, wider lanes and a persistent block
//                        double-buffering the next tile's rows were all
//                        slower.  What is left is the corner table (the
//                        offsets' load latency and the corners, a thread a
//                        sample, as in the other two kernels), then
//                        grad_col's stream and the gathers.
//
// The kernels run on the caller's stream, allocate nothing (the wrapper
// passes the channels-last buffers) and assume contiguous operands; each
// entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 16;  // a block's channels: a group's, in chunks of 16

struct Geom {
  // pad_h last: the fields before it keep the offsets they had before the
  // row origin (with it between stride and dil, bf16 im2col without a row
  // origin ran 15-23% longer on an H100, PERF.md section 6)
  int B, C, H, W, Ho, Wo, kh, kw, stride, pad_w, dil, dg, R, pad_h;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// The four corners of one sample: corner k at row y0 + (k >> 1), column
// x0 + (k & 1), kept or dropped, and its weight (0 for a dropped corner);
// the sample's fractions fy, fx, on which the weights' derivatives in py
// and px depend (col2im_coord).
struct Corners {
  int y0, x0;  // meaningful where a corner is kept
  bool any;    // the sample passes the outer test
  bool ok[4];
  float w[4];
  float fy, fx;
};

// kOrigin: the row origin pad_h may differ from pad_w; without it pad_w
// serves both axes (and the geometry's pad_h is never read)
template <bool kOrigin>
__device__ __forceinline__ Corners corners(const Geom& g, int ho, int wo, int tap, float oy,
                                           float ox) {
  Corners c;
  const int i = tap / g.kw, j = tap % g.kw;
  const int pad_h = kOrigin ? g.pad_h : g.pad_w;
  const float by = static_cast<float>(ho * g.stride - pad_h + i * g.dil);
  const float bx = static_cast<float>(wo * g.stride - g.pad_w + j * g.dil);
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
  // inside the outer test y0 and x0 are small integers
  c.y0 = c.any ? static_cast<int>(y0) : 0;
  c.x0 = c.any ? static_cast<int>(x0) : 0;
  c.fy = fy;
  c.fx = fx;
  const float R = static_cast<float>(g.R);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int dy = k >> 1, dx = k & 1;
    const float yc = y0 + dy, xc = x0 + dx;
    bool ok = c.any && yc >= 0.f && yc <= H - 1.f && xc >= 0.f && xc <= W - 1.f;
    if (g.R >= 0) ok = ok && fabsf(fly + dy) <= R && fabsf(flx + dx) <= R;
    const float ay = dy ? fy : 1.f - fy, ax = dx ? fx : 1.f - fx;
    c.ok[k] = ok;
    c.w[k] = ok ? ay * ax : 0.f;
  }
  return c;
}

// ------------------------------------------------------------------ im2col

// The positions of a block of im2col and col2im (a 64-byte run of a col
// row) and its shared-memory table of K * kPos samples.
template <typename T>
struct Tile {
  static constexpr int kPos = 64 / sizeof(T);
  static size_t smem(int K) { return (sizeof(int4) + sizeof(float4) + sizeof(float)) * K * kPos; }
};

// The block's (b, group, channel chunk) and first position.
struct Block {
  int b, grp, c0, nc, p0;
};

template <int kPos>
__device__ __forceinline__ Block block_of(const Geom& g) {
  const int Cg = g.C / g.dg, chunks = (Cg + kLanes - 1) / kLanes;
  Block k;
  k.b = blockIdx.z;
  k.grp = blockIdx.y / chunks;
  const int cg0 = blockIdx.y % chunks * kLanes;
  k.nc = min(kLanes, Cg - cg0);
  k.c0 = k.grp * Cg + cg0;
  k.p0 = blockIdx.x * kPos;
  return k;
}

// Step 1 of the three kernels: the corners of the block's samples (tap
// s / kPos, position p0 + s % kPos), once for all its channels: a kept
// corner's element offset of channel 0 in a channels-last (B, H, W, C)
// tensor, or -1; the mask (1 without one); and a sample's four corner weights
// (W float4: im2col, col2im) or its fractions (fy, fx) (W float2:
// col2im_coord).  The stride kStride (the block's thread count) and the
// choice W are compile-time: with blockDim.x and a null test in their place
// bf16 im2col took more registers and ran 14-26% longer.  So is kOrigin
// (corners): reading the row origin takes bf16 im2col from 32 registers to
// 39 and 14-21% longer (an H100, PERF.md section 6), so im2col reads it only
// for the geometries that have one (the spatial axis's bands and gathered
// frames); col2im and col2im_coord always read it, at no measured cost.
template <typename T, int kPos, int kStride, typename W, bool kOrigin = true>
__device__ __forceinline__ void corner_table(const Geom& g, const Block& k, const float* offset,
                                             const T* mask, int4* corner, W* weight, float* mk) {
  static_assert(std::is_same_v<W, float4> || std::is_same_v<W, float2>, "weights or fractions");
  const int K = g.kh * g.kw, P = g.Ho * g.Wo;
  const float* op = offset + (k.b * g.dg + k.grp) * 2 * K * P;
  const T* mp = mask ? mask + (k.b * g.dg + k.grp) * K * P : nullptr;
  for (int s = threadIdx.x; s < K * kPos; s += kStride) {
    const int tap = s / kPos, p = k.p0 + s % kPos;
    int e[4] = {-1, -1, -1, -1};
    W w{};
    float m = 0.f;
    if (p < P) {
      const Corners cr = corners<kOrigin>(g, p / g.Wo, p % g.Wo, tap, op[2 * tap * P + p],
                                          op[(2 * tap + 1) * P + p]);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (cr.ok[c]) e[c] = ((k.b * g.H + cr.y0 + (c >> 1)) * g.W + cr.x0 + (c & 1)) * g.C;
      if constexpr (std::is_same_v<W, float4>)
        w = make_float4(cr.w[0], cr.w[1], cr.w[2], cr.w[3]);
      else
        w = make_float2(cr.fy, cr.fx);
      m = mp ? to_f(mp[tap * P + p]) : 1.f;
    }
    corner[s] = make_int4(e[0], e[1], e[2], e[3]);
    weight[s] = w;
    mk[s] = m;
  }
}

// ------------------------------------------------------------------ im2col

// v[j] += w * x[i + j] for the 16 bytes at x + i (i >= 0; a dropped corner
// has i = -1 and adds nothing)
__device__ __forceinline__ void accumulate(float (&v)[4], const float* x, int i, float w) {
  if (i < 0) return;
  const float4 q = __ldg(reinterpret_cast<const float4*>(x + i));
  v[0] += w * q.x;
  v[1] += w * q.y;
  v[2] += w * q.z;
  v[3] += w * q.w;
}

__device__ __forceinline__ void accumulate(float (&v)[8], const __nv_bfloat16* x, int i, float w) {
  if (i < 0) return;
  const int4 q = __ldg(reinterpret_cast<const int4*>(x + i));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] += w * f.x;
    v[2 * j + 1] += w * f.y;
  }
}

template <typename T, bool kOrigin>
__global__ void __launch_bounds__(kThreads)
deform_im2col_kernel(const T* __restrict__ x, const float* __restrict__ offset,
                     const T* __restrict__ mask, T* __restrict__ col, Geom g) {
  constexpr int kPos = Tile<T>::kPos, kVec = 16 / sizeof(T);
  const int K = g.kh * g.kw, P = g.Ho * g.Wo, n = K * kPos;
  const Block k = block_of<kPos>(g);
  extern __shared__ __align__(16) unsigned char smem[];
  int4* corner = reinterpret_cast<int4*>(smem);            // [n]
  float4* weight = reinterpret_cast<float4*>(corner + n);  // [n]
  float* mk = reinterpret_cast<float*>(weight + n);        // [n]
  corner_table<T, kPos, kThreads, float4, kOrigin>(g, k, offset, mask, corner, weight, mk);
  __syncthreads();

  // 2. kLanes / kVec lanes a sample, kVec channels a lane, one 16-byte load a
  //    corner (a lane a channel when Cg is not a multiple of kVec): the kept
  //    corners summed in fp32, times the mask, rounded once into col; a warp
  //    covers neighbouring positions of one tap, so each of its stores fills
  //    32-byte sectors of kVec rows
  T* cp = col + (k.b * g.C + k.c0) * K * P;
  if ((g.C / g.dg) % kVec == 0) {
    constexpr int kPer = kLanes / kVec;
    const int c = threadIdx.x % kPer * kVec;
    if (c >= k.nc) return;
    const T* xc = x + k.c0 + c;
    for (int s = threadIdx.x / kPer; s < n; s += kThreads / kPer) {
      const int tap = s / kPos, p = k.p0 + s % kPos;
      if (p >= P) continue;
      const int4 id = corner[s];
      const float4 w = weight[s];
      float v[kVec] = {};
      accumulate(v, xc, id.x, w.x);
      accumulate(v, xc, id.y, w.y);
      accumulate(v, xc, id.z, w.z);
      accumulate(v, xc, id.w, w.w);
      T* dst = cp + (c * K + tap) * P + p;
#pragma unroll
      for (int j = 0; j < kVec; ++j) dst[j * K * P] = from_f<T>(v[j] * mk[s]);
    }
  } else {
    const int c = threadIdx.x % kLanes;
    if (c >= k.nc) return;
    const T* xc = x + k.c0 + c;
    for (int s = threadIdx.x / kLanes; s < n; s += kThreads / kLanes) {
      const int tap = s / kPos, p = k.p0 + s % kPos;
      if (p >= P) continue;
      const int4 id = corner[s];
      const float4 w = weight[s];
      float v = 0.f;
      if (id.x >= 0) v += w.x * to_f(xc[id.x]);
      if (id.y >= 0) v += w.y * to_f(xc[id.y]);
      if (id.z >= 0) v += w.z * to_f(xc[id.z]);
      if (id.w >= 0) v += w.w * to_f(xc[id.w]);
      cp[(c * K + tap) * P + p] = from_f<T>(v * mk[s]);
    }
  }
}

// ------------------------------------------------------------------ col2im

// d[j] += v[j] * w for the 4 floats at d (16-byte aligned): one vector
// reduction in L2
__device__ __forceinline__ void add4(float* d, const float (&v)[4], float w) {
  atomicAdd(reinterpret_cast<float4*>(d), make_float4(v[0] * w, v[1] * w, v[2] * w, v[3] * w));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
deform_col2im_kernel(const T* __restrict__ grad_col, const float* __restrict__ offset,
                     const T* __restrict__ mask, float* __restrict__ grad_x, Geom g) {
  constexpr int kPos = Tile<T>::kPos;
  const int K = g.kh * g.kw, P = g.Ho * g.Wo, n = K * kPos;
  const Block k = block_of<kPos>(g);
  extern __shared__ __align__(16) unsigned char smem[];
  int4* corner = reinterpret_cast<int4*>(smem);            // [n]
  float4* weight = reinterpret_cast<float4*>(corner + n);  // [n]
  float* mk = reinterpret_cast<float*>(weight + n);        // [n]
  corner_table<T, kPos, kThreads>(g, k, offset, mask, corner, weight, mk);
  __syncthreads();

  // 2. 4 lanes a sample, 4 channels a lane: grad * mask (grad_col loads fill
  //    32-byte sectors of 4 rows, as im2col's stores do) times each kept
  //    corner's weight, one float4 reduction a corner into channels-last d_x
  //    (a lane a channel and scalar atomics when Cg is not a multiple of 4)
  const T* gp = grad_col + (k.b * g.C + k.c0) * K * P;
  if ((g.C / g.dg) % 4 == 0) {
    const int c = threadIdx.x % 4 * 4;
    if (c >= k.nc) return;
    float* dx = grad_x + k.c0 + c;
    for (int s = threadIdx.x / 4; s < n; s += kThreads / 4) {
      const int tap = s / kPos, p = k.p0 + s % kPos;
      if (p >= P) continue;
      const int4 id = corner[s];
      if ((id.x & id.y & id.z & id.w) == -1) continue;  // every corner dropped
      const float4 w = weight[s];
      const T* src = gp + (c * K + tap) * P + p;
      float gv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) gv[j] = to_f(src[j * K * P]) * mk[s];
      if (id.x >= 0) add4(dx + id.x, gv, w.x);
      if (id.y >= 0) add4(dx + id.y, gv, w.y);
      if (id.z >= 0) add4(dx + id.z, gv, w.z);
      if (id.w >= 0) add4(dx + id.w, gv, w.w);
    }
  } else {
    const int c = threadIdx.x % kLanes;
    if (c >= k.nc) return;
    float* dx = grad_x + k.c0 + c;
    for (int s = threadIdx.x / kLanes; s < n; s += kThreads / kLanes) {
      const int tap = s / kPos, p = k.p0 + s % kPos;
      if (p >= P) continue;
      const int4 id = corner[s];
      const float4 w = weight[s];
      const float gv = to_f(gp[(c * K + tap) * P + p]) * mk[s];
      if (id.x >= 0) atomicAdd(dx + id.x, gv * w.x);
      if (id.y >= 0) atomicAdd(dx + id.y, gv * w.y);
      if (id.z >= 0) atomicAdd(dx + id.z, gv * w.z);
      if (id.w >= 0) atomicAdd(dx + id.w, gv * w.w);
    }
  }
}

// ---------------------------------------------------------------- transpose

// (B, R, S) -> (B, S, R), cast from Ti to To: 32 x 32 tiles through shared
// memory, loads and stores along the contiguous axis.  Turns x channels-last
// for im2col and col2im_coord, and col2im's channels-last d_x back into NCHW.
template <typename Ti, typename To>
__global__ void __launch_bounds__(kThreads)
transpose_kernel(const Ti* __restrict__ in, To* __restrict__ out, int R, int S) {
  __shared__ float tile[32][33];
  const int r0 = blockIdx.y * 32, s0 = blockIdx.x * 32, tx = threadIdx.x % 32;
  const Ti* ip = in + blockIdx.z * R * S;
  To* op = out + blockIdx.z * R * S;
  for (int r = threadIdx.x / 32; r < 32; r += kThreads / 32)
    if (r0 + r < R && s0 + tx < S) tile[r][tx] = to_f(ip[(r0 + r) * S + s0 + tx]);
  __syncthreads();
  for (int s = threadIdx.x / 32; s < 32; s += kThreads / 32)
    if (s0 + s < S && r0 + tx < R) op[(s0 + s) * R + r0 + tx] = from_f<To>(tile[tx][s]);
}

template <typename Ti, typename To>
cudaError_t transpose(const void* in, void* out, int B, int R, int S, cudaStream_t stream) {
  const dim3 grid((S + 31) / 32, (R + 31) / 32, B);
  transpose_kernel<Ti, To>
      <<<grid, kThreads, 0, stream>>>(static_cast<const Ti*>(in), static_cast<To*>(out), R, S);
  return cudaGetLastError();
}

// ------------------------------------------------------------ col2im_coord

constexpr int kCoordThreads = 9 * 32;

// A col2im_coord block: kPos positions (a 128-byte run of an fp32 grad_col
// row, 64 bytes in bf16) and kVec channels a lane (16 bytes).
template <typename T>
struct CoordTile {
  static constexpr int kPos = 32;
  static constexpr int kVec = 16 / sizeof(T);
};

// the 16 bytes at x + i as floats
__device__ __forceinline__ void load16(const float* x, int i, float (&v)[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(x + i));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* x, int i, float (&v)[8]) {
  const int4 q = __ldg(reinterpret_cast<const int4*>(x + i));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

// sum_j g[j] * x[i + j] over a lane's kVec channels: 16-byte loads, or one
// element at a time (the scalar path, kVec 1)
template <typename T, int kVec>
__device__ __forceinline__ float dot(const T* x, int i, const float (&g)[kVec]) {
  constexpr int kPiece = 16 / sizeof(T);
  float d = 0.f;
  if constexpr (kVec % kPiece == 0) {
#pragma unroll
    for (int j0 = 0; j0 < kVec; j0 += kPiece) {
      float v[kPiece];
      load16(x, i + j0, v);
#pragma unroll
      for (int j = 0; j < kPiece; ++j) d += g[j0 + j] * v[j];
    }
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) d += g[j] * to_f(x[i + j]);
  }
  return d;
}

// kVec channels a lane (CoordTile's, or 1 when Cg is not a multiple of
// it), kLanes / kVec lanes a sample
template <typename T, int kVec>
__global__ void __launch_bounds__(kCoordThreads)
deform_col2im_coord_kernel(const T* __restrict__ grad_col, const T* __restrict__ x,
                           const float* __restrict__ offset, const T* __restrict__ mask,
                           float* __restrict__ grad_offset, float* __restrict__ grad_mask,
                           Geom g) {
  constexpr int kPos = CoordTile<T>::kPos, kPer = kLanes / kVec;
  const int K = g.kh * g.kw, P = g.Ho * g.Wo, n = K * kPos, Cg = g.C / g.dg;
  Block k;  // all the group's channels
  k.b = blockIdx.z;
  k.grp = blockIdx.y;
  k.c0 = k.grp * Cg;
  k.p0 = blockIdx.x * kPos;
  extern __shared__ __align__(16) unsigned char smem[];
  int4* corner = reinterpret_cast<int4*>(smem);          // [n]
  float2* frac = reinterpret_cast<float2*>(corner + n);  // [n]
  float* mk = reinterpret_cast<float*>(frac + n);        // [n]
  corner_table<T, kPos, kCoordThreads>(g, k, offset, mask, corner, frac, mk);
  __syncthreads();

  // 2. each lane sums its channels' grad_col * x at each kept corner; the
  //    sample's lanes share their sums and one lane writes.  kPer divides 32
  //    and a warp's samples have the same trip count, so every lane reaches
  //    the shuffles.
  const int lane = threadIdx.x % kPer;
  const int bg = k.b * g.dg + k.grp;
  const T* gp = grad_col + (k.b * g.C + k.c0) * K * P;  // the group's first row
  const T* xc = x + k.c0;
  float* dop = grad_offset + bg * 2 * K * P;
  float* dmp = grad_mask ? grad_mask + bg * K * P : nullptr;
  for (int s = threadIdx.x / kPer; s < n; s += kCoordThreads / kPer) {
    const int tap = s / kPos, p = k.p0 + s % kPos;
    const int4 id = corner[s];
    float d[4] = {0.f, 0.f, 0.f, 0.f};  // D_k = sum_c grad_col * x at corner k
    if ((id.x & id.y & id.z & id.w) != -1) {  // some corner kept (none past P)
#pragma unroll 1
      for (int c = lane * kVec; c < Cg; c += kLanes) {
        float gv[kVec];
#pragma unroll
        for (int j = 0; j < kVec; ++j) gv[j] = to_f(gp[((c + j) * K + tap) * P + p]);
        if (id.x >= 0) d[0] += dot<T, kVec>(xc + c, id.x, gv);
        if (id.y >= 0) d[1] += dot<T, kVec>(xc + c, id.y, gv);
        if (id.z >= 0) d[2] += dot<T, kVec>(xc + c, id.z, gv);
        if (id.w >= 0) d[3] += dot<T, kVec>(xc + c, id.w, gv);
      }
    }
    // the sum over the sample's lanes
#pragma unroll
    for (int o = 1; o < kPer; o <<= 1)
#pragma unroll
      for (int c = 0; c < 4; ++c) d[c] += __shfl_xor_sync(0xffffffffu, d[c], o);
    if (lane != 0 || p >= P) continue;
    // corner k's weight is ay * ax and its derivatives -+ax (in py) and
    // -+ay (in px), + for the far corner (ay0 = 1 - fy, ay1 = fy; ax
    // likewise); a dropped corner's D_k is 0
    const float2 f = frac[s];
    const float ay1 = f.x, ay0 = 1.f - ay1, ax1 = f.y, ax0 = 1.f - ax1, m = mk[s];
    dop[2 * tap * P + p] = m * (ax0 * (d[2] - d[0]) + ax1 * (d[3] - d[1]));
    dop[(2 * tap + 1) * P + p] = m * (ay0 * (d[1] - d[0]) + ay1 * (d[3] - d[2]));
    if (dmp) dmp[tap * P + p] = ay0 * (ax0 * d[0] + ax1 * d[1]) + ay1 * (ax0 * d[2] + ax1 * d[3]);
  }
}

// ------------------------------------------------------------------ launch

Geom geom_of(const int64_t* v) {
  return Geom{static_cast<int>(v[0]), static_cast<int>(v[1]), static_cast<int>(v[2]),
              static_cast<int>(v[3]), static_cast<int>(v[4]), static_cast<int>(v[5]),
              static_cast<int>(v[6]), static_cast<int>(v[7]), static_cast<int>(v[8]),
              static_cast<int>(v[9]), static_cast<int>(v[10]), static_cast<int>(v[11]),
              static_cast<int>(v[12]), static_cast<int>(v[13])};
}

// dynamic shared memory above the 48 KB default needs the kernel's opt-in
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// one of im2col's and col2im's blocks a (position tile, group's channel
// chunk, image)
template <typename T, typename Out>
cudaError_t launch_tiles(void (*kernel)(const T*, const float*, const T*, Out*, Geom),
                         const Geom& g, cudaStream_t stream, const void* in, const void* offset,
                         const void* mask, Out* out) {
  const int K = g.kh * g.kw, P = g.Ho * g.Wo;
  const size_t smem = Tile<T>::smem(K);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int chunks = (g.C / g.dg + kLanes - 1) / kLanes;
  const dim3 grid((P + Tile<T>::kPos - 1) / Tile<T>::kPos, g.dg * chunks, g.B);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(in),
                                           static_cast<const float*>(offset),
                                           static_cast<const T*>(mask), out, g);
  return cudaGetLastError();
}

// x_nchw (x_bf16: bfloat16, else float), when given, is first transposed
// and cast into x_cl; the gathers read x_cl
template <typename T>
int im2col(const void* x_nchw, int x_bf16, void* x_cl, const void* offset, const void* mask,
           void* col, const int64_t* gv, void* stream) {
  const Geom g = geom_of(gv);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g.B == 0 || g.C == 0 || g.Ho * g.Wo == 0) return static_cast<int>(cudaSuccess);
  if (x_nchw) {
    const cudaError_t err =
        x_bf16 ? transpose<__nv_bfloat16, T>(x_nchw, x_cl, g.B, g.C, g.H * g.W, st)
               : transpose<float, T>(x_nchw, x_cl, g.B, g.C, g.H * g.W, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(launch_tiles<T>(g.pad_h != g.pad_w ? deform_im2col_kernel<T, true>
                                                              : deform_im2col_kernel<T, false>,
                                          g, st, x_cl, offset, mask, static_cast<T*>(col)));
}

// grad_x_cl: a zeroed channels-last fp32 buffer the scatter adds into, then
// transposed into grad_x (NCHW, fp32)
template <typename T>
int col2im(const void* grad_col, const void* offset, const void* mask, void* grad_x_cl,
           void* grad_x, const int64_t* gv, void* stream) {
  const Geom g = geom_of(gv);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g.B == 0 || g.C == 0 || g.Ho * g.Wo == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = launch_tiles<T>(deform_col2im_kernel<T>, g, st, grad_col, offset, mask,
                                    static_cast<float*>(grad_x_cl));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(transpose<float, float>(grad_x_cl, grad_x, g.B, g.H * g.W, g.C, st));
}

// one block a (position tile, group, image), all the group's channels
template <typename T, int kVec>
cudaError_t launch_coord(const Geom& g, cudaStream_t stream, const void* grad_col, const void* x,
                         const void* offset, const void* mask, void* grad_offset,
                         void* grad_mask) {
  constexpr int kPos = CoordTile<T>::kPos;
  const int K = g.kh * g.kw, P = g.Ho * g.Wo;
  const size_t smem = (sizeof(int4) + sizeof(float2) + sizeof(float)) * K * kPos;
  const cudaError_t err = allow_smem(deform_col2im_coord_kernel<T, kVec>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((P + kPos - 1) / kPos, g.dg, g.B);
  deform_col2im_coord_kernel<T, kVec><<<grid, kCoordThreads, smem, stream>>>(
      static_cast<const T*>(grad_col), static_cast<const T*>(x),
      static_cast<const float*>(offset), static_cast<const T*>(mask),
      static_cast<float*>(grad_offset), static_cast<float*>(grad_mask), g);
  return cudaGetLastError();
}

// x_nchw, when given, is first transposed and cast into x_cl, as for im2col
template <typename T>
int col2im_coord(const void* grad_col, const void* x_nchw, int x_bf16, void* x_cl,
                 const void* offset, const void* mask, void* grad_offset, void* grad_mask,
                 const int64_t* gv, void* stream) {
  const Geom g = geom_of(gv);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g.B == 0 || g.Ho * g.Wo == 0) return static_cast<int>(cudaSuccess);
  if (x_nchw && g.C > 0) {
    const cudaError_t err =
        x_bf16 ? transpose<__nv_bfloat16, T>(x_nchw, x_cl, g.B, g.C, g.H * g.W, st)
               : transpose<float, T>(x_nchw, x_cl, g.B, g.C, g.H * g.W, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  constexpr int kVec = CoordTile<T>::kVec;
  return static_cast<int>((g.C / g.dg) % kVec == 0
                              ? launch_coord<T, kVec>(g, st, grad_col, x_cl, offset, mask,
                                                      grad_offset, grad_mask)
                              : launch_coord<T, 1>(g, st, grad_col, x_cl, offset, mask,
                                                   grad_offset, grad_mask));
}

}  // namespace

extern "C" int deform_im2col_f32(const void* x_nchw, int x_bf16, void* x_cl, const void* offset,
                                 const void* mask, void* col, const int64_t* geom, void* stream) {
  return im2col<float>(x_nchw, x_bf16, x_cl, offset, mask, col, geom, stream);
}

extern "C" int deform_im2col_bf16(const void* x_nchw, int x_bf16, void* x_cl, const void* offset,
                                  const void* mask, void* col, const int64_t* geom,
                                  void* stream) {
  return im2col<__nv_bfloat16>(x_nchw, x_bf16, x_cl, offset, mask, col, geom, stream);
}

extern "C" int deform_col2im_f32(const void* grad_col, const void* offset, const void* mask,
                                 void* grad_x_cl, void* grad_x, const int64_t* geom,
                                 void* stream) {
  return col2im<float>(grad_col, offset, mask, grad_x_cl, grad_x, geom, stream);
}

extern "C" int deform_col2im_bf16(const void* grad_col, const void* offset, const void* mask,
                                  void* grad_x_cl, void* grad_x, const int64_t* geom,
                                  void* stream) {
  return col2im<__nv_bfloat16>(grad_col, offset, mask, grad_x_cl, grad_x, geom, stream);
}

extern "C" int deform_col2im_coord_f32(const void* grad_col, const void* x_nchw, int x_bf16,
                                       void* x_cl, const void* offset, const void* mask,
                                       void* grad_offset, void* grad_mask, const int64_t* geom,
                                       void* stream) {
  return col2im_coord<float>(grad_col, x_nchw, x_bf16, x_cl, offset, mask, grad_offset,
                             grad_mask, geom, stream);
}

extern "C" int deform_col2im_coord_bf16(const void* grad_col, const void* x_nchw, int x_bf16,
                                        void* x_cl, const void* offset, const void* mask,
                                        void* grad_offset, void* grad_mask, const int64_t* geom,
                                        void* stream) {
  return col2im_coord<__nv_bfloat16>(grad_col, x_nchw, x_bf16, x_cl, offset, mask, grad_offset,
                                     grad_mask, geom, stream);
}
