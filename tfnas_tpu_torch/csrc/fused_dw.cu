// Fused normalise + activation -> 5x5 depthwise convolution -> per-channel
// statistics of the output, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of tfnas_tpu/kernels/fused_dw.py:
// `_kernel` (stride 1, launched by `_pallas_forward`) and `_kernel_s2`
// (stride 2, launched by `_pallas_forward_s2`). It computes
//
//   y[n, o, p, c] = sum_{dy, dx} w[dy, dx, c] *
//                   xa[n, o * s + dy - 2, p * s + dx - 2, c],
//   xa = act(x * scale[c] + offset[c])  inside the image, 0 outside,
//
// with every tap and weight rounded to x's dtype and the sum kept in f32,
// y written in x's dtype, and the f32 sum(y) and sum(y^2) of each channel
// (the next BatchNorm's batch statistics) taken from the f32 accumulator.
// The zero padding applies AFTER the activation, as in the TPU kernel.
//
// Bound: memory. The function must read x once and write y once (weights,
// scale and offset are a few KB). At the largest site of the search, the
// soft path's stage1 block1 (N 32, 112 x 112 x 768 bf16 in, stride 2,
// 56 x 56 out), that is 616.6 MB + 154.1 MB = 770.7 MB, about 0.23 ms at
// 3.35 TB/s; its 25 multiply-adds per output (3.9 GFLOP) are far below the
// f32 peak.
//
// Design against that bound: one block per (64-channel tile, output tile
// of 8 rows x TW columns, image); each of the 32 lanes owns two adjacent
// channels, so a warp moves one NHWC pixel's 64 channels in one 128-byte
// (bf16) or 256-byte (f32) access. The block stages its input window
// ((8-1)*s+5 rows x (TW-1)*s+5 columns) in shared memory once, after
// normalise + act and rounded to x's dtype (exactly the taps the
// convolution uses), so x is read from device memory once (halo rows of
// neighbouring tiles come from L2) and the activated tensor never goes to
// device memory; each thread issues 16 window loads before it activates
// them, to keep enough bytes in flight. Each thread then computes a column
// of 8 output rows, walking the window rows once and keeping the 8
// partial sums in registers: 5 shared-memory reads per window row instead
// of 25 per output. The statistics are reduced inside the block and written as one
// partial row per block; the caller sums the [R, C] partials, which keeps
// the result deterministic (no atomics). Stride 2 reads the window at
// stride 2 directly: no space-to-depth split.
//
// C interface (loaded with ctypes): fused_dw_forward(...) returns
// cudaGetLastError() after the launch; 0 means launched.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int LANES = 32;  // threadIdx.x; each lane owns two channels
constexpr int ROWS = 8;    // threadIdx.y
constexpr int CPB = 2 * LANES;  // channels per block
constexpr int TH = 8;      // output rows per tile (one register column)
constexpr int K = 5;       // taps per side
constexpr int PAD = 2;

// Two adjacent channels of T: loads, stores and the shared-memory tap type.
template <typename T> struct Pair;

template <> struct Pair<float> {
  using V = float2;
  __device__ static V load(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  __device__ static V pack(float a, float b) { return make_float2(a, b); }
  __device__ static float2 unpack(V v) { return v; }
  __device__ static float round(float v) { return v; }
  __device__ static void store(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};

template <> struct Pair<__nv_bfloat16> {
  using V = __nv_bfloat162;
  __device__ static V load(const __nv_bfloat16* p) {
    return *reinterpret_cast<const __nv_bfloat162*>(p);
  }
  __device__ static V pack(float a, float b) {
    return __floats2bfloat162_rn(a, b);
  }
  __device__ static float2 unpack(V v) { return __bfloat1622float2(v); }
  __device__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  __device__ static void store(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};

// Activation codes shared with kernels/fused_dw.py (_ACT_CODES).
__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case 1: return fmaxf(v, 0.f);                                  // relu
    case 2: return v * (1.f / (1.f + expf(-v)));                   // swish
    case 3: return v * fminf(fmaxf(v + 3.f, 0.f), 6.f) * (1.f / 6.f);  // h-swish
    case 4: return fminf(fmaxf(v, 0.f), 6.f);                      // relu6
    default: return v;                                             // none
  }
}

template <typename T, int S, int TW>
__global__ void __launch_bounds__(LANES * ROWS, 2)
fused_dw_kernel(const T* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ scale,
                const float* __restrict__ offset, T* __restrict__ y,
                float* __restrict__ psum, float* __restrict__ psq, int H,
                int W, int C, int Ho, int Wo, int act, int tiles_w) {
  using P = Pair<T>;
  using V = typename P::V;
  constexpr int WR = (TH - 1) * S + K, WC = (TW - 1) * S + K;
  extern __shared__ __align__(16) unsigned char smem[];
  V* win = reinterpret_cast<V*>(smem);  // [WR * WC][LANES] activated taps
  __shared__ float2 red_s[ROWS][LANES];
  __shared__ float2 red_q[ROWS][LANES];

  const int lane = threadIdx.x, row = threadIdx.y;
  const int c = blockIdx.x * CPB + 2 * lane;  // C is even: c < C => c+1 < C
  const bool live = c < C;
  const int tile = blockIdx.y, n = blockIdx.z;
  const int oy0 = (tile / tiles_w) * TH, ox0 = (tile % tiles_w) * TW;
  const int iy0 = oy0 * S - PAD, ix0 = ox0 * S - PAD;
  const float2 sc = live ? make_float2(scale[c], scale[c + 1])
                         : make_float2(0.f, 0.f);
  const float2 of = live ? make_float2(offset[c], offset[c + 1])
                         : make_float2(0.f, 0.f);

  // Stage the window: each thread loads CHUNK pixels before it activates
  // any, so many independent loads are in flight per SM.
  constexpr int NP = WR * WC, PER = (NP + ROWS - 1) / ROWS, CHUNK = 16;
  const T* xn = x + (size_t)n * H * W * C + c;
#pragma unroll
  for (int j0 = 0; j0 < PER; j0 += CHUNK) {
    V raw[CHUNK];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      const int p = row + (j0 + j) * ROWS;
      const int gy = iy0 + p / WC, gx = ix0 + p % WC;
      raw[j] = P::pack(0.f, 0.f);
      if (j0 + j < PER && p < NP && live && gy >= 0 && gy < H && gx >= 0 &&
          gx < W)
        raw[j] = P::load(xn + ((size_t)gy * W + gx) * C);
    }
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      const int p = row + (j0 + j) * ROWS;
      if (j0 + j < PER && p < NP) {
        const int gy = iy0 + p / WC, gx = ix0 + p % WC;
        float2 v = make_float2(0.f, 0.f);  // zero padding, after the act
        if (live && gy >= 0 && gy < H && gx >= 0 && gx < W) {
          const float2 xv = P::unpack(raw[j]);
          v.x = activate(xv.x * sc.x + of.x, act);
          v.y = activate(xv.y * sc.y + of.y, act);
        }
        win[p * LANES + lane] = P::pack(v.x, v.y);  // rounds to x's dtype
      }
    }
  }
  float w0[K * K], w1[K * K];
#pragma unroll
  for (int t = 0; t < K * K; ++t) {
    w0[t] = live ? P::round(w[(size_t)t * C + c]) : 0.f;
    w1[t] = live ? P::round(w[(size_t)t * C + c + 1]) : 0.f;
  }
  __syncthreads();

  float2 s = make_float2(0.f, 0.f), q = make_float2(0.f, 0.f);
  T* yn = y + (size_t)n * Ho * Wo * C + c;
  for (int tx = row; tx < TW && ox0 + tx < Wo; tx += ROWS) {
    float a0[TH], a1[TH];
#pragma unroll
    for (int o = 0; o < TH; ++o) a0[o] = a1[o] = 0.f;
#pragma unroll
    for (int r = 0; r < WR; ++r) {
      float2 tap[K];
#pragma unroll
      for (int dx = 0; dx < K; ++dx)
        tap[dx] = P::unpack(win[(r * WC + tx * S + dx) * LANES + lane]);
#pragma unroll
      for (int o = 0; o < TH; ++o) {
        const int dy = r - o * S;  // compile-time after unrolling
        if (dy >= 0 && dy < K) {
#pragma unroll
          for (int dx = 0; dx < K; ++dx) {
            a0[o] += tap[dx].x * w0[dy * K + dx];
            a1[o] += tap[dx].y * w1[dy * K + dx];
          }
        }
      }
    }
    if (live) {
      const int ox = ox0 + tx;
#pragma unroll
      for (int o = 0; o < TH; ++o) {
        if (oy0 + o < Ho) {
          P::store(yn + ((size_t)(oy0 + o) * Wo + ox) * C, a0[o], a1[o]);
          s.x += a0[o];
          s.y += a1[o];
          q.x += a0[o] * a0[o];
          q.y += a1[o] * a1[o];
        }
      }
    }
  }
  red_s[row][lane] = s;
  red_q[row][lane] = q;
  __syncthreads();
  if (row == 0 && live) {
    float2 ts = make_float2(0.f, 0.f), tq = make_float2(0.f, 0.f);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      ts.x += red_s[r][lane].x;
      ts.y += red_s[r][lane].y;
      tq.x += red_q[r][lane].x;
      tq.y += red_q[r][lane].y;
    }
    const size_t slot = ((size_t)n * gridDim.y + tile) * C + c;
    *reinterpret_cast<float2*>(psum + slot) = ts;
    *reinterpret_cast<float2*>(psq + slot) = tq;
  }
}

template <typename T, int S, int TW>
cudaError_t launch(const void* x, const void* w, const void* scale,
                   const void* offset, void* y, void* psum, void* psq, int n,
                   int h, int wd, int c, int act, cudaStream_t stream) {
  const int ho = (h - 1) / S + 1, wo = (wd - 1) / S + 1;
  const int tiles_h = (ho + TH - 1) / TH, tiles_w = (wo + TW - 1) / TW;
  const size_t smem = (size_t)((TH - 1) * S + K) * ((TW - 1) * S + K) *
                      LANES * sizeof(typename Pair<T>::V);
  cudaError_t err = cudaFuncSetAttribute(
      fused_dw_kernel<T, S, TW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((c + CPB - 1) / CPB, tiles_h * tiles_w, n);
  const dim3 block(LANES, ROWS);
  fused_dw_kernel<T, S, TW><<<grid, block, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(offset),
      static_cast<T*>(y), static_cast<float*>(psum),
      static_cast<float*>(psq), h, wd, c, ho, wo, act, tiles_w);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* w, const void* scale,
                     const void* offset, void* y, void* psum, void* psq,
                     int n, int h, int wd, int c, int stride, int act, int tw,
                     cudaStream_t s) {
  if (stride == 1 && tw == 16)
    return launch<T, 1, 16>(x, w, scale, offset, y, psum, psq, n, h, wd, c,
                            act, s);
  if (stride == 1 && tw == 8)
    return launch<T, 1, 8>(x, w, scale, offset, y, psum, psq, n, h, wd, c,
                           act, s);
  if (stride == 2 && tw == 8)
    return launch<T, 2, 8>(x, w, scale, offset, y, psum, psq, n, h, wd, c,
                           act, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// x: [n, h, wd, c] (float32 if is_bf16 == 0, else bfloat16), contiguous,
// c even; w: [5, 5, c] f32; scale, offset: [c] f32; y: [n, ho, wo, c] in
// x's dtype; psum, psq: [n * tiles_h * tiles_w, c] f32 partials over tiles
// of 8 x tw output pixels (tw 16 or 8 at stride 1, 8 at stride 2). Returns
// the CUDA error code of the launch.
extern "C" int fused_dw_forward(const void* x, const void* w,
                                const void* scale, const void* offset,
                                void* y, void* psum, void* psq, int n, int h,
                                int wd, int c, int stride, int act,
                                int is_bf16, int tw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c % 2 != 0) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return (int)dispatch<__nv_bfloat16>(x, w, scale, offset, y, psum, psq, n,
                                        h, wd, c, stride, act, tw, s);
  return (int)dispatch<float>(x, w, scale, offset, y, psum, psq, n, h, wd, c,
                              stride, act, tw, s);
}
