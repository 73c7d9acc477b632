// The epilogue of a biased convolution or linear layer in one pass, for
// NVIDIA Hopper (sm_90a):
//
//   out = act(x * s[n, c] + b[c]) + r        s, b, r and act each optional
//
// x is the layer's output without its bias (bf16 or f32), b the folded
// bias as stored (f32, or bf16 where the parameters are held in bf16), s a
// per-(image, channel) squeeze-excite gate (f32 or bf16), r a residual of
// x's shape and layout. The maths is f32 and the
// result is rounded once, to x's dtype.
//
// Why it was added: it replaces no TPU kernel. The JAX package leaves these
// passes to XLA, which fuses a bias, an activation and a residual into the
// convolution that makes them. PyTorch runs each as a kernel of its own: a
// cast of the bias to bf16, the broadcast bias add, sigmoid and multiply for
// swish, the SE gate's multiply, the residual add. A BN-folded MBConv block
// with SE read and wrote its bf16 map three or four times in about 30
// launches. Here each epilogue is one launch that reads x (and r) once and
// writes out once.
//
// Bound: memory. An element moves 4 bytes in bf16 (6 with a residual), at
// 3.35 TB/s from HBM; the activation costs at most ~25 f32 instructions an
// element, which the loads cover. Most maps after the served net's second
// stage are 1-12 MB and still sit in the 50 MB L2 when this kernel reads
// them right after their convolution wrote them, so a share of the HBM
// bound could read above 100% while the kernel does just its work: none is
// kept.
//
// Design:
// - Vector path (C % 8 == 0, channels_last [N, C, H, W] or [N, C], every
//   operand 16-byte aligned): a thread loads and stores 8 consecutive
//   channels (16 bytes of bf16, 32 of f32), its 8 biases and the gate's 8
//   values of its image, all through the read-only path. Every
//   channel count of the served net is a multiple of 8 (16 ... 1280).
// - Scalar path (any other C, contiguous NCHW maps, unaligned operands):
//   one element a thread, its channel and image from the layout.
// - The grid is sized from the element count (one vector or element a
//   thread, 256 threads a block), so a 25-38 MB map at 112^2 or 56^2 gives
//   thousands of blocks for the 132 SMs; the small [N, C] SE tensors take a
//   few blocks. A grid-stride loop covers counts beyond MAX_BLOCKS.
// - The activation is a template argument (codes shared with
//   kernels/bias_act.py ACT_CODES): each instance is straight-line code.
// - No atomics, no allocation, no synchronisation: the wrapper allocates
//   out, and the launch goes to the caller's stream.
//
// C interface (loaded with ctypes): tfnas_bias_act_forward(...) returns
// cudaGetLastError() after the launch; 0 means launched.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;  // channels a thread of the vector path takes
constexpr unsigned MAX_BLOCKS = 1u << 16;

// Activation codes shared with kernels/bias_act.py (ACT_CODES); the
// functions of ops/activations.py, in f32.
template <int ACT>
__device__ __forceinline__ float activate(float v) {
  if constexpr (ACT == 1) return fmaxf(v, 0.f);                     // relu
  if constexpr (ACT == 2) return fminf(fmaxf(v, 0.f), 6.f);         // relu6
  if constexpr (ACT == 3) return v * (1.f / (1.f + expf(-v)));      // swish
  if constexpr (ACT == 4)                                         // h-swish
    return v * fminf(fmaxf(v + 3.f, 0.f), 6.f) * (1.f / 6.f);
  if constexpr (ACT == 5) return 1.f / (1.f + expf(-v));          // sigmoid
  if constexpr (ACT == 6) return tanhf(v);                           // tanh
  if constexpr (ACT == 7)                                            // gelu
    return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
  return v;                                                           // none
}

// 8 consecutive values as f32, read through the read-only path.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// 8 values at p + at of a bias or gate held in bf16 (is_bf16) or f32.
__device__ __forceinline__ void load8(const void* p, int is_bf16, size_t at,
                                      float* f) {
  if (is_bf16)
    load8(static_cast<const __nv_bfloat16*>(p) + at, f);
  else
    load8(static_cast<const float*>(p) + at, f);
}

// 8 f32 values rounded to the output's dtype, in one 16-byte store (two
// for f32).
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* f) {
  uint4 u;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(float* p, const float* f) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load1(const void* p, int is_bf16,
                                       size_t at) {
  return is_bf16 ? load1(static_cast<const __nv_bfloat16*>(p) + at)
                 : load1(static_cast<const float*>(p) + at);
}

__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

// The vector path: vector v holds channels [c, c + 8) of one pixel (or
// row), c = (v % cvec) * 8, of image v / img_vec.
template <typename T, int ACT>
__global__ void __launch_bounds__(THREADS)
tfnas_bias_act_vec(const T* __restrict__ x, const void* __restrict__ b,
                   int b_bf16, const void* __restrict__ s, int s_bf16,
                   const T* __restrict__ r, T* __restrict__ out,
                   unsigned nvec, unsigned cvec, unsigned img_vec) {
  const unsigned step = gridDim.x * THREADS;
  for (unsigned v = blockIdx.x * THREADS + threadIdx.x; v < nvec;
       v += step) {
    const size_t at = (size_t)v * VEC;
    const unsigned c = (v % cvec) * VEC;
    float f[VEC], rr[VEC];
    load8(x + at, f);
    if (r != nullptr) load8(r + at, rr);
    if (s != nullptr) {
      const size_t g_at = (size_t)(v / img_vec) * cvec * VEC + c;
      float g[VEC];
      load8(s, s_bf16, g_at, g);
#pragma unroll
      for (int i = 0; i < VEC; ++i) f[i] *= g[i];
    }
    if (b != nullptr) {
      float bb[VEC];
      load8(b, b_bf16, c, bb);
#pragma unroll
      for (int i = 0; i < VEC; ++i) f[i] += bb[i];
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) f[i] = activate<ACT>(f[i]);
    if (r != nullptr) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) f[i] += rr[i];
    }
    store8(out + at, f);
  }
}

// The scalar path: element i of a channels_last map or [N, C] rows
// (channel i % c) or of a contiguous NCHW map (channel (i / hw) % c).
template <typename T, int ACT>
__global__ void __launch_bounds__(THREADS)
tfnas_bias_act_scalar(const T* __restrict__ x, const void* __restrict__ b,
                      int b_bf16, const void* __restrict__ s, int s_bf16,
                      const T* __restrict__ r, T* __restrict__ out,
                      unsigned numel, unsigned c, unsigned hw, int nchw) {
  const unsigned step = gridDim.x * THREADS;
  for (unsigned i = blockIdx.x * THREADS + threadIdx.x; i < numel;
       i += step) {
    const unsigned ch = nchw ? (i / hw) % c : i % c;
    float f = load1(x + i);
    if (s != nullptr) {
      const unsigned g_at = i / (hw * c) * c + ch;
      f *= load1(s, s_bf16, g_at);
    }
    if (b != nullptr) f += load1(b, b_bf16, ch);
    f = activate<ACT>(f);
    if (r != nullptr) f += load1(r + i);
    store1(out + i, f);
  }
}

// One call's operands and shape, as the C interface receives them.
struct Call {
  const void* x;
  const void* b;
  int b_bf16;
  const void* s;
  int s_bf16;
  const void* r;
  void* out;
  unsigned numel, c, hw;
  int nchw, vec;
  cudaStream_t stream;
};

template <typename T, int ACT>
cudaError_t launch(const Call& a) {
  const unsigned work = a.vec ? a.numel / VEC : a.numel;
  unsigned blocks = (work + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  const T* x = static_cast<const T*>(a.x);
  const T* r = static_cast<const T*>(a.r);
  T* out = static_cast<T*>(a.out);
  if (a.vec)
    tfnas_bias_act_vec<T, ACT><<<blocks, THREADS, 0, a.stream>>>(
        x, a.b, a.b_bf16, a.s, a.s_bf16, r, out, work, a.c / VEC,
        a.hw * a.c / VEC);
  else
    tfnas_bias_act_scalar<T, ACT><<<blocks, THREADS, 0, a.stream>>>(
        x, a.b, a.b_bf16, a.s, a.s_bf16, r, out, a.numel, a.c, a.hw,
        a.nchw);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int act, const Call& a) {
  switch (act) {
    case 0: return launch<T, 0>(a);
    case 1: return launch<T, 1>(a);
    case 2: return launch<T, 2>(a);
    case 3: return launch<T, 3>(a);
    case 4: return launch<T, 4>(a);
    case 5: return launch<T, 5>(a);
    case 6: return launch<T, 6>(a);
    case 7: return launch<T, 7>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, r, out: numel = n * c * hw elements of one dtype (float32 if is_bf16
// == 0, else bfloat16), channels_last [n, c, h, w] or [n, c] rows (nchw ==
// 0) or contiguous NCHW (nchw == 1); b: [c] (bf16 if b_bf16, else f32) or
// null; s: [n, c] (bf16 if s_bf16, else f32) or null; r: null for no
// residual. vec == 1 takes the vector path: c % 8 == 0, nchw == 0 and every
// pointer 16-byte aligned.
// act: an ACT_CODES code. numel < 2^31. Returns the CUDA error code of the
// launch.
extern "C" int tfnas_bias_act_forward(const void* x, const void* b,
                                      int b_bf16, const void* s, int s_bf16,
                                      const void* r, void* out,
                                      long long numel, long long c,
                                      long long hw, int is_bf16, int act,
                                      int nchw, int vec, void* stream) {
  if (numel < 1 || numel >= (1LL << 31) || c < 1 || hw < 1 ||
      numel % (c * hw) != 0)
    return (int)cudaErrorInvalidValue;
  if (vec && (c % VEC != 0 || nchw)) return (int)cudaErrorInvalidValue;
  const Call a{x, b, b_bf16, s, s_bf16, r, out,
               (unsigned)numel, (unsigned)c, (unsigned)hw, nchw, vec,
               static_cast<cudaStream_t>(stream)};
  return (int)(is_bf16 ? dispatch<__nv_bfloat16>(act, a)
                       : dispatch<float>(act, a));
}
