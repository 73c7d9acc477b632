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
// scale and offset are a few KB): at the largest stride-2 site of the
// search (N 32, 112 x 112 x 768 bf16 in) 770.7 MB, about 0.23 ms at
// 3.35 TB/s. Its f32 math is not small beside that: 25 FMAs per output
// (0.09 ms at 56 x 56 x 1152 stride 1 at the card's f32 rate) and the
// activation per input, so loads, activation and math have to overlap.
//
// Design: row streaming.
// - Work. A block of 8 warps owns CB = 64 * (8 / CW) channels and a strip
//   of SW = 4 * CW output columns (CW = 8, 4, 2 or 1 column warps: the
//   least that covers the output width; the other warps take more
//   channels). Per channel group the work list is the items (image, row
//   segment, column strip), strip fastest. A persistent grid of at most
//   two blocks per SM gives each channel group `bpg` blocks, and block j
//   of a group walks items j, j + bpg, ... of it. kernels/fused_dw.py
//   `plan` chooses CW, the segment and bpg; `work_items` there mirrors
//   this order for the tests.
// - Ring. A block streams down the rows of its strip. Raw input rows
//   ((SW - 1) * S + 5 columns x CB channels) arrive in a ring of DEPTH = 6
//   slots of shared memory by cp.async copies of 16 bytes (8 bf16 or 4
//   f32 channels a thread; one channel pair, 4 or 8 bytes, where C is not
//   a multiple of that), issued DEPTH - 1 = 5 rows ahead of the math and
//   running on into the block's next item. Each thread activates, in
//   place, exactly the vectors it copied, so its own wait_group makes them
//   visible to it; one __syncthreads per input row, after the activation,
//   is the only barrier. Each input pixel is read from device memory once
//   and activated once per strip: the halo is only the strip's 4 extra
//   columns (1.13x at stride 1 and 1.05x at stride 2 for a 32-column
//   strip) and a segment's 4 extra rows (none for a whole-column segment).
// - Padding. The activation writes 0 for columns outside the image
//   (masked by coordinate, after the activation); rows outside the image
//   are neither copied nor read. A TMA tensor map would fill the halo
//   with x = 0, which is not the padding, since act(offset) is not 0.
// - Activation. The act code is a template argument of the activation
//   pass, dispatched once per row: a switch per element cost more than the
//   whole convolution at stride 2.
// - Math. Lane l of a warp owns channels 2l, 2l + 1 of the warp's 64 (a
//   warp reads 128 contiguous bytes of a bf16 row: no bank conflicts) and
//   4 adjacent output columns, with its 50 f32 weights in registers (8
//   channels a thread would need 200). As an activated row arrives, each
//   thread reads its (4 - 1) * S + 5 taps once and adds them into the
//   rolling accumulators of the 5 (stride 1) or 3 (stride 2) output rows
//   that use that row. The row loop is unrolled over the 5 (6) rows after
//   which the accumulator slots repeat, so they are registers. An output
//   row is stored (bf16x2 or float2: 128 or 256 contiguous bytes a warp)
//   when its last input row is in.
// - Statistics. Each thread keeps sum(y) and sum(y^2) of its channel pair
//   in registers over the block's whole work list. The block reduces them
//   in a fixed order into its one partial row (part[0 or 1][j][c]), and
//   the wrapper's single torch.sum over the bpg rows finishes them. There
//   are no atomics, so two runs give identical sums.
// - Host. The shared-memory attribute is set once per instantiation, and
//   the wrapper makes one scratch tensor, for the partials.
//
// Measured and not taken (PERF.md): a warp-specialised block (4
// producer warps copying and activating, 8 consumer warps doing the math,
// mbarrier full/empty rings instead of the row barrier) ran slower at
// every main-path site: its producers could not activate fast enough, and
// one block of 12 warps per SM left too few warps for the math. Two rows
// per barrier, one channel per thread and 4-warp blocks were slower too.
// What holds this design back is registers: 50 weights and 40 (stride 1)
// accumulators live across the activation, so at the 128 registers of two
// blocks per SM ptxas spills up to 132 bytes in the stride-1 instances.
//
// C interface (loaded with ctypes): fused_dw_forward(...) returns
// cudaGetLastError() after the launch; 0 means launched.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int COLS = 4;    // output columns a thread computes
constexpr int GROUP = 64;  // channels of one warp: 32 lanes x a pair
constexpr int K = 5;       // taps per side
constexpr int PAD = 2;
constexpr int DEPTH = 6;   // ring slots; copies run DEPTH - 1 rows ahead
constexpr int MAX_SMEM = 227 * 1024;

__host__ __device__ constexpr int pmod(int a, int m) {
  return ((a % m) + m) % m;
}

// Elements of T packed into 32-bit words, for the vector copies.
template <typename T> struct Elem;

template <> struct Elem<float> {
  static constexpr int PER_WORD = 1;
  __device__ static void unpack(uint32_t w, float* f) {
    f[0] = __uint_as_float(w);
  }
  __device__ static uint32_t pack(const float* f) {
    return __float_as_uint(f[0]);
  }
  __device__ static float round(float v) { return v; }
  __device__ static float2 load2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  __device__ static void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};

template <> struct Elem<__nv_bfloat16> {
  static constexpr int PER_WORD = 2;
  __device__ static void unpack(uint32_t w, float* f) {
    f[0] = __uint_as_float(w << 16);
    f[1] = __uint_as_float(w & 0xffff0000u);
  }
  __device__ static uint32_t pack(const float* f) {
    __nv_bfloat162 h = __floats2bfloat162_rn(f[0], f[1]);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  __device__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  __device__ static float2 load2(const __nv_bfloat16* p) {
    float f[2];
    unpack(*reinterpret_cast<const uint32_t*>(p), f);
    return make_float2(f[0], f[1]);
  }
  __device__ static void store2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};

// E elements of T as BYTES / 4 words: one copy, one activation step.
template <int BYTES> struct alignas(BYTES) Words {
  uint32_t w[BYTES / 4];
};

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(gmem), "n"(BYTES)
                 : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// f(integral_constant<int, 0>), ..., f(integral_constant<int, N - 1>): the
// row loop's phase is a compile-time constant, so the rolling accumulators
// are indexed by constants and stay in registers.
template <int N, int I = 0, class F>
__device__ __forceinline__ void unrolled(F&& f) {
  if constexpr (I < N) {
    f(std::integral_constant<int, I>{});
    unrolled<N, I + 1>(f);
  }
}

// Activation codes shared with kernels/fused_dw.py (_ACT_CODES). The
// code is a template argument: the activation pass dispatches once per row,
// not once per element.
template <int ACT> __device__ __forceinline__ float activate(float v) {
  if constexpr (ACT == 1) return fmaxf(v, 0.f);                        // relu
  if constexpr (ACT == 2) return __fdividef(v, 1.f + __expf(-v));      // swish
  if constexpr (ACT == 3)  // h-swish
    return v * fminf(fmaxf(v + 3.f, 0.f), 6.f) * (1.f / 6.f);
  if constexpr (ACT == 4) return fminf(fmaxf(v, 0.f), 6.f);            // relu6
  return v;                                                            // none
}

// Activate, in place, this thread's vectors of one raw row: pixels p0,
// p0 + ppi, ... < iw of the slot, channels [ch, ch + E) of the block
// (scale and offset in shared memory); 0 outside the image, since the
// padding applies after the activation.
template <int ACT, typename T, int E>
__device__ __forceinline__ void activate_row(T* slot, int p0, int ppi,
                                             int iw, int cb, int ch,
                                             bool chunk_live, int ix0, int W,
                                             const float* scale_s,
                                             const float* offset_s) {
  using El = Elem<T>;
  constexpr int BYTES = E * sizeof(T);
  using Vec = Words<BYTES>;
  for (int p = p0; p < iw; p += ppi) {
    const int gx = ix0 + p;
    Vec* v = reinterpret_cast<Vec*>(slot + (size_t)p * cb + ch);
    Vec out;
    if (chunk_live && gx >= 0 && gx < W) {
      const Vec raw = *v;
#pragma unroll
      for (int m = 0; m < BYTES / 4; ++m) {
        float f[El::PER_WORD];
        El::unpack(raw.w[m], f);
        const int c0 = ch + m * El::PER_WORD;
#pragma unroll
        for (int e = 0; e < El::PER_WORD; ++e)
          f[e] = activate<ACT>(f[e] * scale_s[c0 + e] + offset_s[c0 + e]);
        out.w[m] = El::pack(f);  // rounds to x's dtype
      }
    } else {
#pragma unroll
      for (int m = 0; m < BYTES / 4; ++m) out.w[m] = 0u;
    }
    *v = out;
  }
}

// The static decomposition (mirrored by kernels/fused_dw.py `plan`).
struct Geometry {
  int cb, sw, iw, strips, segs, items;
};

template <int S>
__host__ __device__ Geometry geometry(int n, int ho, int wo, int cw, int rs) {
  Geometry g;
  g.cb = GROUP * (WARPS / cw);
  g.sw = COLS * cw;
  g.iw = (g.sw - 1) * S + K;
  g.strips = (wo + g.sw - 1) / g.sw;
  g.segs = (ho + rs - 1) / rs;
  g.items = n * g.segs * g.strips;
  return g;
}

template <typename T>
__host__ __device__ size_t smem_bytes(int iw, int cb) {
  return (size_t)DEPTH * iw * cb * sizeof(T) + 2 * cb * sizeof(float) +
         WARPS * 32 * sizeof(float4);
}

// One item's coordinates.
struct Item {
  int n, oy0, nvalid, ox0, nk;
};

template <int S>
__device__ __forceinline__ Item item_at(int i, const Geometry& g, int ho,
                                        int rs) {
  Item it;
  const int strip = i % g.strips, seg = (i / g.strips) % g.segs;
  it.n = i / (g.strips * g.segs);
  it.oy0 = seg * rs;
  it.nvalid = min(rs, ho - it.oy0);
  it.ox0 = strip * g.sw;
  it.nk = (it.nvalid - 1) * S + K;
  return it;
}

template <typename T, int S, int E>
__global__ void __launch_bounds__(THREADS, 2)
fused_dw_kernel(const T* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ scale,
                const float* __restrict__ offset, T* __restrict__ y,
                float* __restrict__ part, int N, int H, int W, int C,
                int Ho, int Wo, int act, int cw, int rs, int bpg) {
  using El = Elem<T>;
  constexpr int BYTES = E * sizeof(T);
  constexpr int NA = S == 1 ? 5 : 3;  // output rows one input row feeds
  constexpr int P = NA * S;           // unroll: accumulator slots repeat
  constexpr int NT = (COLS - 1) * S + K;  // tap columns of a thread

  const Geometry geo = geometry<S>(N, Ho, Wo, cw, rs);
  const int CB = geo.cb, IW = geo.iw;
  const int grp = blockIdx.x / bpg, j = blockIdx.x % bpg;
  const int c_base = grp * CB;

  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const size_t slot_elems = (size_t)IW * CB;
  float* scale_s = reinterpret_cast<float*>(ring + DEPTH * slot_elems);
  float* offset_s = scale_s + CB;
  float4* red = reinterpret_cast<float4*>(offset_s + CB);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // copy / activation role: a fixed E-channel chunk, pixels p0 + i * PPI
  const int VP = CB / E, PPI = THREADS / VP;
  const int ch = (tid % VP) * E, p0 = tid / VP;
  const bool chunk_live = c_base + ch < C;  // C % E == 0: whole chunk

  // compute role: a channel pair of one warp group and 4 output columns
  const int gl = warp / cw, cwi = warp % cw;
  const int cl = gl * GROUP + 2 * lane, c = c_base + cl;
  const bool live = c < C;  // C is even: c < C => c + 1 < C

  for (int i = tid; i < CB; i += THREADS) {
    const bool ok = c_base + i < C;
    scale_s[i] = ok ? scale[c_base + i] : 0.f;
    offset_s[i] = ok ? offset[c_base + i] : 0.f;
  }
  float wt[K * K][2];
#pragma unroll
  for (int t = 0; t < K * K; ++t) {
    wt[t][0] = live ? El::round(w[(size_t)t * C + c]) : 0.f;
    wt[t][1] = live ? El::round(w[(size_t)t * C + c + 1]) : 0.f;
  }

  // producer cursor: the next row to copy, DEPTH - 1 rows ahead
  int pi = j, pk = 0, pq = 0;
  Item pit = item_at<S>(pi < geo.items ? pi : 0, geo, Ho, rs);
  auto issue = [&]() {
    if (pi < geo.items) {
      const int iy = pit.oy0 * S - PAD + pk;
      if (iy >= 0 && iy < H && chunk_live) {
        T* slot = ring + (size_t)(pq % DEPTH) * slot_elems;
        const int ix0 = pit.ox0 * S - PAD;
        const T* src = x + ((size_t)pit.n * H + iy) * W * C + c_base + ch;
        for (int p = p0; p < IW; p += PPI) {
          const int gx = ix0 + p;
          if (gx >= 0 && gx < W)
            cp_async<BYTES>(slot + (size_t)p * CB + ch, src + (size_t)gx * C);
        }
      }
      if (++pk == pit.nk) {
        pk = 0;
        pi += bpg;
        if (pi < geo.items) pit = item_at<S>(pi, geo, Ho, rs);
      }
    }
    ++pq;
    cp_commit();  // one group per row, empty or not
  };
  for (int r = 0; r < DEPTH - 1; ++r) issue();
  __syncthreads();  // scale_s / offset_s

  float2 st_s = make_float2(0.f, 0.f), st_q = make_float2(0.f, 0.f);
  int q = 0;  // consumer's row count: ring slot q % DEPTH
  for (int i = j; i < geo.items; i += bpg) {
    const Item it = item_at<S>(i, geo, Ho, rs);
    const int ix0 = it.ox0 * S - PAD;
    const bool cols_live = it.ox0 + cwi * COLS < Wo;
    T* yn = y + (size_t)it.n * Ho * Wo * C + c;
    // acc[o mod NA]: output row o of the item. Rows outside [0, nvalid)
    // accumulate too (no guard in the inner loop) and are never stored.
    float acc[NA][COLS][2];
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int t = 0; t < COLS; ++t) acc[a][t][0] = acc[a][t][1] = 0.f;

    for (int k0 = 0; k0 < it.nk; k0 += P) {
      unrolled<P>([&](auto phase) {
        constexpr int ph = decltype(phase)::value;
        const int k = k0 + ph;
        if (k < it.nk) {
          T* slot = ring + (size_t)(q % DEPTH) * slot_elems;
          ++q;
          const int iy = it.oy0 * S - PAD + k;
          const bool in_img = iy >= 0 && iy < H;
          cp_wait<DEPTH - 2>();  // this thread's copies of row k are in
          if (in_img) {
            switch (act) {
#define FDW_ACT(A)                                                        \
  case A:                                                                 \
    activate_row<A, T, E>(slot, p0, PPI, IW, CB, ch, chunk_live, ix0, W,  \
                          scale_s, offset_s);                             \
    break;
              FDW_ACT(0) FDW_ACT(1) FDW_ACT(2) FDW_ACT(3) FDW_ACT(4)
#undef FDW_ACT
            }
          }
          __syncthreads();  // row k activated; row k - 1 no longer read
          issue();
          if (in_img && cols_live) {
            const T* base = slot + (size_t)(cwi * COLS * S) * CB + cl;
            float2 tap[NT];
#pragma unroll
            for (int jt = 0; jt < NT; ++jt)
              tap[jt] = El::load2(base + (size_t)jt * CB);
#pragma unroll
            for (int dx = 0; dx < K; ++dx) {
#pragma unroll
              for (int dy = 0; dy < K; ++dy) {
                if (pmod(ph - dy, S) != 0) continue;
                // output row (k - dy) / S lives in acc[((ph - dy) / S) mod NA]
                const int a = pmod((ph - dy) / S, NA);
#pragma unroll
                for (int t = 0; t < COLS; ++t) {
                  const float2 tv = tap[t * S + dx];
                  acc[a][t][0] = fmaf(tv.x, wt[dy * K + dx][0], acc[a][t][0]);
                  acc[a][t][1] = fmaf(tv.y, wt[dy * K + dx][1], acc[a][t][1]);
                }
              }
            }
          }
          // output row (k - 4) / S takes its last input row here
          if (pmod(ph - (K - 1), S) == 0) {
            const int o = (k - (K - 1)) / S;
            const int a = pmod((ph - (K - 1)) / S, NA);
            if (k >= K - 1 && o < it.nvalid && live) {
              T* yr = yn + (size_t)(it.oy0 + o) * Wo * C;
#pragma unroll
              for (int t = 0; t < COLS; ++t) {
                const int ox = it.ox0 + cwi * COLS + t;
                if (ox < Wo) {
                  const float v0 = acc[a][t][0], v1 = acc[a][t][1];
                  El::store2(yr + (size_t)ox * C, v0, v1);
                  st_s.x += v0;
                  st_s.y += v1;
                  st_q.x += v0 * v0;
                  st_q.y += v1 * v1;
                }
              }
            }
#pragma unroll
            for (int t = 0; t < COLS; ++t) acc[a][t][0] = acc[a][t][1] = 0.f;
          }
        }
      });
    }
  }
  cp_wait<0>();

  red[tid] = make_float4(st_s.x, st_s.y, st_q.x, st_q.y);
  __syncthreads();
  if (cwi == 0 && live) {
    float4 tot = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < cw; ++r) {  // fixed order: deterministic
      const float4 v = red[(gl * cw + r) * 32 + lane];
      tot.x += v.x;
      tot.y += v.y;
      tot.z += v.z;
      tot.w += v.w;
    }
    *reinterpret_cast<float2*>(part + (size_t)j * C + c) =
        make_float2(tot.x, tot.y);
    *reinterpret_cast<float2*>(part + ((size_t)bpg + j) * C + c) =
        make_float2(tot.z, tot.w);
  }
}

template <typename T, int S, int E>
cudaError_t launch(const void* x, const void* w, const void* scale,
                   const void* offset, void* y, void* part, int n, int h,
                   int wd, int c, int act, int cw, int rs, int bpg,
                   cudaStream_t stream) {
  static bool attr_set = false;  // once per instantiation
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_dw_kernel<T, S, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MAX_SMEM);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int ho = (h - 1) / S + 1, wo = (wd - 1) / S + 1;
  const Geometry g = geometry<S>(n, ho, wo, cw, rs);
  const size_t smem = smem_bytes<T>(g.iw, g.cb);
  if (smem > MAX_SMEM || bpg < 1 || bpg > g.items)
    return cudaErrorInvalidValue;
  const int groups = (c + g.cb - 1) / g.cb;
  fused_dw_kernel<T, S, E><<<groups * bpg, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(offset),
      static_cast<T*>(y), static_cast<float*>(part), n, h, wd, c, ho, wo,
      act, cw, rs, bpg);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* w, const void* scale,
                     const void* offset, void* y, void* part, int n, int h,
                     int wd, int c, int stride, int act, int vec_bytes,
                     int cw, int rs, int bpg, cudaStream_t s) {
  constexpr int EW = 16 / sizeof(T);  // elements of a 16-byte copy
  if (cw != 1 && cw != 2 && cw != 4 && cw != 8) return cudaErrorInvalidValue;
  if (rs < 1 || n < 1 || h < 1 || wd < 1) return cudaErrorInvalidValue;
  if (vec_bytes == 16 && c % EW == 0) {
    if (stride == 1)
      return launch<T, 1, EW>(x, w, scale, offset, y, part, n, h, wd, c, act,
                              cw, rs, bpg, s);
    if (stride == 2)
      return launch<T, 2, EW>(x, w, scale, offset, y, part, n, h, wd, c, act,
                              cw, rs, bpg, s);
  } else if (vec_bytes == (int)(2 * sizeof(T))) {
    if (stride == 1)
      return launch<T, 1, 2>(x, w, scale, offset, y, part, n, h, wd, c, act,
                             cw, rs, bpg, s);
    if (stride == 2)
      return launch<T, 2, 2>(x, w, scale, offset, y, part, n, h, wd, c, act,
                             cw, rs, bpg, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x: [n, h, wd, c] (float32 if is_bf16 == 0, else bfloat16), contiguous,
// c even, aligned to vec_bytes; w: [5, 5, c] f32; scale, offset: [c] f32;
// y: [n, ho, wo, c] in x's dtype; part: [2, bpg, c] f32 partial sums of y
// and y^2, one row per block of a channel group. vec_bytes is 16 (c a
// multiple of 16 bytes of channels) or one channel pair; cw (column warps:
// 1, 2, 4 or 8), rs (output rows of a segment) and bpg (blocks per channel
// group) come from kernels/fused_dw.py `plan`. Returns the CUDA error code
// of the launch.
extern "C" int fused_dw_forward(const void* x, const void* w,
                                const void* scale, const void* offset,
                                void* y, void* part, int n, int h, int wd,
                                int c, int stride, int act, int is_bf16,
                                int vec_bytes, int cw, int rs, int bpg,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c % 2 != 0) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return (int)dispatch<__nv_bfloat16>(x, w, scale, offset, y, part, n, h,
                                        wd, c, stride, act, vec_bytes, cw, rs,
                                        bpg, s);
  return (int)dispatch<float>(x, w, scale, offset, y, part, n, h, wd, c,
                              stride, act, vec_bytes, cw, rs, bpg, s);
}
