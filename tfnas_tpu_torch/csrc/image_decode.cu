// JPEG decode and the fused train / val augment of a batch, on the card
// (sm_90a): the port's counterpart of the host C++ pipeline
// tfnas_tpu/runtime/src/image_pipeline.cpp.
//
// Replaces no TPU kernel: the JAX package decodes and augments on the host
// (libjpeg decode, :68-106; bilinear crop-box resize and flip, :112-148;
// colour jitter, :151-208; clip and quantise to uint8, :210, :399-405; the
// val resize and centre crop, :254-283). The card's machine has no libjpeg,
// and its host decodes too slowly for the search (PERF.md), so the port
// decodes with nvJPEG and augments here, with the same arithmetic.
//
// Decode (tfnas_card_open / _probe / _decode). nvJPEG is loaded at run time
// with dlopen from the path the caller found under CUDA_HOME (the machine
// may have only libnvjpeg.so.12, no link-time symlink). Two handles:
// the hardware backend (the H100's JPEG engines, which leave the SMs to the
// search) decodes every entry nvjpegDecodeBatchedSupported accepts, in one
// batched call; the default backend decodes the rest one by one
// (progressive files). Entries neither takes (not a JPEG, CMYK, no end
// marker after the last scan: truncated) get a non-zero status, for the
// caller's host decode. Output is interleaved RGB (NVJPEG_OUTPUT_RGBI), or
// planar RGB from the hardware backend where it refuses interleaved output
// (`hw_planar`); the caller lays the buffer out and allocates it with torch,
// and the augment kernel reads either layout through per-image strides.
// Every call takes the caller's stream; nothing here synchronises, touches
// the legacy default stream or allocates. nvJPEG's own work buffers are
// allocated by nvJPEG at first use (from stream-ordered memory pools where
// it can) and grow with the largest image seen.
//
// Augment (tfnas_augment). Per image i of the batch and output pixel
// (oy, ox) of an S x S image: a bilinear sample at pixel centres with edge
// clamping from the source image (train: the crop box mapped onto S x S,
// then the flip; val: short side to `resize`, the centre crop), in f32 and
// scaled to [0, 1]; train then applies up to 4 jitter ops in the image's
// own order with no clip between them, clips to [0, 1], and quantises
// round-half-away (std::lround). Contrast needs the mean gray of the image
// at that point. Every f32 operation is written with an explicit rounding
// intrinsic, so nvcc contracts nothing into an FMA: the kernel does the
// arithmetic of the plain version (runtime/card.py) operation for
// operation. (g++ -O3 -march=native may contract the host pipeline's
// multiply-adds: against it the result is within one uint8 level.)
//
// Bound: bytes. The kernel must read each crop box's source pixels once and
// write n * S * S * 3 bytes: for 32 images at 224^2 about 4.8 MB out plus
// the boxes (up to the decoded images, ~15 MB for 400-500 px JPEGs), a few
// microseconds at 3.35 TB/s. Its math (~100 f32 operations a pixel with
// the hue op) is under a microsecond at the card's f32 rate.
//
// Design (Hopper, sm_90a): one launch per batch of up to 256 images, their
// ImageArgs in the launch's own parameters (__grid_constant__; CUDA 12.1
// takes 32,764 bytes of them), so a call copies nothing to the card first;
// a larger batch takes one launch per 256. Each image is one thread-block
// cluster of C <= 8 blocks (runtime/card.py `plan`: at 224^2, 8 blocks of
// 28 rows, 896 threads, 7 pixels a thread: 61 registers, one block and 28
// warps an SM; 448 threads holding 14 pixels took 108 registers, 14 warps
// an SM, and 1.4x the time, PERF.md). A block first computes its
// rows' and columns' bilinear taps once (the sample step, the crop box,
// the flip: no per-pixel division); its threads are laid out as warps of
// 32 consecutive output columns, so a warp's source reads share cache
// lines, read through the read-only path. Where the plan holds (S up to
// ~256), each thread samples its pixels once into registers and applies
// the ops to them in the image's order; contrast reduces the gray of what
// the cluster holds in a fixed order: each thread's f64 sum, a shuffle
// tree per warp, a tree over the block's warps, cluster.sync(), and the
// cluster's block sums read through distributed shared memory in rank
// order, so every block gets the same mean on every run (an image without
// contrast skips the barrier: a cluster is one image, so the branch is
// uniform). The block quantises into a shared-memory copy of its output
// rows, which are contiguous in [n, S, S, 3], and writes them with one bulk
// copy (cp.async.bulk, TMA's 1-D form) where the span's start and length
// are multiples of 16 bytes, else with 16-byte stores and byte stores at
// the ragged ends. Larger images sweep: a first pass sums the gray before
// contrast, and after the cluster's barrier the same launch recomputes the
// pixels tile by tile into two staging buffers. Val is the same kernel
// without ops and reduction.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <library_types.h>
#include <nvjpeg.h>

#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

namespace cg = cooperative_groups;

namespace {

// ---- nvJPEG, resolved with dlsym ---------------------------------------

struct Api {
  decltype(&nvjpegGetProperty) GetProperty;
  decltype(&nvjpegCreateEx) CreateEx;
  decltype(&nvjpegJpegStateCreate) JpegStateCreate;
  decltype(&nvjpegJpegStreamCreate) JpegStreamCreate;
  decltype(&nvjpegJpegStreamParse) JpegStreamParse;
  decltype(&nvjpegJpegStreamGetFrameDimensions) GetFrameDimensions;
  decltype(&nvjpegJpegStreamGetComponentsNum) GetComponentsNum;
  decltype(&nvjpegDecodeBatchedSupported) DecodeBatchedSupported;
  decltype(&nvjpegDecodeBatchedInitialize) DecodeBatchedInitialize;
  decltype(&nvjpegDecodeBatched) DecodeBatched;
  decltype(&nvjpegDecode) Decode;
};

struct Library {
  void* so = nullptr;
  Api api{};
  nvjpegHandle_t def = nullptr;  // default backend
  nvjpegHandle_t hw = nullptr;   // hardware backend, null where refused
  int version[3] = {0, 0, 0};
  int hw_status = -1;            // nvjpegCreateEx's status for the hardware
  int hw_planar = 0;             // 1: the hardware backend writes planar RGB
  int device = -1;
  int flags = 0;                 // the handles' nvjpegCreateEx flags
};

Library lib;
std::mutex lib_mu;
char dl_error[512] = "";

template <typename F>
bool resolve(F& fn, const char* name) {
  fn = reinterpret_cast<F>(dlsym(lib.so, name));
  if (!fn) {
    const char* e = dlerror();
    std::strncpy(dl_error, e ? e : name, sizeof(dl_error) - 1);
  }
  return fn != nullptr;
}

// Per worker thread: nvJPEG's decode states are not thread safe, its
// handles are.
struct Worker {
  nvjpegJpegState_t hw_state = nullptr;
  nvjpegJpegState_t def_state = nullptr;
  nvjpegJpegStream_t parse = nullptr;
};

// Whether an end-of-image marker follows the last start-of-scan: a file
// cut short has none (markers cannot occur inside entropy-coded data, where
// 0xFF is stuffed, so the last SOS is the main image's last scan).
bool complete(const uint8_t* d, size_t n) {
  size_t sos = 0;
  bool seen = false;
  for (size_t i = n; i-- > 1;)
    if (d[i - 1] == 0xFF && d[i] == 0xDA) {
      sos = i;
      seen = true;
      break;
    }
  if (!seen) return false;
  for (size_t i = sos + 1; i + 1 < n; ++i)
    if (d[i] == 0xFF && d[i + 1] == 0xD9) return true;
  return false;
}

nvjpegImage_t destination(unsigned long long dst, int w, int h, int planar) {
  nvjpegImage_t img;
  std::memset(&img, 0, sizeof(img));
  unsigned char* p = reinterpret_cast<unsigned char*>(dst);
  if (planar) {
    for (int c = 0; c < 3; ++c) {
      img.channel[c] = p + (size_t)c * w * h;
      img.pitch[c] = (size_t)w;
    }
  } else {
    img.channel[0] = p;
    img.pitch[0] = (size_t)w * 3;
  }
  return img;
}

// ---- the augment kernel ------------------------------------------------

constexpr int MODE_TRAIN = 0, MODE_VAL = 1;
constexpr int LANES = 32;          // a warp: 32 consecutive output columns
constexpr int MAX_WARPS = 32;      // 1024 threads a block
constexpr int MAX_CLUSTER = 8;     // the portable cluster size
constexpr int HOLD = 8;            // pixels a thread holds in registers
constexpr int LAUNCH_IMAGES = 256; // images whose arguments one launch takes
constexpr int SMEM_PER_BLOCK = 232448;

// One image's arguments; runtime/card.py `IMAGE_ARGS` is the same layout.
struct ImageArgs {
  long long src;             // device address of pixel (0, 0), channel 0
  long long row, col, chan;  // element strides of the [H, W, 3] source
  int h, w;
  int ox, oy;                // train: crop box corner; val: centre-crop
                             // corner in the resized image
  int num_x, den_x;          // sample step num / den: train cw / S,
  int num_y, den_y;          // ch / S; val w / nw, h / nh
  int flip;
  int order[4];              // jitter ops, -1 ends: 0 brightness,
                             // 1 contrast, 2 saturation, 3 hue
  float factors[4];          // by op id
};
static_assert(sizeof(ImageArgs) == 104, "ImageArgs layout");

// A launch's decomposition: runtime/card.py `plan`, field for field.
struct Plan {
  int size, mode;
  int clusters;   // blocks per image, one cluster: each owns `rows` rows
  int rows;
  int warps;      // threads = 32 warps; warp w takes rows w, w + warps, ..
  int kx, ky;     // column groups of 32 and row passes of a thread
  int hold;       // 1: a thread's kx * ky <= HOLD pixels stay in registers
  int tile_rows;  // rows staged in shared memory per store
  int buffers;    // staging buffers (2 where a block stores several tiles)
  int smem;       // dynamic shared memory bytes
};

// The kernel's parameters: the batch's arguments travel in the launch
// (__grid_constant__, up to 32,764 bytes from CUDA 12.1), not in a copy.
struct Launch {
  Plan p;
  unsigned long long out;  // uint8 [n, S, S, 3] of the launch's image 0
  ImageArgs img[LAUNCH_IMAGES];
};
static_assert(sizeof(Launch) <= 32764, "kernel parameters");

// Per output row / column of a block: the source offsets of the two
// bilinear taps and the weight (the same rounded values the per-pixel
// arithmetic gave: each is computed once, with the same operations).
struct Row {
  long long r0, r1;
  float fy;
};
struct Col {
  int c0, c1;
  float fx;
};

__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }
__host__ __device__ constexpr int table_bytes(int rows, int size) {
  return align16(rows * (int)sizeof(Row) + size * (int)sizeof(Col));
}
// a staging buffer: the span at offset (its global address mod 16)
__host__ __device__ constexpr int stage_bytes(int tile_rows, int size) {
  return align16(3 * size * tile_rows) + 16;
}

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float dv(float a, float b) {
  return __fdiv_rn(a, b);
}

__device__ __forceinline__ float gray(const float* p) {
  return add(add(mul(0.299f, p[0]), mul(0.587f, p[1])), mul(0.114f, p[2]));
}

// The block's row and column taps (image_pipeline.cpp bilinear /
// resize_crop / tfnas_augment_val): the sample step once, train's crop box
// and flip, val's centre crop, edge clamping.
__device__ void tables(const ImageArgs& a, bool train, int size, int y0,
                       int nr, Row* rows, Col* cols) {
  const float scx = dv((float)a.num_x, (float)a.den_x);
  const float scy = dv((float)a.num_y, (float)a.den_y);
  const bool flip = train && a.flip;
  for (int c = threadIdx.x; c < size; c += blockDim.x) {
    const int ox = flip ? size - 1 - c : c;
    float sx = train ? sub(add((float)a.ox, mul(add((float)ox, 0.5f), scx)),
                           0.5f)
                     : sub(mul(add((float)(a.ox + ox), 0.5f), scx), 0.5f);
    sx = fminf(fmaxf(sx, 0.0f), (float)(a.w - 1));
    const int x0 = (int)sx, x1 = min(x0 + 1, a.w - 1);
    cols[c] = Col{(int)(x0 * a.col), (int)(x1 * a.col), sub(sx, (float)x0)};
  }
  for (int r = threadIdx.x; r < nr; r += blockDim.x) {
    const int oy = y0 + r;
    float sy = train ? sub(add((float)a.oy, mul(add((float)oy, 0.5f), scy)),
                           0.5f)
                     : sub(mul(add((float)(a.oy + oy), 0.5f), scy), 0.5f);
    sy = fminf(fmaxf(sy, 0.0f), (float)(a.h - 1));
    const int t0 = (int)sy, t1 = min(t0 + 1, a.h - 1);
    rows[r] = Row{t0 * a.row, t1 * a.row, sub(sy, (float)t0)};
  }
}

// The [0, 1] RGB bilinear sample at one (row, column) of the tables,
// through the read-only path.
__device__ __forceinline__ void sample(const uint8_t* s, long long chan,
                                       const Row& r, const Col& c,
                                       float* rgb) {
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const long long k = ch * chan;
    const int p00 = __ldg(s + r.r0 + c.c0 + k);
    const int p01 = __ldg(s + r.r0 + c.c1 + k);
    const int p10 = __ldg(s + r.r1 + c.c0 + k);
    const int p11 = __ldg(s + r.r1 + c.c1 + k);
    const float top = add((float)p00, mul((float)(p01 - p00), c.fx));
    const float bot = add((float)p10, mul((float)(p11 - p10), c.fx));
    rgb[ch] = mul(add(top, mul(sub(bot, top), r.fy)), 1.0f / 255.0f);
  }
}

__device__ __forceinline__ void brightness(float* p, float f) {
  for (int c = 0; c < 3; ++c) p[c] = mul(p[c], f);
}
__device__ __forceinline__ void contrast(float* p, float f, float mean) {
  for (int c = 0; c < 3; ++c) p[c] = add(mul(sub(p[c], mean), f), mean);
}
__device__ __forceinline__ void saturation(float* p, float f) {
  const float g = gray(p);
  for (int c = 0; c < 3; ++c) p[c] = add(mul(sub(p[c], g), f), g);
}

__device__ __forceinline__ void hue(float* p, float shift) {
  const float r = p[0], g = p[1], b = p[2];
  const float maxc = fmaxf(r, fmaxf(g, b));
  const float minc = fminf(r, fminf(g, b));
  const float v = maxc, delta = sub(maxc, minc);
  const float s = maxc > 0.0f ? dv(delta, fmaxf(maxc, 1e-12f)) : 0.0f;
  const float dz = fmaxf(delta, 1e-12f);
  float hh;
  if (delta == 0.0f) hh = 0.0f;
  else if (maxc == r) hh = fmodf(dv(sub(g, b), dz), 6.0f);
  else if (maxc == g) hh = add(dv(sub(b, r), dz), 2.0f);
  else hh = add(dv(sub(r, g), dz), 4.0f);
  if (hh < 0.0f) hh = add(hh, 6.0f);
  float hn = add(dv(hh, 6.0f), shift);
  hn = sub(hn, floorf(hn));
  const float h6 = mul(hn, 6.0f);
  const int ii = ((int)h6) % 6;
  const float fr = sub(h6, floorf(h6));
  const float pp = mul(v, sub(1.0f, s));
  const float qq = mul(v, sub(1.0f, mul(s, fr)));
  const float tt = mul(v, sub(1.0f, mul(s, sub(1.0f, fr))));
  switch (ii) {
    case 0: p[0] = v; p[1] = tt; p[2] = pp; break;
    case 1: p[0] = qq; p[1] = v; p[2] = pp; break;
    case 2: p[0] = pp; p[1] = v; p[2] = tt; break;
    case 3: p[0] = pp; p[1] = qq; p[2] = v; break;
    case 4: p[0] = tt; p[1] = pp; p[2] = v; break;
    default: p[0] = v; p[1] = pp; p[2] = qq; break;
  }
}

__device__ void jitter(int op, float f, float mean, float* p) {
  if (op == 0) brightness(p, f);
  else if (op == 1) contrast(p, f, mean);
  else if (op == 2) saturation(p, f);
  else hue(p, f);
}

// The image's ops at positions [from, to) of its order.
__device__ __forceinline__ void ops(const ImageArgs& a, int from, int to,
                                    float mean, float* p) {
  for (int i = from; i < to && a.order[i] >= 0; ++i)
    jitter(a.order[i], a.factors[a.order[i]], mean, p);
}

// Position of contrast in the image's order, or 4 where it has none.
__device__ int contrast_at(const ImageArgs& a) {
  for (int i = 0; i < 4 && a.order[i] >= 0; ++i)
    if (a.order[i] == 1) return i;
  return 4;
}

__device__ __forceinline__ void put(unsigned char* d, const float* p) {
  for (int c = 0; c < 3; ++c)
    d[c] = (uint8_t)roundf(fminf(fmaxf(mul(p[c], 255.0f), 0.0f), 255.0f));
}

__device__ __forceinline__ void clip(float* p) {
  for (int c = 0; c < 3; ++c) p[c] = fminf(fmaxf(p[c], 0.0f), 1.0f);
}

// f(px[k]) for each pixel k a thread holds (fully unrolled: the array
// stays in registers).
template <typename F>
__device__ __forceinline__ void each(float (&px)[HOLD][3], unsigned held,
                                     F f) {
#pragma unroll
  for (int k = 0; k < HOLD; ++k)
    if (held >> k & 1) f(px[k]);
}

// The image's mean gray from each thread's f64 sum `acc`, in a fixed
// order: each warp's shuffle tree, the block's warps in a second tree,
// cluster.sync(), then the cluster's block sums in rank order through
// distributed shared memory. Every block of the cluster gets the same
// value on every run. The caller ends with cluster_wait(): a block's sum
// must outlive the other blocks' reads.
__device__ float cluster_mean(double acc, int size, int clusters,
                              int warps) {
  __shared__ double warp_sum[MAX_WARPS];
  __shared__ double block_sum;
  __shared__ float mean_s;
  const int lane = threadIdx.x % LANES, warp = threadIdx.x / LANES;
  for (int o = LANES / 2; o > 0; o >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, o);
  if (lane == 0) warp_sum[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    double v = lane < warps ? warp_sum[lane] : 0.0;
    for (int o = LANES / 2; o > 0; o >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) block_sum = v;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (threadIdx.x == 0) {
    double m = 0.0;
    for (int r = 0; r < clusters; ++r)
      m += *cluster.map_shared_rank(&block_sum, r);
    mean_s = (float)(m / ((double)size * size));
  }
  __syncthreads();
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  return mean_s;
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_all_but_one() {
  asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
}

// Write the block's contiguous span of `len` output bytes, staged at
// buf + (dst mod 16): one bulk copy (TMA's 1-D form) where its start and
// length are multiples of 16 bytes, else 16-byte stores with byte stores
// at the ragged ends. Thread 0 owns the bulk group; a caller that reuses
// `buf` first waits for its reads.
__device__ void store_span(const unsigned char* buf, uint8_t* dst, int len) {
  const int mis = (int)(reinterpret_cast<uintptr_t>(dst) & 15);
  if (mis == 0 && (len & 15) == 0) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      const unsigned s = (unsigned)__cvta_generic_to_shared(buf);
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
          :: "l"(dst), "r"(s), "r"(len) : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
    return;
  }
  __syncthreads();
  const unsigned char* s = buf + mis;
  const int head = min(len, (16 - mis) & 15), body = (len - head) / 16;
  for (int i = threadIdx.x; i < head; i += blockDim.x) dst[i] = s[i];
  const uint4* sv = reinterpret_cast<const uint4*>(s + head);
  uint4* gv = reinterpret_cast<uint4*>(dst + head);
  for (int i = threadIdx.x; i < body; i += blockDim.x) gv[i] = sv[i];
  for (int i = head + 16 * body + threadIdx.x; i < len; i += blockDim.x)
    dst[i] = s[i];
}

// One cluster of p.clusters blocks per image (blockIdx.y), block rank r
// owning output rows [r * rows, (r + 1) * rows). Where the plan holds
// (p.hold), each thread samples its pixels once into registers, applies
// the image's ops in its order (contrast: the cluster's mean of what it
// holds), clips, quantises into the staged span and the block stores it.
// Else a sweep: a first pass sums the gray before contrast (when the
// image has it), then the pixels are recomputed tile by tile, staged and
// stored, double-buffered.
__global__ void __launch_bounds__(LANES * MAX_WARPS, 1)
    augment_batch(const __grid_constant__ Launch L) {
  const Plan& p = L.p;
  const ImageArgs& a = L.img[blockIdx.y];
  const int size = p.size, lane = threadIdx.x % LANES;
  const int warp = threadIdx.x / LANES;
  const int y0 = blockIdx.x * p.rows, nr = min(p.rows, size - y0);
  const bool train = p.mode == MODE_TRAIN;
  extern __shared__ __align__(16) unsigned char smem[];
  Row* rows = reinterpret_cast<Row*>(smem);
  Col* cols = reinterpret_cast<Col*>(smem + p.rows * sizeof(Row));
  unsigned char* stage = smem + table_bytes(p.rows, size);
  uint8_t* out = reinterpret_cast<uint8_t*>(L.out) +
                 ((size_t)blockIdx.y * size + y0) * size * 3;
  const uint8_t* src = reinterpret_cast<const uint8_t*>(a.src);
  tables(a, train, size, y0, nr, rows, cols);
  __syncthreads();
  const int at = train ? contrast_at(a) : 4;
  if (p.hold) {
    float px[HOLD][3];
    unsigned held = 0;
    {
      int i = 0, j = 0;
#pragma unroll
      for (int k = 0; k < HOLD; ++k) {
        const int r = warp + p.warps * j, c = lane + LANES * i;
        if (j < p.ky && r < nr && c < size) {
          held |= 1u << k;
          sample(src, a.chan, rows[r], cols[c], px[k]);
        }
        if (++i == p.kx) {
          i = 0;
          ++j;
        }
      }
    }
    if (train) {
      for (int o = 0; o < 4 && a.order[o] >= 0; ++o) {
        const int op = a.order[o];
        const float f = a.factors[op];
        if (op == 0) {
          each(px, held, [&](float* q) { brightness(q, f); });
        } else if (op == 1) {
          double acc = 0.0;
          each(px, held, [&](float* q) { acc += (double)gray(q); });
          const float m = cluster_mean(acc, size, p.clusters, p.warps);
          each(px, held, [&](float* q) { contrast(q, f, m); });
        } else if (op == 2) {
          each(px, held, [&](float* q) { saturation(q, f); });
        } else {
          each(px, held, [&](float* q) { hue(q, f); });
        }
      }
      each(px, held, [&](float* q) { clip(q); });
    }
    unsigned char* buf = stage + (reinterpret_cast<uintptr_t>(out) & 15);
    {
      int i = 0, j = 0;
#pragma unroll
      for (int k = 0; k < HOLD; ++k) {
        const int r = warp + p.warps * j, c = lane + LANES * i;
        if (held >> k & 1) put(buf + ((size_t)r * size + c) * 3, px[k]);
        if (++i == p.kx) {
          i = 0;
          ++j;
        }
      }
    }
    store_span(stage, out, nr * size * 3);
  } else {
    float m = 0.0f;
    if (at < 4) {
      double acc = 0.0;
      for (int r = warp; r < nr; r += p.warps)
        for (int c = lane; c < size; c += LANES) {
          float q[3];
          sample(src, a.chan, rows[r], cols[c], q);
          ops(a, 0, at, 0.0f, q);
          acc += (double)gray(q);
        }
      m = cluster_mean(acc, size, p.clusters, p.warps);
    }
    const int span = stage_bytes(p.tile_rows, size);
    for (int t = 0; t * p.tile_rows < nr; ++t) {
      const int r0 = t * p.tile_rows, r1 = min(nr, r0 + p.tile_rows);
      unsigned char* base = stage + (t % p.buffers) * span;
      uint8_t* dst = out + (size_t)r0 * size * 3;
      if (t >= p.buffers) {  // this buffer's store has read it
        if (threadIdx.x == 0) bulk_wait_all_but_one();
        __syncthreads();
      }
      unsigned char* buf = base + (reinterpret_cast<uintptr_t>(dst) & 15);
      for (int r = r0 + warp; r < r1; r += p.warps)
        for (int c = lane; c < size; c += LANES) {
          float q[3];
          sample(src, a.chan, rows[r], cols[c], q);
          if (train) {
            ops(a, 0, 4, m, q);
            clip(q);
          }
          put(buf + ((size_t)(r - r0) * size + c) * 3, q);
        }
      store_span(base, dst, (r1 - r0) * size * 3);
    }
  }
  if (threadIdx.x == 0) bulk_wait_all();
  if (at < 4) cluster_wait();
}

// The plan's checks (runtime/card.py `plan` makes it): every row covered
// once, at most MAX_CLUSTER blocks and MAX_WARPS warps, held pixels within
// HOLD, the staging and shared memory as the kernel lays them out.
bool plan_ok(const Plan& p) {
  const int s = p.size;
  if (s < 1 || (p.mode != MODE_TRAIN && p.mode != MODE_VAL) ||
      p.clusters < 1 || p.clusters > MAX_CLUSTER || p.rows < 1 ||
      p.clusters * p.rows < s || (p.clusters - 1) * p.rows >= s ||
      p.warps < 1 || p.warps > MAX_WARPS || p.kx != (s + LANES - 1) / LANES ||
      p.tile_rows < 1 || p.tile_rows > p.rows || p.buffers < 1 ||
      p.buffers > 2 || (p.tile_rows < p.rows && p.buffers != 2))
    return false;
  if (p.hold && (p.kx * p.ky > HOLD || p.ky < 1 || p.warps * p.ky < p.rows ||
                 p.tile_rows != p.rows))
    return false;
  const int smem = table_bytes(p.rows, s) +
                   p.buffers * stage_bytes(p.tile_rows, s);
  return p.smem == smem && smem <= SMEM_PER_BLOCK;
}

}  // namespace

extern "C" {

// Load nvJPEG from `path` and create its handles on `device` (once per
// process; a second call returns what the first made). props: [major,
// minor, patch, hardware backend's create status (0: it is there),
// hw_planar, device, the handles' flags]. Returns 0; -1 when the library or a symbol cannot be
// loaded (tfnas_card_dlerror says why); 1000 + status when the default
// handle cannot be created.
int tfnas_card_open(const char* path, int device, int* props) {
  std::lock_guard<std::mutex> guard(lib_mu);
  if (!lib.def) {
    if (cudaSetDevice(device) != cudaSuccess) return -2;
    if (!lib.so) {
      lib.so = dlopen(path, RTLD_NOW | RTLD_LOCAL);
      if (!lib.so) {
        const char* e = dlerror();
        std::strncpy(dl_error, e ? e : path, sizeof(dl_error) - 1);
        return -1;
      }
    }
    Api& f = lib.api;
    if (!(resolve(f.GetProperty, "nvjpegGetProperty") &&
          resolve(f.CreateEx, "nvjpegCreateEx") &&
          resolve(f.JpegStateCreate, "nvjpegJpegStateCreate") &&
          resolve(f.JpegStreamCreate, "nvjpegJpegStreamCreate") &&
          resolve(f.JpegStreamParse, "nvjpegJpegStreamParse") &&
          resolve(f.GetFrameDimensions,
                  "nvjpegJpegStreamGetFrameDimensions") &&
          resolve(f.GetComponentsNum, "nvjpegJpegStreamGetComponentsNum") &&
          resolve(f.DecodeBatchedSupported, "nvjpegDecodeBatchedSupported") &&
          resolve(f.DecodeBatchedInitialize,
                  "nvjpegDecodeBatchedInitialize") &&
          resolve(f.DecodeBatched, "nvjpegDecodeBatched") &&
          resolve(f.Decode, "nvjpegDecode")))
      return -1;
    f.GetProperty(MAJOR_VERSION, &lib.version[0]);
    f.GetProperty(MINOR_VERSION, &lib.version[1]);
    f.GetProperty(PATCH_LEVEL, &lib.version[2]);
    // Chroma upsampled by interpolation, as libjpeg's default ("fancy")
    // upsampling does (nearest replication was 6 levels off PIL on 4:2:0
    // files), and nvJPEG's work buffers from stream-ordered memory pools,
    // whose frees synchronise nothing (a loader thread's cudaFree would
    // stall the card beside the search), where this nvJPEG has the flags.
    unsigned int flags = 0;
#ifdef NVJPEG_FLAGS_UPSAMPLING_WITH_INTERPOLATION
    flags |= NVJPEG_FLAGS_UPSAMPLING_WITH_INTERPOLATION;
#endif
    nvjpegHandle_t def = nullptr;
    nvjpegStatus_t s = NVJPEG_STATUS_NOT_INITIALIZED;
#ifdef NVJPEG_FLAGS_ENABLE_MEMORY_POOLS
    s = f.CreateEx(NVJPEG_BACKEND_DEFAULT, nullptr, nullptr,
                   flags | NVJPEG_FLAGS_ENABLE_MEMORY_POOLS, &def);
    if (s == NVJPEG_STATUS_SUCCESS) flags |= NVJPEG_FLAGS_ENABLE_MEMORY_POOLS;
#endif
    if (s != NVJPEG_STATUS_SUCCESS)
      s = f.CreateEx(NVJPEG_BACKEND_DEFAULT, nullptr, nullptr, flags, &def);
    if (s != NVJPEG_STATUS_SUCCESS) return 1000 + (int)s;
    lib.flags = (int)flags;
    s = f.CreateEx(NVJPEG_BACKEND_HARDWARE, nullptr, nullptr, flags,
                   &lib.hw);
    lib.hw_status = (int)s;
    if (s != NVJPEG_STATUS_SUCCESS) {
      lib.hw = nullptr;
    } else {  // does the hardware backend write interleaved RGB?
      nvjpegJpegState_t probe = nullptr;
      if (f.JpegStateCreate(lib.hw, &probe) != NVJPEG_STATUS_SUCCESS) {
        lib.hw = nullptr;
        lib.hw_status = 1000;
      } else {
        lib.hw_planar = f.DecodeBatchedInitialize(lib.hw, probe, 1, 1,
                                                  NVJPEG_OUTPUT_RGBI) !=
                        NVJPEG_STATUS_SUCCESS;
      }
    }
    lib.device = device;
    lib.def = def;
  }
  props[0] = lib.version[0];
  props[1] = lib.version[1];
  props[2] = lib.version[2];
  props[3] = lib.hw_status;
  props[4] = lib.hw_planar;
  props[5] = lib.device;
  props[6] = lib.flags;
  return 0;
}

const char* tfnas_card_dlerror() { return dl_error; }

// A worker's decode states; 0 or 1000 + nvJPEG's status.
int tfnas_card_worker(void** out) {
  if (!lib.def) return 1000 + (int)NVJPEG_STATUS_NOT_INITIALIZED;
  Worker* w = new Worker();
  const Api& f = lib.api;
  nvjpegHandle_t ph = lib.hw ? lib.hw : lib.def;
  nvjpegStatus_t s = f.JpegStateCreate(lib.def, &w->def_state);
  if (s == NVJPEG_STATUS_SUCCESS && lib.hw)
    s = f.JpegStateCreate(lib.hw, &w->hw_state);
  if (s == NVJPEG_STATUS_SUCCESS) s = f.JpegStreamCreate(ph, &w->parse);
  if (s != NVJPEG_STATUS_SUCCESS) {
    delete w;  // the states made so far are left to the process's end
    return 1000 + (int)s;
  }
  *out = w;
  return 0;
}

// info[3 * i ...] = (width, height, backend) of entry i: backend 0 for the
// hardware backend, 1 for the default one, -1 where nvJPEG cannot decode it
// (not a JPEG, not 1 or 3 components, truncated). Host work only.
int tfnas_card_probe(void* worker, const uint8_t* const* datas,
                     const size_t* lens, int n, int* info) {
  Worker* w = static_cast<Worker*>(worker);
  const Api& f = lib.api;
  nvjpegHandle_t ph = lib.hw ? lib.hw : lib.def;
  for (int i = 0; i < n; ++i) {
    int* o = info + 3 * i;
    o[0] = o[1] = 0;
    o[2] = -1;
    if (!complete(datas[i], lens[i])) continue;
    if (f.JpegStreamParse(ph, datas[i], lens[i], 0, 0, w->parse) !=
        NVJPEG_STATUS_SUCCESS)
      continue;
    unsigned int wd = 0, ht = 0, comps = 0;
    if (f.GetFrameDimensions(w->parse, &wd, &ht) != NVJPEG_STATUS_SUCCESS ||
        f.GetComponentsNum(w->parse, &comps) != NVJPEG_STATUS_SUCCESS ||
        (comps != 1 && comps != 3) || wd == 0 || ht == 0)
      continue;
    int backend = 1;
    if (lib.hw) {
      int unsupported = 1;  // nvJPEG: 0 means supported
      if (f.DecodeBatchedSupported(lib.hw, w->parse, &unsupported) ==
              NVJPEG_STATUS_SUCCESS &&
          unsupported == 0)
        backend = 0;
    }
    o[0] = (int)wd;
    o[1] = (int)ht;
    o[2] = backend;
  }
  return 0;
}

// Decode the entries whose info backend is >= 0 into dst[i] (device
// addresses laid out by the caller: planar for hardware entries when
// hw_planar, else interleaved), on `stream`. status[i]: 0 decoded, 1
// refused by the probe, 1000 + nvJPEG's status when decoding failed. When
// the hardware batch fails, its entries go to the default backend one by
// one, and their info backend becomes 1.
int tfnas_card_decode(void* worker, const uint8_t* const* datas,
                      const size_t* lens, int n, int* info,
                      const unsigned long long* dst, int* status,
                      void* stream) {
  Worker* w = static_cast<Worker*>(worker);
  const Api& f = lib.api;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  std::vector<int> hw;
  for (int i = 0; i < n; ++i) {
    status[i] = info[3 * i + 2] < 0 ? 1 : 0;
    if (info[3 * i + 2] == 0) hw.push_back(i);
  }
  if (!hw.empty()) {
    const int k = (int)hw.size();
    std::vector<const unsigned char*> d(k);
    std::vector<size_t> l(k);
    std::vector<nvjpegImage_t> out(k);
    for (int j = 0; j < k; ++j) {
      const int i = hw[j];
      d[j] = datas[i];
      l[j] = lens[i];
      out[j] = destination(dst[i], info[3 * i], info[3 * i + 1],
                           lib.hw_planar);
    }
    const nvjpegOutputFormat_t fmt =
        lib.hw_planar ? NVJPEG_OUTPUT_RGB : NVJPEG_OUTPUT_RGBI;
    nvjpegStatus_t s = f.DecodeBatchedInitialize(lib.hw, w->hw_state, k, 1,
                                                 fmt);
    if (s == NVJPEG_STATUS_SUCCESS)
      s = f.DecodeBatched(lib.hw, w->hw_state, d.data(), l.data(),
                          out.data(), st);
    if (s != NVJPEG_STATUS_SUCCESS)
      for (int i : hw) info[3 * i + 2] = 1;
  }
  for (int i = 0; i < n; ++i) {
    if (info[3 * i + 2] != 1) continue;
    nvjpegImage_t img = destination(dst[i], info[3 * i], info[3 * i + 1], 0);
    const nvjpegStatus_t s = f.Decode(lib.def, w->def_state, datas[i],
                                      lens[i], NVJPEG_OUTPUT_RGBI, &img, st);
    if (s != NVJPEG_STATUS_SUCCESS) status[i] = 1000 + (int)s;
  }
  return (int)cudaGetLastError();
}

// args: n <= LAUNCH_IMAGES ImageArgs in host memory (they travel in the
// launch's parameters); plan: runtime/card.py `plan` as 11 ints (Plan's
// fields); out: [n, size, size, 3] uint8 on the card. One launch. Returns
// its CUDA error (cudaErrorInvalidValue for a plan the kernel does not
// take, whatever refuses the cluster launch otherwise); nothing falls back.
int tfnas_augment(const void* args, int n, const int* plan, void* out,
                  void* stream) {
  static_assert(sizeof(Plan) == 11 * sizeof(int), "Plan layout");
  static Launch params;  // 26 KB: not on the caller's stack
  static std::mutex mu;
  Plan p;
  std::memcpy(&p, plan, sizeof(Plan));
  if (n < 1 || n > LAUNCH_IMAGES || !plan_ok(p))
    return (int)cudaErrorInvalidValue;
  std::lock_guard<std::mutex> guard(mu);
  params.p = p;
  params.out = reinterpret_cast<unsigned long long>(out);
  std::memcpy(params.img, args, (size_t)n * sizeof(ImageArgs));
  if (p.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        augment_batch, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.clusters, n, 1);
  cfg.blockDim = dim3(LANES * p.warps, 1, 1);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.clusters;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, augment_batch, params);
  if (e == cudaSuccess) e = cudaGetLastError();
  return (int)e;
}

}  // extern "C"
