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
// at that point: the `stats` pass recomputes each pixel up to the contrast
// op and sums its gray in f64 per block of rows (a fixed-order tree), and
// the `write` pass adds those partials in row order, so the mean is the
// same on every run. Every f32 operation is written with an explicit
// rounding intrinsic, so nvcc contracts nothing into an FMA: the kernel
// does the arithmetic of the plain version (runtime/card.py) operation for
// operation. (g++ -O3 -march=native may contract the host pipeline's
// multiply-adds: against it the result is within one uint8 level.)
//
// Bound: bytes. The kernel must read each crop box's source pixels once and
// write n * S * S * 3 bytes: for 32 images at 224^2 about 4.8 MB out plus
// the boxes (up to the decoded images, ~15 MB for 400-500 px JPEGs), a few
// microseconds at 3.35 TB/s. Its math (~100 f32 operations a pixel with
// the hue op) is under a microsecond at the card's f32 rate. Design: one
// block of 256 threads per (image, tile of `rows` output rows), about 1024
// pixels a block, so a batch of 32 at 224^2 is 1792 blocks over 132 SMs;
// the source rows a tile samples stay in L1 / L2 across its threads.

#include <cuda_runtime.h>
#include <dlfcn.h>
#include <library_types.h>
#include <nvjpeg.h>

#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

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

constexpr int THREADS = 256;
constexpr int MODE_TRAIN = 0, MODE_VAL = 1;

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

// The [0, 1] RGB sample for output pixel (oy, ox) before the flip
// (image_pipeline.cpp bilinear / resize_crop / tfnas_augment_val).
__device__ void sample(const ImageArgs& a, int mode, int oy, int ox,
                       float* rgb) {
  const float scx = dv((float)a.num_x, (float)a.den_x);
  const float scy = dv((float)a.num_y, (float)a.den_y);
  float sx, sy;
  if (mode == MODE_TRAIN) {
    sx = sub(add((float)a.ox, mul((float)ox + 0.5f, scx)), 0.5f);
    sy = sub(add((float)a.oy, mul((float)oy + 0.5f, scy)), 0.5f);
  } else {
    sx = sub(mul(add((float)(a.ox + ox), 0.5f), scx), 0.5f);
    sy = sub(mul(add((float)(a.oy + oy), 0.5f), scy), 0.5f);
  }
  sx = fminf(fmaxf(sx, 0.0f), (float)(a.w - 1));
  sy = fminf(fmaxf(sy, 0.0f), (float)(a.h - 1));
  const int x0 = (int)sx, y0 = (int)sy;
  const int x1 = min(x0 + 1, a.w - 1), y1 = min(y0 + 1, a.h - 1);
  const float fx = sub(sx, (float)x0), fy = sub(sy, (float)y0);
  const uint8_t* s = reinterpret_cast<const uint8_t*>(a.src);
  const long long r0 = y0 * a.row, r1 = y1 * a.row;
  const long long c0 = x0 * a.col, c1 = x1 * a.col;
  for (int c = 0; c < 3; ++c) {
    const long long k = c * a.chan;
    const int p00 = s[r0 + c0 + k], p01 = s[r0 + c1 + k];
    const int p10 = s[r1 + c0 + k], p11 = s[r1 + c1 + k];
    const float top = add((float)p00, mul((float)(p01 - p00), fx));
    const float bot = add((float)p10, mul((float)(p11 - p10), fx));
    rgb[c] = mul(add(top, mul(sub(bot, top), fy)), 1.0f / 255.0f);
  }
}

__device__ void hue(float* p, float shift) {
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
  if (op == 0) {
    for (int c = 0; c < 3; ++c) p[c] = mul(p[c], f);
  } else if (op == 1) {
    for (int c = 0; c < 3; ++c) p[c] = add(mul(sub(p[c], mean), f), mean);
  } else if (op == 2) {
    const float g = gray(p);
    for (int c = 0; c < 3; ++c) p[c] = add(mul(sub(p[c], g), f), g);
  } else {
    hue(p, f);
  }
}

// Position of contrast in the image's order, or 4 where it has none.
__device__ int contrast_at(const ImageArgs& a) {
  for (int i = 0; i < 4 && a.order[i] >= 0; ++i)
    if (a.order[i] == 1) return i;
  return 4;
}

// partial[i * tiles + t]: the f64 sum of the gray of image i's pixels in
// tile t just before its contrast op.
__global__ void __launch_bounds__(THREADS)
    augment_stats(const ImageArgs* args, int size, int rows, int tiles,
                  double* partial) {
  const ImageArgs a = args[blockIdx.y];
  const int at = contrast_at(a);
  if (at == 4) return;
  const int y0 = blockIdx.x * rows, y1 = min(size, y0 + rows);
  double acc = 0.0;
  for (int p = threadIdx.x; p < (y1 - y0) * size; p += THREADS) {
    const int oy = y0 + p / size, ox = p % size;
    float px[3];
    sample(a, MODE_TRAIN, oy, ox, px);
    for (int i = 0; i < at; ++i)
      jitter(a.order[i], a.factors[a.order[i]], 0.0f, px);
    acc += (double)gray(px);
  }
  __shared__ double red[THREADS];
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {  // fixed order
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) partial[(size_t)blockIdx.y * tiles + blockIdx.x] =
      red[0];
}

__global__ void __launch_bounds__(THREADS)
    augment_write(const ImageArgs* args, int mode, int size, int rows,
                  int tiles, const double* partial, uint8_t* out) {
  const ImageArgs a = args[blockIdx.y];
  __shared__ float mean_s;
  const bool train = mode == MODE_TRAIN;
  if (train && contrast_at(a) < 4) {
    if (threadIdx.x == 0) {
      double m = 0.0;
      for (int t = 0; t < tiles; ++t)  // row order: deterministic
        m += partial[(size_t)blockIdx.y * tiles + t];
      mean_s = (float)(m / ((double)size * size));
    }
    __syncthreads();
  }
  const int y0 = blockIdx.x * rows, y1 = min(size, y0 + rows);
  uint8_t* img = out + (size_t)blockIdx.y * size * size * 3;
  for (int p = threadIdx.x; p < (y1 - y0) * size; p += THREADS) {
    const int oy = y0 + p / size, tx = p % size;
    const int ox = (train && a.flip) ? size - 1 - tx : tx;
    float px[3];
    sample(a, mode, oy, ox, px);
    if (train) {
      for (int i = 0; i < 4 && a.order[i] >= 0; ++i)
        jitter(a.order[i], a.factors[a.order[i]], mean_s, px);
      for (int c = 0; c < 3; ++c) px[c] = fminf(fmaxf(px[c], 0.0f), 1.0f);
    }
    uint8_t* dst = img + ((size_t)oy * size + tx) * 3;
    for (int c = 0; c < 3; ++c)
      dst[c] = (uint8_t)roundf(fminf(fmaxf(mul(px[c], 255.0f), 0.0f),
                                     255.0f));
  }
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

// args: n ImageArgs on the card; mode 0 train, 1 val; out: [n, size, size,
// 3] uint8; partial: [n, tiles] f64 scratch, tiles = ceil(size / rows).
// Returns the CUDA error of the launches.
int tfnas_augment(const void* args, int n, int mode, int size, int rows,
                  void* partial, void* out, void* stream) {
  if (n < 1 || size < 1 || rows < 1 || n > 65535 ||
      (mode != MODE_TRAIN && mode != MODE_VAL))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (size + rows - 1) / rows;
  const dim3 grid(tiles, n);
  const ImageArgs* a = static_cast<const ImageArgs*>(args);
  if (mode == MODE_TRAIN) {
    augment_stats<<<grid, THREADS, 0, st>>>(a, size, rows, tiles,
                                            static_cast<double*>(partial));
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  augment_write<<<grid, THREADS, 0, st>>>(
      a, mode, size, rows, tiles, static_cast<const double*>(partial),
      static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
