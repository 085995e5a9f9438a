// Native host runtime of arap_flow_tpu_torch: the reference-exact forward
// rasterizer, the Middlebury .flo codec, an asynchronous file-writer pool
// (all three from the JAX package's native/src/arap_native.cpp; the
// rasterizer's bbox is cut to the frame before its int cast, and a writer
// counts a failed fclose), a baseline JPEG decoder and encoder, and
// Pillow's LANCZOS resample of an output window (at the end of the file).
//
// Semantics of the first three, replicated from the reference CPU code:
// - triangle coverage + barycentric weights: the LK edge-function test of
//   ARAP/warping/src/main.cpp:68-104;
// - quad iteration, validity gating, draw order and color truncation:
//   warping/src/main.cpp:145-225 and deformation CombinedSolver.h:248-342;
// - .flo layout ('PIEH', int32 w/h, interleaved row-major float32 u,v).
//
// The JPEG decoder reads baseline and progressive files (SOF0/SOF1 and
// SOF2, 8-bit samples, Huffman coding, 1, 3 or 4 components, any sampling
// factors libjpeg's upsampler takes, restart markers) and reproduces
// libjpeg-turbo's default decode, which PIL uses: the ISLOW integer IDCT
// (jidctint.c, CONST_BITS 13, PASS1_BITS 2), the upsampler jdsample.c's
// jinit_upsampler picks for each component (h2v1/h2v2_fancy_upsample where
// the component is wider than 2 samples, plain replication where it is
// not, h1v2_fancy_upsample with context rows, int_upsample's replication
// for other integral ratios such as 4:1:1) and the fixed-point YCbCr->RGB
// tables (jdcolor.c). Four components are CMYK (Adobe transform 0, or no
// Adobe marker) or YCCK (any other transform: ycck_cmyk_convert), written
// inverted as PIL's "CMYK;I" raw mode gives them. A progressive file's
// scans (DC first and refinement, AC spectral selection with EOB runs, AC
// successive approximation: ITU T.81 G.1.2, jdphuff.c) build the
// coefficient planes, which then take the same IDCT and colour path.
// libjpeg's block smoothing (jdcoefct.c) runs only while some of the first
// AC coefficients are left unrefined at the end of the file.
//
// Refusals come in two kinds. A file of a process or variant this decoder
// does not implement (arithmetic coding, 12-bit samples, lossless or
// hierarchical processes, a DNL-defined height, a progressive file left
// unrefined, a component count other than 1, 3 or 4) is "unsupported"
// (jpeg_decode returns -2): libjpeg may read it. A file that is broken
// (truncated data, bad tables or headers, sampling factors libjpeg refuses
// too) is "corrupt" (-1). Both set an error message.
// The encoder writes baseline JFIF files: RGB->YCbCr in
// fixed point, 4:2:0 chroma, the islow forward DCT (jfdctint.c), the
// quality-scaled Annex K quantization tables and the Annex K Huffman tables.
//
// Exposed as a plain C ABI for ctypes.
// Build: g++ -O3 -std=c++17 -ffp-contract=off -shared -fPIC -pthread
//        arap_native.cpp -o lib.so

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// LK edge-function point-in-triangle test; returns true and the barycentric
// weights when the pixel is covered (accept rule: not backfacing and all
// normalised edge functions >= 0).
inline bool tri_cover(float x0, float y0, float x1, float y1, float x2,
                      float y2, float sx, float sy, float* w0, float* w1,
                      float* w2) {
  float X0 = x0 - sx, X1 = x1 - sx, X2 = x2 - sx;
  float Y0 = y0 - sy, Y1 = y1 - sy, Y2 = y2 - sy;
  float d01 = X0 * Y1 - Y0 * X1;
  float d12 = X1 * Y2 - Y1 * X2;
  float d20 = X2 * Y0 - Y2 * X0;
  if ((d01 < 0) & (d12 < 0) & (d20 < 0)) return false;  // backfacing
  float inv = 1.f / (d01 + d12 + d20);
  float n01 = d01 * inv, n12 = d12 * inv, n20 = d20 * inv;
  if (!(n01 >= 0 && n12 >= 0 && n20 >= 0)) return false;  // rejects NaN too
  *w0 = n12;
  *w1 = n20;
  *w2 = n01;
  return true;
}

struct Vec3f {
  float r, g, b;
};

inline void paint_tri(const float* P0, const float* P1, const float* P2,
                      Vec3f c0, Vec3f c1, Vec3f c2, uint8_t* rgb_out,
                      uint8_t* cov_out, int W, int H) {
  float minx = std::floor(std::min(P0[0], std::min(P1[0], P2[0])));
  float miny = std::floor(std::min(P0[1], std::min(P1[1], P2[1])));
  float maxx = std::ceil(std::max(P0[0], std::max(P1[0], P2[0])));
  float maxy = std::ceil(std::max(P0[1], std::max(P1[1], P2[1])));
  // a non-finite corner covers no pixel (the numpy version drops such
  // triangles); the bbox is cut to the frame in float, before any int cast
  if (!(std::isfinite(minx) && std::isfinite(miny) && std::isfinite(maxx) &&
        std::isfinite(maxy)))
    return;
  const int x0 = (int)std::max(minx, 0.f);
  const int x1 = (int)std::min(maxx, (float)(W - 1));
  const int y0 = (int)std::max(miny, 0.f);
  const int y1 = (int)std::min(maxy, (float)(H - 1));
  for (int x = x0; x <= x1; ++x) {
    for (int y = y0; y <= y1; ++y) {
      float w0, w1, w2;
      if (!tri_cover(P0[0], P0[1], P1[0], P1[1], P2[0], P2[1], (float)x,
                     (float)y, &w0, &w1, &w2))
        continue;
      float r = c0.r * w0 + c1.r * w1 + c2.r * w2;
      float g = c0.g * w0 + c1.g * w1 + c2.g * w2;
      float b = c0.b * w0 + c1.b * w1 + c2.b * w2;
      uint8_t* px = rgb_out + 3 * (y * W + x);
      px[0] = (uint8_t)r;  // C-cast truncation (mLib vec3uc semantics)
      px[1] = (uint8_t)g;
      px[2] = (uint8_t)b;
      cov_out[y * W + x] = 255;
    }
  }
}

}  // namespace

extern "C" {

// warp: (H, W, 2) float32 absolute positions; rgb: (H, W, 3) u8;
// mask: (H, W) u8 with 0 = drawable object. Outputs must be zero-initialised
// by the caller: out_rgb (H, W, 3), out_mask (H, W).
void raster_warp(const float* warp, const uint8_t* rgb, const uint8_t* mask,
                 int H, int W, uint8_t* out_rgb, uint8_t* out_mask) {
  auto P = [&](int y, int x) { return warp + 2 * (y * W + x); };
  auto C = [&](int y, int x) {
    const uint8_t* p = rgb + 3 * (y * W + x);
    return Vec3f{(float)p[0], (float)p[1], (float)p[2]};
  };
  for (int y = 0; y + 1 < H; ++y) {
    for (int x = 0; x + 1 < W; ++x) {
      if (mask[y * W + x] != 0) continue;
      if (mask[y * W + x + 1] != 0 || mask[(y + 1) * W + x] != 0 ||
          mask[(y + 1) * W + x + 1] != 0)
        continue;
      const float* p00 = P(y, x);
      const float* p01 = P(y, x + 1);
      const float* p10 = P(y + 1, x);
      const float* p11 = P(y + 1, x + 1);
      paint_tri(p00, p01, p10, C(y, x), C(y, x + 1), C(y + 1, x), out_rgb,
                out_mask, W, H);
      paint_tri(p10, p01, p11, C(y + 1, x), C(y, x + 1), C(y + 1, x + 1),
                out_rgb, out_mask, W, H);
    }
  }
}

// ---------------- .flo codec ----------------

int flo_write_file(const char* path, const float* uv, int W, int H) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  const char tag[4] = {'P', 'I', 'E', 'H'};
  std::fwrite(tag, 1, 4, f);
  int32_t w32 = W, h32 = H;
  std::fwrite(&w32, 4, 1, f);
  std::fwrite(&h32, 4, 1, f);
  size_t n = (size_t)W * H * 2;
  size_t wrote = std::fwrite(uv, 4, n, f);
  int closed = std::fclose(f);
  return (wrote == n && closed == 0) ? 0 : -2;
}

// Reads dims only (out=nullptr) or the full payload. Returns 0 on success.
int flo_read_file(const char* path, float* out, long max_floats, int* W,
                  int* H) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  float tag;
  int32_t w32, h32;
  if (std::fread(&tag, 4, 1, f) != 1 || std::fread(&w32, 4, 1, f) != 1 ||
      std::fread(&h32, 4, 1, f) != 1) {
    std::fclose(f);
    return -2;
  }
  if (tag != 202021.25f || w32 <= 0 || h32 <= 0 || w32 > 99999 || h32 > 99999) {
    std::fclose(f);
    return -3;
  }
  *W = w32;
  *H = h32;
  if (out != nullptr) {
    long n = (long)w32 * h32 * 2;
    if (n > max_floats) {
      std::fclose(f);
      return -4;
    }
    if ((long)std::fread(out, 4, n, f) != n) {
      std::fclose(f);
      return -5;
    }
  }
  std::fclose(f);
  return 0;
}

}  // extern "C"

// ---------------- async writer pool ----------------
//
// .flo fields and encoded images are written by a pool of threads while the
// caller goes on; each submit copies its data, so the caller's buffer may be
// reused at once.

namespace {
struct Job {
  std::string path;
  std::vector<uint8_t> data;
  bool is_flo;
  int w, h;
};

std::deque<Job> g_queue;
std::mutex g_mu;
std::condition_variable g_cv;
std::vector<std::thread> g_threads;
std::atomic<bool> g_stop{false};
std::atomic<int> g_inflight{0};
std::atomic<long> g_errors{0};

void worker_loop() {
  for (;;) {
    Job job;
    {
      std::unique_lock<std::mutex> lk(g_mu);
      g_cv.wait(lk, [] { return g_stop.load() || !g_queue.empty(); });
      if (g_queue.empty()) {
        if (g_stop.load()) return;
        continue;
      }
      job = std::move(g_queue.front());
      g_queue.pop_front();
    }
    int rc = 0;
    if (job.is_flo) {
      rc = flo_write_file(job.path.c_str(),
                          reinterpret_cast<const float*>(job.data.data()),
                          job.w, job.h);
    } else {
      FILE* f = std::fopen(job.path.c_str(), "wb");
      if (!f) {
        rc = -1;
      } else {
        if (std::fwrite(job.data.data(), 1, job.data.size(), f) !=
            job.data.size())
          rc = -2;
        if (std::fclose(f) != 0) rc = -3;
      }
    }
    if (rc != 0) g_errors.fetch_add(1);
    {
      // the predicate state changes under the condvar's mutex: decrementing
      // outside g_mu lets writer_drain() evaluate its predicate between the
      // fetch_sub and notify_all (a lost wakeup: drain would block forever)
      std::lock_guard<std::mutex> lk(g_mu);
      g_inflight.fetch_sub(1);
    }
    g_cv.notify_all();
  }
}

void enqueue(Job&& job) {
  g_inflight.fetch_add(1);
  {
    std::lock_guard<std::mutex> lk(g_mu);
    g_queue.push_back(std::move(job));
  }
  g_cv.notify_one();
}
}  // namespace

extern "C" {

void writer_start(int nthreads) {
  g_stop.store(false);
  g_errors.store(0);  // a count per writer lifetime: a run's end-of-run
                      // check must not see an earlier run's failures
  for (int i = 0; i < nthreads; ++i) g_threads.emplace_back(worker_loop);
}

void writer_submit_flo(const char* path, const float* uv, int W, int H) {
  Job job;
  job.path = path;
  job.is_flo = true;
  job.w = W;
  job.h = H;
  size_t bytes = (size_t)W * H * 2 * 4;
  job.data.assign(reinterpret_cast<const uint8_t*>(uv),
                  reinterpret_cast<const uint8_t*>(uv) + bytes);
  enqueue(std::move(job));
}

void writer_submit_bytes(const char* path, const void* data, long n) {
  Job job;
  job.path = path;
  job.is_flo = false;
  job.w = job.h = 0;
  job.data.assign(reinterpret_cast<const uint8_t*>(data),
                  reinterpret_cast<const uint8_t*>(data) + n);
  enqueue(std::move(job));
}

long writer_pending() { return g_inflight.load(); }
long writer_errors() { return g_errors.load(); }

void writer_drain() {
  std::unique_lock<std::mutex> lk(g_mu);
  g_cv.wait(lk, [] { return g_queue.empty() && g_inflight.load() == 0; });
}

void writer_stop() {
  g_stop.store(true);
  g_cv.notify_all();
  for (auto& t : g_threads) t.join();
  g_threads.clear();
}

}  // extern "C"

// ---------------- baseline JPEG ----------------

namespace jpg {

struct Error {
  std::string msg;
  bool unsupported;  // a variant libjpeg may read, not a broken file
};

// a broken file
[[noreturn]] void fail(const std::string& msg) { throw Error{msg, false}; }
// a file of a variant this decoder does not implement
[[noreturn]] void refuse(const std::string& msg) {
  throw Error{msg, true};
}

thread_local std::string t_error;
thread_local std::vector<uint8_t> t_encoded;

// zigzag position -> natural (row-major) index in the 8x8 block
const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

inline uint8_t clamp8(int v) {
  return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// ---- the ISLOW integer IDCT (jidctint.c) ----

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int32_t FIX_0_298631336 = 2446;
constexpr int32_t FIX_0_390180644 = 3196;
constexpr int32_t FIX_0_541196100 = 4433;
constexpr int32_t FIX_0_765366865 = 6270;
constexpr int32_t FIX_0_899976223 = 7373;
constexpr int32_t FIX_1_175875602 = 9633;
constexpr int32_t FIX_1_501321110 = 12299;
constexpr int32_t FIX_1_847759065 = 15137;
constexpr int32_t FIX_1_961570560 = 16069;
constexpr int32_t FIX_2_053119869 = 16819;
constexpr int32_t FIX_2_562915447 = 20995;
constexpr int32_t FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + ((int64_t)1 << (n - 1))) >> n;
}

// coef: 64 quantized coefficients in natural order; q: the quantization
// table in natural order; out: 8 rows of 8 samples at `stride`. Samples are
// range-limited by saturation: for coefficients that fit the 16-bit lanes
// libjpeg-turbo's SIMD IDCT uses, this equals its masked range table.
void idct_islow(const int32_t* coef, const uint16_t* q, uint8_t* out,
                int stride) {
  int64_t ws[64];
  for (int c = 0; c < 8; ++c) {
    const int32_t* in = coef + c;
    const uint16_t* qp = q + c;
    int64_t* w = ws + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 &&
        in[40] == 0 && in[48] == 0 && in[56] == 0) {
      int64_t dc = ((int64_t)in[0] * qp[0]) << kPass1Bits;
      for (int r = 0; r < 8; ++r) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = (int64_t)in[16] * qp[16], z3 = (int64_t)in[48] * qp[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = (int64_t)in[0] * qp[0];
    z3 = (int64_t)in[32] * qp[32];
    int64_t tmp0 = (z2 + z3) << kConstBits;
    int64_t tmp1 = (z2 - z3) << kConstBits;
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = (int64_t)in[56] * qp[56];
    tmp1 = (int64_t)in[40] * qp[40];
    tmp2 = (int64_t)in[24] * qp[24];
    tmp3 = (int64_t)in[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = kConstBits - kPass1Bits;
    w[0] = (int32_t)descale(tmp10 + tmp3, n);
    w[56] = (int32_t)descale(tmp10 - tmp3, n);
    w[8] = (int32_t)descale(tmp11 + tmp2, n);
    w[48] = (int32_t)descale(tmp11 - tmp2, n);
    w[16] = (int32_t)descale(tmp12 + tmp1, n);
    w[40] = (int32_t)descale(tmp12 - tmp1, n);
    w[24] = (int32_t)descale(tmp13 + tmp0, n);
    w[32] = (int32_t)descale(tmp13 - tmp0, n);
  }
  const int n = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; ++r) {
    const int64_t* w = ws + 8 * r;
    uint8_t* o = out + (size_t)r * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 &&
        w[6] == 0 && w[7] == 0) {
      uint8_t dc = clamp8((int)descale(w[0], kPass1Bits + 3) + 128);
      for (int c = 0; c < 8; ++c) o[c] = dc;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (w[0] + w[4]) << kConstBits;
    int64_t tmp1 = (w[0] - w[4]) << kConstBits;
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = clamp8((int)descale(tmp10 + tmp3, n) + 128);
    o[7] = clamp8((int)descale(tmp10 - tmp3, n) + 128);
    o[1] = clamp8((int)descale(tmp11 + tmp2, n) + 128);
    o[6] = clamp8((int)descale(tmp11 - tmp2, n) + 128);
    o[2] = clamp8((int)descale(tmp12 + tmp1, n) + 128);
    o[5] = clamp8((int)descale(tmp12 - tmp1, n) + 128);
    o[3] = clamp8((int)descale(tmp13 + tmp0, n) + 128);
    o[4] = clamp8((int)descale(tmp13 - tmp0, n) + 128);
  }
}

// ---- the fixed-point YCbCr -> RGB tables (jdcolor.c) ----

struct ColorTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  ColorTables() {
    const int kScale = 16;
    const int32_t half = (int32_t)1 << (kScale - 1);
    auto fix = [&](double x) { return (int32_t)(x * (1L << kScale) + 0.5); };
    for (int i = 0; i < 256; ++i) {
      int32_t x = i - 128;
      cr_r[i] = (int)((fix(1.40200) * x + half) >> kScale);
      cb_b[i] = (int)((fix(1.77200) * x + half) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
};

const ColorTables& color_tables() {
  static const ColorTables t;
  return t;
}

// ---- decoder ----

struct Huffman {
  bool present = false;
  uint8_t vals[256];
  int32_t maxcode[18];  // largest code of each length, -1 if none
  int32_t valptr[17];
  int32_t mincode[17];
  uint8_t look_len[512];  // 9-bit lookahead: code length (0 = slow path)
  uint8_t look_val[512];

  void build(const uint8_t* bits, const uint8_t* v, int nvals) {
    std::memcpy(vals, v, nvals);
    std::memset(look_len, 0, sizeof(look_len));
    int32_t code = 0;
    int k = 0;
    for (int len = 1; len <= 16; ++len) {
      valptr[len] = k;
      mincode[len] = code;
      for (int i = 0; i < bits[len]; ++i, ++k, ++code) {
        if (len <= 9) {
          int shift = 9 - len;
          for (int j = 0; j < (1 << shift); ++j) {
            look_len[(code << shift) | j] = (uint8_t)len;
            look_val[(code << shift) | j] = vals[k];
          }
        }
      }
      maxcode[len] = bits[len] ? code - 1 : -1;
      if (code > (1 << len)) fail("bad Huffman table");
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    present = true;
  }
};

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;
  int nbits = 0;     // bits in acc
  int injected = 0;  // zero bits appended after a marker (not data)
  bool at_marker = false;

  void fill() {
    while (nbits <= 56) {
      uint32_t byte = 0;
      if (!at_marker) {
        if (p >= end) fail("JPEG data ends inside a scan");
        byte = *p;
        if (byte == 0xFF) {
          const uint8_t* q = p + 1;
          while (q < end && *q == 0xFF) ++q;  // fill bytes
          if (q >= end) fail("JPEG data ends inside a scan");
          if (*q == 0x00) {
            p = q + 1;
          } else {
            at_marker = true;  // p stays on the marker
            p = q - 1;
            byte = 0;
          }
        } else {
          ++p;
        }
      }
      if (at_marker) injected += 8;
      acc |= (uint64_t)byte << (56 - nbits);
      nbits += 8;
    }
  }
  inline void need(int n) {
    if (nbits < n) fill();
    if (n > nbits - injected) fail("JPEG entropy-coded data is truncated");
  }
  inline uint32_t get(int n) {
    if (n == 0) return 0;
    need(n);
    uint32_t v = (uint32_t)(acc >> (64 - n));
    acc <<= n;
    nbits -= n;
    return v;
  }
  // drop the bits of the partly consumed byte and move to the next marker
  void reset() {
    acc = 0;
    nbits = 0;
    injected = 0;
    at_marker = false;
    while (p + 1 < end && !(p[0] == 0xFF && p[1] != 0x00 && p[1] != 0xFF))
      ++p;
  }
};

inline int decode_symbol(BitReader& br, const Huffman& h) {
  if (br.nbits < 16) br.fill();
  uint32_t look = (uint32_t)(br.acc >> 55);  // 9 bits
  int len = h.look_len[look];
  if (len) {
    if (len > br.nbits - br.injected)
      fail("JPEG entropy-coded data is truncated");
    br.acc <<= len;
    br.nbits -= len;
    return h.look_val[look];
  }
  int32_t code = (int32_t)(br.acc >> 48);  // 16 bits
  for (len = 10; len <= 16; ++len) {
    int32_t c = code >> (16 - len);
    if (c <= h.maxcode[len]) {
      if (len > br.nbits - br.injected)
        fail("JPEG entropy-coded data is truncated");
      br.acc <<= len;
      br.nbits -= len;
      return h.vals[h.valptr[len] + c - h.mincode[len]];
    }
  }
  fail("corrupt JPEG data: bad Huffman code");
}

inline int extend(uint32_t v, int s) {
  return (s && v < (1u << (s - 1))) ? (int)v - (1 << s) + 1 : (int)v;
}

struct Component {
  int id, h, v, tq;
  int td = 0, ta = 0;
  int dw = 0, dh = 0;  // downsampled size (real samples)
  int bw = 0, bh = 0;  // block grid, padded to whole MCUs
  std::vector<uint8_t> pix;
  int pred = 0;
  // the quantization table, latched at the component's first scan (as
  // libjpeg's latch_quant_tables does)
  bool latched = false;
  uint16_t q[64];
  // progressive only: the quantized coefficients of every block (JCOEF,
  // 16 bits, in natural order) and, per zigzag index, the successive-
  // approximation bit of the last scan that coded it (-1: none yet)
  std::vector<int16_t> coef;
  int coef_bits[64];
};

struct Decoder {
  const uint8_t* data;
  const uint8_t* end;
  const uint8_t* p;
  int H = 0, W = 0, nc = 0;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  Component comp[4];
  uint16_t qt[4][64];
  bool qt_set[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  int restart = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  bool frame = false;
  bool progressive = false;
  int scans = 0;
  int eobrun = 0;  // progressive AC scans: blocks left in the current EOB run

  Decoder(const uint8_t* d, long n) : data(d), end(d + n), p(d) {}

  int u8() {
    if (p >= end) fail("JPEG file ends early");
    return *p++;
  }
  int u16() {
    int hi = u8();
    return (hi << 8) | u8();
  }

  int next_marker() {
    // skip anything up to 0xFF, then fill bytes
    while (p < end && *p != 0xFF) ++p;
    while (p < end && *p == 0xFF) ++p;
    if (p >= end) fail("JPEG file ends before EOI");
    return *p++;
  }

  void read_sof(int marker) {
    if (frame) fail("JPEG with more than one frame header");
    int len = u16();
    const uint8_t* seg_end = p + len - 2;
    int precision = u8();
    H = u16();
    W = u16();
    nc = u8();
    if (marker >= 0xC9)
      refuse("JPEG with arithmetic coding is not supported");
    if (marker == 0xC3)
      refuse("lossless JPEG is not supported");
    if (marker >= 0xC5)
      refuse("hierarchical JPEG is not supported");
    progressive = marker == 0xC2;
    if (precision != 8)
      refuse("JPEG with " + std::to_string(precision) +
             "-bit samples is not supported");
    if (H == 0) refuse("JPEG with a DNL-defined height is not supported");
    if (W <= 0) fail("JPEG with a zero width");
    if (nc != 1 && nc != 3 && nc != 4)
      refuse("JPEG with " + std::to_string(nc) +
             " components is not supported");
    if (len != 8 + 3 * nc) fail("bad JPEG frame header length");
    for (int i = 0; i < nc; ++i) {
      Component& c = comp[i];
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail("bad JPEG component parameters");
    }
    if (nc == 1) comp[0].h = comp[0].v = 1;  // a lone component: 1x1
    hmax = vmax = 1;
    for (int i = 0; i < nc; ++i) {
      hmax = std::max(hmax, comp[i].h);
      vmax = std::max(vmax, comp[i].v);
    }
    // jinit_upsampler: every component is upsampled by integral factors
    for (int i = 0; i < nc; ++i)
      if (hmax % comp[i].h != 0 || vmax % comp[i].v != 0)
        fail("JPEG with fractional sampling factors (libjpeg refuses them)");
    mcux = (W + 8 * hmax - 1) / (8 * hmax);
    mcuy = (H + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < nc; ++i) {
      Component& c = comp[i];
      c.dw = (W * c.h + hmax - 1) / hmax;
      c.dh = (H * c.v + vmax - 1) / vmax;
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.pix.assign((size_t)c.bw * 8 * c.bh * 8, 0);
      if (progressive) {
        c.coef.assign((size_t)c.bw * c.bh * 64, 0);
        std::fill(c.coef_bits, c.coef_bits + 64, -1);
      }
    }
    p = seg_end;
    frame = true;
  }

  void read_dht() {
    int len = u16();
    const uint8_t* seg_end = p + len - 2;
    if (seg_end > end) fail("JPEG file ends early");
    while (p < seg_end) {
      int tc_th = u8();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail("bad JPEG Huffman table id");
      uint8_t bits[17] = {0};
      int total = 0;
      for (int i = 1; i <= 16; ++i) total += bits[i] = (uint8_t)u8();
      if (total > 256 || p + total > seg_end) fail("bad JPEG Huffman table");
      (tc == 0 ? dc[th] : ac[th]).build(bits, p, total);
      p += total;
    }
    p = seg_end;
  }

  void read_dqt() {
    int len = u16();
    const uint8_t* seg_end = p + len - 2;
    if (seg_end > end) fail("JPEG file ends early");
    while (p < seg_end) {
      int pq_tq = u8();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3 || pq > 1) fail("bad JPEG quantization table");
      for (int i = 0; i < 64; ++i)
        qt[tq][kNatural[i]] = (uint16_t)(pq ? u16() : u8());
      qt_set[tq] = true;
    }
    p = seg_end;
  }

  void read_app(int marker) {
    int len = u16();
    const uint8_t* seg_end = p + len - 2;
    if (len < 2 || seg_end > end) fail("bad JPEG marker segment length");
    if (marker == 0xE0 && len >= 16 && std::memcmp(p, "JFIF\0", 5) == 0)
      jfif = true;
    if (marker == 0xEE && len >= 14 && std::memcmp(p, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = p[11];
    }
    p = seg_end;
  }

  void decode_block(BitReader& br, Component& c, int by, int bx) {
    const Huffman& hd = dc[c.td];
    const Huffman& ha = ac[c.ta];
    int32_t coef[64] = {0};
    int t = decode_symbol(br, hd);
    if (t > 11) fail("corrupt JPEG data: DC magnitude");
    c.pred += extend(br.get(t), t);
    coef[0] = c.pred;
    for (int k = 1; k < 64;) {
      int rs = decode_symbol(br, ha);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) fail("corrupt JPEG data: coefficient index");
        coef[kNatural[k]] = extend(br.get(s), s);
        ++k;
      } else if (r == 15) {
        k += 16;
      } else {
        break;
      }
    }
    int stride = c.bw * 8;
    idct_islow(coef, c.q, c.pix.data() + (size_t)by * 8 * stride + bx * 8,
               stride);
  }

  // ---- progressive scans (jdphuff.c), into c.coef ----

  int16_t* block(Component& c, int by, int bx) {
    return c.coef.data() + ((size_t)by * c.bw + bx) * 64;
  }

  void dc_first(BitReader& br, Component& c, int16_t* blk, int al) {
    int t = decode_symbol(br, dc[c.td]);
    if (t > 11) fail("corrupt JPEG data: DC magnitude");
    c.pred += extend(br.get(t), t);
    blk[0] = (int16_t)(int)((unsigned)c.pred << al);
  }

  static void dc_refine(BitReader& br, int16_t* blk, int al) {
    if (br.get(1)) blk[0] = (int16_t)(blk[0] | (1 << al));
  }

  void ac_first(BitReader& br, const Huffman& h, int16_t* blk, int ss, int se,
                int al) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    for (int k = ss; k <= se; ++k) {
      int rs = decode_symbol(br, h);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        if (k > se) fail("corrupt JPEG data: coefficient index");
        blk[kNatural[k]] = (int16_t)(int)((unsigned)extend(br.get(s), s) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = (1 << r) + (int)br.get(r) - 1;
        break;
      }
    }
  }

  // a coefficient already nonzero takes one correction bit: its magnitude
  // grows by 1 << al unless that bit is set already
  static void refine_nonzero(BitReader& br, int16_t* c, int p1) {
    if (br.get(1) && (*c & p1) == 0) *c = (int16_t)(*c + (*c >= 0 ? p1 : -p1));
  }

  void ac_refine(BitReader& br, const Huffman& h, int16_t* blk, int ss, int se,
                 int al) {
    const int p1 = 1 << al;
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        int rs = decode_symbol(br, h);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          // a new coefficient of magnitude 1 (libjpeg reads any size as 1)
          s = br.get(1) ? p1 : -p1;
        } else if (r != 15) {
          eobrun = (1 << r) + (int)br.get(r);
          break;
        }
        // skip r zero coefficients, refining the nonzero ones passed
        do {
          int16_t* c = blk + kNatural[k];
          if (*c != 0) {
            refine_nonzero(br, c, p1);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) {
          if (k > se) fail("corrupt JPEG data: coefficient index");
          blk[kNatural[k]] = (int16_t)s;
        }
      }
    }
    if (eobrun > 0) {  // the rest of this block lies in an EOB run
      for (; k <= se; ++k) {
        int16_t* c = blk + kNatural[k];
        if (*c != 0) refine_nonzero(br, c, p1);
      }
      --eobrun;
    }
  }

  // The progressive file's coefficients through the IDCT. libjpeg-turbo
  // smooths the blocks (decompress_smooth_data) when, at the output pass,
  // every component has DC coded, its first ten quantizers are nonzero
  // and some of its zigzag coefficients 1..9 is unrefined (coef_bits != 0);
  // such a file is refused.
  void finish_progressive() {
    static const int kSmoothQ[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool smooth_ok = true, useful = false;
    for (int i = 0; i < nc; ++i) {
      const Component& c = comp[i];
      if (!c.latched) fail("progressive JPEG component without a scan");
      for (int k : kSmoothQ)
        if (c.q[k] == 0) smooth_ok = false;
      if (c.coef_bits[0] < 0) smooth_ok = false;
      for (int k = 1; k < 10; ++k)
        if (c.coef_bits[k] != 0) useful = true;
    }
    if (smooth_ok && useful)
      refuse("progressive JPEG whose scans leave low-frequency coefficients "
             "unrefined (libjpeg's block smoothing is not reproduced)");
    int32_t tmp[64];
    for (int i = 0; i < nc; ++i) {
      Component& c = comp[i];
      const int stride = c.bw * 8;
      for (int by = 0; by < c.bh; ++by)
        for (int bx = 0; bx < c.bw; ++bx) {
          const int16_t* blk = block(c, by, bx);
          for (int k = 0; k < 64; ++k) tmp[k] = blk[k];
          idct_islow(tmp, c.q,
                     c.pix.data() + (size_t)by * 8 * stride + bx * 8, stride);
        }
    }
  }

  // One MCU of a progressive scan: DC scans may interleave components, AC
  // scans hold one.
  void prog_unit(BitReader& br, Component* const* sc, int ns, int my, int mx,
                 int ss, int se, int ah, int al) {
    auto one = [&](Component& c, int by, int bx) {
      int16_t* blk = block(c, by, bx);
      if (ss == 0) {
        if (ah == 0)
          dc_first(br, c, blk, al);
        else
          dc_refine(br, blk, al);
      } else if (ah == 0) {
        ac_first(br, ac[c.ta], blk, ss, se, al);
      } else {
        ac_refine(br, ac[c.ta], blk, ss, se, al);
      }
    };
    if (ns == 1) {
      one(*sc[0], my, mx);
      return;
    }
    for (int i = 0; i < ns; ++i) {
      Component& c = *sc[i];
      for (int v = 0; v < c.v; ++v)
        for (int h = 0; h < c.h; ++h) one(c, my * c.v + v, mx * c.h + h);
    }
  }

  void read_sos() {
    if (!frame) fail("JPEG scan before the frame header");
    int len = u16();
    int ns = u8();
    if (ns < 1 || ns > nc || len != 6 + 2 * ns) fail("bad JPEG scan header");
    int blocks = 0;
    Component* sc[4];
    for (int i = 0; i < ns; ++i) {
      int id = u8(), t = u8();
      Component* c = nullptr;
      for (int j = 0; j < nc; ++j)
        if (comp[j].id == id) c = &comp[j];
      if (!c) fail("JPEG scan names an unknown component");
      c->td = t >> 4;
      c->ta = t & 15;
      if (c->td > 3 || c->ta > 3) fail("bad JPEG Huffman table id");
      if (!qt_set[c->tq]) fail("JPEG scan uses a missing quantization table");
      sc[i] = c;
      blocks += c->h * c->v;
    }
    // jdinput.c: at most 10 blocks in an interleaved scan's MCU
    if (ns > 1 && blocks > 10)
      fail("JPEG sampling factors too large for an interleaved scan");
    int ss = u8(), se = u8(), ahl = u8();
    int ah = ahl >> 4, al = ahl & 15;
    if (!progressive && (ss != 0 || se != 63 || ahl != 0))
      fail("bad JPEG scan parameters for a sequential frame");
    if (progressive &&
        ((ss == 0 ? se != 0 : (ss > se || se > 63 || ns != 1)) ||
         (ah != 0 && al != ah - 1) || al > 13))
      fail("bad JPEG progressive scan parameters");
    for (int i = 0; i < ns; ++i) {
      Component& c = *sc[i];
      // the tables this scan decodes with: DC ones for a sequential or a DC
      // first scan, AC ones for a sequential or an AC scan
      bool need_dc = !progressive || (ss == 0 && ah == 0);
      bool need_ac = !progressive || ss != 0;
      if ((need_dc && !dc[c.td].present) || (need_ac && !ac[c.ta].present))
        fail("JPEG scan uses a missing Huffman table");
      if (!c.latched) {
        std::memcpy(c.q, qt[c.tq], sizeof(c.q));
        c.latched = true;
      }
      if (progressive)
        for (int k = ss; k <= se; ++k) c.coef_bits[k] = al;
      c.pred = 0;
    }
    eobrun = 0;
    BitReader br{p, end};
    // MCU geometry: an interleaved scan walks whole MCUs; a one-component
    // scan walks that component's own blocks (ceil(size / 8))
    int units_x, units_y;
    if (ns == 1) {
      units_x = (sc[0]->dw + 7) / 8;
      units_y = (sc[0]->dh + 7) / 8;
    } else {
      units_x = mcux;
      units_y = mcuy;
    }
    long total = (long)units_x * units_y, done = 0;
    for (int my = 0; my < units_y; ++my) {
      for (int mx = 0; mx < units_x; ++mx) {
        if (restart && done > 0 && done % restart == 0) {
          br.reset();
          if (!(br.p + 1 < end && br.p[0] == 0xFF && br.p[1] >= 0xD0 &&
                br.p[1] <= 0xD7))
            fail("corrupt JPEG data: missing restart marker");
          br.p += 2;
          for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
          eobrun = 0;
        }
        if (progressive) {
          prog_unit(br, sc, ns, my, mx, ss, se, ah, al);
        } else if (ns == 1) {
          decode_block(br, *sc[0], my, mx);
        } else {
          for (int i = 0; i < ns; ++i) {
            Component& c = *sc[i];
            for (int v = 0; v < c.v; ++v)
              for (int h = 0; h < c.h; ++h)
                decode_block(br, c, my * c.v + v, mx * c.h + h);
          }
        }
        ++done;
      }
    }
    (void)total;
    br.reset();
    p = br.p;
    ++scans;
  }

  void parse(bool header_only) {
    if (end - p < 2 || p[0] != 0xFF || p[1] != 0xD8) fail("not a JPEG file");
    p += 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
      if (m == 0xD9) break;  // EOI
      if ((m >= 0xC0 && m <= 0xC3) || (m >= 0xC5 && m <= 0xC7) ||
          (m >= 0xC9 && m <= 0xCB) || (m >= 0xCD && m <= 0xCF)) {
        if (header_only) {
          int len = u16();
          (void)len;
          u8();
          H = u16();
          W = u16();
          nc = u8();
          return;
        }
        read_sof(m);
      } else if (m == 0xC4) {
        read_dht();
      } else if (m == 0xDB) {
        read_dqt();
      } else if (m == 0xDD) {
        if (u16() != 4) fail("bad JPEG restart interval");
        restart = u16();
      } else if (m == 0xDA) {
        read_sos();
      } else if (m == 0xDC) {
        refuse("JPEG with a DNL marker is not supported");
      } else {
        read_app(m);  // APPn, COM, DAC and other segments with a length
      }
    }
    if (header_only) fail("JPEG without a frame header");
    if (!frame || scans == 0) fail("JPEG without image data");
    if (progressive) finish_progressive();
  }

  bool rgb_colorspace() const {
    if (jfif) return false;
    if (adobe) return adobe_transform == 0;
    return comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B';
  }

  // Row `y` (output resolution) of component c, upsampled as jdsample.c's
  // jinit_upsampler chooses, into out (W samples); row: scratch of
  // 2 * (c.dw + 1) samples. Rows above the first and below the last real
  // one (c.dh - 1) repeat it, as libjpeg's context rows do.
  void upsampled_row(const Component& c, int y, uint8_t* out,
                     uint8_t* row) const {
    const int stride = c.bw * 8;
    const int dw = c.dw;
    const int he = hmax / c.h, ve = vmax / c.v;
    const uint8_t* pix = c.pix.data();
    if (he == 1 && ve == 1) {  // fullsize
      std::memcpy(out, pix + (size_t)y * stride, W);
      return;
    }
    if (he == 2 && ve == 1 && dw > 2) {  // h2v1_fancy_upsample
      const uint8_t* in = pix + (size_t)y * stride;
      uint8_t* o = row;
      int iv = in[0];
      *o++ = (uint8_t)iv;
      *o++ = (uint8_t)((iv * 3 + in[1] + 2) >> 2);
      for (int i = 1; i < dw - 1; ++i) {
        iv = in[i] * 3;
        *o++ = (uint8_t)((iv + in[i - 1] + 1) >> 2);
        *o++ = (uint8_t)((iv + in[i + 1] + 2) >> 2);
      }
      iv = in[dw - 1];
      *o++ = (uint8_t)((iv * 3 + in[dw - 2] + 1) >> 2);
      *o++ = (uint8_t)iv;
      std::memcpy(out, row, W);
      return;
    }
    if (he == 1 && ve == 2) {  // h1v2_fancy_upsample
      int r = y >> 1;
      int other = (y & 1) ? std::min(r + 1, c.dh - 1) : std::max(r - 1, 0);
      const uint8_t* in0 = pix + (size_t)r * stride;
      const uint8_t* in1 = pix + (size_t)other * stride;
      const int bias = (y & 1) ? 2 : 1;
      for (int x = 0; x < W; ++x)
        out[x] = (uint8_t)((in0[x] * 3 + in1[x] + bias) >> 2);
      return;
    }
    if (he == 2 && ve == 2 && dw > 2) {  // h2v2_fancy_upsample
      int r = y >> 1;
      int other = (y & 1) ? std::min(r + 1, c.dh - 1) : std::max(r - 1, 0);
      const uint8_t* in0 = pix + (size_t)r * stride;
      const uint8_t* in1 = pix + (size_t)other * stride;
      uint8_t* o = row;
      int this_sum = in0[0] * 3 + in1[0];
      int next_sum = in0[1] * 3 + in1[1];
      *o++ = (uint8_t)((this_sum * 4 + 8) >> 4);
      *o++ = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
      int last_sum = this_sum;
      this_sum = next_sum;
      for (int i = 2; i < dw; ++i) {
        next_sum = in0[i] * 3 + in1[i];
        *o++ = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
        *o++ = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
        last_sum = this_sum;
        this_sum = next_sum;
      }
      *o++ = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
      *o++ = (uint8_t)((this_sum * 4 + 7) >> 4);
      std::memcpy(out, row, W);
      return;
    }
    // h2v1_upsample, h2v2_upsample and int_upsample: replication
    const uint8_t* in = pix + (size_t)(y / ve) * stride;
    for (int x = 0; x < W; ++x) out[x] = in[x / he];
  }

  // out: (H, W) samples for one component, (H, W, 3) RGB for three, and
  // (H, W, 4) inverted CMYK for four (PIL's "CMYK;I": 255 - libjpeg's CMYK
  // output, which for YCCK is 255 - ycck_cmyk_convert's)
  void output(uint8_t* out) const {
    if (nc == 1) {
      const Component& c = comp[0];
      for (int y = 0; y < H; ++y)
        std::memcpy(out + (size_t)y * W, c.pix.data() + (size_t)y * c.bw * 8,
                    W);
      return;
    }
    const ColorTables& t = color_tables();
    // jdapimin.c's colour space: YCbCr or RGB for three components, YCCK
    // or CMYK for four
    const bool ycc =
        nc == 3 ? !rgb_colorspace() : adobe && adobe_transform != 0;
    std::vector<uint8_t> rows[4];
    std::vector<uint8_t> scratch(2 * ((size_t)W + 2));
    for (int i = 0; i < nc; ++i) rows[i].resize(W);
    for (int y = 0; y < H; ++y) {
      for (int i = 0; i < nc; ++i)
        upsampled_row(comp[i], y, rows[i].data(), scratch.data());
      const uint8_t *c0 = rows[0].data(), *c1 = rows[1].data(),
                    *c2 = rows[2].data();
      uint8_t* o = out + (size_t)y * W * nc;
      for (int x = 0; x < W; ++x, o += nc) {
        if (ycc) {
          int yy = c0[x], cb = c1[x], cr = c2[x];
          o[0] = clamp8(yy + t.cr_r[cr]);
          o[1] = clamp8(yy + (int)((t.cb_g[cb] + t.cr_g[cr]) >> 16));
          o[2] = clamp8(yy + t.cb_b[cb]);
        } else {
          o[0] = c0[x];
          o[1] = c1[x];
          o[2] = c2[x];
        }
      }
      if (nc == 4) {
        // CMYK;I: the inverted CMYK samples; YCCK's inverted C, M and Y,
        // 255 - clamp(255 - (Y + Cr term)) and so on, are the RGB above
        const uint8_t* k = rows[3].data();
        o = out + (size_t)y * W * 4;
        for (int x = 0; x < W; ++x, o += 4) {
          if (!ycc)
            for (int ch = 0; ch < 3; ++ch) o[ch] = (uint8_t)(255 - o[ch]);
          o[3] = (uint8_t)(255 - k[x]);
        }
      }
    }
  }
};

// ---- encoder ----

const uint8_t kStdLuma[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChroma[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

const uint8_t kDcLumaBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1,
                                 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1,
                                   1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3,
                                 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4,
                                   7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffCodes {
  uint16_t code[256];
  uint8_t size[256];
  HuffCodes(const uint8_t* bits, const uint8_t* vals) {
    std::memset(size, 0, sizeof(size));
    uint16_t c = 0;
    int k = 0;
    for (int len = 1; len <= 16; ++len) {
      for (int i = 0; i < bits[len]; ++i, ++k, ++c) {
        code[vals[k]] = c;
        size[vals[k]] = (uint8_t)len;
      }
      c <<= 1;
    }
  }
};

struct BitWriter {
  std::vector<uint8_t>& out;
  uint64_t acc = 0;
  int nbits = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  inline void put(uint32_t bits, int n) {
    if (n == 0) return;
    acc = (acc << n) | (bits & ((1u << n) - 1));
    nbits += n;
    while (nbits >= 8) {
      uint8_t b = (uint8_t)(acc >> (nbits - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);
      nbits -= 8;
    }
  }
  void flush() {
    if (nbits) put(0x7F, 8 - nbits);  // pad with one bits
  }
};

// islow forward DCT (jfdctint.c) of level-shifted samples, in place,
// output scaled up by 8
void fdct_islow(int32_t* d) {
  for (int r = 0; r < 8; ++r) {
    int32_t* p = d + 8 * r;
    int64_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7];
    int64_t tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    int64_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5];
    int64_t tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = (int32_t)((tmp10 + tmp11) << kPass1Bits);
    p[4] = (int32_t)((tmp10 - tmp11) << kPass1Bits);
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    const int n = kConstBits - kPass1Bits;
    p[2] = (int32_t)descale(z1 + tmp13 * FIX_0_765366865, n);
    p[6] = (int32_t)descale(z1 + tmp12 * -FIX_1_847759065, n);
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[7] = (int32_t)descale(tmp4 + z1 + z3, n);
    p[5] = (int32_t)descale(tmp5 + z2 + z4, n);
    p[3] = (int32_t)descale(tmp6 + z2 + z3, n);
    p[1] = (int32_t)descale(tmp7 + z1 + z4, n);
  }
  for (int c = 0; c < 8; ++c) {
    int32_t* p = d + c;
    int64_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56];
    int64_t tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    int64_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40];
    int64_t tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = (int32_t)descale(tmp10 + tmp11, kPass1Bits);
    p[32] = (int32_t)descale(tmp10 - tmp11, kPass1Bits);
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    const int n = kConstBits + kPass1Bits;
    p[16] = (int32_t)descale(z1 + tmp13 * FIX_0_765366865, n);
    p[48] = (int32_t)descale(z1 + tmp12 * -FIX_1_847759065, n);
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[56] = (int32_t)descale(tmp4 + z1 + z3, n);
    p[40] = (int32_t)descale(tmp5 + z2 + z4, n);
    p[24] = (int32_t)descale(tmp6 + z2 + z3, n);
    p[8] = (int32_t)descale(tmp7 + z1 + z4, n);
  }
}

// jcparam.c jpeg_quality_scaling + jpeg_add_quant_table (force_baseline)
void scaled_table(const uint8_t* base, int quality, uint16_t* out) {
  quality = std::min(100, std::max(1, quality));
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; ++i) {
    long t = ((long)base[i] * scale + 50L) / 100L;
    out[i] = (uint16_t)std::min(255L, std::max(1L, t));
  }
}

struct Encoder {
  std::vector<uint8_t>& out;
  explicit Encoder(std::vector<uint8_t>& o) : out(o) {}

  void u8(int v) { out.push_back((uint8_t)v); }
  void u16(int v) {
    u8(v >> 8);
    u8(v & 255);
  }

  static void encode_block(BitWriter& bw, const int32_t* samples,
                           const uint16_t* q, int& pred, const HuffCodes& dch,
                           const HuffCodes& ach) {
    int32_t d[64];
    std::memcpy(d, samples, sizeof(d));
    fdct_islow(d);
    int32_t zz[64];
    for (int k = 0; k < 64; ++k) {
      int i = kNatural[k];
      int32_t div = (int32_t)q[i] << 3;
      int32_t t = d[i];
      if (t < 0) {
        t = -t + (div >> 1);
        t = -(t / div);
      } else {
        t = (t + (div >> 1)) / div;
      }
      zz[k] = k ? std::min(1023, std::max(-1023, t)) : t;  // 10-bit AC
    }
    auto emit = [&](int v, const HuffCodes& h, int run) {
      int a = v < 0 ? -v : v;
      int nb = 0;
      while (a) {
        ++nb;
        a >>= 1;
      }
      int sym = (run << 4) | nb;
      bw.put(h.code[sym], h.size[sym]);
      if (nb) bw.put((uint32_t)(v < 0 ? v - 1 : v), nb);
    };
    int diff = zz[0] - pred;
    pred = zz[0];
    emit(diff, dch, 0);
    int run = 0;
    for (int k = 1; k < 64; ++k) {
      if (zz[k] == 0) {
        ++run;
        continue;
      }
      while (run > 15) {
        bw.put(ach.code[0xF0], ach.size[0xF0]);
        run -= 16;
      }
      emit(zz[k], ach, run);
      run = 0;
    }
    if (run) bw.put(ach.code[0x00], ach.size[0x00]);
  }

  void dht(int tc_th, const uint8_t* bits, const uint8_t* vals, int n) {
    u8(tc_th);
    for (int i = 1; i <= 16; ++i) u8(bits[i]);
    for (int i = 0; i < n; ++i) u8(vals[i]);
  }

  void encode(const uint8_t* px, int H, int W, int C, int quality) {
    const int nc = C == 1 ? 1 : 3;
    uint16_t qy[64], qc[64];
    scaled_table(kStdLuma, quality, qy);
    scaled_table(kStdChroma, quality, qc);
    // SOI, JFIF APP0
    u16(0xFFD8);
    u16(0xFFE0);
    u16(16);
    const uint8_t jfif[14] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
    for (uint8_t b : jfif) u8(b);
    // DQT
    u16(0xFFDB);
    u16(2 + 65 * (nc == 3 ? 2 : 1));
    u8(0);
    for (int k = 0; k < 64; ++k) u8(qy[kNatural[k]]);
    if (nc == 3) {
      u8(1);
      for (int k = 0; k < 64; ++k) u8(qc[kNatural[k]]);
    }
    // SOF0
    u16(0xFFC0);
    u16(8 + 3 * nc);
    u8(8);
    u16(H);
    u16(W);
    u8(nc);
    if (nc == 1) {
      u8(1);
      u8(0x11);
      u8(0);
    } else {
      u8(1);
      u8(0x22);
      u8(0);
      u8(2);
      u8(0x11);
      u8(1);
      u8(3);
      u8(0x11);
      u8(1);
    }
    // DHT
    u16(0xFFC4);
    u16(2 + (nc == 3 ? 2 : 1) * (17 + 12 + 17 + 162));
    dht(0x00, kDcLumaBits, kDcVals, 12);
    dht(0x10, kAcLumaBits, kAcLumaVals, 162);
    if (nc == 3) {
      dht(0x01, kDcChromaBits, kDcVals, 12);
      dht(0x11, kAcChromaBits, kAcChromaVals, 162);
    }
    // SOS
    u16(0xFFDA);
    u16(6 + 2 * nc);
    u8(nc);
    for (int i = 0; i < nc; ++i) {
      u8(i + 1);
      u8(i == 0 ? 0x00 : 0x11);
    }
    u8(0);
    u8(63);
    u8(0);

    static const HuffCodes dcl(kDcLumaBits, kDcVals), acl(kAcLumaBits,
                                                          kAcLumaVals);
    static const HuffCodes dcc(kDcChromaBits, kDcVals),
        acc(kAcChromaBits, kAcChromaVals);
    BitWriter bw(out);
    const int mcu = nc == 1 ? 8 : 16;
    const int PW = (W + mcu - 1) / mcu * mcu, PH = (H + mcu - 1) / mcu * mcu;
    // full-resolution planes, padded by replicating the last row/column
    std::vector<int32_t> Y((size_t)PW * PH), Cb, Cr;
    if (nc == 3) {
      Cb.resize((size_t)PW * PH);
      Cr.resize((size_t)PW * PH);
    }
    const int32_t kOne = 1 << 15, kOff = 128 << 16;
    for (int y = 0; y < PH; ++y) {
      const uint8_t* row = px + (size_t)std::min(y, H - 1) * W * C;
      for (int x = 0; x < PW; ++x) {
        const uint8_t* s = row + (size_t)std::min(x, W - 1) * C;
        size_t i = (size_t)y * PW + x;
        if (nc == 1) {
          Y[i] = s[0];
          continue;
        }
        int32_t r = s[0], g = s[1], b = s[2];
        Y[i] = (19595 * r + 38470 * g + 7471 * b + kOne) >> 16;
        Cb[i] = (-11059 * r - 21709 * g + 32768 * b + kOff + kOne - 1) >> 16;
        Cr[i] = (32768 * r - 27439 * g - 5329 * b + kOff + kOne - 1) >> 16;
      }
    }
    // 4:2:0 chroma (jcsample.c h2v2_downsample: bias 1, 2, 1, 2, ...)
    const int CW = PW / 2, CH = PH / 2;
    std::vector<int32_t> cb2, cr2;
    if (nc == 3) {
      cb2.resize((size_t)CW * CH);
      cr2.resize((size_t)CW * CH);
      for (int y = 0; y < CH; ++y) {
        int bias = 1;
        for (int x = 0; x < CW; ++x) {
          size_t a = (size_t)(2 * y) * PW + 2 * x, b = a + PW;
          cb2[(size_t)y * CW + x] =
              (Cb[a] + Cb[a + 1] + Cb[b] + Cb[b + 1] + bias) >> 2;
          cr2[(size_t)y * CW + x] =
              (Cr[a] + Cr[a + 1] + Cr[b] + Cr[b + 1] + bias) >> 2;
          bias ^= 3;
        }
      }
    }
    auto block = [](const std::vector<int32_t>& plane, int stride, int by,
                    int bx, int32_t* o) {
      for (int r = 0; r < 8; ++r)
        for (int c = 0; c < 8; ++c)
          o[8 * r + c] = plane[(size_t)(by * 8 + r) * stride + bx * 8 + c] - 128;
    };
    int py = 0, pcb = 0, pcr = 0;
    int32_t blk[64];
    for (int my = 0; my < PH / mcu; ++my) {
      for (int mx = 0; mx < PW / mcu; ++mx) {
        if (nc == 1) {
          block(Y, PW, my, mx, blk);
          encode_block(bw, blk, qy, py, dcl, acl);
          continue;
        }
        for (int v = 0; v < 2; ++v)
          for (int h = 0; h < 2; ++h) {
            block(Y, PW, 2 * my + v, 2 * mx + h, blk);
            encode_block(bw, blk, qy, py, dcl, acl);
          }
        block(cb2, CW, my, mx, blk);
        encode_block(bw, blk, qc, pcb, dcc, acc);
        block(cr2, CW, my, mx, blk);
        encode_block(bw, blk, qc, pcr, dcc, acc);
      }
    }
    bw.flush();
    u16(0xFFD9);
  }
};

}  // namespace jpg

extern "C" {

// The calling thread's last JPEG error message.
const char* jpeg_last_error() { return jpg::t_error.c_str(); }

// Header of a JPEG in memory: height, width and component count. Returns 0,
// or -1 with jpeg_last_error() set.
int jpeg_info(const uint8_t* data, long n, int* H, int* W, int* C) {
  try {
    jpg::Decoder d(data, n);
    d.parse(true);
    *H = d.H;
    *W = d.W;
    *C = d.nc;
    return 0;
  } catch (const jpg::Error& e) {
    jpg::t_error = e.msg;
    return -1;
  }
}

// Decode a baseline or progressive JPEG into out: (H, W) samples for one
// component, (H, W, 3) RGB for three, (H, W, 4) inverted CMYK for four; H,
// W and C must be jpeg_info's. Returns 0, or with jpeg_last_error() set -2
// for a file of a variant this decoder does not implement and -1 for a
// broken one.
int jpeg_decode(const uint8_t* data, long n, uint8_t* out, int H, int W,
                int C) {
  try {
    jpg::Decoder d(data, n);
    d.parse(false);
    if (d.H != H || d.W != W || d.nc != C)
      jpg::fail("JPEG size differs from the caller's");
    d.output(out);
    return 0;
  } catch (const jpg::Error& e) {
    jpg::t_error = e.msg;
    return e.unsupported ? -2 : -1;
  } catch (const std::bad_alloc&) {
    jpg::t_error = "out of memory decoding a JPEG";
    return -1;
  }
}

// Encode (H, W) gray or (H, W, 3) RGB samples as a baseline JFIF file
// (4:2:0 chroma) at `quality` (1-100). Returns the byte count, kept for
// jpeg_take on the same thread, or -1 with jpeg_last_error() set.
long jpeg_encode(const uint8_t* px, int H, int W, int C, int quality) {
  try {
    if (H <= 0 || W <= 0 || H > 65535 || W > 65535 || (C != 1 && C != 3))
      jpg::fail("jpeg_encode: size or channel count not supported");
    jpg::t_encoded.clear();
    jpg::t_encoded.reserve((size_t)H * W * C / 4 + 1024);
    jpg::Encoder(jpg::t_encoded).encode(px, H, W, C, quality);
    return (long)jpg::t_encoded.size();
  } catch (const jpg::Error& e) {
    jpg::t_error = e.msg;
    return -1;
  } catch (const std::bad_alloc&) {
    jpg::t_error = "out of memory encoding a JPEG";
    return -1;
  }
}

// Copy the calling thread's last jpeg_encode result into out.
void jpeg_take(uint8_t* out) {
  std::memcpy(out, jpg::t_encoded.data(), jpg::t_encoded.size());
  jpg::t_encoded.clear();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// LANCZOS resample: Pillow's ImagingResample (Resample.c) of a uint8 (H, W,
// C) image, C = 1-4, computing only an output window of the full resize.
// Each output's coefficients come from its absolute index in the full
// output (center = (xx + 0.5) * scale, support 3 scaled by the downscale
// factor, normalised in double, then fixed point with PRECISION_BITS 22,
// rounded half away from zero): the window is bitwise the crop of the full
// resize. A horizontal pass over the input rows the window's outputs read,
// then a vertical pass, each accumulated in int32 from 2^21 and clipped to
// uint8; a pass is skipped along an axis whose size does not change.
namespace rs {

constexpr int kBits = 22;  // PRECISION_BITS: 32 - 8 - 2
constexpr int kRows = 16;  // rows of one block of the horizontal pass

double sinc(double x) {
  if (x == 0.0) return 1.0;
  x = x * M_PI;
  return std::sin(x) / x;
}

double lanczos(double x) {
  if (-3.0 <= x && x < 3.0) return sinc(x) * sinc(x / 3);
  return 0.0;
}

// Pillow's precompute_coeffs and normalize_coeffs_8bpc for the outputs
// [o0, o0 + n) of one axis resized from in_size to out_size: each output's
// first tap and tap count, and its ksize fixed-point coefficients (zero
// past its count).
struct Taps {
  int ksize;
  std::vector<int> first, count;
  std::vector<int32_t> k;  // (n, ksize)
};

Taps taps(int in_size, int out_size, int o0, int n) {
  const double scale = (double)in_size / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = 3.0 * filterscale;
  const double ss = 1.0 / filterscale;
  Taps t;
  t.ksize = (int)std::ceil(support) * 2 + 1;
  t.first.resize(n);
  t.count.resize(n);
  t.k.assign((size_t)n * t.ksize, 0);
  std::vector<double> w(t.ksize);
  for (int i = 0; i < n; ++i) {
    const double center = (o0 + i + 0.5) * scale;
    const int xmin = std::max((int)(center - support + 0.5), 0);
    const int cnt = std::min(std::min((int)(center + support + 0.5), in_size)
                             - xmin, t.ksize);
    double ww = 0.0;
    for (int x = 0; x < cnt; ++x) {
      w[x] = lanczos((x + xmin - center + 0.5) * ss);
      ww += w[x];
    }
    int32_t* k = &t.k[(size_t)i * t.ksize];
    for (int x = 0; x < cnt; ++x) {
      const double v = ww != 0.0 ? w[x] / ww : w[x];
      const double s = v * (1 << kBits);
      k[x] = (int32_t)(v < 0 ? -0.5 + s : 0.5 + s);
    }
    t.first[i] = xmin;
    t.count[i] = cnt;
  }
  return t;
}

inline uint8_t clip8(int32_t acc) {
  const int32_t v = acc >> kBits;
  return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
}

// The two passes are integer arithmetic alone, so their AVX2 clones (picked
// at load time where the CPU has AVX2) give the same bytes as the default.
#define RS_CLONES __attribute__((target_clones("avx2", "default")))

// The horizontal pass of `nrows` rows of src (row stride `stride` bytes)
// into out ((nrows, n, C), n = t's outputs). Rows go kRows at a time
// through a transposed block, col[x][r][c], so that each output sums whole
// blocks of kRows * C contiguous samples.
template <int C>
RS_CLONES void horizontal(const uint8_t* src, long stride, int nrows,
                          const Taps& t, uint8_t* out) {
  constexpr int L = kRows * C;
  const int n = (int)t.first.size();
  const int xlo = t.first[0];
  int xhi = xlo;
  for (int j = 0; j < n; ++j) xhi = std::max(xhi, t.first[j] + t.count[j]);
  std::vector<uint8_t> col((size_t)(xhi - xlo) * L, 0);
  for (int rb = 0; rb < nrows; rb += kRows) {
    const int nr = std::min(kRows, nrows - rb);
    for (int r = 0; r < nr; ++r) {
      const uint8_t* s = src + (rb + r) * stride + (long)xlo * C;
      uint8_t* d = &col[r * C];
      for (int x = 0; x < xhi - xlo; ++x)
        for (int c = 0; c < C; ++c) d[(size_t)x * L + c] = s[x * C + c];
    }
    for (int j = 0; j < n; ++j) {
      const int32_t* k = &t.k[(size_t)j * t.ksize];
      const uint8_t* s = &col[(size_t)(t.first[j] - xlo) * L];
      int32_t acc[L];
      for (int l = 0; l < L; ++l) acc[l] = 1 << (kBits - 1);
      for (int tap = 0; tap < t.count[j]; ++tap, s += L) {
        const int32_t kv = k[tap];
        for (int l = 0; l < L; ++l) acc[l] += s[l] * kv;
      }
      for (int r = 0; r < nr; ++r)
        for (int c = 0; c < C; ++c)
          out[((size_t)(rb + r) * n + j) * C + c] = clip8(acc[r * C + c]);
    }
  }
}

// The vertical pass: out row i sums t's taps of the rows of src (row
// stride `stride` bytes, row 0 the input row r0), each row `len` samples.
RS_CLONES void vertical(const uint8_t* src, long stride, int r0, int len,
                        const Taps& t, uint8_t* out) {
  std::vector<int32_t> acc(len);
  for (int i = 0; i < (int)t.first.size(); ++i) {
    const int32_t* k = &t.k[(size_t)i * t.ksize];
    std::fill(acc.begin(), acc.end(), 1 << (kBits - 1));
    const uint8_t* s = src + (long)(t.first[i] - r0) * stride;
    for (int tap = 0; tap < t.count[i]; ++tap, s += stride) {
      const int32_t kv = k[tap];
      for (int l = 0; l < len; ++l) acc[l] += s[l] * kv;
    }
    uint8_t* o = out + (size_t)i * len;
    for (int l = 0; l < len; ++l) o[l] = clip8(acc[l]);
  }
}

template <int C>
void resample(const uint8_t* in, int H, int W, int w, int h, int y0, int x0,
              int oh, int ow, uint8_t* out) {
  const long in_stride = (long)W * C;
  const int len = ow * C;
  if (H == h) {  // one pass, or none
    const uint8_t* src = in + y0 * in_stride;
    if (W == w) {
      for (int i = 0; i < oh; ++i)
        std::memcpy(out + (size_t)i * len, src + i * in_stride + x0 * C, len);
    } else {
      horizontal<C>(src, in_stride, oh, taps(W, w, x0, ow), out);
    }
    return;
  }
  const Taps tv = taps(H, h, y0, oh);
  int r0 = H, r1 = 0;  // the input rows the window's outputs read
  for (int i = 0; i < oh; ++i) {
    r0 = std::min(r0, tv.first[i]);
    r1 = std::max(r1, tv.first[i] + tv.count[i]);
  }
  if (W == w) {
    vertical(in + r0 * in_stride + x0 * C, in_stride, r0, len, tv, out);
    return;
  }
  std::vector<uint8_t> mid((size_t)(r1 - r0) * len);
  horizontal<C>(in + r0 * in_stride, in_stride, r1 - r0, taps(W, w, x0, ow),
                mid.data());
  vertical(mid.data(), len, r0, len, tv, out);
}

}  // namespace rs

extern "C" {

// Rows [y0, y0 + oh) and columns [x0, x0 + ow) of Pillow's LANCZOS resize
// of the uint8 (H, W, C) image `in` to (h, w), written to out, (oh, ow, C).
// Returns 0, -1 when C is not 1-4 or the window is not inside (h, w), or
// -2 out of memory.
int resize_lanczos_window(const uint8_t* in, int H, int W, int C, int w,
                          int h, int y0, int x0, int oh, int ow,
                          uint8_t* out) {
  if (H <= 0 || W <= 0 || w <= 0 || h <= 0 || oh <= 0 || ow <= 0 ||
      y0 < 0 || x0 < 0 || y0 + oh > h || x0 + ow > w)
    return -1;
  try {
    switch (C) {
      case 1: rs::resample<1>(in, H, W, w, h, y0, x0, oh, ow, out); break;
      case 2: rs::resample<2>(in, H, W, w, h, y0, x0, oh, ow, out); break;
      case 3: rs::resample<3>(in, H, W, w, h, y0, x0, oh, ow, out); break;
      case 4: rs::resample<4>(in, H, W, w, h, y0, x0, oh, ow, out); break;
      default: return -1;
    }
  } catch (const std::bad_alloc&) {
    return -2;
  }
  return 0;
}

}  // extern "C"
