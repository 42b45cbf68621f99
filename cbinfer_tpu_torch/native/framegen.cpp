// Native video data layer (SURVEY.md C18).
//
// The reference's data path is native (OpenCV decode + preprocessing,
// [repo-recall]). This box has no datasets or codecs, so the native tier
// generates synthetic static-camera video: a fixed multi-octave value-noise
// background plus moving square sprites with parameterized count/size/speed
// (the change-rate knob), plus optional per-pixel sensor noise — the same
// model as cbinfer_tpu/video.py, implemented in C++ for production-rate
// frame generation (multithreaded row fill, xorshift RNG), exposed through
// a plain C ABI consumed via ctypes (cbinfer_tpu/data.py).
//
// Frames are HWC float32 in [0, 1].

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct XorShift {
  uint64_t s;
  explicit XorShift(uint64_t seed) : s(seed ? seed : 0x9e3779b97f4a7c15ULL) {}
  uint64_t next() {
    s ^= s << 13;
    s ^= s >> 7;
    s ^= s << 17;
    return s;
  }
  // uniform in [0, 1)
  float uniform() { return (next() >> 40) * (1.0f / (1ULL << 24)); }
  // approximate standard normal (sum of 4 uniforms, Irwin-Hall)
  float normal() {
    float acc = 0.f;
    for (int i = 0; i < 4; ++i) acc += uniform();
    return (acc - 2.0f) * 1.7320508f;  // var(U4)=4/12 -> scale sqrt(3)
  }
};

struct Sprite {
  float y, x, vy, vx;
  std::vector<float> color;
};

struct FrameGen {
  int h, w, c, sprite_size;
  float noise_std;
  std::vector<float> background;  // h*w*c
  std::vector<Sprite> sprites;
  XorShift noise_rng;
  uint64_t frame_index = 0;

  FrameGen(int h_, int w_, int c_, int n_sprites, int sprite_size_,
           float speed, float noise_std_, uint64_t seed)
      : h(h_), w(w_), c(c_), sprite_size(sprite_size_),
        noise_std(noise_std_), noise_rng(seed + 1) {
    XorShift rng(seed ? seed : 1);
    // multi-octave value noise background (bilinear upsampled octaves)
    background.assign(size_t(h) * w * c, 0.f);
    const int octaves = 4;
    for (int o = 0; o < octaves; ++o) {
      int gh = std::max(2, h >> (octaves - o));
      int gw = std::max(2, w >> (octaves - o));
      std::vector<float> coarse(size_t(gh) * gw * c);
      for (auto &v : coarse) v = rng.normal();
      float amp = 1.0f / float(1 << o);
      for (int y = 0; y < h; ++y) {
        float fy = float(y) * (gh - 1) / std::max(1, h - 1);
        int y0 = int(fy), y1 = std::min(y0 + 1, gh - 1);
        float wy = fy - y0;
        for (int x = 0; x < w; ++x) {
          float fx = float(x) * (gw - 1) / std::max(1, w - 1);
          int x0 = int(fx), x1 = std::min(x0 + 1, gw - 1);
          float wx = fx - x0;
          for (int ch = 0; ch < c; ++ch) {
            float v00 = coarse[(size_t(y0) * gw + x0) * c + ch];
            float v01 = coarse[(size_t(y0) * gw + x1) * c + ch];
            float v10 = coarse[(size_t(y1) * gw + x0) * c + ch];
            float v11 = coarse[(size_t(y1) * gw + x1) * c + ch];
            background[(size_t(y) * w + x) * c + ch] +=
                amp * ((1 - wy) * ((1 - wx) * v00 + wx * v01) +
                       wy * ((1 - wx) * v10 + wx * v11));
          }
        }
      }
    }
    float lo = background[0], hi = background[0];
    for (float v : background) { lo = std::min(lo, v); hi = std::max(hi, v); }
    float scale = 1.0f / std::max(hi - lo, 1e-6f);
    for (auto &v : background) v = (v - lo) * scale;

    for (int i = 0; i < n_sprites; ++i) {
      Sprite s;
      s.y = rng.uniform() * std::max(1, h - sprite_size);
      s.x = rng.uniform() * std::max(1, w - sprite_size);
      float ang = rng.uniform() * 6.2831853f;
      s.vy = speed * std::sin(ang);
      s.vx = speed * std::cos(ang);
      s.color.resize(c);
      for (int ch = 0; ch < c; ++ch) s.color[ch] = rng.uniform();
      sprites.push_back(std::move(s));
    }
  }

  void render(float *out, int n_threads) {
    size_t total = size_t(h) * w * c;
    // background copy + optional noise, parallel over row bands
    int threads = std::max(1, n_threads);
    std::vector<std::thread> pool;
    int band = (h + threads - 1) / threads;
    uint64_t base_seed = noise_rng.next();
    for (int t = 0; t < threads; ++t) {
      pool.emplace_back([&, t]() {
        int y0 = t * band, y1 = std::min(h, y0 + band);
        if (y0 >= y1) return;
        size_t off = size_t(y0) * w * c;
        size_t len = size_t(y1 - y0) * w * c;
        std::memcpy(out + off, background.data() + off, len * sizeof(float));
        if (noise_std > 0.f) {
          // cheap centered-uniform noise, variance-matched to N(0, std^2):
          // (u - 0.5) * sqrt(12) has unit variance; distribution shape is
          // irrelevant for threshold-stressing sensor noise.
          XorShift r(base_seed ^ (0x9e3779b9ULL * (t + 1)));
          const float scale = noise_std * 3.4641016f;
          for (size_t i = off; i < off + len; ++i)
            out[i] += scale * (r.uniform() - 0.5f);
        }
      });
    }
    for (auto &th : pool) th.join();
    (void)total;
    // sprites on top (small, serial)
    for (const auto &s : sprites) {
      int sy = int(s.y), sx = int(s.x);
      for (int dy = 0; dy < sprite_size; ++dy) {
        int y = sy + dy;
        if (y < 0 || y >= h) continue;
        for (int dx = 0; dx < sprite_size; ++dx) {
          int x = sx + dx;
          if (x < 0 || x >= w) continue;
          float *p = out + (size_t(y) * w + x) * c;
          for (int ch = 0; ch < c; ++ch) p[ch] = s.color[ch];
        }
      }
    }
  }

  void step() {
    for (auto &s : sprites) {
      s.y += s.vy;
      s.x += s.vx;
      float ylim = float(std::max(1, h - sprite_size));
      float xlim = float(std::max(1, w - sprite_size));
      if (s.y < 0) { s.y = -s.y; s.vy = -s.vy; }
      if (s.y > ylim) { s.y = 2 * ylim - s.y; s.vy = -s.vy; }
      if (s.x < 0) { s.x = -s.x; s.vx = -s.vx; }
      if (s.x > xlim) { s.x = 2 * xlim - s.x; s.vx = -s.vx; }
    }
    frame_index++;
  }
};

}  // namespace

extern "C" {

void *fg_create(int h, int w, int c, int n_sprites, int sprite_size,
                float speed, float noise_std, uint64_t seed) {
  return new FrameGen(h, w, c, n_sprites, sprite_size, speed, noise_std,
                      seed);
}

void fg_destroy(void *handle) { delete static_cast<FrameGen *>(handle); }

// Render the next frame into out (h*w*c floats) and advance sprite state.
void fg_next(void *handle, float *out, int n_threads) {
  auto *g = static_cast<FrameGen *>(handle);
  g->render(out, n_threads);
  g->step();
}

// Render n frames into out (n*h*w*c floats).
void fg_next_batch(void *handle, float *out, int n, int n_threads) {
  auto *g = static_cast<FrameGen *>(handle);
  size_t stride = size_t(g->h) * g->w * g->c;
  for (int i = 0; i < n; ++i) {
    g->render(out + i * stride, n_threads);
    g->step();
  }
}

uint64_t fg_frame_index(void *handle) {
  return static_cast<FrameGen *>(handle)->frame_index;
}
}
