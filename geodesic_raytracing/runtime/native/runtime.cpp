// Native runtime support library.
//
// Equivalents of the reference's C++ runtime roles:
//  * mip-pyramid construction on the host (graphics_settings.cpp:152-212
//    builds a CPU-side pyramid to work around GPU driver holes; here the
//    pyramid feeds the device mip atlas and large skyspheres make numpy
//    slow),
//  * OBJ mesh loading (triangle_manager.cpp:110-193 via tinyobjloader),
//  * an asynchronous frame writer: a worker-thread queue that encodes and
//    writes PNGs off the render thread (the reference's async readback
//    queues + screenshot path, main.cpp:434-523, 2777-2808).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <condition_variable>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------------
// Mip pyramid: repeated 2x2 box filter with edge clamping, packed into a
// (h, 2w, c) atlas whose level l occupies rows [0, h>>l), cols
// [xoff_l, xoff_l + (w>>l)).
// ---------------------------------------------------------------------------

static void downsample2(const float* src, int h, int w, int c,
                        float* dst, int oh, int ow) {
  for (int y = 0; y < oh; ++y) {
    int y0 = 2 * y, y1 = (2 * y + 1 < h) ? 2 * y + 1 : h - 1;
    for (int x = 0; x < ow; ++x) {
      int x0 = 2 * x, x1 = (2 * x + 1 < w) ? 2 * x + 1 : w - 1;
      for (int k = 0; k < c; ++k) {
        float v = src[(y0 * w + x0) * c + k] + src[(y0 * w + x1) * c + k] +
                  src[(y1 * w + x0) * c + k] + src[(y1 * w + x1) * c + k];
        dst[(y * ow + x) * c + k] = 0.25f * v;
      }
    }
  }
}

// Returns the number of levels written; fills atlas (h x 2w x c, zeroed by
// caller) plus per-level width/height/xoff arrays (size >= max_levels).
int grt_build_mips(const float* img, int h, int w, int c, int max_levels,
                   float* atlas, int* level_w, int* level_h, int* level_x) {
  int atlas_w = 2 * w;
  std::vector<float> cur(img, img + (size_t)h * w * c);
  int ch = h, cw = w, x = 0, l = 0;
  for (; l < max_levels && ch >= 1 && cw >= 1; ++l) {
    for (int y = 0; y < ch; ++y)
      memcpy(atlas + ((size_t)y * atlas_w + x) * c,
             cur.data() + (size_t)y * cw * c, sizeof(float) * cw * c);
    level_w[l] = cw;
    level_h[l] = ch;
    level_x[l] = x;
    x += cw;
    int nh = (ch + 1) / 2, nw = (cw + 1) / 2;
    if (nh == ch && nw == cw) { ++l; break; }
    std::vector<float> nxt((size_t)nh * nw * c);
    downsample2(cur.data(), ch, cw, c, nxt.data(), nh, nw);
    cur.swap(nxt);
    ch = nh; cw = nw;
  }
  return l;
}

// ---------------------------------------------------------------------------
// OBJ loader: v / vn / vt / f records, fan-triangulated polygons, negative
// indices, ignores materials.  (triangle_manager.cpp:110-193 parity.)
// ---------------------------------------------------------------------------

struct ObjMesh {
  std::vector<float> positions;  // 3 per vertex
  std::vector<int> indices;      // 3 per triangle
};

static thread_local std::string g_obj_error;

void* grt_obj_load(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) { g_obj_error = "cannot open file"; return nullptr; }
  ObjMesh* mesh = new ObjMesh();
  char line[4096];
  std::vector<int> face;
  while (fgets(line, sizeof line, f)) {
    if (line[0] == 'v' && (line[1] == ' ' || line[1] == '\t')) {
      float x = 0, y = 0, z = 0;
      if (sscanf(line + 2, "%f %f %f", &x, &y, &z) == 3) {
        mesh->positions.push_back(x);
        mesh->positions.push_back(y);
        mesh->positions.push_back(z);
      }
    } else if (line[0] == 'f' && (line[1] == ' ' || line[1] == '\t')) {
      face.clear();
      char* p = line + 2;
      while (*p) {
        while (*p == ' ' || *p == '\t') ++p;
        if (*p == '\0' || *p == '\n' || *p == '\r') break;
        long idx = strtol(p, &p, 10);
        // skip /vt/vn suffixes
        while (*p && *p != ' ' && *p != '\t' && *p != '\n' && *p != '\r') ++p;
        long nverts = (long)mesh->positions.size() / 3;
        if (idx < 0) idx = nverts + idx + 1;
        if (idx >= 1 && idx <= nverts) face.push_back((int)(idx - 1));
      }
      for (size_t i = 2; i < face.size(); ++i) {  // fan triangulation
        mesh->indices.push_back(face[0]);
        mesh->indices.push_back(face[i - 1]);
        mesh->indices.push_back(face[i]);
      }
    }
  }
  fclose(f);
  return mesh;
}

int grt_obj_vertex_count(void* handle) {
  return (int)(((ObjMesh*)handle)->positions.size() / 3);
}
int grt_obj_index_count(void* handle) {
  return (int)(((ObjMesh*)handle)->indices.size());
}
void grt_obj_copy(void* handle, float* positions, int* indices) {
  ObjMesh* m = (ObjMesh*)handle;
  memcpy(positions, m->positions.data(),
         m->positions.size() * sizeof(float));
  memcpy(indices, m->indices.data(), m->indices.size() * sizeof(int));
}
void grt_obj_free(void* handle) { delete (ObjMesh*)handle; }

// ---------------------------------------------------------------------------
// PNG encoding (zlib) + async writer pool
// ---------------------------------------------------------------------------

static void put32(std::vector<uint8_t>& v, uint32_t x) {
  v.push_back(x >> 24); v.push_back(x >> 16); v.push_back(x >> 8);
  v.push_back(x);
}

static uint32_t crc32_of(const uint8_t* data, size_t n, uint32_t seed) {
  return (uint32_t)crc32(seed, data, (uInt)n);
}

static void chunk(std::vector<uint8_t>& out, const char tag[4],
                  const std::vector<uint8_t>& payload) {
  put32(out, (uint32_t)payload.size());
  size_t start = out.size();
  out.insert(out.end(), tag, tag + 4);
  out.insert(out.end(), payload.begin(), payload.end());
  uint32_t crc = crc32_of(out.data() + start, out.size() - start, 0);
  put32(out, crc);
}

static bool write_png(const char* path, const uint8_t* rgb, int w, int h) {
  std::vector<uint8_t> raw;
  raw.reserve((size_t)h * (w * 3 + 1));
  for (int y = 0; y < h; ++y) {
    raw.push_back(0);  // filter none
    raw.insert(raw.end(), rgb + (size_t)y * w * 3,
               rgb + (size_t)(y + 1) * w * 3);
  }
  uLongf zcap = compressBound((uLong)raw.size());
  std::vector<uint8_t> z(zcap);
  if (compress2(z.data(), &zcap, raw.data(), (uLong)raw.size(), 6) != Z_OK)
    return false;
  z.resize(zcap);

  std::vector<uint8_t> out;
  static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  out.insert(out.end(), sig, sig + 8);
  std::vector<uint8_t> ihdr;
  put32(ihdr, (uint32_t)w); put32(ihdr, (uint32_t)h);
  ihdr.push_back(8);   // bit depth
  ihdr.push_back(2);   // colour type: truecolour
  ihdr.push_back(0); ihdr.push_back(0); ihdr.push_back(0);
  chunk(out, "IHDR", ihdr);
  chunk(out, "IDAT", z);
  chunk(out, "IEND", {});

  FILE* f = fopen(path, "wb");
  if (!f) return false;
  size_t n = fwrite(out.data(), 1, out.size(), f);
  fclose(f);
  return n == out.size();
}

struct WriteJob {
  std::string path;
  int w, h;
  std::vector<uint8_t> rgb;
};

struct Writer {
  std::deque<WriteJob> queue;
  std::mutex mu;
  std::condition_variable cv;
  std::vector<std::thread> threads;
  std::atomic<int> pending{0};
  std::atomic<int> failures{0};
  bool stop = false;

  explicit Writer(int n) {
    for (int i = 0; i < n; ++i)
      threads.emplace_back([this] { run(); });
  }
  void run() {
    for (;;) {
      WriteJob job;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [this] { return stop || !queue.empty(); });
        if (queue.empty()) {
          if (stop) return;
          continue;
        }
        job = std::move(queue.front());
        queue.pop_front();
      }
      if (!write_png(job.path.c_str(), job.rgb.data(), job.w, job.h))
        failures.fetch_add(1);
      pending.fetch_sub(1);
    }
  }
};

void* grt_writer_create(int n_threads) {
  if (n_threads < 1) n_threads = 1;
  return new Writer(n_threads);
}

void grt_writer_submit(void* handle, const char* path, const uint8_t* rgb,
                       int w, int h) {
  Writer* wr = (Writer*)handle;
  WriteJob job;
  job.path = path;
  job.w = w;
  job.h = h;
  job.rgb.assign(rgb, rgb + (size_t)w * h * 3);
  wr->pending.fetch_add(1);
  {
    std::lock_guard<std::mutex> lk(wr->mu);
    wr->queue.push_back(std::move(job));
  }
  wr->cv.notify_one();
}

int grt_writer_pending(void* handle) {
  return ((Writer*)handle)->pending.load();
}

int grt_writer_failures(void* handle) {
  return ((Writer*)handle)->failures.load();
}

void grt_writer_destroy(void* handle) {
  Writer* wr = (Writer*)handle;
  // Drain before shutdown.
  while (wr->pending.load() > 0)
    std::this_thread::sleep_for(std::chrono::milliseconds(1));
  {
    std::lock_guard<std::mutex> lk(wr->mu);
    wr->stop = true;
  }
  wr->cv.notify_all();
  for (auto& t : wr->threads) t.join();
  delete wr;
}

}  // extern "C"
