// Native IO runtime for waldboost_tpu_torch: bbGt annotation parsing, PGM/PPM
// image decoding, and a multi-threaded prefetching dataset loader.  The port's
// own copy of waldboost_tpu/io/native/loader.cpp, with the same C ABI and
// behaviour.
//
// This is the host-side input pipeline that keeps the card fed: worker
// threads decode (image, ground-truth) pairs into a bounded ring buffer while
// the device is busy, in place of a per-image multiprocessing fan-out.
//
// Exposed as a plain C ABI consumed from Python via ctypes (no pybind11
// dependency).  Build: g++ -O2 -shared -fPIC -std=c++17 -pthread.

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <mutex>
#include <queue>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// bbGt v3 annotation parser (Piotr's Toolbox format; 12-field lines:
// label x y w h occluded vx vy vw vh ignore angle) — parity with
// waldboost_tpu_torch/groundtruth.py::read_bbgt, XYWH -> XYXY conversion
// applied here.
// ---------------------------------------------------------------------------

// Parse one bbGt file.  rects_out: (cap, 4) floats XYXY; ignore_out: (cap,).
// Returns number of boxes, -1 on IO error, -2 on bad signature,
// -3 on malformed line.  Boxes beyond cap are counted but not stored.
int wb_bbgt_parse_file(const char* path, float* rects_out, int* ignore_out,
                       int cap) {
  std::ifstream f(path);
  if (!f.is_open()) return -1;
  std::string line;
  if (!std::getline(f, line)) return -2;
  if (line.rfind("% bbGt version=3", 0) != 0) return -2;
  int count = 0;
  while (std::getline(f, line)) {
    if (line.empty()) continue;
    std::istringstream ss(line);
    std::string label;
    double v[11];
    ss >> label;
    for (int i = 0; i < 11; i++) {
      if (!(ss >> v[i])) return -3;
    }
    if (count < cap) {
      float x = (float)v[0], y = (float)v[1], w = (float)v[2], h = (float)v[3];
      rects_out[count * 4 + 0] = x;
      rects_out[count * 4 + 1] = y;
      rects_out[count * 4 + 2] = x + w;
      rects_out[count * 4 + 3] = y + h;
      ignore_out[count] = (int)v[9];
    }
    count++;
  }
  return count;
}

// ---------------------------------------------------------------------------
// PGM (P5) / PPM (P6, converted to gray) decoder — dependency-free formats
// for the streaming pipeline.
// ---------------------------------------------------------------------------

static bool read_pnm_token(std::ifstream& f, std::string& tok) {
  tok.clear();
  int c;
  while ((c = f.get()) != EOF) {
    if (c == '#') {  // comment to end of line
      while ((c = f.get()) != EOF && c != '\n') {}
      continue;
    }
    if (!isspace(c)) break;
  }
  if (c == EOF) return false;
  do {
    tok.push_back((char)c);
  } while ((c = f.get()) != EOF && !isspace(c));
  return true;
}

// Decode a P5/P6 file into an 8-bit grayscale buffer.  Returns 0 on success,
// -1 IO error, -2 bad magic, -3 buffer too small.  h/w outputs.
int wb_load_pnm_gray(const char* path, uint8_t* buf, int64_t cap,
                     int* h_out, int* w_out) {
  std::ifstream f(path, std::ios::binary);
  if (!f.is_open()) return -1;
  std::string tok;
  if (!read_pnm_token(f, tok)) return -2;
  bool color;
  if (tok == "P5") color = false;
  else if (tok == "P6") color = true;
  else return -2;
  if (!read_pnm_token(f, tok)) return -2;
  int w = atoi(tok.c_str());
  if (!read_pnm_token(f, tok)) return -2;
  int h = atoi(tok.c_str());
  if (!read_pnm_token(f, tok)) return -2;
  int maxval = atoi(tok.c_str());
  if (w <= 0 || h <= 0 || maxval <= 0 || maxval > 255) return -2;
  int64_t n = (int64_t)w * h;
  if (n > cap) return -3;
  if (!color) {
    f.read((char*)buf, n);
    if (f.gcount() != n) return -1;
  } else {
    std::vector<uint8_t> rgb(n * 3);
    f.read((char*)rgb.data(), n * 3);
    if (f.gcount() != n * 3) return -1;
    for (int64_t i = 0; i < n; i++) {
      // integer luma approximation (BT.601): (77 R + 150 G + 29 B) >> 8
      buf[i] = (uint8_t)((77 * rgb[i * 3] + 150 * rgb[i * 3 + 1] +
                          29 * rgb[i * 3 + 2]) >> 8);
    }
  }
  *h_out = h;
  *w_out = w;
  return 0;
}

// ---------------------------------------------------------------------------
// Multi-threaded prefetching loader.
// ---------------------------------------------------------------------------

struct Item {
  int64_t index;           // position in the path list
  int status;              // 0 ok, <0 error code from decode
  int h, w;
  std::vector<uint8_t> pixels;
  std::vector<float> rects;   // XYXY
  std::vector<int> ignore;
};

struct Prefetcher {
  std::vector<std::string> img_paths;
  std::vector<std::string> ann_paths;  // may be empty
  size_t queue_cap;
  bool loop;

  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::queue<Item*> ready;
  std::atomic<int64_t> next_index{0};
  std::atomic<bool> stop{false};
  int64_t total_emitted = 0;  // guarded by mu (epoch accounting when !loop)

  void worker() {
    const int64_t N = (int64_t)img_paths.size();
    while (!stop.load()) {
      int64_t i = next_index.fetch_add(1);
      if (!loop && i >= N) break;
      int64_t idx = i % N;
      Item* it = new Item();
      it->index = idx;
      it->pixels.resize(1 << 24);  // 16MB cap (4Kx4K)
      int h = 0, w = 0;
      it->status = wb_load_pnm_gray(img_paths[idx].c_str(), it->pixels.data(),
                                    (int64_t)it->pixels.size(), &h, &w);
      it->h = h;
      it->w = w;
      if (it->status == 0) it->pixels.resize((size_t)h * w);
      if (idx < (int64_t)ann_paths.size() && !ann_paths[idx].empty()) {
        it->rects.resize(4 * 4096);
        it->ignore.resize(4096);
        int nb = wb_bbgt_parse_file(ann_paths[idx].c_str(), it->rects.data(),
                                    it->ignore.data(), 4096);
        if (nb < 0) nb = 0;
        it->rects.resize((size_t)nb * 4);
        it->ignore.resize((size_t)nb);
      }
      std::unique_lock<std::mutex> lk(mu);
      cv_push.wait(lk, [&] { return ready.size() < queue_cap || stop.load(); });
      if (stop.load()) { delete it; break; }
      ready.push(it);
      cv_pop.notify_one();
    }
  }
};

void* wb_prefetcher_create(const char** img_paths, const char** ann_paths,
                           int64_t n, int n_threads, int queue_cap, int loop) {
  auto* p = new Prefetcher();
  p->img_paths.reserve(n);
  for (int64_t i = 0; i < n; i++) p->img_paths.emplace_back(img_paths[i]);
  if (ann_paths) {
    p->ann_paths.reserve(n);
    for (int64_t i = 0; i < n; i++)
      p->ann_paths.emplace_back(ann_paths[i] ? ann_paths[i] : "");
  }
  p->queue_cap = queue_cap > 0 ? queue_cap : 8;
  p->loop = loop != 0;
  int nt = n_threads > 0 ? n_threads : 4;
  for (int t = 0; t < nt; t++)
    p->workers.emplace_back([p] { p->worker(); });
  return p;
}

// Pop the next decoded item.  Returns 0 ok; 1 end-of-data (finite, drained);
// <0 decode error (item consumed).  Blocks until an item is ready.
int wb_prefetcher_next(void* handle, uint8_t* img_buf, int64_t img_cap,
                       int* h_out, int* w_out,
                       float* rects_buf, int rects_cap, int* n_rects_out,
                       int* ignore_buf, int64_t* index_out) {
  auto* p = (Prefetcher*)handle;
  Item* it = nullptr;
  {
    std::unique_lock<std::mutex> lk(p->mu);
    const int64_t N = (int64_t)p->img_paths.size();
    while (true) {
      if (!p->ready.empty()) {
        it = p->ready.front();
        p->ready.pop();
        p->cv_push.notify_one();
        if (!p->loop) p->total_emitted++;
        break;
      }
      if (!p->loop && p->total_emitted >= N) return 1;
      // workers may all have exited after claiming the tail indices
      p->cv_pop.wait_for(lk, std::chrono::milliseconds(50));
      if (p->stop.load()) return 1;
    }
  }
  int status = it->status;
  if (status == 0) {
    int64_t n = (int64_t)it->h * it->w;
    if (n > img_cap) status = -3;
    else {
      memcpy(img_buf, it->pixels.data(), n);
      *h_out = it->h;
      *w_out = it->w;
    }
  }
  int nb = (int)(it->ignore.size());
  if (nb > rects_cap) nb = rects_cap;
  if (rects_buf && nb > 0) {
    memcpy(rects_buf, it->rects.data(), (size_t)nb * 4 * sizeof(float));
    memcpy(ignore_buf, it->ignore.data(), (size_t)nb * sizeof(int));
  }
  *n_rects_out = nb;
  *index_out = it->index;
  delete it;
  return status;
}

void wb_prefetcher_destroy(void* handle) {
  auto* p = (Prefetcher*)handle;
  p->stop.store(true);
  p->cv_push.notify_all();
  p->cv_pop.notify_all();
  for (auto& t : p->workers) t.join();
  while (!p->ready.empty()) {
    delete p->ready.front();
    p->ready.pop();
  }
  delete p;
}

}  // extern "C"
