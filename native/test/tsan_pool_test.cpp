// TSAN harness for the native ingest worker pool (SURVEY.md §5: "host-side
// C++ gets TSAN in CI").  Exercises the public C ABI — concurrent
// tsfm_load_batch calls with overlapping output buffers per image slot,
// concurrent tsfm_exif / tsfm_image_info — under ThreadSanitizer.  Build +
// run via ci.sh nightly.
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

extern "C" {
int tsfm_image_info(const char* path, int* w, int* h, int* c);
int tsfm_load_batch(const char** paths, int n, int w, int h, float* out_gray,
                    uint8_t* out_rgb, int* status, int n_threads);
int tsfm_exif(const char* path, double* focal_mm, double* focal35, double* lat,
              double* lon, double* alt, char* make, int make_cap, char* model,
              int model_cap);
}

// Write a tiny valid binary PPM (decoder handles PNM).
static std::string write_ppm(const char* dir, int k, int w, int h) {
  std::string path = std::string(dir) + "/t" + std::to_string(k) + ".ppm";
  FILE* f = fopen(path.c_str(), "wb");
  fprintf(f, "P6\n%d %d\n255\n", w, h);
  std::vector<uint8_t> px(size_t(w) * h * 3);
  for (size_t i = 0; i < px.size(); ++i) px[i] = uint8_t((i * 37 + k) & 0xff);
  fwrite(px.data(), 1, px.size(), f);
  fclose(f);
  return path;
}

int main() {
  const char* dir = getenv("TMPDIR") ? getenv("TMPDIR") : "/tmp";
  const int N = 64, W = 96, H = 64;
  std::vector<std::string> paths;
  for (int k = 0; k < N; ++k) paths.push_back(write_ppm(dir, k, W, H));
  std::vector<const char*> cpaths;
  for (auto& p : paths) cpaths.push_back(p.c_str());

  // 1. One big batch with the internal pool maxed out.
  std::vector<float> gray(size_t(N) * W * H);
  std::vector<uint8_t> rgb(size_t(N) * W * H * 3);
  std::vector<int> status(N);
  int ok = tsfm_load_batch(cpaths.data(), N, W, H, gray.data(), rgb.data(),
                           status.data(), 16);
  if (ok != N) { fprintf(stderr, "batch failed: %d/%d\n", ok, N); return 1; }

  // 2. Concurrent independent batches + info/exif calls from caller threads
  //    (the Python side may issue these from multiple threads).
  std::atomic<int> fails{0};
  std::vector<std::thread> ts;
  for (int t = 0; t < 8; ++t) {
    ts.emplace_back([&, t] {
      std::vector<float> g(size_t(N) * W * H);
      std::vector<int> st(N);
      if (tsfm_load_batch(cpaths.data(), N, W, H, g.data(), nullptr,
                          st.data(), 4) != N)
        fails.fetch_add(1);
      int w, h, c;
      if (!tsfm_image_info(cpaths[t % N], &w, &h, &c) || w != W)
        fails.fetch_add(1);
      double fm, f35, la, lo, al;
      char mk[64], md[64];
      tsfm_exif(cpaths[t % N], &fm, &f35, &la, &lo, &al, mk, 64, md, 64);
    });
  }
  for (auto& th : ts) th.join();
  for (auto& p : paths) remove(p.c_str());
  if (fails.load()) { fprintf(stderr, "%d failures\n", fails.load()); return 1; }
  printf("tsan pool test OK\n");
  return 0;
}
