// Native image writers.
//
// ASCII P3 PPM token-compatible with the reference writer
// (test/RaytraceTest.cpp:277-287: "P3\n<w> <h>\n255\n" then
// space-separated triplets, one pixel row per line), plus binary P6 for speed.
// The gamma/quirk transforms happen in Python (render/image.py); this layer
// only serializes bytes. C ABI for ctypes.

#include <cstdint>
#include <cstdio>

extern "C" {

// rgb: h*w*3 bytes, row-major. Returns 0 on success.
int oclpt_write_ppm(const char* path, const uint8_t* rgb, int w, int h) {
  FILE* f = fopen(path, "w");
  if (!f) return 1;
  fprintf(f, "P3\n%d %d\n255\n", w, h);
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = rgb + size_t(y) * w * 3;
    for (int x = 0; x < w; ++x) {
      fprintf(f, "%d %d %d ", row[x * 3], row[x * 3 + 1], row[x * 3 + 2]);
    }
    fputc('\n', f);
  }
  fclose(f);
  return 0;
}

int oclpt_write_ppm6(const char* path, const uint8_t* rgb, int w, int h) {
  FILE* f = fopen(path, "wb");
  if (!f) return 1;
  fprintf(f, "P6\n%d %d\n255\n", w, h);
  size_t n = size_t(w) * h * 3;
  size_t written = fwrite(rgb, 1, n, f);
  fclose(f);
  return written == n ? 0 : 1;
}

}  // extern "C"
