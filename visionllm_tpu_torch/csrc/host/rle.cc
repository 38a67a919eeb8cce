// COCO-compressed RLE codec (column-major binary masks).
//
// Native equivalent of the mask codecs the reference gets from
// pycocotools / crowdpose-api (crowdpose-api/common/maskApi.c provides
// the same wire format; this is a fresh implementation from the format
// spec: runs of 0s/1s in column-major order; each count delta-encoded
// against count[i-2] and serialized as little-endian 5-bit groups with
// a continuation bit, offset by '0' (ASCII 48)).
//
// Build: g++ -O3 -shared -fPIC rle.cc -o librle.so
// (compiled at first use by visionllm_tpu_torch/kernels/host_build.py).

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Decode RLE string -> row-major uint8 mask [h, w]. Returns 0 on success.
int rle_decode(const char* s, int64_t h, int64_t w, uint8_t* out) {
  std::vector<int64_t> cnts;
  int64_t m = 0;
  for (int64_t p = 0; s[p];) {
    int64_t x = 0;
    int k = 0;
    bool more = true;
    while (more) {
      char c = s[p] - 48;
      if (s[p] == 0) return 1;  // truncated
      x |= (int64_t)(c & 0x1f) << (5 * k);
      more = (c & 0x20) != 0;
      p++;
      k++;
      if (!more && (c & 0x10)) x |= -1LL << (5 * k);
    }
    if (m > 2) x += cnts[m - 2];
    cnts.push_back(x);
    m++;
  }
  // runs are column-major; emit into row-major out
  int64_t pos = 0;
  uint8_t val = 0;
  for (int64_t i = 0; i < m; i++) {
    for (int64_t j = 0; j < cnts[i]; j++) {
      if (pos >= h * w) return 2;  // overflow
      int64_t col = pos / h, row = pos % h;
      out[row * w + col] = val;
      pos++;
    }
    val = 1 - val;
  }
  return pos == h * w ? 0 : 3;
}

// Encode row-major uint8 mask [h, w] -> RLE string into `out`
// (caller-allocated, cap bytes incl. NUL). Returns string length,
// or -1 if cap too small.
int64_t rle_encode(const uint8_t* mask, int64_t h, int64_t w, char* out,
                   int64_t cap) {
  // column-major run lengths
  std::vector<int64_t> cnts;
  int64_t run = 0;
  uint8_t cur = 0;
  for (int64_t col = 0; col < w; col++) {
    for (int64_t row = 0; row < h; row++) {
      uint8_t v = mask[row * w + col] ? 1 : 0;
      if (v == cur) {
        run++;
      } else {
        cnts.push_back(run);
        run = 1;
        cur = v;
      }
    }
  }
  cnts.push_back(run);

  int64_t p = 0;
  int64_t m = (int64_t)cnts.size();
  for (int64_t i = 0; i < m; i++) {
    int64_t x = cnts[i];
    if (i > 2) x -= cnts[i - 2];
    bool more = true;
    while (more) {
      char c = x & 0x1f;
      x >>= 5;
      more = (c & 0x10) ? x != -1 : x != 0;
      if (more) c |= 0x20;
      c += 48;
      if (p + 1 >= cap) return -1;
      out[p++] = c;
    }
  }
  out[p] = 0;
  return p;
}

// Area of an RLE (sum of 1-runs).
int64_t rle_area(const char* s) {
  int64_t area = 0, m = 0;
  std::vector<int64_t> cnts;
  for (int64_t p = 0; s[p];) {
    int64_t x = 0;
    int k = 0;
    bool more = true;
    while (more) {
      char c = s[p] - 48;
      x |= (int64_t)(c & 0x1f) << (5 * k);
      more = (c & 0x20) != 0;
      p++;
      k++;
      if (!more && (c & 0x10)) x |= -1LL << (5 * k);
    }
    if (m > 2) x += cnts[m - 2];
    cnts.push_back(x);
    if (m % 2 == 1) area += cnts[m];
    m++;
  }
  return area;
}

}  // extern "C"
