// COCO mask runtime: RLE codec + batched mask IoU (plain C ABI, ctypes).
//
// Counterpart of pycocotools' C `maskApi.c`, which the reference stack
// depends on for every det/segm evaluation (mmdet `encode_mask_results`,
// COCOeval `computeIoU`). The python fallback in
// `vitadapter/data/coco.py` stays as the reference implementation.
//
// Encoding is the COCO compressed format: column-major run lengths,
// difference-coded from the run two places back, LEB128-style base-32
// varints in chars '0'+ (6 bits per char: 5 payload + 1 continuation).

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Binary (h, w) row-major mask -> compressed counts string.
// `out` must hold >= 6 * (h * w + 2) chars; returns length via out_len.
void rle_encode_mask(const uint8_t* mask, int h, int w,
                     char* out, int* out_len) {
  // column-major run lengths, first run counts zeros
  std::vector<long> runs;
  runs.reserve(256);
  long run = 0;
  uint8_t val = 0;
  for (int x = 0; x < w; ++x) {
    const uint8_t* col = mask + x;  // stride w (row-major input)
    for (int y = 0; y < h; ++y) {
      uint8_t v = col[(size_t)y * w] != 0;
      if (v == val) {
        ++run;
      } else {
        runs.push_back(run);
        run = 1;
        val = v;
      }
    }
  }
  runs.push_back(run);
  int n = 0;
  for (size_t i = 0; i < runs.size(); ++i) {
    long x = runs[i];
    if (i > 2) x -= runs[i - 2];
    bool more = true;
    while (more) {
      int c = x & 0x1F;
      x >>= 5;
      more = !((x == 0 && !(c & 0x10)) || (x == -1 && (c & 0x10)));
      if (more) c |= 0x20;
      out[n++] = (char)(c + 48);
    }
  }
  *out_len = n;
}

// Compressed counts string -> binary (h, w) row-major mask.
void rle_decode_mask(const char* s, int slen, int h, int w, uint8_t* out) {
  std::vector<long> runs;
  runs.reserve(256);
  int i = 0;
  while (i < slen) {
    long x = 0;
    int k = 0;
    bool more = true;
    while (more && i < slen) {
      int c = s[i] - 48;
      x |= (long)(c & 0x1F) << (5 * k);
      more = (c & 0x20) != 0;
      ++i;
      ++k;
    }
    if (x & (1L << (5 * k - 1))) x |= -1L << (5 * k);
    if (runs.size() > 2) x += runs[runs.size() - 2];
    runs.push_back(x);
  }
  std::memset(out, 0, (size_t)h * w);
  long pos = 0;
  uint8_t val = 0;
  for (long r : runs) {
    if (val) {
      for (long p = pos; p < pos + r; ++p) {
        long x = p / h, y = p % h;         // column-major position
        out[y * (long)w + x] = 1;
      }
    }
    pos += r;
    val ^= 1;
  }
}

// Pairwise IoU between D det masks and G gt masks, each (hw,) uint8
// row-major flattened. iscrowd (G,) switches gt columns to
// intersection-over-det-area (the COCO crowd rule). Bit-packs each mask
// once, then AND+popcount per pair: ~64 pixels per instruction.
void mask_iou_batch(const uint8_t* dets, int D, const uint8_t* gts, int G,
                    long hw, const uint8_t* iscrowd, double* iou_out) {
  const long words = (hw + 63) / 64;
  std::vector<uint64_t> dp((size_t)D * words, 0), gp((size_t)G * words, 0);
  std::vector<long> darea(D, 0), garea(G, 0);
  for (int d = 0; d < D; ++d) {
    uint64_t* row = dp.data() + (size_t)d * words;
    const uint8_t* m = dets + (size_t)d * hw;
    for (long p = 0; p < hw; ++p)
      if (m[p]) { row[p >> 6] |= 1ULL << (p & 63); ++darea[d]; }
  }
  for (int g = 0; g < G; ++g) {
    uint64_t* row = gp.data() + (size_t)g * words;
    const uint8_t* m = gts + (size_t)g * hw;
    for (long p = 0; p < hw; ++p)
      if (m[p]) { row[p >> 6] |= 1ULL << (p & 63); ++garea[g]; }
  }
  for (int d = 0; d < D; ++d) {
    const uint64_t* a = dp.data() + (size_t)d * words;
    for (int g = 0; g < G; ++g) {
      const uint64_t* b = gp.data() + (size_t)g * words;
      long inter = 0;
      for (long k = 0; k < words; ++k)
        inter += __builtin_popcountll(a[k] & b[k]);
      double denom = iscrowd && iscrowd[g]
                         ? (double)darea[d]
                         : (double)(darea[d] + garea[g] - inter);
      iou_out[(size_t)d * G + g] = denom > 0 ? inter / denom : 0.0;
    }
  }
}

}  // extern "C"
