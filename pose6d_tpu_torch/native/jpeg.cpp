// Huffman entropy decoding of one baseline (sequential, 8-bit) JPEG scan,
// the part of data/jpeg.py that is a bit-serial loop. Exposed through a
// C ABI loaded with ctypes; built with g++ at first use by
// pose6d_tpu_torch/native/__init__.py.
//
// The caller parses the markers (tables, frame, scan header) and hands
// over the entropy-coded bytes that follow SOS, the scan's Huffman
// tables as (counts per code length 1..16, symbols) and, per component
// of the scan, where its quantized coefficients go: a grid of 8 x 8
// blocks, 64 int16 values each in natural (row-major) order. Decoding
// follows ITU-T T.81 F.2.2: DC differences from a running predictor,
// AC run/size codes with EOB and ZRL, byte stuffing (FF 00) removed,
// and at every restart interval the bit buffer dropped, an RSTn marker
// consumed and the predictors reset. A marker in the data ends the scan;
// past it the reader feeds zero bits, as libjpeg does.
#include <cstdint>
#include <cstring>

namespace {

constexpr int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// Canonical Huffman decoding tables (T.81 F.2.2.3): for each code
// length l, the largest code of that length (-1 if none) and the index
// of its first symbol.
struct Huffman {
  int32_t maxcode[18];
  int32_t valptr[17];
  int32_t mincode[17];
  const uint8_t* vals;

  bool build(const uint8_t* counts, const uint8_t* symbols) {
    vals = symbols;
    int32_t code = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      valptr[l] = k;
      mincode[l] = code;
      code += counts[l - 1];
      k += counts[l - 1];
      if (code > (1 << l)) return false;    // an over-full length
      maxcode[l] = counts[l - 1] ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    return k <= 256;
  }
};

struct BitReader {
  const uint8_t* data;
  int64_t len, pos = 0;
  uint32_t buf = 0;
  int bits = 0;
  bool marker = false;     // a marker was reached: feed zeros from here

  void fill() {
    while (bits <= 24) {
      uint32_t byte = 0;
      if (!marker && pos < len) {
        byte = data[pos];
        if (byte == 0xFF) {
          const uint8_t next = pos + 1 < len ? data[pos + 1] : 0xD9;
          if (next == 0x00) {
            pos += 2;
          } else {
            marker = true;   // leave pos on the marker
            byte = 0;
          }
        } else {
          ++pos;
        }
      }
      buf |= byte << (24 - bits);
      bits += 8;
    }
  }

  int get(int n) {          // n <= 16 bits, MSB first
    if (n == 0) return 0;
    if (bits < n) fill();
    const int v = static_cast<int>(buf >> (32 - n));
    buf <<= n;
    bits -= n;
    return v;
  }

  int decode(const Huffman& h) {
    int code = get(1), l = 1;
    while (code > h.maxcode[l]) {
      if (++l > 16) return -1;   // no such code: corrupt data
      code = (code << 1) | get(1);
    }
    return h.vals[h.valptr[l] + code - h.mincode[l]];
  }

  // The next RSTn marker: drop the buffered bits (and any padding
  // before the marker), consume the marker; false if none follows.
  bool restart() {
    buf = 0;
    bits = 0;
    marker = false;
    while (pos + 1 < len && !(data[pos] == 0xFF && data[pos + 1] != 0x00))
      ++pos;
    if (pos + 1 >= len || data[pos + 1] < 0xD0 || data[pos + 1] > 0xD7)
      return false;
    pos += 2;
    return true;
  }
};

inline int extend(int v, int s) {   // T.81 F.2.2.1 EXTEND
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

bool decode_block(BitReader& br, const Huffman& dc, const Huffman& ac,
                  int& pred, int16_t* out) {
  const int s = br.decode(dc);
  if (s < 0 || s > 11) return false;
  pred += s ? extend(br.get(s), s) : 0;
  out[0] = static_cast<int16_t>(pred);
  for (int k = 1; k < 64;) {
    const int rs = br.decode(ac);
    if (rs < 0) return false;
    const int r = rs >> 4, sz = rs & 15;
    if (sz == 0) {
      if (r != 15) break;      // EOB
      k += 16;                 // ZRL
      continue;
    }
    k += r;
    if (k > 63) return false;
    out[kZigzag[k]] = static_cast<int16_t>(extend(br.get(sz), sz));
    ++k;
  }
  return true;
}

}  // namespace

// Decodes one scan of `ns` components. huff_counts (8, 16) and
// huff_symbols (8, 256): tables 0-3 DC, 4-7 AC. Per scan component c:
// coefs[c] -> its (blocks_y, blocks_x, 64) int16 grid (zeroed by the
// caller), blocks_x[c] its row stride in blocks, h[c] x v[c] blocks per
// MCU, dc[c] / ac[c] table slots (0-3), and for a one-component scan
// nbx[c] x nby[c] blocks to decode (its own extent, not the MCU grid's).
// mcux x mcuy MCUs for an interleaved scan. Returns the number of bytes
// of `data` the scan took (the caller's parser resumes there), or a
// negative error: -1 bad table, -2 corrupt data, -3 missing restart.
extern "C" int64_t jpeg_decode_scan(
    const uint8_t* data, int64_t len, int ns, int16_t** coefs,
    const int32_t* blocks_x, const int32_t* h, const int32_t* v,
    const int32_t* dc, const int32_t* ac, const int32_t* nbx,
    const int32_t* nby, const uint8_t* huff_counts,
    const uint8_t* huff_symbols, int32_t mcux, int32_t mcuy,
    int32_t restart_interval) {
  Huffman tables[8];
  for (int t = 0; t < 8; ++t)
    if (!tables[t].build(huff_counts + 16 * t, huff_symbols + 256 * t))
      return -1;
  BitReader br{data, len};
  int pred[4] = {0, 0, 0, 0};
  const bool single = ns == 1;
  const int64_t units = single ? (int64_t)nbx[0] * nby[0]
                               : (int64_t)mcux * mcuy;
  for (int64_t u = 0; u < units; ++u) {
    if (restart_interval > 0 && u > 0 && u % restart_interval == 0) {
      if (!br.restart()) return -3;
      for (int c = 0; c < 4; ++c) pred[c] = 0;
    }
    if (single) {
      const int64_t bx = u % nbx[0], by = u / nbx[0];
      int16_t* out = coefs[0] + (by * blocks_x[0] + bx) * 64;
      if (!decode_block(br, tables[dc[0]], tables[4 + ac[0]], pred[0], out))
        return -2;
      continue;
    }
    const int64_t mx = u % mcux, my = u / mcux;
    for (int c = 0; c < ns; ++c) {
      for (int yy = 0; yy < v[c]; ++yy) {
        for (int xx = 0; xx < h[c]; ++xx) {
          const int64_t bx = mx * h[c] + xx, by = my * v[c] + yy;
          int16_t* out = coefs[c] + (by * blocks_x[c] + bx) * 64;
          if (!decode_block(br, tables[dc[c]], tables[4 + ac[c]], pred[c],
                            out))
            return -2;
        }
      }
    }
  }
  // the scan's bytes end at the marker after its last unit
  while (br.pos + 1 < len && !(data[br.pos] == 0xFF &&
                               data[br.pos + 1] != 0x00))
    ++br.pos;
  return br.pos;
}
