// The byte-stream decoders of the image readers in coma_tpu_torch/utils/:
// GIF's and TIFF's LZW, TIFF's PackBits and TGA's run-length packets. Each
// equals its plain Python twin byte for byte (utils/gif_reader.py:
// lzw_decode_python, utils/tiff.py: lzw_decode_python and
// packbits_decode_python, utils/tga.py: rle_decode_python); these exist
// because a 2048 x 1536 file takes seconds in Python.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 image_codecs.cpp (native/__init__.py
// does it at first use).

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// LZW of GIF (``tiff`` 0: codes least-significant bit first, the width
// grows when the next code reaches 2^width) or TIFF (``tiff`` 1: most
// significant bit first, the width grows one code earlier). ``min_code_size``
// is GIF's initial code size (8 for TIFF). Writes at most ``cap`` bytes to
// ``out``; returns the count written, stopping at the end code, at the end
// of the data, or (-1) at a code that is neither in the table nor the next
// one.
int64_t lzw_decode(const uint8_t* data, int64_t n, int min_code_size, int tiff, uint8_t* out,
                   int64_t cap) {
  const int clear = 1 << min_code_size, end = clear + 1;
  std::vector<int32_t> prefix(4096, -1);
  std::vector<uint8_t> suffix(4096, 0), first(4096, 0);
  std::vector<int32_t> length(4096, 0);
  for (int i = 0; i < clear; ++i) {
    suffix[i] = first[i] = static_cast<uint8_t>(i);
    length[i] = 1;
  }
  int width = min_code_size + 1, next = end + 1, prev = -1;
  int64_t written = 0, bitpos = 0, total_bits = n * 8;
  const int early = tiff ? 1 : 0;
  while (bitpos + width <= total_bits) {
    uint32_t code = 0;
    if (tiff) {
      for (int b = 0; b < width; ++b, ++bitpos)
        code = (code << 1) | ((data[bitpos >> 3] >> (7 - (bitpos & 7))) & 1);
    } else {
      for (int b = 0; b < width; ++b, ++bitpos)
        code |= static_cast<uint32_t>((data[bitpos >> 3] >> (bitpos & 7)) & 1) << b;
    }
    if (static_cast<int>(code) == clear) {
      width = min_code_size + 1;
      next = end + 1;
      prev = -1;
      continue;
    }
    if (static_cast<int>(code) == end) break;
    int c = static_cast<int>(code);
    if (prev < 0) {
      if (c >= clear) return -1;
      if (written < cap) out[written] = static_cast<uint8_t>(c);
      ++written;
      prev = c;
      continue;
    }
    int entry;
    uint8_t head;
    if (c < next) {
      entry = c;
      head = first[c];
    } else if (c == next) {
      entry = -1;
      head = first[prev];
    } else {
      return -1;
    }
    if (next < 4096) {
      prefix[next] = prev;
      suffix[next] = head;
      first[next] = first[prev];
      length[next] = length[prev] + 1;
      if (entry < 0) entry = next;
      ++next;
      if (next + early >= (1 << width) && width < 12) ++width;
    } else if (entry < 0) {
      return -1;
    }
    int len = length[entry];
    int64_t at = written + len - 1;
    for (int e = entry; e >= 0 && at >= written; e = prefix[e], --at)
      if (at < cap) out[at] = suffix[e];
    written += len;
    prev = c;
  }
  return written < cap ? written : cap;
}

// PackBits (TIFF compression 32773) of ``n`` bytes into at most ``cap``;
// returns the count written.
int64_t packbits_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t cap) {
  int64_t pos = 0, written = 0;
  while (pos < n && written < cap) {
    int h = static_cast<int8_t>(data[pos++]);
    if (h >= 0) {
      int64_t count = h + 1;
      for (int64_t i = 0; i < count && pos < n && written < cap; ++i) out[written++] = data[pos++];
    } else if (h != -128) {
      if (pos >= n) break;
      uint8_t v = data[pos++];
      for (int i = 0; i < 1 - h && written < cap; ++i) out[written++] = v;
    }
  }
  return written;
}

// PackBits as PIL's decoder reads it (a Photoshop file's channels): rows of
// ``row`` bytes, a packet that crosses a row's end cut there, 0x80 a no-op,
// from ``data[pos:]`` until ``rows`` rows are full. Returns 0, or 1 when the
// data ends first.
int packbits_rows_decode(const uint8_t* data, int64_t n, int64_t pos, int64_t row, int64_t rows,
                         uint8_t* out) {
  int64_t x = 0, y = 0;
  while (y < rows) {
    if (pos >= n) return 1;
    int h = data[pos];
    int64_t count, take;
    if (h & 0x80) {
      if (h == 0x80) {
        ++pos;
        continue;
      }
      if (pos + 2 > n) return 1;
      count = 257 - h;
      take = count < row - x ? count : row - x;
      std::memset(out + y * row + x, data[pos + 1], take);
      pos += 2;
    } else {
      count = h + 1;
      if (pos + 1 + count > n) return 1;
      take = count < row - x ? count : row - x;
      std::memcpy(out + y * row + x, data + pos + 1, take);
      pos += 1 + count;
    }
    x += take;
    if (x >= row) {
      x = 0;
      ++y;
    }
  }
  return 0;
}

// TGA run-length packets from ``data[pos:]`` until ``rows`` rows of
// ``row_bytes`` are full (pixels of ``pixel_bytes``). Returns 0, 1 when the
// data ends first, 2 when a run crosses the end of a row.
int tga_rle_decode(const uint8_t* data, int64_t n, int64_t pos, int64_t row_bytes, int64_t rows,
                   int pixel_bytes, uint8_t* out) {
  const int64_t want = row_bytes * rows;
  int64_t written = 0;
  while (written < want) {
    if (pos >= n) return 1;
    int head = data[pos];
    int64_t count = static_cast<int64_t>(pixel_bytes) * ((head & 0x7F) + 1);
    if (head & 0x80) {
      if (pos + 1 + pixel_bytes > n) return 1;
      if (written % row_bytes + count > row_bytes) return 2;
      for (int64_t i = 0; i < count; ++i) out[written + i] = data[pos + 1 + i % pixel_bytes];
      written += count;
      pos += 1 + pixel_bytes;
    } else {
      if (pos + 1 + count > n) return 1;
      int64_t take = count < want - written ? count : want - written;
      std::memcpy(out + written, data + pos + 1, take);
      written += take;
      pos += 1 + count;
    }
  }
  return 0;
}

}  // extern "C"
