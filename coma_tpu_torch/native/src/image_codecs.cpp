// The byte-stream decoders of the image readers in coma_tpu_torch/utils/:
// GIF's and TIFF's LZW, TIFF's PackBits, TGA's, SGI's, PCX's, ICNS's, Sun
// raster's and MSP's run-length codes, QOI's opcodes, Little CMS's
// tetrahedral interpolation of Lab pixels (utils/lcms.py), FLI/FLC's frame
// chunks and the gathering of sub-byte TIFF tiles. Each equals its plain
// Python twin byte for byte (utils/gif_reader.py: lzw_decode_python,
// utils/tiff.py: lzw_decode_python, packbits_decode_python and
// tile_bits_gather_python, utils/tga.py, sgi.py, pcx.py, icns.py, sun.py,
// msp.py: rle_decode_python, utils/qoi.py: decode_ops_python, utils/fli.py:
// frame_decode_python); these exist because a 2048 x 1536 file takes
// seconds in Python.
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
// ``out``; returns the count written, stopping at ``cap`` bytes, at an end
// code that ends in byte ``end_from`` or later (one before it is passed over,
// as Pillow's GIF decoder passes over one while more of the file is to come),
// at the end of the data, or (-1) at a code that is neither in the table nor
// the next one.
int64_t lzw_decode(const uint8_t* data, int64_t n, int min_code_size, int tiff, uint8_t* out,
                   int64_t cap, int64_t end_from) {
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
  while (bitpos + width <= total_bits && written < cap) {
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
    if (static_cast<int>(code) == end) {
      if ((bitpos - 1) >> 3 < end_from) continue;
      break;
    }
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
      // TIFF grows a code early; GIF (GifDecode.c) when the table reaches 2^width exactly
      if ((tiff ? next + early >= (1 << width) : next == (1 << width)) && width < 12) ++width;
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

// PackBits (TIFF compression 32773, as libtiff decodes it) of ``n`` bytes into
// at most ``cap``; returns the count written.
int64_t packbits_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t cap) {
  int64_t pos = 0, written = 0;
  while (pos < n && written < cap) {
    int h = static_cast<int8_t>(data[pos++]);
    if (h >= 0) {
      // libtiff's PackBitsDecode: a literal run (cut to the room left) the data
      // cannot fill ends the decoding, none of it copied
      int64_t count = h + 1 < cap - written ? h + 1 : cap - written;
      if (n - pos < count) break;
      for (int64_t i = 0; i < count; ++i) out[written++] = data[pos++];
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

// QOI's opcodes from data[pos:] until ``pixels`` pixels of ``channels``
// bytes are out (QoiImagePlugin.QoiDecoder). Returns 0, or 1 when the
// data ends first.
int qoi_decode(const uint8_t* data, int64_t n, int64_t pos, int64_t pixels, int channels,
               uint8_t* out) {
  uint8_t seen[64][4];
  bool filled[64] = {false};
  uint8_t prev[4] = {0, 0, 0, 255};
  const int64_t want = pixels * channels;
  int64_t written = 0;
  while (written < want) {
    if (pos >= n) return 1;
    const int byte = data[pos++];
    uint8_t value[4];
    if (byte == 0xFE) {
      if (pos + 3 > n) return 1;
      value[0] = data[pos];
      value[1] = data[pos + 1];
      value[2] = data[pos + 2];
      value[3] = prev[3];
      pos += 3;
    } else if (byte == 0xFF) {
      if (pos + 4 > n) return 1;
      std::memcpy(value, data + pos, 4);
      pos += 4;
    } else if ((byte >> 6) == 0) {
      if (filled[byte]) {
        std::memcpy(value, seen[byte], 4);
      } else {
        std::memset(value, 0, 4);
      }
    } else if ((byte >> 6) == 1) {
      value[0] = static_cast<uint8_t>(prev[0] + ((byte >> 4) & 3) - 2);
      value[1] = static_cast<uint8_t>(prev[1] + ((byte >> 2) & 3) - 2);
      value[2] = static_cast<uint8_t>(prev[2] + (byte & 3) - 2);
      value[3] = prev[3];
    } else if ((byte >> 6) == 2) {
      if (pos >= n) return 1;
      const int second = data[pos++];
      const int dg = (byte & 0x3F) - 32;
      value[0] = static_cast<uint8_t>(prev[0] + dg + (second >> 4) - 8);
      value[1] = static_cast<uint8_t>(prev[1] + dg);
      value[2] = static_cast<uint8_t>(prev[2] + dg + (second & 15) - 8);
      value[3] = prev[3];
    } else {
      for (int r = 0; r < (byte & 0x3F) + 1; ++r)
        for (int c = 0; c < channels; ++c, ++written)
          if (written < want) out[written] = prev[c];
      continue;
    }
    std::memcpy(prev, value, 4);
    const int slot = (value[0] * 3 + value[1] * 5 + value[2] * 7 + value[3] * 11) % 64;
    std::memcpy(seen[slot], value, 4);
    filled[slot] = true;
    for (int c = 0; c < channels; ++c) out[written++] = value[c];
  }
  return 0;
}

// SGI's run-length rows (SgiRleDecode.c) of the file ``data`` (its 512-byte
// header included): rows in file order, ``width * bands * bpc`` bytes each,
// samples interleaved, into ``out`` (zeroed by the caller). Returns 0, 1
// when a table, row or packet runs past the file or a row (PIL's overrun).
int sgi_rle_decode(const uint8_t* data, int64_t n, int64_t width, int64_t height, int bands,
                   int bpc, uint8_t* out) {
  const uint8_t* body = data + 512;
  const int64_t size = n - 512, tablen = static_cast<int64_t>(bands) * height;
  if (size < 8 * tablen) return 1;
  auto be32 = [&](int64_t at) {
    return static_cast<int64_t>(static_cast<uint32_t>(body[at]) << 24 | body[at + 1] << 16 |
                                body[at + 2] << 8 | body[at + 3]);
  };
  const int64_t row_bytes = width * bands * bpc, last = size - 1;
  std::vector<uint8_t> row(row_bytes, 0);
  for (int64_t y = 0; y < height; ++y) {
    for (int c = 0; c < bands; ++c) {
      const int64_t start = be32(4 * (y + c * height));
      // PIL passes the length on as an int: 2^31 and up is negative, no packets
      int64_t count_left = static_cast<int32_t>(static_cast<uint32_t>(
          be32(4 * (tablen + y + c * height))));
      if (start < 512) return 1;
      int64_t src = start - 512, x = 0, dest = static_cast<int64_t>(c) * bpc;
      bool stop = false;
      for (; count_left > 0; --count_left) {
        if (src + bpc - 1 > last) return 1;
        const int pixel = body[src + bpc - 1];
        src += bpc;
        if (count_left == 1 && pixel) {
          stop = true;
          break;
        }
        const int count = pixel & 0x7F;
        if (!count) break;
        if (x + count > width) return 1;
        x += count;
        if (pixel & 0x80) {
          if (src + static_cast<int64_t>(bpc) * count > last) return 1;
          for (int k = 0; k < count; ++k, src += bpc, dest += bands * bpc)
            std::memcpy(row.data() + dest, body + src, bpc);
        } else {
          if (src + bpc - 1 > last) return 1;
          for (int k = 0; k < count; ++k, dest += bands * bpc)
            std::memcpy(row.data() + dest, body + src, bpc);
          src += bpc;
        }
      }
      if (stop) return 0;
    }
    std::memcpy(out + y * row_bytes, row.data(), row_bytes);
  }
  return 0;
}

// PCX's run-length rows (PcxDecode.c) from data[pos:]: ``rows`` rows of
// ``row_bytes``, planes 1 to ``bands`` of each row moved from ``stride`` to
// ``size`` bytes apart (utils/pcx.py's _relay; ``bands`` 0 moves nothing).
// Returns 0, 1 when the data ends first, 2 when a run passed a row's end
// (PIL's overrun, raised when the image is done).
int pcx_rle_decode(const uint8_t* data, int64_t n, int64_t pos, int64_t row_bytes, int64_t rows,
                   int64_t bands, int64_t size, int64_t stride, uint8_t* out) {
  std::vector<uint8_t> buf(row_bytes, 0);
  int64_t x = 0, y = 0;
  bool overrun = false;
  while (y < rows) {
    if (pos >= n) return 1;
    const int byte = data[pos];
    if ((byte & 0xC0) == 0xC0) {
      if (pos + 1 >= n) return 1;
      int64_t count = byte & 0x3F;
      if (x + count > row_bytes) {
        overrun = true;
        count = row_bytes - x;
      }
      std::memset(buf.data() + x, data[pos + 1], count);
      x += count;
      pos += 2;
    } else {
      buf[x++] = static_cast<uint8_t>(byte);
      ++pos;
    }
    if (x >= row_bytes) {
      for (int64_t i = 1; i < bands; ++i)
        std::memmove(buf.data() + i * size, buf.data() + i * stride, size);
      std::memcpy(out + y * row_bytes, buf.data(), row_bytes);
      x = 0;
      ++y;
    }
  }
  return overrun ? 2 : 0;
}

// ICNS's run-length channels (IcnsImagePlugin.read_32) from data[pos:]:
// three planes of ``pixels`` bytes. Returns 0, 1 when a channel does not
// come out at exactly ``pixels`` (PIL's "error reading channel"), 2 when
// the data ends inside a packet (not enough image data).
int icns_rle_decode(const uint8_t* data, int64_t n, int64_t pos, int64_t pixels, uint8_t* out) {
  for (int band = 0; band < 3; ++band) {
    uint8_t* plane = out + band * pixels;
    int64_t left = pixels, written = 0;
    bool short_read = false;
    while (left > 0) {
      if (pos >= n) break;
      const int byte = data[pos++];
      int64_t count;
      if (byte & 0x80) {
        count = byte - 125;
        if (pos >= n) {
          short_read = true;
        } else {
          for (int64_t k = 0; k < count && written < pixels; ++k) plane[written++] = data[pos];
        }
        ++pos;
      } else {
        count = byte + 1;
        const int64_t take = pos + count <= n ? count : (n > pos ? n - pos : 0);
        if (take < count) short_read = true;
        for (int64_t k = 0; k < take && written < pixels; ++k) plane[written++] = data[pos + k];
        pos += count;
      }
      left -= count;
    }
    if (left != 0) return 1;
    if (short_read) return 2;
  }
  return 0;
}

// Sun raster's run-length stream (SunRleDecode.c) from data[pos:] until
// ``want`` bytes are out. Returns 0, or 1 when the data ends first.
int sun_rle_decode(const uint8_t* data, int64_t n, int64_t pos, int64_t want, uint8_t* out) {
  int64_t written = 0;
  while (written < want) {
    if (pos >= n) return 1;
    const int byte = data[pos];
    if (byte == 0x80) {
      if (pos + 1 >= n) return 1;
      const int count = data[pos + 1];
      if (count == 0) {
        out[written++] = 0x80;
        pos += 2;
      } else {
        if (pos + 2 >= n) return 1;
        for (int k = 0; k <= count && written < want; ++k) out[written++] = data[pos + 2];
        pos += 3;
      }
    } else {
      out[written++] = static_cast<uint8_t>(byte);
      ++pos;
    }
  }
  return 0;
}

// MSP version 2's rows (MspImagePlugin.MspDecoder): the row map of
// ``height`` words at byte 32, then each row's runs, joined into at most
// ``cap`` bytes of ``out``; a row of count 0 is ``(width + 7) / 8`` bytes of
// 0xFF. Returns the bytes the rows decode to (PIL's stream, which may
// exceed ``cap``), -1 when the map or a row is cut short, -2 when a run's
// count and value are cut short.
int64_t msp_rle_decode(const uint8_t* data, int64_t n, int64_t width, int64_t height,
                       uint8_t* out, int64_t cap) {
  if (32 + 2 * height > n) return -1;
  int64_t pos = 32 + 2 * height, written = 0;
  const int64_t blank = (width + 7) / 8;
  auto put = [&](uint8_t v) {
    if (written < cap) out[written] = v;
    ++written;
  };
  for (int64_t y = 0; y < height; ++y) {
    const int64_t count = data[32 + 2 * y] | data[33 + 2 * y] << 8;
    if (count == 0) {
      for (int64_t k = 0; k < blank; ++k) put(0xFF);
      continue;
    }
    if (pos + count > n) return -1;
    const uint8_t* row = data + pos;
    pos += count;
    int64_t k = 0;
    while (k < count) {
      const int kind = row[k++];
      if (kind == 0) {
        if (k + 2 > count) return -2;
        for (int r = 0; r < row[k]; ++r) put(row[k + 1]);
        k += 2;
      } else {
        for (int r = 0; r < kind && k + r < count; ++r) put(row[k + r]);
        k += kind;
      }
    }
  }
  return written;
}

// Little CMS's TetrahedralInterp16 of 8-bit Lab pixels (each byte widened
// as x * 257, a and b already offset) on a (grid^3, 3) 16-bit CLUT, each
// output narrowed by FROM_16_TO_8: utils/lcms.py, tetra_interp_python.
void lab_tetra_interp(const uint8_t* in, int64_t n, const int32_t* table, int grid,
                      uint8_t* out) {
  const int32_t opta[3] = {3, 3 * grid, 3 * grid * grid};
  for (int64_t p = 0; p < n; ++p) {
    int32_t input[3], rest[3], node[3], step[3];
    for (int k = 0; k < 3; ++k) {
      input[k] = in[3 * p + k] * 257;
      int32_t f = input[k] * (grid - 1);
      f += (f + 0x7FFF) / 0xFFFF;
      node[k] = f >> 16;
      rest[k] = f & 0xFFFF;
      step[k] = input[k] == 0xFFFF ? 0 : opta[2 - k];
    }
    const int32_t* base = table + node[0] * opta[2] + node[1] * opta[1] + node[2] * opta[0];
    const int32_t rx = rest[0], ry = rest[1], rz = rest[2];
    int order[3];
    if (rx >= ry) {
      if (ry >= rz) { order[0] = 0; order[1] = 1; order[2] = 2; }
      else if (rz >= rx) { order[0] = 2; order[1] = 0; order[2] = 1; }
      else { order[0] = 0; order[1] = 2; order[2] = 1; }
    } else {
      if (rx >= rz) { order[0] = 1; order[1] = 0; order[2] = 2; }
      else if (ry >= rz) { order[0] = 1; order[1] = 2; order[2] = 0; }
      else { order[0] = 2; order[1] = 1; order[2] = 0; }
    }
    const int32_t p1 = step[order[0]], p2 = p1 + step[order[1]], p3 = p2 + step[order[2]];
    for (int ch = 0; ch < 3; ++ch) {
      const int32_t c0 = base[ch], c1 = base[p1 + ch], c2 = base[p2 + ch], c3 = base[p3 + ch];
      const int32_t total = (c1 - c0) * rest[order[0]] + (c2 - c1) * rest[order[1]] +
                            (c3 - c2) * rest[order[2]] + 0x8001;
      const uint32_t v = static_cast<uint16_t>(c0 + ((total + (total >> 16)) >> 16));
      out[3 * p + ch] = static_cast<uint8_t>(((v * 65281u + 8388608u) >> 24) & 0xFF);
    }
  }
}

// libImaging's FliDecode.c on buf[0:n] into the zeroed or partly decoded
// (height, width) image ``img``: utils/fli.py, frame_decode_python.
// Returns libImaging's status (-1 at the frame's end, else the bytes
// consumed before it asks for more) and sets *error to its code (0, or
// -1 overrun, -2 broken, -3 unknown).
int64_t fli_decode(const uint8_t* buf, int64_t n, int64_t width, int64_t height, uint8_t* img,
                   int* error) {
  auto i16 = [&](int64_t at) -> int64_t { return buf[at] | buf[at + 1] << 8; };
  auto i32 = [&](int64_t at) -> int64_t {
    return static_cast<int32_t>(static_cast<uint32_t>(buf[at]) | buf[at + 1] << 8 |
                                buf[at + 2] << 16 | static_cast<uint32_t>(buf[at + 3]) << 24);
  };
  *error = 0;
  if (n < 4) return 0;
  if (n + n % 2 < i32(0)) return 0;
  if (n < 8) { *error = -1; return -1; }
  if (i16(4) != 0xF1FA) { *error = -3; return -1; }
  const int64_t chunks = i16(6);
  int64_t ptr = 16, left = n - 16;
  const int64_t end = n;
  for (int64_t c = 0; c < chunks; ++c) {
    if (left < 10) { *error = -1; return -1; }
    int64_t data = ptr + 6;
    const int64_t kind = i16(ptr + 4);
    if (kind == 7) {                                  // SS2, word delta
      const int64_t lines = i16(data);
      data += 2;
      int64_t l = 0, y = 0;
      while (l < lines && y < height) {
        uint8_t* row = img + y * width;
        if (data + 2 > end) { *error = -1; return -1; }
        int64_t packets = i16(data);
        data += 2;
        while (packets & 0x8000) {
          if (packets & 0x4000) {
            y += 65536 - packets;
            if (y >= height) { *error = -1; return -1; }
            row = img + y * width;
          } else {
            row[width - 1] = static_cast<uint8_t>(packets);
          }
          if (data + 2 > end) { *error = -1; return -1; }
          packets = i16(data);
          data += 2;
        }
        int64_t x = 0, p = 0;
        for (; p < packets; ++p) {
          if (data + 2 > end) { *error = -1; return -1; }
          x += buf[data];
          if (buf[data + 1] >= 128) {
            if (data + 4 > end) { *error = -1; return -1; }
            const int64_t i = 256 - buf[data + 1];
            if (x + 2 * i > width) break;
            for (int64_t j = 0; j < i; ++j) {
              row[x++] = buf[data + 2];
              row[x++] = buf[data + 3];
            }
            data += 4;
          } else {
            const int64_t i = 2 * static_cast<int64_t>(buf[data + 1]);
            if (x + i > width) break;
            if (data + 2 + i > end) { *error = -1; return -1; }
            std::memcpy(row + x, buf + data + 2, i);
            data += 2 + i;
            x += i;
          }
        }
        if (p < packets) break;
        ++l;
        ++y;
      }
      if (l < lines) { *error = -1; return -1; }
    } else if (kind == 12) {                          // LC, byte delta
      int64_t y = i16(data);
      const int64_t ymax = y + i16(data + 2);
      data += 4;
      for (; y < ymax && y < height; ++y) {
        uint8_t* row = img + y * width;
        if (data + 1 > end) { *error = -1; return -1; }
        const int64_t packets = buf[data++];
        int64_t x = 0, p = 0, i = 0;
        for (; p < packets; ++p, x += i) {
          if (data + 2 > end) { *error = -1; return -1; }
          x += buf[data];
          if (buf[data + 1] & 0x80) {
            i = 256 - buf[data + 1];
            if (x + i > width) break;
            if (data + 3 > end) { *error = -1; return -1; }
            std::memset(row + x, buf[data + 2], i);
            data += 3;
          } else {
            i = buf[data + 1];
            if (x + i > width) break;
            if (data + 2 + i > end) { *error = -1; return -1; }
            std::memcpy(row + x, buf + data + 2, i);
            data += i + 2;
          }
        }
        if (p < packets) break;
      }
      if (y < ymax) { *error = -1; return -1; }
    } else if (kind == 13) {                          // BLACK
      std::memset(img, 0, width * height);
    } else if (kind == 15) {                          // BRUN
      for (int64_t y = 0; y < height; ++y) {
        uint8_t* row = img + y * width;
        data += 1;                                    // the packet count, ignored
        int64_t x = 0, i = 0;
        for (; x < width; x += i) {
          if (data + 2 > end) { *error = -1; return -1; }
          if (buf[data] & 0x80) {
            i = 256 - buf[data];
            if (x + i > width) break;
            if (data + i + 1 > end) { *error = -1; return -1; }
            std::memcpy(row + x, buf + data + 1, i);
            data += i + 1;
          } else {
            i = buf[data];
            if (x + i > width) break;
            std::memset(row + x, buf[data + 1], i);
            data += 2;
          }
        }
        if (x != width) { *error = -1; return -1; }
      }
    } else if (kind == 16) {                          // COPY
      if (data + width * height > end) return ptr;
      std::memcpy(img, buf + data, width * height);
    } else if (kind != 4 && kind != 11 && kind != 18) {
      *error = -3;
      return -1;
    }
    const int64_t advance = i32(ptr);
    if (advance == 0) { *error = -2; return -1; }
    if (advance < 0 || advance > left) { *error = -1; return -1; }
    ptr += advance;
    left -= advance;
  }
  return -1;
}

// Sub-byte TIFF tiles side by side (rows x across * tile_row_bytes) -> the
// image's rows (rows x ceil(width * bits / 8), zeroed by the caller): each
// tile row's first tile_width * bits bits, the last tile's cut at the
// image's width: utils/tiff.py, tile_bits_gather_python.
void tile_bits_gather(const uint8_t* raw, int64_t rows, int64_t across, int64_t tile_row_bytes,
                      int64_t tile_width, int bits, int64_t width, uint8_t* out) {
  const int64_t out_row = (width * bits + 7) / 8, tile_bits = tile_width * bits;
  const int64_t total = width * bits;
  for (int64_t r = 0; r < rows; ++r) {
    const uint8_t* in = raw + r * across * tile_row_bytes;
    uint8_t* o = out + r * out_row;
    for (int64_t b = 0; b < total; ++b) {
      const int64_t t = b / tile_bits, k = b % tile_bits;
      const int bit = in[t * tile_row_bytes + k / 8] >> (7 - k % 8) & 1;
      o[b / 8] |= static_cast<uint8_t>(bit << (7 - b % 8));
    }
  }
}

}  // extern "C"
