// Entropy decoding of one JPEG scan into quantised DCT coefficients (or, for
// a lossless frame, samples), and the reconstruction of the pixels from them.
//
// The native half of coma_tpu_torch/utils/jpeg.py: the Python side parses the
// markers and holds the coefficient arrays; each jpeg_decode_scan* function
// reads one scan's entropy-coded data from the file where the scan header
// ends, as libjpeg-turbo 3.1.3 reads it through Pillow, and leaves the read
// position, libjpeg's unread marker and the expected RSTn in ``state``:
//
// - jpeg_decode_scan: Huffman coding, jdhuff.c (sequential, with
//   decode_mcu_fast's six-byte fills where more than 512 bytes a block are
//   in hand) and jdphuff.c (progressive: DC first and refine, AC first and
//   refine with end-of-band runs);
// - jpeg_decode_scan_arith: arithmetic coding, jdarith.c (the QM decoder, its
//   statistics bins and the DAC conditioning);
// - jpeg_decode_scan_lossless: lossless, jdlhuff.c's differences an MCU row at
//   a time, then jdlossls.c's undifferencing and point transform.
//
// libjpeg's recovery from corrupt data is followed: a marker inside the data
// supplies zero bits and, once a bit past the data is used, the rest of the
// restart interval is not decoded (insufficient_data); read_restart_marker and
// jpeg_resync_to_restart decide what a wrong, missing or extra RSTn does; a
// code no table entry starts is symbol 0 after 17 bits; arithmetic-coded data
// that overflows ends the interval (ct = -1). The file arrives as Pillow hands
// it over, 65536 bytes at a time (an MCU that runs past a block starts again
// with the next; arithmetic decoding cannot suspend), and its end is a
// truncation; libtiff's source (``libtiff`` nonzero) supplies FF D9 past it,
// and its old-style JPEG source (``libtiff`` 2) fails where libjpeg would
// resynchronise to a restart marker. Each
// result equals the plain Python decoder's (utils/jpeg.py) value for value.
// jpeg_smooth is jdcoefct.c's block smoothing of a progressive frame, and
// jpeg_reconstruct does what utils/jpeg.py:reconstruct does in numpy
// (libjpeg-turbo's SIMD islow IDCT, jdsample.c's upsampling, jdcolor.c's
// colour conversion), in the same integer arithmetic, so the pixels are equal
// too.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 jpeg_decode.cpp (native/__init__.py
// does it at first use).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// zig-zag index -> natural (row-major) index; 16 extra entries keep a corrupt
// run from writing outside the block (libjpeg's jpeg_natural_order does so too)
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kTableBytes = 1 + 16 + 256;   // present, counts of lengths 1..16, values
constexpr int64_t kChunk = 65536;           // Pillow's reads
constexpr int kMinGetBits = 57;

// Statuses; a negative one names a table: -(1 + 4 * kind + table), kind 0 an
// undefined DC table, 1 an undefined AC table, 2 a bad DC table, 3 a bad AC one.
enum Status { kOk = 0, kTruncated = 1, kCantSuspend = 2, kNoResync = 3 };

// int32 per component of a scan: h, v, blocks per row of its array, coded
// blocks per row and column, DC table, AC table, sample rows and columns,
// MCU rows per restart interval (lossless)
constexpr int kComp = 10;

struct Suspend {};                 // the MCU starts again with the next block in hand
struct Fail { int status; };       // libjpeg refuses (or the file ends)
struct BadArith {};                // JWRN_ARITH_BAD_CODE: ct = -1

// libjpeg's data source over the file: ``state`` is pos, end (what Pillow has
// handed over), unread_marker, next restart number.
struct Source {
  const uint8_t* data;
  int64_t size, pos, end;
  int unread, restart;
  bool libtiff;
  bool no_resync;                  // libtiff's old-style JPEG: a resync fails the strip

  int byte(bool in_mcu) {
    int64_t p = pos;
    if (p >= end) {
      if (libtiff) {
        pos = p + 1;
        return (p - size) % 2 == 0 ? 0xFF : 0xD9;
      }
      if (end >= size) throw Fail{kTruncated};
      end = end + kChunk < size ? end + kChunk : size;
      if (in_mcu) throw Suspend{};
    }
    pos = p + 1;
    return data[p];
  }
  int arith_byte() {
    if (pos >= end && !libtiff) throw Fail{kCantSuspend};
    return byte(false);
  }
  void next_marker(bool can_suspend) {
    auto get = [&]() { return can_suspend ? byte(false) : arith_byte(); };
    int c;
    for (;;) {
      c = get();
      while (c != 0xFF) c = get();
      do c = get(); while (c == 0xFF);
      if (c) break;
    }
    unread = c;
  }
  // read_restart_marker and jpeg_resync_to_restart
  void read_restart_marker(bool can_suspend) {
    if (!unread) next_marker(can_suspend);
    int desired = restart;
    if (unread == 0xD0 + desired) {
      unread = 0;
    } else {
      if (no_resync) throw Fail{kNoResync};
      for (;;) {
        int m = unread, action;
        if (m < 0xC0)
          action = 2;
        else if (m < 0xD0 || m > 0xD7)
          action = 3;
        else if (m == 0xD0 + ((desired + 1) & 7) || m == 0xD0 + ((desired + 2) & 7))
          action = 3;
        else if (m == 0xD0 + ((desired - 1) & 7) || m == 0xD0 + ((desired - 2) & 7))
          action = 2;
        else
          action = 1;
        if (action == 1) {
          unread = 0;
          break;
        }
        if (action == 3) break;
        next_marker(can_suspend);
      }
    }
    restart = (desired + 1) & 7;
  }
};

// jpeg_make_d_derived_tbl
struct Table {
  int look[256];
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t huffval[256];
};

int derive(const uint8_t* tables, int which, bool dc, bool lossless, Table& t) {
  const int kind = dc ? 0 : 1;
  if (which > 3 || !tables[(which + (dc ? 0 : 4)) * kTableBytes]) return -(1 + 4 * kind + which);
  const uint8_t* spec = tables + (which + (dc ? 0 : 4)) * kTableBytes;
  const uint8_t* counts = spec + 1;
  int n = 0;
  for (int l = 0; l < 16; ++l) n += counts[l];
  std::memset(t.huffval, 0, sizeof(t.huffval));
  std::memcpy(t.huffval, spec + 17, n);
  int sizes[257], codes[256];
  int p = 0;
  for (int l = 1; l <= 16; ++l)
    for (int i = 0; i < counts[l - 1]; ++i) sizes[p++] = l;
  int code = 0, si = n ? sizes[0] : 0;
  p = 0;
  while (p < n) {
    while (p < n && sizes[p] == si) codes[p++] = code++;
    if (code >= (1 << si)) return -(1 + 4 * (2 + kind) + which);
    code <<= 1;
    ++si;
  }
  if (dc)
    for (int i = 0; i < n; ++i)
      if (t.huffval[i] > (lossless ? 16 : 15)) return -(1 + 4 * (2 + kind) + which);
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (counts[l - 1]) {
      t.valoffset[l] = p - codes[p];
      p += counts[l - 1];
      t.maxcode[l] = codes[p - 1];
    } else {
      t.maxcode[l] = -1;
    }
  }
  t.valoffset[17] = 0;
  t.maxcode[17] = 0xFFFFF;
  for (int i = 0; i < 256; ++i) t.look[i] = 9 << 8;
  p = 0;
  for (int l = 1; l <= 8; ++l)
    for (int i = 0; i < counts[l - 1]; ++i, ++p) {
      int first = codes[p] << (8 - l);
      for (int j = 0; j < (1 << (8 - l)); ++j) t.look[first + j] = (l << 8) | t.huffval[p];
    }
  return kOk;
}

// libjpeg-turbo's bit reader (jdhuff.c / jdhuff.h)
struct Bits {
  Source* src;
  uint64_t buf = 0;
  int left = 0;
  bool insufficient = false;

  void fill(int nbits) {               // jpeg_fill_bit_buffer
    if (!src->unread) {
      while (left < kMinGetBits) {
        int c = src->byte(true);
        if (c == 0xFF) {
          do c = src->byte(true); while (c == 0xFF);
          if (c) {
            src->unread = c;
            goto no_more;
          }
          c = 0xFF;
        }
        buf = (buf << 8) | static_cast<uint64_t>(c);
        left += 8;
      }
      return;
    }
  no_more:
    if (nbits > left) {
      insufficient = true;
      buf <<= kMinGetBits - left;
      left = kMinGetBits;
    }
  }
  void fill_fast() {                   // FILL_BIT_BUFFER_FAST
    if (left > 16) return;
    const uint8_t* d = src->data;
    int64_t p = src->pos;
    for (int i = 0; i < 6; ++i) {
      int c0 = d[p], c1 = d[p + 1];
      ++p;
      buf = (buf << 8) | static_cast<uint64_t>(c0);
      if (c0 == 0xFF) {
        ++p;
        if (c1) {                        // a marker: zeros, and the MCU again slowly
          src->unread = c1;
          p -= 2;
          buf &= ~static_cast<uint64_t>(0xFF);
        }
      }
    }
    left += 48;
    src->pos = p;
  }
  uint32_t take(int n) {
    left -= n;
    return n ? static_cast<uint32_t>((buf >> left) & ((uint64_t{1} << n) - 1)) : 0;
  }
  uint32_t get(int n) {                // CHECK_BIT_BUFFER + GET_BITS
    if (left < n) fill(n);
    return take(n);
  }
  uint32_t get_fast(int n) {
    fill_fast();
    return take(n);
  }
  int walk(const Table& t, int l) {    // jpeg_huff_decode
    int32_t code = static_cast<int32_t>(get(l));
    while (code > t.maxcode[l]) {
      code = (code << 1) | static_cast<int32_t>(get(1));
      ++l;
    }
    return l > 16 ? 0 : t.huffval[(code + t.valoffset[l]) & 0xFF];
  }
  int decode(const Table& t) {         // HUFF_DECODE
    if (left < 8) {
      fill(0);
      if (left < 8) return walk(t, 1);
    }
    int e = t.look[(buf >> (left - 8)) & 0xFF];
    if ((e >> 8) <= 8) {
      left -= e >> 8;
      return e & 0xFF;
    }
    return walk(t, 9);
  }
  int decode_fast(const Table& t) {    // HUFF_DECODE_FAST
    fill_fast();
    int e = t.look[(buf >> (left - 8)) & 0xFF];
    int nb = e >> 8;
    left -= nb;
    if (nb <= 8) return e & 0xFF;
    int32_t s = static_cast<int32_t>((buf >> left) & ((uint64_t{1} << nb) - 1));
    while (s > t.maxcode[nb]) {
      --left;
      s = (s << 1) | static_cast<int32_t>((buf >> left) & 1);
      ++nb;
    }
    return nb > 16 ? 0 : t.huffval[(s + t.valoffset[nb]) & 0xFF];
  }
};

inline int extend(uint32_t v, int s) {
  return v < (1u << (s - 1)) ? static_cast<int>(v) - (1 << s) + 1 : static_cast<int>(v);
}

inline int16_t shl16(int v, int al) {
  return static_cast<int16_t>(static_cast<int>(static_cast<unsigned>(v) << al));
}

// The units of each MCU in coding order: (component, offset of the unit in
// its array, ``unit`` elements per block: 64 for DCT blocks, 1 for lossless
// samples). A one-component scan codes the component's own extent.
std::vector<std::pair<int, int64_t>> mcu_units(int mcus_x, int mcus_y, int n_comps,
                                               const int32_t* comp, int64_t unit,
                                               int64_t& n_mcus, int& per_mcu,
                                               int64_t& per_row) {
  std::vector<std::pair<int, int64_t>> units;
  if (n_comps == 1) {
    int64_t bw = comp[2], cw = comp[3], ch = comp[4];
    n_mcus = cw * ch;
    per_mcu = 1;
    per_row = cw;
    units.reserve(n_mcus);
    for (int64_t y = 0; y < ch; ++y)
      for (int64_t x = 0; x < cw; ++x) units.emplace_back(0, (y * bw + x) * unit);
    return units;
  }
  n_mcus = static_cast<int64_t>(mcus_x) * mcus_y;
  per_row = mcus_x;
  per_mcu = 0;
  for (int i = 0; i < n_comps; ++i) per_mcu += comp[i * kComp] * comp[i * kComp + 1];
  units.reserve(n_mcus * per_mcu);
  for (int64_t my = 0; my < mcus_y; ++my)
    for (int64_t mx = 0; mx < mcus_x; ++mx)
      for (int i = 0; i < n_comps; ++i) {
        int64_t h = comp[i * kComp], v = comp[i * kComp + 1], bw = comp[i * kComp + 2];
        for (int64_t y = 0; y < v; ++y)
          for (int64_t x = 0; x < h; ++x)
            units.emplace_back(i, ((my * v + y) * bw + mx * h + x) * unit);
      }
  return units;
}

struct ScanParams {
  int ss, se, ah, al;
  bool progressive;
};

// decode_mcu_fast (Fast) / decode_mcu_slow
template <bool Fast>
void sequential_mcu(Bits& br, const std::pair<int, int64_t>* units, int per_mcu,
                    int16_t* const* coef, const Table* const* dc, const Table* const* ac,
                    int* pred) {
  for (int b = 0; b < per_mcu; ++b) {
    int i = units[b].first;
    int16_t* block = coef[i] + units[b].second;
    int s = Fast ? br.decode_fast(*dc[i]) : br.decode(*dc[i]);
    if (s) {
      uint32_t r = Fast ? br.get_fast(s) : br.get(s);
      s = extend(r, s);
    }
    pred[i] = static_cast<int>(static_cast<unsigned>(pred[i]) + static_cast<unsigned>(s));
    block[0] = static_cast<int16_t>(pred[i]);
    for (int k = 1; k < 64; ++k) {
      int rs = Fast ? br.decode_fast(*ac[i]) : br.decode(*ac[i]);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        uint32_t v = Fast ? br.get_fast(s) : br.get(s);
        block[kNatural[k]] = static_cast<int16_t>(extend(v, s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }
}

// jdphuff.c's MCU decoders; ``eobrun`` the end-of-band run
void progressive_mcu(Bits& br, const std::pair<int, int64_t>* units, int per_mcu,
                     int16_t* const* coef, const Table* const* dc, const Table* ac, int* pred,
                     int& eobrun, const ScanParams& sc) {
  if (sc.ss == 0) {
    for (int b = 0; b < per_mcu; ++b) {
      int i = units[b].first;
      int16_t* block = coef[i] + units[b].second;
      if (sc.ah == 0) {
        int s = br.decode(*dc[i]);
        if (s) s = extend(br.get(s), s);
        pred[i] += s;
        block[0] = shl16(pred[i], sc.al);
      } else if (br.get(1)) {
        block[0] = static_cast<int16_t>(block[0] | (1 << sc.al));
      }
    }
    return;
  }
  int16_t* block = coef[units[0].first] + units[0].second;
  if (sc.ah == 0) {                       // AC first
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    for (int k = sc.ss; k <= sc.se; ++k) {
      int rs = br.decode(*ac);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        block[kNatural[k]] = shl16(extend(br.get(s), s), sc.al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += static_cast<int>(br.get(r));
        --eobrun;
        break;
      }
    }
    return;
  }
  // AC refine
  const int p1 = 1 << sc.al, m1 = -(1 << sc.al);
  int k = sc.ss, newnz[64], n_new = 0, run = eobrun;
  auto correct = [&](int16_t* c) {
    if (br.get(1) && (*c & p1) == 0) *c = static_cast<int16_t>(*c + (*c >= 0 ? p1 : m1));
  };
  try {
    if (run == 0) {
      for (; k <= sc.se; ++k) {
        int rs = br.decode(*ac);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = br.get(1) ? p1 : m1;
        } else if (r != 15) {
          run = 1 << r;
          if (r) run += static_cast<int>(br.get(r));
          break;
        }
        do {
          int16_t* c = block + kNatural[k];
          if (*c != 0) {
            correct(c);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= sc.se);
        if (s) {
          block[kNatural[k]] = static_cast<int16_t>(s);
          if (n_new < 64) newnz[n_new++] = kNatural[k];
        }
      }
    }
    if (run > 0) {
      for (; k <= sc.se; ++k) {
        int16_t* c = block + kNatural[k];
        if (*c != 0) correct(c);
      }
      --run;
    }
  } catch (const Suspend&) {
    while (n_new > 0) block[newnz[--n_new]] = 0;   // libjpeg undoes the newly nonzero ones
    throw;
  }
  eobrun = run;
}

}  // namespace

extern "C" {

// Decodes one Huffman-coded scan from data[state[0]:] (``size`` bytes in
// all); state[4] receives the last MCU begun with data in hand. ``comp`` holds kComp int32 per component of the scan (the tables
// index ``tables``: 0-3 DC, 4-7 AC, each kTableBytes). ``coef[i]`` is
// component i's (rows, blocks per row, 64) int16 array in natural order.
// Returns a Status.
int jpeg_decode_scan(const uint8_t* data, int64_t size, int libtiff, int64_t* state,
                     int mcus_x, int mcus_y, int restart_interval, int n_comps,
                     const int32_t* comp, int16_t* const* coef, const uint8_t* tables,
                     int ss, int se, int ah, int al, int progressive) {
  ScanParams sc{ss, se, ah, al, progressive != 0};
  bool need_dc = !sc.progressive || (ss == 0 && ah == 0);
  bool need_ac = !sc.progressive || ss > 0;
  Table dc_t[4], ac_t[4];
  const Table* dc[4] = {nullptr, nullptr, nullptr, nullptr};
  const Table* ac[4] = {nullptr, nullptr, nullptr, nullptr};
  for (int i = 0; i < n_comps; ++i) {
    int d = comp[i * kComp + 5], a = comp[i * kComp + 6];
    if (need_dc) {
      int st = derive(tables, d, true, false, dc_t[i]);
      if (st) return st;
      dc[i] = &dc_t[i];
    }
    if (need_ac) {
      int st = derive(tables, a, false, false, ac_t[i]);
      if (st) return st;
      ac[i] = &ac_t[i];
    }
  }
  Source src{data, size, state[0], state[1], static_cast<int>(state[2]),
             static_cast<int>(state[3]), libtiff != 0, libtiff == 2};
  int64_t n_mcus, per_row;
  int per_mcu;
  std::vector<std::pair<int, int64_t>> units =
      mcu_units(mcus_x, mcus_y, n_comps, comp, 64, n_mcus, per_mcu, per_row);
  Bits br{&src};
  int pred[4] = {0, 0, 0, 0}, eobrun = 0, to_go = restart_interval;
  const bool refine_dc = sc.progressive && ss == 0 && ah > 0;
  int status = kOk;
  int64_t at = 0;
  try {
    for (int64_t m = 0; m < n_mcus; ++m) {
      const std::pair<int, int64_t>* mu = units.data() + m * per_mcu;
      at = m;
      if (!br.insufficient) state[4] = m;            // the last MCU begun with data in hand
      if (restart_interval && to_go == 0) {          // process_restart
        br.left = 0;
        src.read_restart_marker(true);
        std::memset(pred, 0, sizeof(pred));
        eobrun = 0;
        to_go = restart_interval;
        if (!src.unread) br.insufficient = false;
      }
      for (;;) {
        uint64_t buf = br.buf;
        int left = br.left, unread = src.unread, save_pred[4], save_eob = eobrun;
        int64_t pos = src.pos;
        std::memcpy(save_pred, pred, sizeof(pred));
        try {
          if (br.insufficient && !refine_dc) {
            // the rest of the interval stays as it was
          } else if (sc.progressive) {
            progressive_mcu(br, mu, per_mcu, coef, dc, ac[0], pred, eobrun, sc);
          } else if (!restart_interval && !src.unread && src.end - src.pos >= 512 * per_mcu) {
            sequential_mcu<true>(br, mu, per_mcu, coef, dc, ac, pred);
            if (src.unread) {                          // the fast path met a marker
              br.buf = buf;
              br.left = left;
              src.pos = pos;
              src.unread = 0;
              std::memcpy(pred, save_pred, sizeof(pred));
              sequential_mcu<false>(br, mu, per_mcu, coef, dc, ac, pred);
            }
          } else {
            sequential_mcu<false>(br, mu, per_mcu, coef, dc, ac, pred);
          }
          break;
        } catch (const Suspend&) {
          br.buf = buf;
          br.left = left;
          src.pos = pos;
          src.unread = unread;
          eobrun = save_eob;
          std::memcpy(pred, save_pred, sizeof(pred));
        }
      }
      --to_go;
    }
  } catch (const Fail& f) {
    status = f.status;
    if (status == kNoResync) state[4] = at;          // the MCU whose restart was refused
  }
  state[0] = src.pos;
  state[1] = src.end;
  state[2] = src.unread;
  state[3] = src.restart;
  return status;
}

}  // extern "C"

// Arithmetic decoding (jdarith.c) --------------------------------------------

namespace {

// jaricom.c's jpeg_aritab, unpacked: Qe, Next_Index_LPS | Switch_MPS << 7,
// Next_Index_MPS (JPEG's Table D.2; state 113 is the fixed 0.5 estimate)
const uint16_t kQe[114] = {
    0x5a1d, 0x2586, 0x1114, 0x080b, 0x03d8, 0x01da, 0x00e5, 0x006f, 0x0036, 0x001a, 0x000d,
    0x0006, 0x0003, 0x0001, 0x5a7f, 0x3f25, 0x2cf2, 0x207c, 0x17b9, 0x1182, 0x0cef, 0x09a1,
    0x072f, 0x055c, 0x0406, 0x0303, 0x0240, 0x01b1, 0x0144, 0x00f5, 0x00b7, 0x008a, 0x0068,
    0x004e, 0x003b, 0x002c, 0x5ae1, 0x484c, 0x3a0d, 0x2ef1, 0x261f, 0x1f33, 0x19a8, 0x1518,
    0x1177, 0x0e74, 0x0bfb, 0x09f8, 0x0861, 0x0706, 0x05cd, 0x04de, 0x040f, 0x0363, 0x02d4,
    0x025c, 0x01f8, 0x01a4, 0x0160, 0x0125, 0x00f6, 0x00cb, 0x00ab, 0x008f, 0x5b12, 0x4d04,
    0x412c, 0x37d8, 0x2fe8, 0x293c, 0x2379, 0x1edf, 0x1aa9, 0x174e, 0x1424, 0x119c, 0x0f6b,
    0x0d51, 0x0bb6, 0x0a40, 0x5832, 0x4d1c, 0x438e, 0x3bdd, 0x34ee, 0x2eae, 0x299a, 0x2516,
    0x5570, 0x4ca9, 0x44d9, 0x3e22, 0x3824, 0x32b4, 0x2e17, 0x56a8, 0x4f46, 0x47e5, 0x41cf,
    0x3c3d, 0x375e, 0x5231, 0x4c0f, 0x4639, 0x415e, 0x5627, 0x50e7, 0x4b85, 0x5597, 0x504f,
    0x5a10, 0x5522, 0x59eb, 0x5a1d};
const uint8_t kNextLps[114] = {
    129, 14,  16,  18,  20,  23,  25,  28,  30,  33,  35,  9,   10,  12,  143, 36,  38,  39,  40,
    42,  43,  45,  46,  48,  49,  51,  52,  54,  56,  57,  59,  60,  62,  63,  32,  33,  165, 64,
    65,  67,  68,  69,  70,  72,  73,  74,  75,  77,  78,  79,  48,  50,  50,  51,  52,  53,  54,
    55,  56,  57,  58,  59,  61,  61,  193, 80,  81,  82,  83,  84,  86,  87,  87,  72,  72,  74,
    74,  75,  77,  77,  208, 88,  89,  90,  91,  92,  93,  86,  216, 95,  96,  97,  99,  99,  93,
    223, 101, 102, 103, 104, 99,  105, 106, 107, 103, 233, 108, 109, 110, 111, 238, 112, 240, 113};
const uint8_t kNextMps[114] = {
    1,   2,   3,   4,   5,   6,   7,   8,   9,   10,  11,  12,  13,  13,  15,  16,  17,  18,  19,
    20,  21,  22,  23,  24,  25,  26,  27,  28,  29,  30,  31,  32,  33,  34,  35,  9,   37,  38,
    39,  40,  41,  42,  43,  44,  45,  46,  47,  48,  49,  50,  51,  52,  53,  54,  55,  56,  57,
    58,  59,  60,  61,  62,  63,  32,  65,  66,  67,  68,  69,  70,  71,  72,  73,  74,  75,  76,
    77,  78,  79,  48,  81,  82,  83,  84,  85,  86,  87,  71,  89,  90,  91,  92,  93,  94,  86,
    96,  97,  98,  99,  100, 93,  102, 103, 104, 99,  106, 107, 103, 109, 107, 111, 109, 111, 113};

struct ArithDecoder {
  Source* src;
  int64_t c = 0, a = 0;
  int ct = -16;

  int bit(uint8_t* st) {
    while (a < 0x8000) {                         // renormalisation and input, D.2.6
      if (--ct < 0) {
        int data = 0;
        if (!src->unread) {
          data = src->arith_byte();
          if (data == 0xFF) {
            do data = src->arith_byte(); while (data == 0xFF);
            if (data) {
              src->unread = data;
              data = 0;
            } else {
              data = 0xFF;
            }
          }
        }
        c = (c << 8) | data;
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;
      }
      a <<= 1;
    }
    int sv = *st;
    int64_t qe = kQe[sv & 0x7F];
    a -= qe;
    int64_t temp = a << ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {                              // conditional exchange, D.2.4
        *st = static_cast<uint8_t>((sv & 0x80) ^ kNextMps[sv & 0x7F]);
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ kNextLps[sv & 0x7F]);
        sv ^= 0x80;
      }
      a = qe;
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ kNextLps[sv & 0x7F]);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ kNextMps[sv & 0x7F]);
      }
    }
    return sv >> 7;
  }
};

// Figures F.23 and F.24 from bin ``st`` (then ``big`` onwards): the signed value.
int arith_value(ArithDecoder& d, uint8_t* stats, int st, int sign, int big) {
  int m = d.bit(stats + st);
  if (m && d.bit(stats + st)) {
    m = 2;
    st = big;
    while (d.bit(stats + st)) {
      if ((m <<= 1) == 0x8000) throw BadArith{};
      ++st;
    }
  }
  int v = m;
  st += 14;
  while (m >>= 1)
    if (d.bit(stats + st)) v |= m;
  ++v;
  return sign ? -v : v;
}

// Figure F.19 with F.1.4.4.1.2's conditioning: one DC difference.
int arith_dc_diff(ArithDecoder& d, uint8_t* stats, int& ctx, int lo, int hi) {
  int st = ctx;
  if (d.bit(stats + st) == 0) {
    ctx = 0;
    return 0;
  }
  int sign = d.bit(stats + st + 1);
  st += 2 + sign;
  int m = d.bit(stats + st);
  if (m) {
    st = 20;
    while (d.bit(stats + st)) {
      if ((m <<= 1) == 0x8000) throw BadArith{};
      ++st;
    }
  }
  if (m < ((1 << lo) >> 1))
    ctx = 0;
  else if (m > ((1 << hi) >> 1))
    ctx = 12 + sign * 4;
  else
    ctx = 4 + sign * 4;
  int v = m;
  st += 14;
  while (m >>= 1)
    if (d.bit(stats + st)) v |= m;
  ++v;
  return sign ? -v : v;
}

}  // namespace

extern "C" {

// Decodes one arithmetic-coded scan (sequential or progressive), as
// jpeg_decode_scan does a Huffman-coded one. ``cond`` holds 48 int32: the DC
// conditioning L and U of tables 0-15, then the AC K of tables 0-15.
int jpeg_decode_scan_arith(const uint8_t* data, int64_t size, int libtiff, int64_t* state,
                           int mcus_x, int mcus_y, int restart_interval, int n_comps,
                           const int32_t* comp, int16_t* const* coef, const int32_t* cond,
                           int ss, int se, int ah, int al, int progressive) {
  Source src{data, size, state[0], state[1], static_cast<int>(state[2]),
             static_cast<int>(state[3]), libtiff != 0, libtiff == 2};
  int64_t n_mcus, per_row;
  int per_mcu;
  std::vector<std::pair<int, int64_t>> units =
      mcu_units(mcus_x, mcus_y, n_comps, comp, 64, n_mcus, per_mcu, per_row);
  const bool sequential = !progressive;
  const int p1 = 1 << al, m1 = -(1 << al);
  static thread_local uint8_t dc_stats[16][64], ac_stats[16][256];
  uint8_t fixed = 113;
  int pred[4], ctx[4], to_go = restart_interval;
  ArithDecoder d{&src};
  auto fresh = [&]() {
    std::memset(dc_stats, 0, sizeof(dc_stats));
    std::memset(ac_stats, 0, sizeof(ac_stats));
    std::memset(pred, 0, sizeof(pred));
    std::memset(ctx, 0, sizeof(ctx));
    fixed = 113;
  };
  fresh();
  int status = kOk;
  try {
    for (int64_t m = 0; m < n_mcus; ++m) {
      if (restart_interval) {
        if (to_go == 0) {                                      // process_restart
          src.read_restart_marker(false);
          fresh();
          d.c = d.a = 0;
          d.ct = -16;
          to_go = restart_interval;
        }
        --to_go;
      }
      if (d.ct == -1) continue;
      try {
        for (int b = 0; b < per_mcu; ++b) {
          const auto& u = units[m * per_mcu + b];
          int i = u.first;
          int16_t* block = coef[i] + u.second;
          int td = comp[i * kComp + 5], ta = comp[i * kComp + 6];
          if (sequential || (ss == 0 && ah == 0)) {                    // DC
            int diff = arith_dc_diff(d, dc_stats[td], ctx[i], cond[td], cond[16 + td]);
            if (sequential) {
              pred[i] = (pred[i] + diff) & 0xFFFF;
              block[0] = static_cast<int16_t>(pred[i]);
            } else {
              pred[i] += diff;
              block[0] = shl16(pred[i], al);
            }
          } else if (ss == 0) {                                        // DC refine
            if (d.bit(&fixed)) block[0] = static_cast<int16_t>(block[0] | p1);
          }
          if (sequential || (ss > 0 && ah == 0)) {                     // AC (first)
            uint8_t* stats = ac_stats[ta];
            int kx = cond[32 + ta], last = sequential ? 63 : se;
            for (int k = sequential ? 1 : ss; k <= last; ++k) {
              int st = 3 * (k - 1);
              if (d.bit(stats + st)) break;                            // end of block
              while (d.bit(stats + st + 1) == 0) {
                st += 3;
                if (++k > last) throw BadArith{};
              }
              int sign = d.bit(&fixed);
              int v = arith_value(d, stats, st + 2, sign, k <= kx ? 189 : 217);
              block[kNatural[k]] = sequential ? static_cast<int16_t>(v) : shl16(v, al);
            }
          } else if (ss > 0) {                                         // AC refine
            uint8_t* stats = ac_stats[ta];
            int kex = se;
            while (kex > 0 && block[kNatural[kex]] == 0) --kex;
            for (int k = ss; k <= se; ++k) {
              int st = 3 * (k - 1);
              if (k > kex && d.bit(stats + st)) break;
              for (;;) {
                int16_t* c = block + kNatural[k];
                if (*c) {
                  if (d.bit(stats + st + 2)) *c = static_cast<int16_t>(*c + (*c < 0 ? m1 : p1));
                  break;
                }
                if (d.bit(stats + st + 1)) {
                  *c = static_cast<int16_t>(d.bit(&fixed) ? m1 : p1);
                  break;
                }
                st += 3;
                if (++k > se) throw BadArith{};
              }
            }
          }
        }
      } catch (const BadArith&) {
        d.ct = -1;
      }
    }
  } catch (const Fail& f) {
    status = f.status;
  }
  state[0] = src.pos;
  state[1] = src.end;
  state[2] = src.unread;
  state[3] = src.restart;
  return status;
}

// Decodes one lossless (SOF3) scan: the Huffman-coded differences of each
// sample, an MCU row at a time (a row that starts with the data run out is
// zeros, predicted afresh), then each component's undifferencing with
// predictor ``ss`` (the first row of the scan, of each restart interval and
// of each such row from the left, the first column from above, sums modulo
// 2^16) and the point transform ``al``, into ``samples[i]``, component i's
// (rows, columns) int32 array.
int jpeg_decode_scan_lossless(const uint8_t* data, int64_t size, int libtiff, int64_t* state,
                              int mcus_x, int mcus_y, int, int n_comps,
                              const int32_t* comp, int32_t* const* samples,
                              const uint8_t* tables, int ss, int, int, int al, int) {
  Table dc_t[4];
  for (int i = 0; i < n_comps; ++i) {
    int st = derive(tables, comp[i * kComp + 5], true, true, dc_t[i]);
    if (st) return st;
  }
  Source src{data, size, state[0], state[1], static_cast<int>(state[2]),
             static_cast<int>(state[3]), libtiff != 0, libtiff == 2};
  int64_t n_mcus, per_row;
  int per_mcu;
  std::vector<std::pair<int, int64_t>> units =
      mcu_units(mcus_x, mcus_y, n_comps, comp, 1, n_mcus, per_mcu, per_row);
  const int64_t rows = per_row ? n_mcus / per_row : 0;
  const int restart_rows = comp[9];
  std::vector<uint8_t> fresh(rows, 0);
  Bits br{&src};
  int to_go = restart_rows, status = kOk;   // the caller hands over zeroed arrays
  try {
    for (int64_t r = 0; r < rows; ++r) {
      if (r == 0) fresh[r] = 1;
      if (restart_rows) {
        if (to_go == 0) {                               // process_restart
          br.left = 0;
          src.read_restart_marker(true);
          to_go = restart_rows;
          if (!src.unread) br.insufficient = false;
          fresh[r] = 1;
        }
        --to_go;
      }
      if (br.insufficient) {
        fresh[r] = 1;
        continue;
      }
      for (int64_t m = r * per_row; m < (r + 1) * per_row; ++m) {
        for (;;) {
          uint64_t buf = br.buf;
          int left = br.left;
          int64_t pos = src.pos;
          try {
            for (int b = 0; b < per_mcu; ++b) {
              const auto& u = units[m * per_mcu + b];
              int i = u.first;
              int sym = br.decode(dc_t[i]);
              samples[i][u.second] = sym == 16 ? 32768 : sym ? extend(br.get(sym), sym) : 0;
            }
            break;
          } catch (const Suspend&) {
            br.buf = buf;
            br.left = left;
            src.pos = pos;
          }
        }
      }
    }
  } catch (const Fail& f) {
    status = f.status;
  }
  state[0] = src.pos;
  state[1] = src.end;
  state[2] = src.unread;
  state[3] = src.restart;
  if (status) return status;
  for (int i = 0; i < n_comps; ++i) {
    const int32_t* p = comp + i * kComp;
    int64_t bw = p[2];
    int rows_i = p[7], cols = p[8], v = n_comps == 1 ? 1 : p[1];
    int32_t* out = samples[i];
    std::vector<int32_t> prev(cols), cur(cols);
    for (int y = 0; y < rows_i; ++y) {
      const int32_t* diff = out + y * bw;
      if (y % v == 0 && fresh[y / v]) {
        int ra = (diff[0] + (1 << (7 - al))) & 0xFFFF;
        cur[0] = ra;
        for (int x = 1; x < cols; ++x) cur[x] = ra = (diff[x] + ra) & 0xFFFF;
      } else {
        int rb = prev[0], ra = (diff[0] + rb) & 0xFFFF, rc;
        cur[0] = ra;
        for (int x = 1; x < cols; ++x) {
          rc = rb;
          rb = prev[x];
          int pr = ss == 1 ? ra : ss == 2 ? rb : ss == 3 ? rc : ss == 4 ? ra + rb - rc
                 : ss == 5 ? ra + ((rb - rc) >> 1) : ss == 6 ? rb + ((ra - rc) >> 1)
                 : (ra + rb) >> 1;
          cur[x] = ra = (diff[x] + pr) & 0xFFFF;
        }
      }
      for (int x = 0; x < cols; ++x) out[y * bw + x] = (cur[x] << al) & 0xFF;
      std::swap(prev, cur);
    }
    // the padding of the coded extent holds no samples (zeros, as the plain decoder)
    int64_t coded_rows = n_comps == 1 ? p[4] : static_cast<int64_t>(mcus_y) * p[1];
    int64_t coded_cols = n_comps == 1 ? p[3] : static_cast<int64_t>(mcus_x) * p[0];
    for (int64_t y = 0; y < coded_rows; ++y)
      for (int64_t x = y < rows_i ? cols : 0; x < coded_cols; ++x) out[y * bw + x] = 0;
  }
  return kOk;
}

}  // extern "C"

// Block smoothing (jdcoefct.c decompress_smooth_data, libjpeg-turbo >= 2.1) --

extern "C" {

// Writes into ``out`` (a copy of ``in``, (rows_held, bw, 64) int16) the
// blocks a progressive frame's IDCT receives after libjpeg's block smoothing:
// hb x wb real blocks, ``v`` block rows per iMCU row, ``quant`` the (64,)
// table in natural order, ``latched`` coef_bits of zig-zag positions 0-9 then
// the earlier ones, which block rows from ``first_prev`` on take (the rows
// below the last iMCU row the latest scan began with data in hand). The
// neighbourhood follows utils/jpeg.py:_smoothing_rows and _smoothing_cols.
void jpeg_smooth(const int16_t* in, int16_t* out, int bw, int rows_held, int hb, int wb, int v,
                 const int64_t* quant, const int32_t* latched, int first_prev) {
  static const int kPos[9] = {1, 8, 16, 9, 2, 3, 10, 17, 24};
  const int padded = (hb + v - 1) / v * v, last_start = (hb - 1) / v * v;
  auto dc = [&](int r, int c) -> int64_t {
    return r < rows_held ? in[(static_cast<int64_t>(r) * bw + c) * 64] : 0;
  };
  for (int r = 0; r < hb; ++r) {
    const int32_t* bits = latched + (r >= first_prev ? 10 : 0);
    bool change_dc = true;
    for (int k = 1; k <= 9; ++k) change_dc = change_dc && bits[k] == -1;
    int rr[5];
    rr[0] = r >= 2 ? r - 2 : 0;
    rr[1] = r >= 1 ? r - 1 : 0;
    rr[2] = r;
    rr[3] = r + 1 < hb ? r + 1 : hb - 1;
    bool below2 = r + 2 < hb || (r < last_start && r + 2 < padded);
    rr[4] = below2 ? r + 2 : rr[3];
    if (last_start == v && hb == v + 1 && r == hb - 1) rr[0] = rr[1];
    for (int b = 0; b < wb; ++b) {
      int64_t w[26];                             // DC01..DC25 at w[1..25]
      for (int i = 0; i < 5; ++i)
        for (int j = 0; j < 5; ++j) {
          int c = b + j - 2;
          c = c < 0 ? 0 : c > wb - 1 ? wb - 1 : c;
          w[5 * i + j + 1] = dc(rr[i], c);
        }
      int64_t est[10];                           // by zig-zag index 1..9, then the DC
      if (change_dc) {
        est[1] = -w[1] - w[2] + w[4] + w[5] - 3 * w[6] + 13 * w[7] - 13 * w[9] + 3 * w[10] -
                 3 * w[11] + 38 * w[12] - 38 * w[14] + 3 * w[15] - 3 * w[16] + 13 * w[17] -
                 13 * w[19] + 3 * w[20] - w[21] - w[22] + w[24] + w[25];
        est[2] = -w[1] - 3 * w[2] - 3 * w[3] - 3 * w[4] - w[5] - w[6] + 13 * w[7] + 38 * w[8] +
                 13 * w[9] - w[10] + w[16] - 13 * w[17] - 38 * w[18] - 13 * w[19] + w[20] +
                 w[21] + 3 * w[22] + 3 * w[23] + 3 * w[24] + w[25];
        est[3] = w[3] + 2 * w[7] + 7 * w[8] + 2 * w[9] - 5 * w[12] - 14 * w[13] - 5 * w[14] +
                 2 * w[17] + 7 * w[18] + 2 * w[19] + w[23];
        est[4] = -w[1] + w[5] + 9 * w[7] - 9 * w[9] - 9 * w[17] + 9 * w[19] + w[21] - w[25];
        est[5] = 2 * w[7] - 5 * w[8] + 2 * w[9] + w[11] + 7 * w[12] - 14 * w[13] + 7 * w[14] +
                 w[15] + 2 * w[17] - 5 * w[18] + 2 * w[19];
        est[6] = w[7] - w[9] + 2 * w[12] - 2 * w[14] + w[17] - w[19];
        est[7] = w[7] - 3 * w[8] + w[9] - w[17] + 3 * w[18] - w[19];
        est[8] = w[7] - w[9] - 3 * w[12] + 3 * w[14] + w[17] - w[19];
        est[9] = w[7] + 2 * w[8] + w[9] - w[17] - 2 * w[18] - w[19];
        est[0] = -2 * w[1] - 6 * w[2] - 8 * w[3] - 6 * w[4] - 2 * w[5] - 6 * w[6] + 6 * w[7] +
                 42 * w[8] + 6 * w[9] - 6 * w[10] - 8 * w[11] + 42 * w[12] + 152 * w[13] +
                 42 * w[14] - 8 * w[15] - 6 * w[16] + 6 * w[17] + 42 * w[18] + 6 * w[19] -
                 6 * w[20] - 2 * w[21] - 6 * w[22] - 8 * w[23] - 6 * w[24] - 2 * w[25];
      } else {
        est[1] = -7 * w[11] + 50 * w[12] - 50 * w[14] + 7 * w[15];
        est[2] = -7 * w[3] + 50 * w[8] - 50 * w[18] + 7 * w[23];
        est[3] = -w[3] + 13 * w[8] - 24 * w[13] + 13 * w[18] - w[23];
        est[4] = w[10] + w[16] - 10 * w[17] + 10 * w[19] - w[2] - w[20] + w[22] - w[24] + w[4] -
                 w[6] + 10 * w[7] - 10 * w[9];
        est[5] = -w[11] + 13 * w[12] - 24 * w[13] + 13 * w[14] - w[15];
      }
      int16_t* blk = out + (static_cast<int64_t>(r) * bw + b) * 64;
      const int n_est = change_dc ? 9 : 5;
      for (int k = 1; k <= n_est; ++k) {
        int al = bits[k], pos = kPos[k - 1];
        if (al == 0 || blk[pos] != 0) continue;
        int64_t num = quant[0] * est[k], q = quant[pos];
        int64_t pred = num >= 0 ? ((q << 7) + num) / (q << 8) : ((q << 7) - num) / (q << 8);
        if (al > 0 && pred >= (int64_t{1} << al)) pred = (int64_t{1} << al) - 1;
        blk[pos] = static_cast<int16_t>(num >= 0 ? pred : -pred);
      }
      if (change_dc) {
        int64_t num = quant[0] * est[0], q = quant[0];
        int64_t pred = num >= 0 ? ((q << 7) + num) / (q << 8) : -(((q << 7) - num) / (q << 8));
        blk[0] = static_cast<int16_t>(pred);
      }
    }
  }
}

}  // extern "C"

// Reconstruction -----------------------------------------------------------

namespace {

constexpr int64_t kFix(double x, int bits) { return static_cast<int64_t>(x * (1LL << bits) + 0.5); }

const int64_t F0298 = kFix(0.298631336, 13), F0390 = kFix(0.390180644, 13),
              F0541 = kFix(0.541196100, 13), F0765 = kFix(0.765366865, 13),
              F0899 = kFix(0.899976223, 13), F1175 = kFix(1.175875602, 13),
              F1501 = kFix(1.501321110, 13), F1847 = kFix(1.847759065, 13),
              F1961 = kFix(1.961570560, 13), F2053 = kFix(2.053119869, 13),
              F2562 = kFix(2.562915447, 13), F3072 = kFix(3.072711026, 13);

inline int64_t wrap32(int64_t x) { return static_cast<int32_t>(static_cast<uint32_t>(x)); }
inline int64_t wrap16(int64_t x) { return static_cast<int16_t>(static_cast<uint16_t>(x)); }

// One pass of libjpeg-turbo's SIMD jsimd_idct_islow (the AVX2 and SSE2
// kernels, bit-exact with jpeg_idct_islow while values stay in range) over 8
// int16 values d[0], d[step], ..., d[7 step]: in0 +- in4, in7 + in3 and in5 + in1
// in 16-bit lanes, the products (pmaddwd) and sums in 32-bit ones, the
// descale, and the outputs saturated to int16 (packssdw).
void idct_pass(const int16_t* d, int step, int16_t* out, int ostep, int shift) {
  int64_t i0 = d[0], i1 = d[step], i2 = d[2 * step], i3 = d[3 * step], i4 = d[4 * step],
          i5 = d[5 * step], i6 = d[6 * step], i7 = d[7 * step];
  int64_t tmp3 = wrap32(i2 * (F0541 + F0765) + i6 * F0541);
  int64_t tmp2 = wrap32(i2 * F0541 + i6 * (F0541 - F1847));
  int64_t tmp0 = wrap16(i0 + i4) * (int64_t{1} << 13), tmp1 = wrap16(i0 - i4) * (int64_t{1} << 13);
  int64_t tmp10 = wrap32(tmp0 + tmp3), tmp13 = wrap32(tmp0 - tmp3);
  int64_t tmp11 = wrap32(tmp1 + tmp2), tmp12 = wrap32(tmp1 - tmp2);
  int64_t z3 = wrap16(i7 + i3), z4 = wrap16(i5 + i1);
  int64_t z3p = wrap32(z3 * (F1175 - F1961) + z4 * F1175);
  int64_t z4p = wrap32(z3 * F1175 + z4 * (F1175 - F0390));
  int64_t t0 = wrap32(wrap32(i7 * (F0298 - F0899) - i1 * F0899) + z3p);
  int64_t t3 = wrap32(wrap32(-i7 * F0899 + i1 * (F1501 - F0899)) + z4p);
  int64_t t1 = wrap32(wrap32(i5 * (F2053 - F2562) - i3 * F2562) + z4p);
  int64_t t2 = wrap32(wrap32(-i5 * F2562 + i3 * (F3072 - F2562)) + z3p);
  const int64_t sums[8] = {tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                           tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3};
  for (int k = 0; k < 8; ++k) {
    int64_t x = wrap32(wrap32(sums[k]) + (int64_t{1} << (shift - 1))) >> shift;
    out[k * ostep] = static_cast<int16_t>(x < -32768 ? -32768 : x > 32767 ? 32767 : x);
  }
}

// One component's samples (rows x cols) from its coefficients: the products
// wrapped to 16 bits (pmullw), the columns (a block whose rows 1-7 are zero
// takes the kernel's shortcut: the dequantised first row << 2 in 16-bit
// lanes), the rows, the samples saturated to [-128, 127] and centred.
std::vector<uint8_t> component_samples(const int16_t* coef, int64_t blocks_per_row, int rows,
                                       int cols, const int64_t* quant) {
  std::vector<uint8_t> out(static_cast<size_t>(rows) * cols);
  int nby = (rows + 7) / 8, nbx = (cols + 7) / 8;
  int16_t deq[64], ws[64], px[64];
  for (int by = 0; by < nby; ++by)
    for (int bx = 0; bx < nbx; ++bx) {
      const int16_t* c = coef + (by * blocks_per_row + bx) * 64;
      bool flat = true;
      for (int k = 0; k < 64; ++k) {
        deq[k] = static_cast<int16_t>(wrap16(static_cast<int64_t>(c[k]) * quant[k]));
        if (k >= 8 && c[k]) flat = false;
      }
      if (flat) {
        for (int col = 0; col < 8; ++col) {
          int16_t v = static_cast<int16_t>(wrap16(static_cast<int64_t>(deq[col]) * 4));
          for (int row = 0; row < 8; ++row) ws[row * 8 + col] = v;
        }
      } else {
        for (int col = 0; col < 8; ++col) idct_pass(deq + col, 8, ws + col, 8, 11);
      }
      for (int row = 0; row < 8; ++row) idct_pass(ws + row * 8, 1, px + row * 8, 1, 18);
      for (int r = 0; r < 8 && by * 8 + r < rows; ++r)
        for (int x = 0; x < 8 && bx * 8 + x < cols; ++x) {
          int v = px[r * 8 + x];
          out[static_cast<size_t>(by * 8 + r) * cols + bx * 8 + x] =
              static_cast<uint8_t>((v < -128 ? -128 : v > 127 ? 127 : v) + 128);
        }
    }
  return out;
}

// libjpeg-turbo's upsampling of a (rows x cols) component to H x W: the fancy
// h2v1 and h2v2 triangle filters where the component is wider than 2
// samples, the fancy h1v2, else int_upsample's replication (every ratio of a
// lossless frame).
std::vector<uint8_t> upsample(const std::vector<uint8_t>& c, int rows, int cols, int rh, int rv,
                              int H, int W, bool fancy) {
  if (rh == 1 && rv == 1) return c;
  std::vector<uint8_t> out(static_cast<size_t>(H) * W);
  auto at = [&](int y, int x) -> int { return c[static_cast<size_t>(y) * cols + x]; };
  bool h2 = rh == 2 && (rv == 1 || rv == 2) && cols > 2, h1v2 = rh == 1 && rv == 2;
  for (int y = 0; y < H; ++y) {
    uint8_t* o = out.data() + static_cast<size_t>(y) * W;
    int i = y / rv;
    if (!fancy || !(h2 || h1v2)) {
      for (int x = 0; x < W; ++x) o[x] = static_cast<uint8_t>(at(i, x / rh));
      continue;
    }
    int other = (y % 2 == 0) ? (i > 0 ? i - 1 : 0) : (i + 1 < rows ? i + 1 : rows - 1);
    if (h1v2) {
      int bias = y % 2 == 0 ? 1 : 2;
      for (int x = 0; x < W; ++x) o[x] = static_cast<uint8_t>((3 * at(i, x) + at(other, x) + bias) >> 2);
      continue;
    }
    for (int j = 0; j < cols; ++j) {
      int jl = j > 0 ? j - 1 : 0, jr = j + 1 < cols ? j + 1 : cols - 1;
      int left, right;
      if (rv == 1) {
        int s = 3 * at(i, j);
        left = (s + at(i, jl) + 1) >> 2;
        right = (s + at(i, jr) + 2) >> 2;
      } else {
        int s = 3 * at(i, j) + at(other, j);
        int sl = 3 * at(i, jl) + at(other, jl), sr = 3 * at(i, jr) + at(other, jr);
        left = (3 * s + sl + 8) >> 4;
        right = (3 * s + sr + 7) >> 4;
      }
      if (2 * j < W) o[2 * j] = static_cast<uint8_t>(left);
      if (2 * j + 1 < W) o[2 * j + 1] = static_cast<uint8_t>(right);
    }
  }
  return out;
}

inline uint8_t clip255(int64_t x) { return static_cast<uint8_t>(x < 0 ? 0 : x > 255 ? 255 : x); }

enum Colour { kGray = 0, kYcc = 1, kRgb = 2, kCmyk = 3, kYcck = 4 };

}  // namespace

extern "C" {

// The pixels of a decoded frame. ``comp`` holds, per component, 6 int32:
// horizontal and vertical upsampling ratio, blocks per row of its
// coefficient array, its rows and columns of samples (libjpeg's
// downsampled_height and downsampled_width), and 1 for a lossless frame
// (``coef[i]`` then holds int32 samples, not int16 coefficients);
// ``quant`` its (64,) int64 table in natural order. ``colour``: a Colour.
// ``out`` is (H, W, C) uint8: C 1 gray, 3 RGB, 4 Pillow's CMYK (inverted).
void jpeg_reconstruct(int H, int W, int n_comps, const int32_t* comp, const void* const* coef,
                      const int64_t* quant, int colour, uint8_t* out) {
  std::vector<std::vector<uint8_t>> planes;
  for (int i = 0; i < n_comps; ++i) {
    const int32_t* p = comp + i * 6;
    std::vector<uint8_t> samples;
    if (p[5]) {
      const int32_t* s = static_cast<const int32_t*>(coef[i]);
      samples.resize(static_cast<size_t>(p[3]) * p[4]);
      for (int y = 0; y < p[3]; ++y)
        for (int x = 0; x < p[4]; ++x)
          samples[static_cast<size_t>(y) * p[4] + x] = static_cast<uint8_t>(s[y * p[2] + x]);
    } else {
      samples = component_samples(static_cast<const int16_t*>(coef[i]), p[2], p[3], p[4],
                                  quant + i * 64);
    }
    planes.push_back(upsample(samples, p[3], p[4], p[0], p[1], H, W, !p[5]));
  }
  const size_t n = static_cast<size_t>(H) * W;
  if (colour == kGray) {
    std::memcpy(out, planes[0].data(), n);
    return;
  }
  const int C = n_comps == 4 ? 4 : 3;
  const int64_t half = int64_t{1} << 15;
  const int64_t cr_r = kFix(1.40200, 16), cb_g = kFix(0.34414, 16), cr_g = kFix(0.71414, 16),
                cb_b = kFix(1.77200, 16);
  for (size_t k = 0; k < n; ++k) {
    uint8_t* o = out + C * k;
    if (colour == kRgb || colour == kCmyk) {
      for (int c = 0; c < C; ++c) o[c] = colour == kCmyk ? 255 - planes[c][k] : planes[c][k];
      continue;
    }
    int64_t y = planes[0][k], cb = planes[1][k] - 128, cr = planes[2][k] - 128;
    o[0] = clip255(y + ((cr_r * cr + half) >> 16));
    o[1] = clip255(y + ((-cb_g * cb + half - cr_g * cr) >> 16));
    o[2] = clip255(y + ((cb_b * cb + half) >> 16));
    if (colour == kYcck) o[3] = 255 - planes[3][k];     // ycck_cmyk_convert, inverted
  }
}

}  // extern "C"
