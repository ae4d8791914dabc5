// Entropy decoding of one JPEG scan into quantised DCT coefficients (or, for
// a lossless frame, samples), and the reconstruction of the pixels from them.
//
// The native half of coma_tpu_torch/utils/jpeg.py: the Python side parses the
// markers, removes byte stuffing, splits the scan's data at its restart
// markers and holds the coefficient arrays. jpeg_decode_scan decodes a
// Huffman-coded scan into them, as libjpeg's jdhuff.c (sequential) and
// jdphuff.c (progressive: DC first and refine, AC first and refine with
// end-of-band runs) do; jpeg_decode_scan_arith an arithmetic-coded one
// (jdarith.c: the QM decoder, its statistics bins and the DAC conditioning);
// jpeg_decode_scan_lossless a lossless one (jdlhuff.c's differences, then
// jdlossls.c's undifferencing and point transform). Each result equals the
// plain Python decoder's (utils/jpeg.py) value for value. Reading past the end
// of a segment yields zero bits, as libjpeg supplies zeros at a marker.
// jpeg_smooth is jdcoefct.c's block smoothing of a progressive frame, and
// jpeg_reconstruct does what utils/jpeg.py:reconstruct does in numpy
// (libjpeg's jidctint.c islow IDCT and range limit, jdsample.c's upsampling,
// jdcolor.c's colour conversion), in the same integer arithmetic, so the
// pixels are equal too.
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

enum Status { kOk = 0, kBadCode = 1, kNoTable = 2, kFewSegments = 3, kBadTable = 4,
              kArithOverflow = 5 };

// int32 per component of a scan: h, v, blocks per row of its array, coded
// blocks per row and column, DC table, AC table, sample rows and columns,
// sample rows per restart interval (lossless)
constexpr int kComp = 10;

// A 16-bit lookahead table: entry (length << 8) | symbol, 0 where no code
// starts with those bits.
struct Table {
  std::vector<uint16_t> lookup;
  bool build(const uint8_t* spec) {
    if (!spec[0]) return false;
    lookup.assign(1 << 16, 0);
    const uint8_t* counts = spec + 1;
    const uint8_t* values = spec + 17;
    uint32_t code = 0;
    int k = 0;
    for (int len = 1; len <= 16; ++len) {
      for (int i = 0; i < counts[len - 1]; ++i, ++k, ++code) {
        if (k >= 256 || code >= (1u << len)) return false;
        uint32_t first = code << (16 - len), n = 1u << (16 - len);
        for (uint32_t j = 0; j < n; ++j)
          lookup[first + j] = static_cast<uint16_t>((len << 8) | values[k]);
      }
      code <<= 1;
    }
    return true;
  }
};

struct BitReader {
  const uint8_t* p = nullptr;
  const uint8_t* end = nullptr;
  uint64_t acc = 0;
  int nbits = 0;

  void reset(const uint8_t* begin, const uint8_t* stop) {
    p = begin;
    end = stop;
    acc = 0;
    nbits = 0;
  }
  void fill() {
    while (nbits <= 56) {
      uint64_t byte = p < end ? *p++ : 0;
      acc |= byte << (56 - nbits);
      nbits += 8;
    }
  }
  uint32_t get(int n) {
    if (n == 0) return 0;
    if (nbits < n) fill();
    uint32_t v = static_cast<uint32_t>(acc >> (64 - n));
    acc <<= n;
    nbits -= n;
    return v;
  }
  int symbol(const Table& t) {
    if (nbits < 16) fill();
    uint16_t e = t.lookup[acc >> 48];
    if (!e) return -1;
    int len = e >> 8;
    acc <<= len;
    nbits -= len;
    return e & 0xFF;
  }
};

inline int extend(uint32_t v, int s) {
  return v < (1u << (s - 1)) ? static_cast<int>(v) - (1 << s) + 1 : static_cast<int>(v);
}

struct Scan {
  int ss, se, ah, al;
  bool progressive;
  int eobrun = 0;
};

// One block of a scan; false on a code that no table entry starts.
bool decode_block(BitReader& br, const Table* dc, const Table* ac, int16_t* block, int& pred,
                  Scan& sc) {
  if (!sc.progressive) {
    int s = br.symbol(*dc);
    if (s < 0) return false;
    pred += s ? extend(br.get(s), s) : 0;
    block[0] = static_cast<int16_t>(pred);
    for (int k = 1; k < 64; ++k) {
      int rs = br.symbol(*ac);
      if (rs < 0) return false;
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        block[kNatural[k]] = static_cast<int16_t>(extend(br.get(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
    return true;
  }
  if (sc.ss == 0) {                       // DC scans
    if (sc.ah == 0) {
      int s = br.symbol(*dc);
      if (s < 0) return false;
      pred += s ? extend(br.get(s), s) : 0;
      block[0] = static_cast<int16_t>(static_cast<int>(static_cast<unsigned>(pred) << sc.al));
    } else if (br.get(1)) {
      block[0] = static_cast<int16_t>(block[0] | (1 << sc.al));
    }
    return true;
  }
  if (sc.ah == 0) {                       // AC first
    if (sc.eobrun > 0) {
      --sc.eobrun;
      return true;
    }
    for (int k = sc.ss; k <= sc.se; ++k) {
      int rs = br.symbol(*ac);
      if (rs < 0) return false;
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        int v = extend(br.get(s), s);
        block[kNatural[k]] = static_cast<int16_t>(static_cast<int>(static_cast<unsigned>(v) << sc.al));
      } else if (r == 15) {
        k += 15;
      } else {
        sc.eobrun = 1 << r;
        if (r) sc.eobrun += br.get(r);
        --sc.eobrun;
        break;
      }
    }
    return true;
  }
  // AC refine
  const int p1 = 1 << sc.al, m1 = -(1 << sc.al);
  int k = sc.ss;
  auto correct = [&](int16_t* c) {
    if (br.get(1) && (*c & p1) == 0) *c = static_cast<int16_t>(*c + (*c >= 0 ? p1 : m1));
  };
  if (sc.eobrun == 0) {
    for (; k <= sc.se; ++k) {
      int rs = br.symbol(*ac);
      if (rs < 0) return false;
      int r = rs >> 4, s = rs & 15;
      if (s) {
        s = br.get(1) ? p1 : m1;   // a newly nonzero coefficient has size 1
      } else if (r != 15) {
        sc.eobrun = 1 << r;
        if (r) sc.eobrun += br.get(r);
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
      if (s) block[kNatural[k]] = static_cast<int16_t>(s);
    }
  }
  if (sc.eobrun > 0) {
    for (; k <= sc.se; ++k) {
      int16_t* c = block + kNatural[k];
      if (*c != 0) correct(c);
    }
    --sc.eobrun;
  }
  return true;
}

// The units of each MCU in coding order: (component, offset of the unit in
// its array, ``unit`` elements per block: 64 for DCT blocks, 1 for lossless
// samples). A one-component scan codes the component's own extent.
std::vector<std::pair<int, int64_t>> mcu_units(int mcus_x, int mcus_y, int n_comps,
                                               const int32_t* comp, int64_t unit,
                                               int64_t& n_mcus, int& per_mcu) {
  std::vector<std::pair<int, int64_t>> units;
  if (n_comps == 1) {
    int64_t bw = comp[2], cw = comp[3], ch = comp[4];
    n_mcus = cw * ch;
    per_mcu = 1;
    units.reserve(n_mcus);
    for (int64_t y = 0; y < ch; ++y)
      for (int64_t x = 0; x < cw; ++x) units.emplace_back(0, (y * bw + x) * unit);
    return units;
  }
  n_mcus = static_cast<int64_t>(mcus_x) * mcus_y;
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

}  // namespace

extern "C" {

// Decodes one Huffman-coded scan. ``data`` holds the scan's segments (one per
// restart interval, stuffing removed) back to back; segment i is
// data[seg_start[i]:seg_start[i + 1]]. ``comp`` holds kComp int32 per
// component of the scan (the tables index ``tables``: 0-3 DC, 4-7 AC, each
// kTableBytes). ``coef[i]`` is component i's (rows, blocks per row, 64) int16
// array in natural order. Returns a Status.
int jpeg_decode_scan(const uint8_t* data, const int64_t* seg_start, int n_segments,
                     int mcus_x, int mcus_y, int restart_interval, int n_comps,
                     const int32_t* comp, int16_t* const* coef, const uint8_t* tables,
                     int ss, int se, int ah, int al, int progressive) {
  Table dc[4], ac[4];
  bool dc_ok[4] = {false, false, false, false}, ac_ok[4] = {false, false, false, false};
  Scan sc{ss, se, ah, al, progressive != 0};
  bool need_dc = !sc.progressive || (ss == 0 && ah == 0);
  bool need_ac = !sc.progressive || ss > 0;
  for (int i = 0; i < n_comps; ++i) {
    int d = comp[i * kComp + 5], a = comp[i * kComp + 6];
    if (need_dc && !dc_ok[d]) {
      if (!tables[d * kTableBytes]) return kNoTable;
      if (!dc[d].build(tables + d * kTableBytes)) return kBadTable;
      dc_ok[d] = true;
    }
    if (need_ac && !ac_ok[a]) {
      if (!tables[(4 + a) * kTableBytes]) return kNoTable;
      if (!ac[a].build(tables + (4 + a) * kTableBytes)) return kBadTable;
      ac_ok[a] = true;
    }
  }
  int64_t n_mcus;
  int per_mcu;
  std::vector<std::pair<int, int64_t>> units =
      mcu_units(mcus_x, mcus_y, n_comps, comp, 64, n_mcus, per_mcu);
  int64_t per_segment = restart_interval > 0 ? restart_interval : n_mcus;
  int64_t needed = n_mcus ? (n_mcus + per_segment - 1) / per_segment : 0;
  if (n_segments < needed) return kFewSegments;
  BitReader br;
  int pred[4];
  for (int64_t m = 0; m < n_mcus; ++m) {
    if (m % per_segment == 0) {
      int64_t s = m / per_segment;
      br.reset(data + seg_start[s], data + seg_start[s + 1]);
      std::memset(pred, 0, sizeof(pred));
      sc.eobrun = 0;
    }
    for (int b = 0; b < per_mcu; ++b) {
      const auto& u = units[m * per_mcu + b];
      int i = u.first;
      const Table* d = need_dc ? &dc[comp[i * kComp + 5]] : nullptr;
      const Table* a = need_ac ? &ac[comp[i * kComp + 6]] : nullptr;
      if (!decode_block(br, d, a, coef[i] + u.second, pred[i], sc)) return kBadCode;
    }
  }
  return kOk;
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
  const uint8_t* p = nullptr;
  const uint8_t* end = nullptr;
  int64_t c = 0, a = 0;
  int ct = -16;

  void reset(const uint8_t* begin, const uint8_t* stop) {
    p = begin;
    end = stop;
    c = 0;
    a = 0;
    ct = -16;
  }
  int bit(uint8_t* st) {
    while (a < 0x8000) {                         // renormalisation and input, D.2.6
      if (--ct < 0) {
        int data = p < end ? *p : 0;
        ++p;
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

// Figures F.23 and F.24 from bin ``st`` (then ``big`` onwards): the signed
// value, or false on a magnitude overflow.
bool arith_value(ArithDecoder& d, uint8_t* stats, int st, int sign, int big, int& out) {
  int m = d.bit(stats + st);
  if (m && d.bit(stats + st)) {
    m = 2;
    st = big;
    while (d.bit(stats + st)) {
      if ((m <<= 1) == 0x8000) return false;
      ++st;
    }
  }
  int v = m;
  st += 14;
  while (m >>= 1)
    if (d.bit(stats + st)) v |= m;
  ++v;
  out = sign ? -v : v;
  return true;
}

// Figure F.19 with F.1.4.4.1.2's conditioning: one DC difference.
bool arith_dc_diff(ArithDecoder& d, uint8_t* stats, int& ctx, int lo, int hi, int& out) {
  int st = ctx;
  if (d.bit(stats + st) == 0) {
    ctx = 0;
    out = 0;
    return true;
  }
  int sign = d.bit(stats + st + 1);
  st += 2 + sign;
  int m = d.bit(stats + st);
  if (m) {
    st = 20;
    while (d.bit(stats + st)) {
      if ((m <<= 1) == 0x8000) return false;
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
  out = sign ? -v : v;
  return true;
}

}  // namespace

extern "C" {

// Decodes one arithmetic-coded scan (sequential or progressive), as
// jpeg_decode_scan does a Huffman-coded one. ``cond`` holds 48 int32: the DC
// conditioning L and U of tables 0-15, then the AC K of tables 0-15.
int jpeg_decode_scan_arith(const uint8_t* data, const int64_t* seg_start, int n_segments,
                           int mcus_x, int mcus_y, int restart_interval, int n_comps,
                           const int32_t* comp, int16_t* const* coef, const int32_t* cond,
                           int ss, int se, int ah, int al, int progressive) {
  int64_t n_mcus;
  int per_mcu;
  std::vector<std::pair<int, int64_t>> units =
      mcu_units(mcus_x, mcus_y, n_comps, comp, 64, n_mcus, per_mcu);
  int64_t per_segment = restart_interval > 0 ? restart_interval : n_mcus;
  int64_t needed = n_mcus ? (n_mcus + per_segment - 1) / per_segment : 0;
  if (n_segments < needed) return kFewSegments;
  const bool sequential = !progressive;
  const int p1 = 1 << al, m1 = -(1 << al);
  uint8_t dc_stats[4][64], ac_stats[4][256], fixed = 113;
  int pred[4], ctx[4];
  ArithDecoder d;
  for (int64_t m = 0; m < n_mcus; ++m) {
    if (m % per_segment == 0) {
      int64_t s = m / per_segment;
      d.reset(data + seg_start[s], data + seg_start[s + 1]);
      std::memset(dc_stats, 0, sizeof(dc_stats));
      std::memset(ac_stats, 0, sizeof(ac_stats));
      std::memset(pred, 0, sizeof(pred));
      std::memset(ctx, 0, sizeof(ctx));
      fixed = 113;
    }
    for (int b = 0; b < per_mcu; ++b) {
      const auto& u = units[m * per_mcu + b];
      int i = u.first;
      int16_t* block = coef[i] + u.second;
      int td = comp[i * kComp + 5], ta = comp[i * kComp + 6];
      if (sequential || (ss == 0 && ah == 0)) {                    // DC
        int diff;
        if (!arith_dc_diff(d, dc_stats[td], ctx[i], cond[td], cond[16 + td], diff))
          return kArithOverflow;
        if (sequential) {
          pred[i] = (pred[i] + diff) & 0xFFFF;
          block[0] = static_cast<int16_t>(pred[i]);
        } else {
          pred[i] += diff;
          block[0] = static_cast<int16_t>(static_cast<int>(static_cast<unsigned>(pred[i]) << al));
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
            if (++k > last) return kArithOverflow;
          }
          int sign = d.bit(&fixed), v;
          if (!arith_value(d, stats, st + 2, sign, k <= kx ? 189 : 217, v))
            return kArithOverflow;
          block[kNatural[k]] = static_cast<int16_t>(
              sequential ? v : static_cast<int>(static_cast<unsigned>(v) << al));
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
            if (++k > se) return kArithOverflow;
          }
        }
      }
    }
  }
  return kOk;
}

// Decodes one lossless (SOF3) scan: the Huffman-coded differences of each
// sample, then each component's undifferencing with predictor ``ss`` (the
// first row of the scan and of each restart interval from the left, the
// first column from above, sums modulo 2^16) and the point transform ``al``,
// into ``samples[i]``, component i's (rows, columns) int32 array.
int jpeg_decode_scan_lossless(const uint8_t* data, const int64_t* seg_start, int n_segments,
                              int mcus_x, int mcus_y, int restart_interval, int n_comps,
                              const int32_t* comp, int32_t* const* samples,
                              const uint8_t* tables, int ss, int, int, int al, int) {
  Table dc[4];
  bool ok[4] = {false, false, false, false};
  for (int i = 0; i < n_comps; ++i) {
    int t = comp[i * kComp + 5];
    if (!ok[t]) {
      if (!tables[t * kTableBytes]) return kNoTable;
      if (!dc[t].build(tables + t * kTableBytes)) return kBadTable;
      ok[t] = true;
    }
  }
  int64_t n_mcus;
  int per_mcu;
  std::vector<std::pair<int, int64_t>> units =
      mcu_units(mcus_x, mcus_y, n_comps, comp, 1, n_mcus, per_mcu);
  int64_t per_segment = restart_interval > 0 ? restart_interval : n_mcus;
  int64_t needed = n_mcus ? (n_mcus + per_segment - 1) / per_segment : 0;
  if (n_segments < needed) return kFewSegments;
  BitReader br;
  for (int64_t m = 0; m < n_mcus; ++m) {
    if (m % per_segment == 0) {
      int64_t s = m / per_segment;
      br.reset(data + seg_start[s], data + seg_start[s + 1]);
    }
    for (int b = 0; b < per_mcu; ++b) {
      const auto& u = units[m * per_mcu + b];
      int i = u.first;
      int sym = br.symbol(dc[comp[i * kComp + 5]]);
      if (sym < 0) return kBadCode;
      samples[i][u.second] = sym == 16 ? 32768 : sym ? extend(br.get(sym), sym) : 0;
    }
  }
  for (int i = 0; i < n_comps; ++i) {
    const int32_t* p = comp + i * kComp;
    int64_t bw = p[2];
    int rows = p[7], cols = p[8], restart_rows = p[9];
    int32_t* out = samples[i];
    std::vector<int32_t> prev(cols), cur(cols);
    for (int y = 0; y < rows; ++y) {
      const int32_t* diff = out + y * bw;
      if (y == 0 || (restart_rows && y % restart_rows == 0)) {
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
  }
  return kOk;
}

}  // extern "C"

// Block smoothing (jdcoefct.c decompress_smooth_data, libjpeg-turbo >= 2.1) --

extern "C" {

// Writes into ``out`` (a copy of ``in``, (rows_held, bw, 64) int16) the
// blocks a progressive frame's IDCT receives after libjpeg's block smoothing:
// hb x wb real blocks, ``v`` block rows per iMCU row, ``quant`` the (64,)
// table in natural order, ``bits`` coef_bits of zig-zag positions 0-9. The
// neighbourhood follows utils/jpeg.py:_smoothing_rows and _smoothing_cols.
void jpeg_smooth(const int16_t* in, int16_t* out, int bw, int rows_held, int hb, int wb, int v,
                 const int64_t* quant, const int32_t* bits) {
  static const int kPos[9] = {1, 8, 16, 9, 2, 3, 10, 17, 24};
  const int padded = (hb + v - 1) / v * v, last_start = (hb - 1) / v * v;
  auto dc = [&](int r, int c) -> int64_t {
    return r < rows_held ? in[(static_cast<int64_t>(r) * bw + c) * 64] : 0;
  };
  bool change_dc = true;
  for (int k = 1; k <= 9; ++k) change_dc = change_dc && bits[k] == -1;
  for (int r = 0; r < hb; ++r) {
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

inline int64_t descale(int64_t x, int n) { return (x + (int64_t{1} << (n - 1))) >> n; }

// One pass of jpeg_idct_islow over 8 values d[0], d[step], ..., d[7 step].
void idct_1d(const int64_t* d, int step, int64_t* out, int ostep, bool final) {
  int64_t z2 = d[2 * step], z3 = d[6 * step];
  int64_t z1 = (z2 + z3) * F0541;
  int64_t tmp2 = z1 + z3 * (-F1847), tmp3 = z1 + z2 * F0765;
  int64_t tmp0 = (d[0] + d[4 * step]) * (int64_t{1} << 13);
  int64_t tmp1 = (d[0] - d[4 * step]) * (int64_t{1} << 13);
  int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  tmp0 = d[7 * step];
  tmp1 = d[5 * step];
  tmp2 = d[3 * step];
  tmp3 = d[step];
  z1 = tmp0 + tmp3;
  z2 = tmp1 + tmp2;
  z3 = tmp0 + tmp2;
  int64_t z4 = tmp1 + tmp3, z5 = (z3 + z4) * F1175;
  tmp0 *= F0298;
  tmp1 *= F2053;
  tmp2 *= F3072;
  tmp3 *= F1501;
  z1 *= -F0899;
  z2 *= -F2562;
  z3 = z3 * (-F1961) + z5;
  z4 = z4 * (-F0390) + z5;
  tmp0 += z1 + z3;
  tmp1 += z2 + z4;
  tmp2 += z2 + z3;
  tmp3 += z1 + z4;
  int shift = final ? 13 + 2 + 3 : 13 - 2;
  out[0] = descale(tmp10 + tmp3, shift);
  out[ostep] = descale(tmp11 + tmp2, shift);
  out[2 * ostep] = descale(tmp12 + tmp1, shift);
  out[3 * ostep] = descale(tmp13 + tmp0, shift);
  out[4 * ostep] = descale(tmp13 - tmp0, shift);
  out[5 * ostep] = descale(tmp12 - tmp1, shift);
  out[6 * ostep] = descale(tmp11 - tmp2, shift);
  out[7 * ostep] = descale(tmp10 - tmp3, shift);
}

// IDCT_range_limit indexed by x & 1023 (x the centred output)
inline uint8_t range_limit(int64_t x) {
  int v = static_cast<int>(x & 1023);
  return static_cast<uint8_t>(v < 128 ? v + 128 : v < 512 ? 255 : v < 896 ? 0 : v - 896);
}

// One component's samples (rows x cols) from its coefficients.
std::vector<uint8_t> component_samples(const int16_t* coef, int64_t blocks_per_row, int rows,
                                       int cols, const int64_t* quant) {
  std::vector<uint8_t> out(static_cast<size_t>(rows) * cols);
  int nby = (rows + 7) / 8, nbx = (cols + 7) / 8;
  int64_t d[64], ws[64], px[64];
  for (int by = 0; by < nby; ++by)
    for (int bx = 0; bx < nbx; ++bx) {
      const int16_t* c = coef + (by * blocks_per_row + bx) * 64;
      for (int k = 0; k < 64; ++k) d[k] = static_cast<int64_t>(c[k]) * quant[k];
      for (int col = 0; col < 8; ++col) idct_1d(d + col, 8, ws + col, 8, false);
      for (int row = 0; row < 8; ++row) idct_1d(ws + row * 8, 1, px + row * 8, 1, true);
      for (int r = 0; r < 8 && by * 8 + r < rows; ++r)
        for (int x = 0; x < 8 && bx * 8 + x < cols; ++x)
          out[static_cast<size_t>(by * 8 + r) * cols + bx * 8 + x] = range_limit(px[r * 8 + x]);
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
