// The CCITT run decoder and the Zstandard frame decoder of TIFF strips
// (coma_tpu_torch/utils/tiff_codecs.py). Each equals its plain Python twin
// (fax_decode_python, zstd_decode_python) byte for byte and status for
// status; these exist because a 2048 x 1536 strip takes seconds in Python.
//
// CCITT follows libtiff 4.7.1's tif_fax3.c (the EXPAND1D and EXPAND2D
// macros, SYNC_EOL, CLEANUP_RUNS and _TIFFFax3fillruns), Zstandard RFC 8878
// with libzstd 1.5.7's checks as ZSTD_decompressStream meets them.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 tiff_codecs.cpp (native/__init__.py
// does it at first use).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

// ------------------------------------------------------------------ CCITT

enum { S_NULL, S_PASS, S_HORIZ, S_V0, S_VR, S_VL, S_EXT, S_TERMW, S_TERMB, S_MAKEUPW,
       S_MAKEUPB, S_MAKEUP, S_EOL };

struct Entry {
  uint8_t state, width;
  int32_t param;
};

const char* WHITE_TERM[] = {
    "00110101", "000111", "0111", "1000", "1011", "1100", "1110", "1111", "10011", "10100",
    "00111", "01000", "001000", "000011", "110100", "110101", "101010", "101011", "0100111",
    "0001100", "0001000", "0010111", "0000011", "0000100", "0101000", "0101011", "0010011",
    "0100100", "0011000", "00000010", "00000011", "00011010", "00011011", "00010010",
    "00010011", "00010100", "00010101", "00010110", "00010111", "00101000", "00101001",
    "00101010", "00101011", "00101100", "00101101", "00000100", "00000101", "00001010",
    "00001011", "01010010", "01010011", "01010100", "01010101", "00100100", "00100101",
    "01011000", "01011001", "01011010", "01011011", "01001010", "01001011", "00110010",
    "00110011", "00110100"};
const char* WHITE_MAKEUP[] = {
    "11011", "10010", "010111", "0110111", "00110110", "00110111", "01100100", "01100101",
    "01101000", "01100111", "011001100", "011001101", "011010010", "011010011", "011010100",
    "011010101", "011010110", "011010111", "011011000", "011011001", "011011010", "011011011",
    "010011000", "010011001", "010011010", "011000", "010011011"};
const char* BLACK_TERM[] = {
    "0000110111", "010", "11", "10", "011", "0011", "0010", "00011", "000101", "000100",
    "0000100", "0000101", "0000111", "00000100", "00000111", "000011000", "0000010111",
    "0000011000", "0000001000", "00001100111", "00001101000", "00001101100", "00000110111",
    "00000101000", "00000010111", "00000011000", "000011001010", "000011001011",
    "000011001100", "000011001101", "000001101000", "000001101001", "000001101010",
    "000001101011", "000011010010", "000011010011", "000011010100", "000011010101",
    "000011010110", "000011010111", "000001101100", "000001101101", "000011011010",
    "000011011011", "000001010100", "000001010101", "000001010110", "000001010111",
    "000001100100", "000001100101", "000001010010", "000001010011", "000000100100",
    "000000110111", "000000111000", "000000100111", "000000101000", "000001011000",
    "000001011001", "000000101011", "000000101100", "000001011010", "000001100110",
    "000001100111"};
const char* BLACK_MAKEUP[] = {
    "0000001111", "000011001000", "000011001001", "000001011011", "000000110011",
    "000000110100", "000000110101", "0000001101100", "0000001101101", "0000001001010",
    "0000001001011", "0000001001100", "0000001001101", "0000001110010", "0000001110011",
    "0000001110100", "0000001110101", "0000001110110", "0000001110111", "0000001010010",
    "0000001010011", "0000001010100", "0000001010101", "0000001011010", "0000001011011",
    "0000001100100", "0000001100101"};
const char* COMMON_MAKEUP[] = {
    "00000001000", "00000001100", "00000001101", "000000010010", "000000010011",
    "000000010100", "000000010101", "000000010110", "000000010111", "000000011100",
    "000000011101", "000000011110", "000000011111"};

void fill_table(std::vector<Entry>& t, const char* code, int state, int param) {
  const int width = static_cast<int>(strlen(code));
  int value = 0;
  for (int i = width - 1; i >= 0; --i) value = value << 1 | (code[i] - '0');
  for (size_t i = value; i < t.size(); i += size_t(1) << width)
    t[i] = Entry{static_cast<uint8_t>(state), static_cast<uint8_t>(width), param};
}

struct FaxTables {
  std::vector<Entry> white, black, main;
  FaxTables() : white(1 << 12), black(1 << 13), main(1 << 7) {
    for (int k = 0; k < 27; ++k) {
      fill_table(white, WHITE_MAKEUP[k], S_MAKEUPW, 64 * (k + 1));
      fill_table(black, BLACK_MAKEUP[k], S_MAKEUPB, 64 * (k + 1));
    }
    for (int k = 0; k < 13; ++k) {
      fill_table(white, COMMON_MAKEUP[k], S_MAKEUP, 1792 + 64 * k);
      fill_table(black, COMMON_MAKEUP[k], S_MAKEUP, 1792 + 64 * k);
    }
    for (int k = 0; k < 64; ++k) {
      fill_table(white, WHITE_TERM[k], S_TERMW, k);
      fill_table(black, BLACK_TERM[k], S_TERMB, k);
    }
    fill_table(white, "00000000000", S_EOL, 0);
    fill_table(black, "00000000000", S_EOL, 0);
    fill_table(main, "0001", S_PASS, 0);
    fill_table(main, "001", S_HORIZ, 0);
    fill_table(main, "1", S_V0, 0);
    fill_table(main, "011", S_VR, 1);
    fill_table(main, "000011", S_VR, 2);
    fill_table(main, "0000011", S_VR, 3);
    fill_table(main, "010", S_VL, 1);
    fill_table(main, "000010", S_VL, 2);
    fill_table(main, "0000010", S_VL, 3);
    fill_table(main, "0000001", S_EXT, 0);
    fill_table(main, "0000000", S_EOL, 0);
  }
};

const FaxTables& fax_tables() {
  static const FaxTables tables;
  return tables;
}

uint8_t reversed_byte(uint8_t b) {
  b = static_cast<uint8_t>((b & 0xF0) >> 4 | (b & 0x0F) << 4);
  b = static_cast<uint8_t>((b & 0xCC) >> 2 | (b & 0x33) << 2);
  return static_cast<uint8_t>((b & 0xAA) >> 1 | (b & 0x55) << 1);
}

struct Eof {};
struct NoEol {};
struct Fail {};

enum { FAX_RLE = 2, FAX_G3 = 3, FAX_G4 = 4, FAX_RLEW = 32771 };

// libtiff's int32_t a0, b1 and RunLength: modulo 2^32, signed
int32_t i32(int64_t v) { return static_cast<int32_t>(static_cast<uint32_t>(v)); }

struct Fax {
  const uint8_t* data;
  int64_t cp = 0, ep;
  int parity;
  uint64_t acc = 0;
  int avail = 0, eolcnt = 0;
  int32_t lastx;
  int64_t nruns;
  uint32_t* cur;  // the run arrays, carried from strip to strip
  uint32_t* ref;
  int32_t a0 = 0, run_length = 0, b1 = 0;
  int64_t pa = 0, pb = 0;
  const FaxTables& t = fax_tables();

  Fax(const uint8_t* d, int64_t n, int par, int64_t width, uint32_t* first, uint32_t* second,
      int64_t runs)
      : data(d), ep(n), parity(par), lastx(static_cast<int32_t>(width)), nruns(runs),
        cur(first), ref(second) {}

  uint64_t byte_at(int64_t i) const { return reversed_byte(data[i]); }

  void need8(int n) {
    if (avail < n) {
      if (cp >= ep) {
        if (avail == 0) throw Eof{};
        avail = n;
      } else {
        acc |= byte_at(cp++) << avail;
        avail += 8;
      }
    }
  }
  void need16(int n) {
    if (avail < n) {
      if (cp >= ep) {
        if (avail == 0) throw Eof{};
        avail = n;
      } else {
        acc |= byte_at(cp++) << avail;
        avail += 8;
        if (avail < n) {
          if (cp >= ep) {
            avail = n;
          } else {
            acc |= byte_at(cp++) << avail;
            avail += 8;
          }
        }
      }
    }
  }
  uint32_t bits(int n) const { return static_cast<uint32_t>(acc & ((uint64_t(1) << n) - 1)); }
  void clear(int n) {
    avail -= n;
    acc >>= n;
  }
  const Entry& lookup(int wid) {
    if (wid <= 8) need8(wid); else need16(wid);
    const std::vector<Entry>& table = wid == 12 ? t.white : wid == 13 ? t.black : t.main;
    const Entry& e = table[bits(wid)];
    clear(e.width);
    return e;
  }
  void setvalue(int64_t x) {
    if (pa >= nruns) throw Fail{};
    cur[pa++] = static_cast<uint32_t>(run_length + x);
    a0 = i32(a0 + x);
    run_length = 0;
  }
  void cleanup() {
    if (run_length) setvalue(0);
    if (a0 != lastx) {
      while (a0 > lastx && pa > 0) a0 = i32(static_cast<int64_t>(a0) - cur[--pa]);
      if (a0 < lastx) {
        if (a0 < 0) a0 = 0;
        if (pa & 1) setvalue(0);
        setvalue(static_cast<int64_t>(lastx) - a0);
      } else if (a0 > lastx) {
        setvalue(lastx);
        setvalue(0);
      }
    }
  }
  void sync_eol() {
    if (eolcnt == 0) {
      for (;;) {
        need16(11);
        if (bits(11) == 0) break;
        clear(1);
      }
    }
    for (;;) {
      try {
        need8(8);
      } catch (Eof&) {
        throw NoEol{};
      }
      if (bits(8)) break;
      clear(8);
    }
    while (bits(1) == 0) clear(1);
    clear(1);
    eolcnt = 0;
  }
  void makeup(int32_t param) {
    a0 = i32(static_cast<int64_t>(a0) + param);
    run_length = i32(static_cast<int64_t>(run_length) + param);
  }
  bool colour_run(int wid, int term) {
    for (;;) {
      const Entry& e = lookup(wid);
      if (e.state == term) {
        setvalue(e.param);
        return true;
      }
      if (e.state == S_MAKEUPW || e.state == S_MAKEUPB || e.state == S_MAKEUP) {
        makeup(e.param);
      } else {
        return false;
      }
    }
  }
  void expand1d() {
    try {
      for (;;) {
        for (;;) {
          const Entry& e = lookup(12);
          if (e.state == S_EOL) {
            eolcnt = 1;
            cleanup();
            return;
          }
          if (e.state == S_TERMW) {
            setvalue(e.param);
            break;
          }
          if (e.state == S_MAKEUPW || e.state == S_MAKEUP) {
            makeup(e.param);
          } else {
            cleanup();
            return;
          }
        }
        if (a0 >= lastx) {
          cleanup();
          return;
        }
        for (;;) {
          const Entry& e = lookup(13);
          if (e.state == S_EOL) {
            eolcnt = 1;
            cleanup();
            return;
          }
          if (e.state == S_TERMB) {
            setvalue(e.param);
            break;
          }
          if (e.state == S_MAKEUPB || e.state == S_MAKEUP) {
            makeup(e.param);
          } else {
            cleanup();
            return;
          }
        }
        if (a0 >= lastx) {
          cleanup();
          return;
        }
        if (cur[pa - 1] == 0 && cur[pa - 2] == 0) pa -= 2;
      }
    } catch (Eof&) {
      cleanup();
      throw;
    }
  }
  void check_b1() {
    if (pa != 0) {
      while (b1 <= a0 && b1 < lastx) {
        if (pb + 1 >= nruns) throw Fail{};
        b1 = i32(static_cast<int64_t>(b1) + ref[pb] + ref[pb + 1]);
        pb += 2;
      }
    }
  }
  void expand2d() {
    try {
      while (a0 < lastx) {
        if (pa >= nruns) throw Fail{};
        const Entry& e = lookup(7);
        switch (e.state) {
          case S_PASS:
            check_b1();
            if (pb + 1 >= nruns) throw Fail{};
            b1 = i32(static_cast<int64_t>(b1) + ref[pb++]);
            run_length = i32(static_cast<int64_t>(run_length) + b1 - a0);
            a0 = b1;
            b1 = i32(static_cast<int64_t>(b1) + ref[pb++]);
            break;
          case S_HORIZ: {
            bool good = (pa & 1) ? colour_run(13, S_TERMB) && colour_run(12, S_TERMW)
                                 : colour_run(12, S_TERMW) && colour_run(13, S_TERMB);
            if (!good) {
              cleanup();
              return;
            }
            check_b1();
            break;
          }
          case S_V0:
          case S_VR:
            check_b1();
            setvalue(static_cast<int64_t>(b1) - a0 + e.param);
            if (pb >= nruns) throw Fail{};
            b1 = i32(static_cast<int64_t>(b1) + ref[pb++]);
            break;
          case S_VL:
            check_b1();
            if (b1 < a0 + e.param) {
              cleanup();
              return;
            }
            setvalue(static_cast<int64_t>(b1) - a0 - e.param);
            b1 = i32(static_cast<int64_t>(b1) - ref[--pb]);
            break;
          case S_EXT:
            cur[pa++] = static_cast<uint32_t>(static_cast<int64_t>(lastx) - a0);
            cleanup();
            return;
          default:  // S_EOL
            cur[pa++] = static_cast<uint32_t>(static_cast<int64_t>(lastx) - a0);
            need8(4);
            clear(4);
            eolcnt = 1;
            cleanup();
            return;
        }
      }
      if (run_length) {
        if (static_cast<int64_t>(run_length) + a0 < lastx) {
          need8(1);
          if (!bits(1)) {
            cleanup();
            return;
          }
          clear(1);
        }
        setvalue(0);
      }
      cleanup();
    } catch (Eof&) {
      cleanup();
      throw;
    }
  }
  void align(int compression) {
    if (compression == FAX_RLE) {
      clear(avail & 7);
    } else {
      clear(avail & 15);
      if (avail == 0 && ((parity + cp) & 1)) ++cp;
    }
  }
};

// _TIFFFax3fillruns, in its uint32_t arithmetic
void fax_fill(uint8_t* row, uint32_t* runs, int64_t pa, uint32_t lastx, int64_t cap) {
  if ((pa & 1) && pa < cap) runs[pa++] = 0;
  uint32_t x = 0;
  for (int64_t k = 0; k < pa; ++k) {
    uint32_t run = runs[k];
    if (x + run > lastx || run > lastx) run = runs[k] = lastx - x;
    if (run) {
      const int black = static_cast<int>(k & 1);
      for (uint32_t i = x; i < x + run; ++i) {
        const uint8_t bit = static_cast<uint8_t>(0x80 >> (i & 7));
        if (black) row[i >> 3] |= bit; else row[i >> 3] &= static_cast<uint8_t>(~bit);
      }
      x += runs[k];
    }
  }
}

// ------------------------------------------------------------- Zstandard

struct ZError {
  std::string what;
};

[[noreturn]] void zfail(const char* what) { throw ZError{what}; }

int highbit(uint64_t v) { return 63 - __builtin_clzll(v); }

const uint32_t LL_BASE[36] = {0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11,
                              12, 13, 14, 15, 16, 18, 20, 22, 24, 28, 32, 40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t ML_BASE_TAIL[21] = {35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99,
                                   131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t ML_BITS_TAIL[21] = {1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15,
                                  16};
const int16_t LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};

struct FseEntry {
  uint16_t symbol;
  uint8_t nbits;
  int32_t base;       // the next state's base
  uint32_t value;     // the symbol's base value (sequences)
  uint8_t extra;      // its extra bits
};

using FseTable = std::vector<FseEntry>;

struct SeqKind {
  int max_symbol, max_log, default_log;
  std::vector<uint32_t> bases;
  std::vector<uint8_t> extra;
  std::vector<int16_t> defaults;
};

const SeqKind& seq_kind(int k) {
  static const SeqKind kinds[3] = {
      [] {
        SeqKind s{35, 9, 6, {}, {}, {}};
        s.bases.assign(LL_BASE, LL_BASE + 36);
        s.extra.assign(LL_BITS, LL_BITS + 36);
        s.defaults.assign(LL_DEFAULT, LL_DEFAULT + 36);
        return s;
      }(),
      [] {
        SeqKind s{31, 8, 5, {}, {}, {}};
        for (int c = 0; c < 32; ++c) {
          s.bases.push_back(c < 2 ? c : (1u << c) - 3);
          s.extra.push_back(static_cast<uint8_t>(c));
        }
        const int16_t d[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                               1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
        s.defaults.assign(d, d + 29);
        return s;
      }(),
      [] {
        SeqKind s{52, 9, 6, {}, {}, {}};
        for (int c = 0; c < 32; ++c) {
          s.bases.push_back(c + 3);
          s.extra.push_back(0);
        }
        s.bases.insert(s.bases.end(), ML_BASE_TAIL, ML_BASE_TAIL + 21);
        s.extra.insert(s.extra.end(), ML_BITS_TAIL, ML_BITS_TAIL + 21);
        s.defaults = {1, 4, 3, 2, 2, 2, 2, 2, 2};
        s.defaults.insert(s.defaults.end(), 37, 1);
        s.defaults.insert(s.defaults.end(), 7, -1);
        return s;
      }()};
  return kinds[k];
}

// FSE_readNCount: the counts and accuracy log; returns the position after it
int64_t read_ncount(const uint8_t* data, int64_t pos, int64_t end, int max_symbol,
                    std::vector<int16_t>& counts, int& log) {
  const int64_t avail = end - pos;
  if (avail <= 0) zfail("an empty FSE table description");
  auto peek = [&](int64_t bit, int n) -> uint32_t {
    uint64_t v = 0;
    for (int i = 0; i < 5; ++i) {
      const int64_t at = pos + (bit >> 3) + i;
      if (at < end) v |= static_cast<uint64_t>(data[at]) << (8 * i);
    }
    return static_cast<uint32_t>((v >> (bit & 7)) & ((uint64_t(1) << n) - 1));
  };
  log = static_cast<int>(data[pos] & 15) + 5;
  if (log > 15) zfail("an FSE accuracy log over 15");
  int64_t bit = 4;
  int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1;
  bool previous0 = false;
  counts.clear();
  for (;;) {
    if (previous0) {
      while (peek(bit, 2) == 3) {
        counts.insert(counts.end(), 3, 0);
        bit += 2;
      }
      counts.insert(counts.end(), peek(bit, 2), 0);
      bit += 2;
      if (static_cast<int>(counts.size()) >= max_symbol + 1) break;
    }
    const int mx = 2 * threshold - 1 - remaining;
    const int low = static_cast<int>(peek(bit, nbits - 1));
    int count;
    if (low < mx) {
      count = low;
      bit += nbits - 1;
    } else {
      count = static_cast<int>(peek(bit, nbits));
      if (count >= threshold) count -= mx;
      bit += nbits;
    }
    --count;
    remaining -= count < 0 ? -count : count;
    counts.push_back(static_cast<int16_t>(count));
    previous0 = count == 0;
    if (remaining < threshold) {
      if (remaining <= 1) break;
      nbits = highbit(static_cast<uint64_t>(remaining)) + 1;
      threshold = 1 << (nbits - 1);
    }
    if (static_cast<int>(counts.size()) >= max_symbol + 1) break;
  }
  if (remaining != 1) zfail("an FSE table description whose counts do not add up");
  if (static_cast<int>(counts.size()) > max_symbol + 1)
    zfail("an FSE table description of too many symbols");
  const int64_t size = (bit + 7) >> 3;
  if (size > avail) zfail("an FSE table description past its section");
  return pos + size;
}

FseTable build_fse(const std::vector<int16_t>& counts, int log, const SeqKind* kind) {
  const int size = 1 << log;
  std::vector<uint16_t> symbols(size, 0);
  std::vector<int> next(counts.begin(), counts.end());
  int high = size - 1;
  for (size_t s = 0; s < counts.size(); ++s) {
    if (counts[s] == -1) {
      symbols[high--] = static_cast<uint16_t>(s);
      next[s] = 1;
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  int pos = 0;
  for (size_t s = 0; s < counts.size(); ++s) {
    for (int i = 0; i < counts[s]; ++i) {
      symbols[pos] = static_cast<uint16_t>(s);
      pos = (pos + step) & mask;
      while (pos > high) pos = (pos + step) & mask;
    }
  }
  if (pos != 0) zfail("an FSE table that does not spread");
  FseTable table(size);
  for (int u = 0; u < size; ++u) {
    const uint16_t s = symbols[u];
    const int state = next[s]++;
    const int nb = log - highbit(static_cast<uint64_t>(state));
    FseEntry e{s, static_cast<uint8_t>(nb), (state << nb) - size, 0, 0};
    if (kind) {
      e.value = kind->bases[s];
      e.extra = kind->extra[s];
    }
    table[u] = e;
  }
  return table;
}

struct Backward {
  const uint8_t* data;
  int64_t start, pos;

  Backward(const uint8_t* d, int64_t s, int64_t e, bool unmarked = false) : data(d), start(s) {
    if (e <= s) zfail("an empty bit stream");
    const uint8_t last = d[e - 1];
    if (last == 0) {
      if (!unmarked) zfail("a bit stream without its end mark");
      pos = (e - s) * 8;  // HUF_initFastDStream: no mark, every bit read
    } else {
      pos = (e - 1 - s) * 8 + highbit(last);
    }
  }
  uint64_t window(int64_t p, int n) const {   // n bits from bit p (>= 0), n <= 57
    const int64_t i = p >> 3;
    uint64_t v = 0;
    const int bytes = static_cast<int>(((p & 7) + n + 7) >> 3);
    for (int k = 0; k < bytes; ++k) v |= static_cast<uint64_t>(data[start + i + k]) << (8 * k);
    return (v >> (p & 7)) & ((uint64_t(1) << n) - 1);
  }
  uint64_t read(int n) {
    if (n == 0) return 0;
    pos -= n;
    if (pos >= 0) return window(pos, n);
    if (pos + n <= 0) return 0;
    return (window(0, static_cast<int>(pos + n)) << -pos) & ((uint64_t(1) << n) - 1);
  }
  uint64_t peek(int n) {
    const uint64_t v = read(n);
    pos += n;
    return v;
  }
  bool overflowed() const { return pos < 0; }
  bool done() const { return pos == 0; }
};

struct Huffman {
  std::vector<uint8_t> symbol, length;
  int log = 0;
  bool x2 = false;  // libzstd built its double-symbol table (HUF_selectDecoder)
};

// HUF_selectDecoder's timings (tableTime, decode256Time) of the single- and
// double-symbol decoders by Q, the compressed size in 16ths of the output
const uint32_t ALGO_TIME[16][4] = {
    {0, 0, 1, 1},         {0, 0, 1, 1},         {150, 216, 381, 119}, {170, 205, 514, 112},
    {177, 199, 539, 110}, {197, 194, 644, 107}, {221, 192, 735, 107}, {256, 189, 881, 106},
    {359, 188, 1167, 109}, {582, 187, 1570, 114}, {688, 187, 1712, 122}, {825, 186, 1965, 136},
    {976, 185, 2131, 150}, {1180, 186, 2070, 175}, {1377, 185, 1731, 202},
    {1412, 185, 1695, 202}};

bool selects_x2(int64_t size, int64_t csize) {
  const int q = csize >= size ? 15 : static_cast<int>(csize * 16 / size);
  const uint64_t d = static_cast<uint64_t>(size) >> 8;
  uint64_t time1 = ALGO_TIME[q][2] + ALGO_TIME[q][3] * d;
  time1 += time1 >> 5;
  return time1 < ALGO_TIME[q][0] + ALGO_TIME[q][1] * d;
}

int64_t huffman_weights(const uint8_t* data, int64_t pos, int64_t end, Huffman& h) {
  if (pos >= end) zfail("no Huffman tree description");
  const int head = data[pos];
  std::vector<int> weights;
  int64_t size;
  if (head >= 128) {
    const int n = head - 127;
    size = (n + 1) / 2;
    if (pos + 1 + size > end) zfail("a Huffman tree description past its section");
    for (int k = 0; k < n; ++k) {
      const uint8_t b = data[pos + 1 + k / 2];
      weights.push_back(k % 2 == 0 ? b >> 4 : b & 15);
    }
  } else {
    size = head;
    if (pos + 1 + size > end) zfail("a Huffman tree description past its section");
    std::vector<int16_t> counts;
    int log;
    const int64_t after = read_ncount(data, pos + 1, pos + 1 + size, 255, counts, log);
    if (log > 6) zfail("a Huffman weight table over accuracy log 6");
    const FseTable table = build_fse(counts, log, nullptr);
    Backward bits(data, after, pos + 1 + size);
    int64_t s1 = static_cast<int64_t>(bits.read(log)), s2 = static_cast<int64_t>(bits.read(log));
    for (;;) {
      if (weights.size() > 253) zfail("a Huffman tree of too many weights");
      weights.push_back(table[s1].symbol);
      s1 = table[s1].base + static_cast<int64_t>(bits.read(table[s1].nbits));
      if (bits.overflowed()) {
        weights.push_back(table[s2].symbol);
        break;
      }
      if (weights.size() > 253) zfail("a Huffman tree of too many weights");
      weights.push_back(table[s2].symbol);
      s2 = table[s2].base + static_cast<int64_t>(bits.read(table[s2].nbits));
      if (bits.overflowed()) {
        weights.push_back(table[s1].symbol);
        break;
      }
    }
  }
  uint32_t total = 0;
  for (int w : weights) {
    if (w > 12) zfail("a Huffman weight over 12");
    if (w) total += 1u << (w - 1);
  }
  if (total == 0) zfail("a Huffman tree of no weights");
  const int log = highbit(total) + 1;
  if (log > 12) zfail("a Huffman tree deeper than 12");
  const uint32_t rest = (1u << log) - total;
  if (rest & (rest - 1)) zfail("a Huffman tree whose last weight is not a power of 2");
  weights.push_back(highbit(rest) + 1);
  int ones = 0;
  for (int w : weights) ones += w == 1;
  if (ones < 2 || (ones & 1)) zfail("a Huffman tree of an odd count of the longest codes");
  h.log = log;
  h.symbol.assign(size_t(1) << log, 0);
  h.length.assign(size_t(1) << log, 0);
  uint32_t code = 0;
  for (int length = log; length >= 1; --length) {
    for (size_t s = 0; s < weights.size(); ++s) {
      if (weights[s] && log + 1 - weights[s] == length) {
        const uint32_t span = 1u << (log - length);
        for (uint32_t i = code; i < code + span; ++i) {
          h.symbol[i] = static_cast<uint8_t>(s);
          h.length[i] = static_cast<uint8_t>(length);
        }
        code += span;
      }
    }
  }
  return pos + 1 + size;
}

// n symbols of one stream; floor >= 0: libzstd's fast 4-stream decoder,
// which reads on below the stream down to floor and checks only the count.
// ``reads`` (if given) gets the bits read from the stream's end after each
// symbol, its end mark included.
void huffman_stream(const uint8_t* data, int64_t start, int64_t end, const Huffman& h, int64_t n,
                    std::vector<uint8_t>& out, int64_t floor = -1,
                    std::vector<int64_t>* reads = nullptr) {
  const int64_t own = start;
  if (floor >= 0) {
    if (end <= start) zfail("an empty bit stream");
    start = floor;
  }
  Backward bits(data, start, end, floor >= 0);
  const int64_t top = bits.pos, pad = (end - own) * 8 - (top - (own - start) * 8);
  if (reads) reads->assign(1, pad);
  for (int64_t i = 0; i < n; ++i) {
    const uint64_t key = bits.peek(h.log);
    out.push_back(h.symbol[key]);
    bits.read(h.length[key]);
    if (reads) reads->push_back(pad + top - bits.pos);
  }
  if (floor < 0 && !bits.done()) zfail("a Huffman stream not read to its end");
}

// HUF_decompress4X1_usingDTable_internal_fast's bounds (see _fast_loop_x1):
// the symbols each stream decodes in the fast loop
int64_t fast_loop_x1(const int64_t* starts, const int64_t* sizes,
                     const std::vector<int64_t>* reads, int64_t lowest, int64_t last) {
  auto ip = [&](int k, int64_t j) { return starts[k] + sizes[k] - 8 - reads[k][j] / 8; };
  int64_t j = 0;
  for (;;) {
    const int64_t iters = std::min((last - j) / 5, (ip(0, j) - lowest) / 7);
    if (iters <= 0 || ip(1, j) < ip(0, j) || ip(2, j) < ip(1, j) || ip(3, j) < ip(2, j)) break;
    j += 5 * iters;
  }
  for (int k = 0; k < 4; ++k)
    if (ip(k, j) < starts[k] - 8)
      zfail("a Huffman stream read past its start (libzstd's fast decoder)");
  return j;
}

// HUF_decompress4X2_usingDTable_internal_fast's bounds (see _fast_loop_x2):
// two symbols a lookup where both codes fit in 11 bits; corruption where a
// stream passes its segment or reads more than 8 bytes below its start
void fast_loop_x2(const int64_t* starts, const int64_t* sizes, const std::vector<int64_t>* reads,
                  int64_t lowest, const int64_t* counts) {
  int64_t done[4] = {0, 0, 0, 0};
  auto ip = [&](int k) { return starts[k] + sizes[k] - 8 - reads[k][done[k]] / 8; };
  auto lookup = [&](int k) {
    const std::vector<int64_t>& r = reads[k];
    const size_t j = static_cast<size_t>(done[k]);
    const int64_t first = r[j + 1] - r[j];
    done[k] += (j + 2 < r.size() && first + r[j + 2] - r[j + 1] <= 11) ? 2 : 1;
  };
  for (;;) {
    int64_t iters = std::max<int64_t>(0, (ip(0) - lowest) / 7);
    for (int k = 0; k < 4; ++k) iters = std::min(iters, (counts[k] - done[k]) / 10);
    const int64_t olimit = done[3] + 5 * iters;
    if (done[3] == olimit || ip(1) < ip(0) || ip(2) < ip(1) || ip(3) < ip(2)) break;
    while (done[3] < olimit)
      for (int t = 0; t < 5; ++t)
        for (int k = 0; k < 4; ++k) lookup(k);
  }
  for (int k = 0; k < 4; ++k)
    if (done[k] > counts[k] || ip(k) < starts[k] - 8)
      zfail("a Huffman stream read past its start (libzstd's fast decoder)");
}

// HUF_decodeStreamX1 after the fast loop (see _tail_x1)
void tail_x1(const uint8_t* data, int64_t lowest, int64_t end, int64_t read, const Huffman& h,
             int64_t count, uint8_t* out) {
  int64_t ptr = end - 8 - read / 8, used = read % 8;
  auto window = [&](int64_t at) {
    uint64_t v;
    memcpy(&v, data + at, 8);
    return v;
  };
  uint64_t box = window(ptr);
  auto reload = [&]() -> int {
    if (used > 64) return 3;
    if (ptr >= lowest + 8) {
      ptr -= used >> 3;
      used &= 7;
      box = window(ptr);
      return 0;
    }
    if (ptr == lowest) return used < 64 ? 1 : 2;
    int64_t step = used >> 3;
    int result = 0;
    if (ptr - step < lowest) {
      step = ptr - lowest;
      result = 1;
    }
    ptr -= step;
    used -= step * 8;
    box = window(ptr);
    return result;
  };
  int64_t p = 0;
  auto symbol = [&]() {
    const uint64_t look = (box << (used & 63)) >> ((64 - 11) & 63);
    const uint64_t key = look >> (11 - h.log);
    out[p++] = h.symbol[key];
    used += h.length[key];
  };
  if (count > 3) {
    while (reload() == 0 && p < count - 3)
      for (int i = 0; i < 4; ++i) symbol();
  } else {
    reload();
  }
  while (p < count) symbol();
}

uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint64_t p1 = 11400714785074694791ULL, p2 = 14029467366897019727ULL,
                 p3 = 1609587929392839161ULL, p4 = 9650029242287828579ULL,
                 p5 = 2870177450012600261ULL;
  auto rd64 = [](const uint8_t* q) {
    uint64_t v;
    memcpy(&v, q, 8);
    return v;
  };
  auto rnd = [&](uint64_t acc, uint64_t lane) { return rotl(acc + lane * p2, 31) * p1; };
  size_t i = 0;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = p1 + p2, v2 = p2, v3 = 0, v4 = 0 - p1;
    for (; i + 32 <= n; i += 32) {
      v1 = rnd(v1, rd64(p + i));
      v2 = rnd(v2, rd64(p + i + 8));
      v3 = rnd(v3, rd64(p + i + 16));
      v4 = rnd(v4, rd64(p + i + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    for (uint64_t v : {v1, v2, v3, v4}) h = (h ^ rnd(0, v)) * p1 + p4;
  } else {
    h = p5;
  }
  h += n;
  for (; i + 8 <= n; i += 8) {
    h ^= rnd(0, rd64(p + i));
    h = rotl(h, 27) * p1 + p4;
  }
  if (i + 4 <= n) {
    uint32_t v;
    memcpy(&v, p + i, 4);
    h ^= static_cast<uint64_t>(v) * p1;
    h = rotl(h, 23) * p2 + p3;
    i += 4;
  }
  for (; i < n; ++i) {
    h ^= p[i] * p5;
    h = rotl(h, 11) * p1;
  }
  h ^= h >> 33;
  h *= p2;
  h ^= h >> 29;
  h *= p3;
  return h ^ (h >> 32);
}

struct Frame {
  std::vector<uint8_t> out;
  int64_t block_max;
  int64_t reps[3] = {1, 4, 8};
  Huffman huffman;
  bool have_huffman = false;
  FseTable tables[3];
  int logs[3] = {0, 0, 0};
  bool have_table[3] = {false, false, false};
  std::vector<uint8_t> lits;

  int64_t literals(const uint8_t* data, int64_t pos, int64_t end) {
    lits.clear();
    if (end - pos < 2) zfail("a compressed block too short for its literals");
    const uint8_t b0 = data[pos];
    const int kind = b0 & 3, size_format = (b0 >> 2) & 3;
    if (kind == 0 || kind == 1) {
      int64_t n, head;
      if (size_format == 0 || size_format == 2) {
        n = b0 >> 3;
        head = 1;
      } else if (size_format == 1) {
        if (kind == 1 && end - pos < 3) zfail("a literals header past its block");
        n = (data[pos] | data[pos + 1] << 8) >> 4;
        head = 2;
      } else {
        if (end - pos < (kind == 0 ? 3 : 4)) zfail("a literals header past its block");
        n = (data[pos] | data[pos + 1] << 8 | data[pos + 2] << 16) >> 4;
        head = 3;
      }
      if (n > block_max) zfail("more literals than a block holds");
      if (kind == 0) {
        if (pos + head + n > end) zfail("raw literals past their block");
        lits.assign(data + pos + head, data + pos + head + n);
        return pos + head + n;
      }
      lits.assign(n, data[pos + head]);
      return pos + head + 1;
    }
    if (kind == 3 && !have_huffman) zfail("treeless literals without an earlier Huffman tree");
    if (end - pos < 5) zfail("a compressed literals header past its block");
    const uint32_t lhc = data[pos] | data[pos + 1] << 8 | data[pos + 2] << 16 |
                         static_cast<uint32_t>(data[pos + 3]) << 24;
    const bool single = size_format == 0;
    int64_t head, n, csize;
    if (size_format <= 1) {
      head = 3;
      n = (lhc >> 4) & 0x3FF;
      csize = (lhc >> 14) & 0x3FF;
    } else if (size_format == 2) {
      head = 4;
      n = (lhc >> 4) & 0x3FFF;
      csize = lhc >> 18;
    } else {
      head = 5;
      n = (lhc >> 4) & 0x3FFFF;
      csize = (lhc >> 22) + (static_cast<int64_t>(data[pos + 4]) << 10);
    }
    if (n > block_max) zfail("more literals than a block holds");
    if (!single && n < 6) zfail("too few literals for 4 streams");
    if (pos + head + csize > end) zfail("compressed literals past their block");
    int64_t start = pos + head;
    const int64_t stop = pos + head + csize;
    if (kind == 2) {
      Huffman h;
      start = huffman_weights(data, start, stop, h);
      h.x2 = !single && selects_x2(n, csize);
      huffman = h;
      have_huffman = true;
    }
    lits.reserve(n);
    if (single) {
      huffman_stream(data, start, stop, huffman, n, lits);
    } else {
      if (stop - start < 10) zfail("4 Huffman streams in under 10 bytes");
      int64_t sizes[4];
      for (int k = 0; k < 3; ++k) sizes[k] = data[start + 2 * k] | data[start + 2 * k + 1] << 8;
      sizes[3] = stop - start - 6 - sizes[0] - sizes[1] - sizes[2];
      if (sizes[3] < 0) zfail("Huffman stream sizes past their section");
      const int64_t segment = (n + 3) / 4;
      if (3 * segment > n) zfail("too few literals for 4 streams");
      const bool fast = huffman.log <= 11 && sizes[0] >= 8 && sizes[1] >= 8 && sizes[2] >= 8 &&
                        sizes[3] >= 8 && 3 * segment < n;
      int64_t at = start + 6, starts[4];
      std::vector<int64_t> reads[4];
      for (int k = 0; k < 4; ++k) {
        starts[k] = at;
        huffman_stream(data, at, at + sizes[k], huffman, k < 3 ? segment : n - 3 * segment, lits,
                       fast ? start : -1, &reads[k]);
        at += sizes[k];
      }
      if (fast && huffman.x2) {
        const int64_t counts[4] = {segment, segment, segment, n - 3 * segment};
        fast_loop_x2(starts, sizes, reads, start, counts);
      } else if (fast) {
        const int64_t done = fast_loop_x1(starts, sizes, reads, start, n - 3 * segment);
        for (int k = 0; k < 4; ++k) {  // the rest of each stream, as HUF_decodeStreamX1
          const int64_t first = k * segment + done;
          const int64_t count = (k < 3 ? segment : n - 3 * segment) - done;
          tail_x1(data, start, starts[k] + sizes[k], reads[k][done], huffman, count,
                  lits.data() + first);
        }
      }
    }
    return stop;
  }

  int64_t sequence_table(int k, int mode, const uint8_t* data, int64_t pos, int64_t end) {
    const SeqKind& kind = seq_kind(k);
    if (mode == 0) {
      tables[k] = build_fse(kind.defaults, kind.default_log, &kind);
      logs[k] = kind.default_log;
    } else if (mode == 1) {
      if (pos >= end) zfail("an RLE sequence table past its section");
      const int s = data[pos];
      if (s > kind.max_symbol) zfail("an RLE sequence symbol out of range");
      tables[k] = {FseEntry{static_cast<uint16_t>(s), 0, 0, kind.bases[s], kind.extra[s]}};
      logs[k] = 0;
      ++pos;
    } else if (mode == 2) {
      std::vector<int16_t> counts;
      int log;
      pos = read_ncount(data, pos, end, kind.max_symbol, counts, log);
      if (log > kind.max_log) zfail("a sequence table over its accuracy log");
      tables[k] = build_fse(counts, log, &kind);
      logs[k] = log;
    } else if (!have_table[k]) {
      zfail("a repeated sequence table without an earlier one");
    }
    have_table[k] = true;
    return pos;
  }

  void compressed(const uint8_t* data, int64_t pos, int64_t end) {
    const int64_t start_out = static_cast<int64_t>(out.size());
    pos = literals(data, pos, end);
    if (pos >= end) zfail("a block without its sequences section");
    int64_t nseq = data[pos++];
    if (nseq > 0x7F) {
      if (nseq == 0xFF) {
        if (pos + 2 > end) zfail("a sequence count past its block");
        nseq = (data[pos] | data[pos + 1] << 8) + 0x7F00;
        pos += 2;
      } else {
        if (pos >= end) zfail("a sequence count past its block");
        nseq = ((nseq - 0x80) << 8) + data[pos++];
      }
    }
    if (nseq == 0) {
      if (pos != end) zfail("bytes after a block's last sequence");
      out.insert(out.end(), lits.begin(), lits.end());
    } else {
      if (pos >= end) zfail("no sequence compression modes");
      const int modes = data[pos++];
      if (modes & 3) zfail("reserved bits set in the sequence modes");
      pos = sequence_table(0, modes >> 6, data, pos, end);
      pos = sequence_table(1, (modes >> 4) & 3, data, pos, end);
      pos = sequence_table(2, (modes >> 2) & 3, data, pos, end);
      const FseTable &ll = tables[0], &of = tables[1], &ml = tables[2];
      Backward bits(data, pos, end);
      int64_t s_ll = static_cast<int64_t>(bits.read(logs[0]));
      int64_t s_of = static_cast<int64_t>(bits.read(logs[1]));
      int64_t s_ml = static_cast<int64_t>(bits.read(logs[2]));
      size_t lit_pos = 0;
      for (int64_t k = 0; k < nseq; ++k) {
        const FseEntry &le = ll[s_ll], &oe = of[s_of], &me = ml[s_ml];
        const int of_bits = oe.extra;
        const bool ll0 = le.value == 0;
        int64_t offset;
        if (of_bits > 1) {
          offset = oe.value + static_cast<int64_t>(bits.read(of_bits));
          reps[2] = reps[1];
          reps[1] = reps[0];
          reps[0] = offset;
        } else if (of_bits == 0) {
          offset = reps[ll0 ? 1 : 0];
          reps[1] = reps[ll0 ? 0 : 1];
          reps[0] = offset;
        } else {
          const int64_t code = oe.value + (ll0 ? 1 : 0) + static_cast<int64_t>(bits.read(1));
          offset = code == 3 ? reps[0] - 1 : reps[code];
          if (offset == 0) offset = -1;
          if (code != 1) reps[2] = reps[1];
          reps[1] = reps[0];
          reps[0] = offset;
        }
        const int64_t match = me.value + static_cast<int64_t>(bits.read(me.extra));
        const int64_t litlen = le.value + static_cast<int64_t>(bits.read(le.extra));
        if (k < nseq - 1) {
          s_ll = le.base + static_cast<int64_t>(bits.read(le.nbits));
          s_ml = me.base + static_cast<int64_t>(bits.read(me.nbits));
          s_of = oe.base + static_cast<int64_t>(bits.read(oe.nbits));
        }
        if (litlen > static_cast<int64_t>(lits.size() - lit_pos))
          zfail("a sequence reads past its literals");
        out.insert(out.end(), lits.begin() + lit_pos, lits.begin() + lit_pos + litlen);
        lit_pos += litlen;
        if (offset <= 0 || offset > static_cast<int64_t>(out.size()))
          zfail("a match offset before the start of the frame");
        if (static_cast<int64_t>(out.size()) + match - start_out > block_max)
          zfail("a block decodes past its maximum size");
        size_t src = out.size() - offset;
        for (int64_t i = 0; i < match; ++i) out.push_back(out[src + i]);
      }
      if (!bits.done()) zfail("a sequence bit stream not read to its end");
      out.insert(out.end(), lits.begin() + lit_pos, lits.end());
    }
    if (static_cast<int64_t>(out.size()) - start_out > block_max)
      zfail("a block decodes past its maximum size");
  }
};

uint64_t le(const uint8_t* p, int n) {
  uint64_t v = 0;
  for (int i = 0; i < n; ++i) v |= static_cast<uint64_t>(p[i]) << (8 * i);
  return v;
}

// the port of zstd_decode_python; returns the bytes decoded, out holding them
void zstd_frame(const uint8_t* data, int64_t n, int64_t cap, std::vector<uint8_t>& result) {
  if (n < 4) zfail("a Zstandard frame cut short");
  const uint32_t magic = static_cast<uint32_t>(le(data, 4));
  if ((magic & 0xFFFFFFF0u) == 0x184D2A50u)
    zfail("a skippable frame first (libzstd ends the stream there, short of the strip)");
  if (magic != 0xFD2FB528u) zfail("not a Zstandard frame (unknown magic number)");
  if (n < 5) zfail("a Zstandard frame header cut short");
  const int fhd = data[4];
  const int fcs_code = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1,
            dict_code = fhd & 3;
  const int dsizes[4] = {0, 1, 2, 4}, fsizes[4] = {0, 2, 4, 8};
  const int fsize = single && fcs_code == 0 ? 1 : fsizes[fcs_code];
  const int64_t size = 5 + (single ? 0 : 1) + dsizes[dict_code] + fsize;
  if (n < size) zfail("a Zstandard frame header cut short");
  if (fhd & 8) zfail("reserved bit set in the frame header");
  int64_t pos = 5;
  uint64_t window = 0;
  if (!single) {
    const int wd = data[5];
    const int wlog = (wd >> 3) + 10;
    if (wlog > 31) zfail("a window over 2^31");
    window = (uint64_t(1) << wlog) + ((uint64_t(1) << wlog) >> 3) * (wd & 7);
    pos = 6;
  }
  const uint64_t dict_id = le(data + pos, dsizes[dict_code]);
  pos += dsizes[dict_code];
  bool have_content = fsize != 0;
  uint64_t content = 0;
  if (fsize) content = le(data + pos, fsize) + (fsize == 2 ? 256 : 0);
  pos += fsize;
  if (single) window = content;
  if (dict_id) zfail("a frame that needs a dictionary");
  if (window < 1024) window = 1024;
  if (window > (uint64_t(1) << 27)) zfail("a frame window over libzstd's limit of 2^27");
  Frame frame;
  frame.block_max = static_cast<int64_t>(window < (1 << 17) ? window : (1 << 17));
  const bool whole = have_content && content <= static_cast<uint64_t>(cap);
  std::vector<uint8_t>& out = frame.out;
  out.reserve(cap);
  bool ahead = false;
  for (;;) {
    if (pos + 3 > n) zfail("a Zstandard frame cut short (libtiff: not enough data)");
    const uint32_t head = static_cast<uint32_t>(le(data + pos, 3));
    const int last = head & 1, kind = (head >> 1) & 3;
    const int64_t bsize = head >> 3;
    pos += 3;
    if (kind == 3) zfail("a reserved block type");
    const int64_t stored = kind == 1 ? 1 : bsize;
    if (kind != 1 && bsize > frame.block_max) zfail("a block over its maximum size");
    if (kind == 0 && !whole) {  // streamed as it comes, a cut block too
      out.insert(out.end(), data + pos, data + (pos + bsize < n ? pos + bsize : n));
      if (pos + bsize > n) break;
    } else if (pos + stored > n) {
      zfail("a Zstandard block cut short (libtiff: not enough data)");
    } else if (kind == 0) {
      out.insert(out.end(), data + pos, data + pos + bsize);
    } else if (kind == 1) {
      if (bsize > frame.block_max) zfail("an RLE block over its maximum size");
      out.insert(out.end(), bsize, data[pos]);
    } else {
      frame.compressed(data, pos, pos + bsize);
    }
    pos += stored;
    const int64_t produced = static_cast<int64_t>(out.size());
    if (have_content && static_cast<uint64_t>(produced) > content)
      zfail("a frame longer than its content size");
    if (last) {
      if (have_content && static_cast<uint64_t>(produced) != content)
        zfail("a frame shorter than its content size");
      if (checksum && (whole || produced <= cap)) {
        if (pos + 4 <= n) {
          if (le(data + pos, 4) != (xxh64(out.data(), out.size()) & 0xFFFFFFFFu))
            zfail("the frame's content checksum is wrong");
        } else if (whole) {
          zfail("a Zstandard frame cut short at its checksum");
        }
      }
      break;
    }
    if (!whole && (ahead || produced > cap)) break;
    if (!whole && produced == cap) ahead = true;
  }
  result.swap(out);
}

void put_error(char* err, int64_t err_size, const std::string& what) {
  if (err_size > 0) snprintf(err, static_cast<size_t>(err_size), "%s", what.c_str());
}

}  // namespace

extern "C" {

// libtiff's CCITT decoder of one strip (see fax_decode_python): rows of
// ``width`` pixels into ``buf`` (rows x row_bytes, the strip buffer);
// ``runs`` the codec's two run arrays of ``nruns`` + 1 entries, carried from
// strip to strip, ``*no_eol`` Group 3's decode-without-EOL mode, in and
// out. 0: the strip decoded; 1: a premature end fails it; 2: Group 4 data
// that ends before its first row; 3: a run array overflow.
int fax_decode(const uint8_t* data, int64_t n, int parity, int compression, int two_d,
               int64_t width, int64_t rows, int64_t row_bytes, uint8_t* buf, uint32_t* runs,
               int64_t nruns, int* no_eol) {
  uint32_t* first = runs;
  uint32_t* second = runs + nruns + 1;
  second[0] = static_cast<uint32_t>(width);  // the reference: one white run
  second[1] = 0;
  Fax st(data, n, parity, width, first, second, nruns);
  int64_t line = 0;
  const uint32_t lastx = static_cast<uint32_t>(width);
  try {
    while (line < rows) {
      uint8_t* row = buf + line * row_bytes;
      st.a0 = st.run_length = 0;
      st.pa = 0;
      try {
        if (compression == FAX_RLE || compression == FAX_RLEW) {
          st.expand1d();
        } else if (compression == FAX_G4) {
          st.pb = 1;
          st.b1 = static_cast<int32_t>(st.ref[0]);
          st.expand2d();
          if (st.eolcnt) throw Eof{};
        } else {
          int one_d = 1;
          try {
            if (!*no_eol) {
              try {
                st.sync_eol();
              } catch (NoEol&) {  // Fax3TryG3WithoutEOL: from the start, without EOLs
                *no_eol = 1;
                st.cp = 0;
                st.acc = 0;
                st.avail = st.eolcnt = 0;
                continue;
              }
            }
            if (two_d) {
              st.need8(1);
              one_d = static_cast<int>(st.bits(1));
              st.clear(1);
            }
          } catch (Eof&) {
            st.cleanup();
            throw;
          }
          st.pb = 1;
          st.b1 = static_cast<int32_t>(st.ref[0]);
          if (!two_d || one_d) st.expand1d(); else st.expand2d();
        }
      } catch (Eof&) {
        if (compression != FAX_G4) {
          fax_fill(row, st.cur, st.pa, lastx, nruns + 1);
          return 1;
        }
        try {
          st.need16(13);
        } catch (Eof&) {
        }
        st.clear(13);
        fax_fill(row, st.cur, st.pa, lastx, nruns + 1);
        return line == 0 ? 2 : 0;
      }
      fax_fill(row, st.cur, st.pa, lastx, nruns + 1);
      if (compression == FAX_RLE || compression == FAX_RLEW) {
        st.align(compression);
      } else if (two_d) {
        if (compression == FAX_G4 || st.pa < st.nruns) st.setvalue(0);
        std::swap(st.cur, st.ref);
      }
      ++line;
    }
  } catch (Fail&) {
    return 3;
  }
  return 0;
}

// tif_zstd.c's ZSTDDecode of one strip (see zstd_decode_python): ``cap``
// bytes into ``out``. 0, or 1 with the reason in ``err``.
int zstd_decode(const uint8_t* data, int64_t n, int64_t cap, uint8_t* out, char* err,
                int64_t err_size) {
  try {
    std::vector<uint8_t> result;
    zstd_frame(data, n, cap, result);
    if (static_cast<int64_t>(result.size()) < cap) {
      put_error(err, err_size, "Zstandard data ends " +
                std::to_string(cap - static_cast<int64_t>(result.size())) +
                " bytes short of the strip (libtiff fails it)");
      return 1;
    }
    memcpy(out, result.data(), static_cast<size_t>(cap));
    return 0;
  } catch (ZError& e) {
    put_error(err, err_size, e.what);
    return 1;
  }
}

}  // extern "C"
