// JPEG 2000 decoding as OpenJPEG 2.5.4 does it, for
// coma_tpu_torch/utils/j2k.py: a tile's packets (tier-2: tag trees, pass
// counts, segment lengths, SOP/EPH, headers from PPM/PPT), tier-1 decoding of
// every code-block of a tile-component (the MQ and raw decoders, the three
// passes, every code-block style, the ROI shift), dequantisation, the inverse
// 5/3 and 9/7 wavelet transforms, the RCT and ICT and the DC level shift.
// Each function equals its plain Python twin (utils/j2k.py: _read_packet,
// utils/j2k_t1.py: decode_cblk, utils/j2k_dwt.py: idwt2d, rct_inverse,
// ict_inverse, level_shift); these exist because a 2048 x 1536 file takes
// minutes in Python.
//
// The 9/7 lifting and the ICT are float32 sums of products, as OpenJPEG's
// SSE code computes them: no fused multiply-add. GCC contracts them into
// FMAs on an FMA machine unless told not to, hence the pragma.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 j2k_decode.cpp (native/__init__.py
// does it at first use).

#pragma GCC optimize("fp-contract=off")

#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct State {
  uint16_t qe;
  uint8_t nmps, nlps, sw;
};

const State kStates[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},   {0x0AC1, 4, 12, 0},
    {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0}, {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},
    {0x4801, 9, 14, 0},  {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1}, {0x5401, 16, 14, 0},
    {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0}, {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0},
    {0x3001, 21, 19, 0}, {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0}, {0x1401, 28, 25, 0},
    {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0}, {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0},
    {0x08A1, 33, 30, 0}, {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0}, {0x0085, 40, 37, 0},
    {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0}, {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0},
    {0x0005, 45, 42, 0}, {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0}};

enum { kCtxSc = 9, kCtxMag = 14, kCtxAgg = 17, kCtxUni = 18, kNumCtx = 19 };
enum { kLazy = 1, kReset = 2, kVsc = 8, kSegsym = 32 };

int zc_context(int h, int v, int d, int orient) {
  if (orient == 1) std::swap(h, v);
  if (orient != 3) {
    if (!h) {
      if (!v) return !d ? 0 : (d == 1 ? 1 : 2);
      return v == 1 ? 3 : 4;
    }
    if (h == 1) return !v ? (!d ? 5 : 6) : 7;
    return 8;
  }
  const int hv = h + v;
  if (!d) return !hv ? 0 : (hv == 1 ? 1 : 2);
  if (d == 1) return !hv ? 3 : (hv == 1 ? 4 : 5);
  if (d == 2) return !hv ? 6 : 7;
  return 8;
}

struct Mq {
  std::vector<uint8_t> buf;
  size_t bp = 0;
  uint32_t c = 0, a = 0;
  int ct = 0;
  uint8_t state[kNumCtx], mps[kNumCtx];

  void reset() {
    std::memset(state, 0, sizeof(state));
    std::memset(mps, 0, sizeof(mps));
    state[kCtxUni] = 46;
    state[kCtxAgg] = 3;
    state[0] = 4;
  }
  void load(const uint8_t* data, size_t len) {
    buf.assign(data, data + len);
    buf.push_back(0xFF);
    buf.push_back(0xFF);
    bp = 0;
  }
  void init(const uint8_t* data, size_t len) {  // opj_mqc_init_dec
    load(data, len);
    c = len == 0 ? 0xFFu << 16 : static_cast<uint32_t>(buf[0]) << 16;
    ct = 0;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }
  void bytein() {
    if (buf[bp] == 0xFF) {
      if (buf[bp + 1] > 0x8F) {
        c += 0xFF00;
        ct = 8;
      } else {
        ++bp;
        c += static_cast<uint32_t>(buf[bp]) << 9;
        ct = 7;
      }
    } else {
      ++bp;
      c += static_cast<uint32_t>(buf[bp]) << 8;
      ct = 8;
    }
  }
  int decode(int cx) {
    const State& s = kStates[state[cx]];
    const uint32_t qe = s.qe;
    int d;
    a -= qe;
    if ((c >> 16) < qe) {
      if (a < qe) {
        d = mps[cx];
        state[cx] = s.nmps;
      } else {
        d = 1 - mps[cx];
        if (s.sw) mps[cx] = static_cast<uint8_t>(d);
        state[cx] = s.nlps;
      }
      a = qe;
    } else {
      c -= qe << 16;
      if (a & 0x8000) return mps[cx];
      if (a < qe) {
        d = 1 - mps[cx];
        if (s.sw) mps[cx] = static_cast<uint8_t>(d);
        state[cx] = s.nlps;
      } else {
        d = mps[cx];
        state[cx] = s.nmps;
      }
    }
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      --ct;
    } while (a < 0x8000);
    return d;
  }
  // the raw (bypass) decoder on the same bytes
  void raw_init(const uint8_t* data, size_t len) {
    load(data, len);
    c = 0;
    ct = 0;
  }
  int raw_decode() {
    if (ct == 0) {
      if (c == 0xFF) {
        if (buf[bp] > 0x8F) {
          c = 0xFF;
          ct = 8;
        } else {
          c = buf[bp++];
          ct = 7;
        }
      } else {
        c = buf[bp++];
        ct = 8;
      }
    }
    --ct;
    return (c >> ct) & 1;
  }
};

struct Block {
  // Per sample, padded by one all round: significance, sign (1 negative),
  // visited this plane (OpenJPEG's PI), refined (MU), and the counts of
  // significant horizontal, vertical and diagonal neighbours it sees (under
  // VSC a stripe's last row does not see the next stripe).
  int w, h, stride;
  bool vsc;
  const int* zc;
  std::vector<uint8_t> sig, neg, pi, mu, hn, vn, dn;
  std::vector<int32_t> data;

  Block(int w_, int h_, bool vsc_, const int* zc_)
      : w(w_), h(h_), stride(w_ + 2), vsc(vsc_), zc(zc_) {
    const size_t n = static_cast<size_t>(w + 2) * (h + 2);
    for (auto* v : {&sig, &neg, &pi, &mu, &hn, &vn, &dn}) v->assign(n, 0);
    data.assign(n, 0);
  }
  bool south(int y) const { return !(vsc && (y & 3) == 3); }
  int zc_ctx(int p) const { return zc[(hn[p] * 3 + vn[p]) * 5 + dn[p]]; }
  bool neighbour(int p) const { return hn[p] | vn[p] | dn[p]; }
  // sample p of row y becomes significant, negative where ``v``
  void set(int p, int y, int v) {
    const int W = stride;
    sig[p] = 1;
    neg[p] = static_cast<uint8_t>(v);
    ++hn[p - 1];
    ++hn[p + 1];
    ++vn[p + W];
    ++dn[p + W - 1];
    ++dn[p + W + 1];
    if (south(y - 1)) {  // the row above sees this one unless VSC cuts it off
      ++vn[p - W];
      ++dn[p - W - 1];
      ++dn[p - W + 1];
    }
  }
  int contrib(int q) const { return sig[q] ? (neg[q] ? -1 : 1) : 0; }
  void sc_ctx(int p, int y, int* cx, int* spb) const {
    const int W = stride;
    int hc = contrib(p - 1) + contrib(p + 1);
    int vc = contrib(p - W) + (south(y) ? contrib(p + W) : 0);
    hc = hc < -1 ? -1 : (hc > 1 ? 1 : hc);
    vc = vc < -1 ? -1 : (vc > 1 ? 1 : vc);
    *spb = (!hc && !vc) ? 0 : !(hc > 0 || (!hc && vc > 0));
    if (hc < 0) {
      hc = -hc;
      vc = -vc;
    }
    int n;
    if (!hc) n = vc ? 1 : 0;
    else n = vc == -1 ? 2 : (vc == 0 ? 3 : 4);
    *cx = kCtxSc + n;
  }
};

void sigpass(Block& b, Mq& mq, int bpno, bool raw) {
  const int32_t oph = (1 << bpno) | ((1 << bpno) >> 1);
  for (int k = 0; k < b.h; k += 4)
    for (int x = 0; x < b.w; ++x)
      for (int y = k; y < k + 4 && y < b.h; ++y) {
        const int p = (y + 1) * b.stride + x + 1;
        if (b.sig[p] || b.pi[p] || !b.neighbour(p)) continue;
        if (raw) {
          if (mq.raw_decode()) {
            const int v = mq.raw_decode();
            b.data[p] = v ? -oph : oph;
            b.set(p, y, v);
          }
        } else if (mq.decode(b.zc_ctx(p))) {
          int cx, spb;
          b.sc_ctx(p, y, &cx, &spb);
          const int v = mq.decode(cx) ^ spb;
          b.data[p] = v ? -oph : oph;
          b.set(p, y, v);
        }
        b.pi[p] = 1;
      }
}

void refpass(Block& b, Mq& mq, int bpno, bool raw) {
  const int32_t poshalf = (1 << bpno) >> 1;
  for (int k = 0; k < b.h; k += 4)
    for (int x = 0; x < b.w; ++x)
      for (int y = k; y < k + 4 && y < b.h; ++y) {
        const int p = (y + 1) * b.stride + x + 1;
        if (!b.sig[p] || b.pi[p]) continue;
        int v;
        if (raw) {
          v = mq.raw_decode();
        } else {
          const int cx = b.mu[p] ? kCtxMag + 2 : kCtxMag + (b.neighbour(p) ? 1 : 0);
          v = mq.decode(cx);
        }
        b.data[p] += (v ^ (b.data[p] < 0)) ? poshalf : -poshalf;
        b.mu[p] = 1;
      }
}

void clnpass(Block& b, Mq& mq, int bpno, bool segsym) {
  const int32_t oph = (1 << bpno) | ((1 << bpno) >> 1);
  auto sign = [&](int p, int y) {
    int cx, spb;
    b.sc_ctx(p, y, &cx, &spb);
    const int v = mq.decode(cx) ^ spb;
    b.data[p] = v ? -oph : oph;
    b.set(p, y, v);
  };
  const int full = b.h & ~3;
  for (int k = 0; k < b.h; k += 4)
    for (int x = 0; x < b.w; ++x) {
      const int rows = b.h - k < 4 ? b.h - k : 4;
      int ps[4];
      for (int j = 0; j < rows; ++j) ps[j] = (k + j + 1) * b.stride + x + 1;
      int start = 0;
      bool check = true;
      bool run = k < full;
      for (int j = 0; run && j < rows; ++j)
        run = !b.sig[ps[j]] && !b.pi[ps[j]] && !b.neighbour(ps[j]);
      bool skip = false;
      if (run) {
        if (!mq.decode(kCtxAgg)) {
          skip = true;
        } else {
          int r = mq.decode(kCtxUni) << 1;
          r |= mq.decode(kCtxUni);
          sign(ps[r], k + r);
          start = r + 1;
          check = false;
        }
      }
      if (!skip)
        for (int j = start; j < rows; ++j) {
          const int p = ps[j];
          if (check && (b.sig[p] || b.pi[p])) continue;
          if (mq.decode(b.zc_ctx(p))) sign(p, k + j);
        }
      for (int j = 0; j < rows; ++j) b.pi[ps[j]] = 0;
    }
  if (segsym)
    for (int i = 0; i < 4; ++i) mq.decode(kCtxUni);
}

int zc_table[4][45];
bool zc_ready = false;

void make_zc() {
  if (zc_ready) return;
  for (int o = 0; o < 4; ++o)
    for (int hh = 0; hh < 3; ++hh)
      for (int v = 0; v < 3; ++v)
        for (int d = 0; d < 5; ++d) zc_table[o][(hh * 3 + v) * 5 + d] = zc_context(hh, v, d, o);
  zc_ready = true;
}

// One code-block: 0, or 1 where bpno_plus_one >= 31 (OpenJPEG fails the block).
int t1_decode(const uint8_t* data, const int32_t* lens, const int32_t* passes, int nsegs, int w,
              int h, int orient, int numbps, int roishift, int cblksty, int32_t* out,
              int out_stride) {
  make_zc();
  Block b(w, h, (cblksty & kVsc) != 0, zc_table[orient]);
  int bpno = roishift + numbps;
  if (bpno >= 31) return 1;
  int passtype = 2;
  Mq mq;
  mq.reset();
  size_t at = 0;
  for (int s = 0; s < nsegs; ++s) {
    const bool raw = bpno <= numbps - 4 && passtype < 2 && (cblksty & kLazy);
    if (raw) mq.raw_init(data + at, lens[s]);
    else mq.init(data + at, lens[s]);
    at += lens[s];
    for (int i = 0; i < passes[s] && bpno >= 1; ++i) {
      if (passtype == 0) sigpass(b, mq, bpno, raw);
      else if (passtype == 1) refpass(b, mq, bpno, raw);
      else clnpass(b, mq, bpno, (cblksty & kSegsym) != 0);
      if ((cblksty & kReset) && !raw) mq.reset();
      if (++passtype == 3) {
        passtype = 0;
        --bpno;
      }
    }
  }
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      int32_t v = b.data[(y + 1) * b.stride + x + 1];
      if (roishift) {
        if (roishift >= 31) {
          v = 0;
        } else {
          const int32_t mag = std::abs(v);
          if (mag >= (1 << roishift)) v = v < 0 ? -(mag >> roishift) : (mag >> roishift);
        }
      }
      out[static_cast<size_t>(y) * out_stride + x] = v;
    }
  return 0;
}

const float kK = 1.230174105f, kTwoInvK = 1.625732422f;
const float kAlpha = -1.586134342f, kBeta = -0.052980118f, kGamma = 0.882911075f,
            kDelta = 0.443506852f;

inline int mirror(int i, int n) { return i < 0 ? -i : (i >= n ? 2 * (n - 1) - i : i); }

// One level of 5/3 along n samples x[0], x[step], ...: sn low first.
void idwt53(int32_t* x, int n, int sn, int cas, size_t step, std::vector<int64_t>& t) {
  if (n == 1) {
    if (cas) x[0] /= 2;
    return;
  }
  t.resize(n);
  for (int i = 0; i < sn; ++i) t[cas + 2 * i] = x[i * step];
  for (int i = 0; i < n - sn; ++i) t[1 - cas + 2 * i] = x[(sn + i) * step];
  for (int p = cas; p < n; p += 2) t[p] -= (t[mirror(p - 1, n)] + t[mirror(p + 1, n)] + 2) >> 2;
  for (int p = 1 - cas; p < n; p += 2) t[p] += (t[mirror(p - 1, n)] + t[mirror(p + 1, n)]) >> 1;
  for (int i = 0; i < n; ++i) x[i * step] = static_cast<int32_t>(t[i]);
}

void idwt97(float* x, int n, int sn, int cas, size_t step, std::vector<float>& t) {
  if (n == 1) return;
  t.resize(n);
  for (int i = 0; i < sn; ++i) t[cas + 2 * i] = x[i * step];
  for (int i = 0; i < n - sn; ++i) t[1 - cas + 2 * i] = x[(sn + i) * step];
  for (int p = cas; p < n; p += 2) t[p] *= kK;
  for (int p = 1 - cas; p < n; p += 2) t[p] *= kTwoInvK;
  const float cs[4] = {-kDelta, -kGamma, -kBeta, -kAlpha};
  for (int s = 0; s < 4; ++s) {
    const int first = (s % 2 == 0) ? cas : 1 - cas;
    // every position of this parity reads the other parity only: no order
    for (int p = first; p < n; p += 2) {
      const float sum = t[mirror(p - 1, n)] + t[mirror(p + 1, n)];
      const float prod = sum * cs[s];
      t[p] = t[p] + prod;
    }
  }
  for (int i = 0; i < n; ++i) x[i * step] = t[i];
}

// The vertical pass of one level on whole rows at once (each row's columns
// lifted together, the same arithmetic as ``idwt53``/``idwt97`` column by
// column): rows interleaved into ``t``, lifted, copied back.
void vertical53(int32_t* buf, size_t w, int rw, int n, int sn, int cas, std::vector<int64_t>& t) {
  if (n == 1) {
    if (cas)
      for (int x = 0; x < rw; ++x) buf[x] /= 2;
    return;
  }
  t.resize(static_cast<size_t>(n) * rw);
  for (int i = 0; i < n; ++i) {
    const int src = (i & 1) == cas ? i / 2 : sn + i / 2;
    for (int x = 0; x < rw; ++x) t[static_cast<size_t>(i) * rw + x] = buf[src * w + x];
  }
  auto row = [&](int i) { return t.data() + static_cast<size_t>(mirror(i, n)) * rw; };
  for (int p = cas; p < n; p += 2) {
    int64_t *c = row(p), *l = row(p - 1), *r = row(p + 1);
    for (int x = 0; x < rw; ++x) c[x] -= (l[x] + r[x] + 2) >> 2;
  }
  for (int p = 1 - cas; p < n; p += 2) {
    int64_t *c = row(p), *l = row(p - 1), *r = row(p + 1);
    for (int x = 0; x < rw; ++x) c[x] += (l[x] + r[x]) >> 1;
  }
  for (int i = 0; i < n; ++i)
    for (int x = 0; x < rw; ++x) buf[i * w + x] = static_cast<int32_t>(t[static_cast<size_t>(i) * rw + x]);
}

void vertical97(float* buf, size_t w, int rw, int n, int sn, int cas, std::vector<float>& t) {
  if (n == 1) return;
  t.resize(static_cast<size_t>(n) * rw);
  for (int i = 0; i < n; ++i) {
    const int src = (i & 1) == cas ? i / 2 : sn + i / 2;
    const float k = (i & 1) == cas ? kK : kTwoInvK;
    for (int x = 0; x < rw; ++x) t[static_cast<size_t>(i) * rw + x] = buf[src * w + x] * k;
  }
  auto row = [&](int i) { return t.data() + static_cast<size_t>(mirror(i, n)) * rw; };
  const float cs[4] = {-kDelta, -kGamma, -kBeta, -kAlpha};
  for (int s = 0; s < 4; ++s) {
    const float c = cs[s];
    for (int p = (s % 2 == 0) ? cas : 1 - cas; p < n; p += 2) {
      float *y = row(p), *l = row(p - 1), *r = row(p + 1);
      for (int x = 0; x < rw; ++x) {
        const float sum = l[x] + r[x];
        const float prod = sum * c;
        y[x] = y[x] + prod;
      }
    }
  }
  for (int i = 0; i < n; ++i)
    for (int x = 0; x < rw; ++x) buf[i * w + x] = t[static_cast<size_t>(i) * rw + x];
}

template <typename T, typename H, typename V>
void idwt2d(T* buf, int w, int nres, const int32_t* dims, H hstep, V vstep) {
  int rw = dims[2] - dims[0], rh = dims[3] - dims[1];
  for (int r = 1; r < nres; ++r) {
    const int32_t* d = dims + 4 * r;
    const int sn = rw, sv = rh;
    rw = d[2] - d[0];
    rh = d[3] - d[1];
    if (!rw || !rh) continue;
    for (int y = 0; y < rh; ++y) hstep(buf + static_cast<size_t>(y) * w, rw, sn, d[0] % 2);
    vstep(buf, static_cast<size_t>(w), rw, rh, sv, d[1] % 2);
  }
}

// ---- tier-2: the packets of a tile (utils/j2k.py: _read_packet) ----

struct T2Error {
  const char* what;
};

struct Bio {  // opj_bio_t
  const uint8_t* data;
  int64_t bp, end;
  uint32_t buf = 0;
  int ct = 0;
  Bio(const uint8_t* d, int64_t pos, int64_t e) : data(d), bp(pos), end(e) {}
  void bytein() {
    buf = (buf << 8) & 0xFFFF;
    ct = buf == 0xFF00 ? 7 : 8;
    if (bp < end) buf |= data[bp++];
  }
  uint32_t bit() {
    if (ct == 0) bytein();
    --ct;
    return (buf >> ct) & 1;
  }
  uint64_t read(int n) {
    uint64_t v = 0;
    for (int i = 0; i < n; ++i) v = (v << 1) | bit();
    return v;
  }
  void inalign() {
    if ((buf & 0xFF) == 0xFF) bytein();
    ct = 0;
  }
};

struct TagTree {  // opj_tgt_tree_t: nodes level by level, each leaf's path root first
  std::vector<std::vector<int>> paths;
  std::vector<int32_t> value, low;
  void build(int w, int h) {
    std::vector<std::pair<int, int>> levels;
    int base = 0;
    for (;;) {
      levels.push_back({w, base});
      base += w * h;
      if (w * h <= 1) break;
      w = (w + 1) / 2;
      h = (h + 1) / 2;
    }
    const int w0 = levels[0].first, leaves = levels.size() > 1 ? levels[1].second : 1;
    paths.assign(leaves, {});
    for (int leaf = 0; leaf < leaves; ++leaf) {
      int i = leaf % w0, j = leaf / w0;
      for (auto& lv : levels) {
        paths[leaf].push_back(lv.second + j * lv.first + i);
        i >>= 1;
        j >>= 1;
      }
      std::reverse(paths[leaf].begin(), paths[leaf].end());
    }
    value.assign(base, 999);
    low.assign(base, 0);
  }
  int decode(Bio& bio, int leaf, int threshold) {
    int lo = 0;
    for (int n : paths[leaf]) {
      if (lo > low[n]) low[n] = lo;
      else lo = low[n];
      while (lo < threshold && lo < value[n]) {
        if (bio.bit()) value[n] = lo;
        else ++lo;
      }
      low[n] = lo;
    }
    return value[paths[leaf].back()] < threshold;
  }
};

struct Seg {
  int64_t maxpasses = 0, numpasses = 0, len = 0, newlen = 0, numnewpasses = 0;
};

struct T2Cblk {
  int numsegs = 0, numbps = 0, numlenbits = 0;
  int64_t numnewpasses = 0;
  std::vector<Seg> segs;
  std::vector<std::pair<int64_t, int64_t>> chunks;
};

struct Rec {  // one band's precinct
  int cw, ch, g0, numbps, sty;
  bool trees = false;
  TagTree incl, imsb;
};

void init_seg(T2Cblk& c, int index, int sty, bool first) {  // opj_t2_init_seg
  if (static_cast<int>(c.segs.size()) <= index) c.segs.resize(index + 1);
  Seg& s = c.segs[index];
  s = Seg();
  if (sty & 4) s.maxpasses = 1;
  else if (sty & 1)
    s.maxpasses = first ? 10 : ((c.segs[index - 1].maxpasses == 1 ||
                                 c.segs[index - 1].maxpasses == 10) ? 2 : 1);
  else s.maxpasses = 109;
}

int64_t numpasses(Bio& bio) {
  if (!bio.bit()) return 1;
  if (!bio.bit()) return 2;
  int64_t n = static_cast<int64_t>(bio.read(2));
  if (n != 3) return 3 + n;
  n = static_cast<int64_t>(bio.read(5));
  if (n != 31) return 6 + n;
  return 37 + static_cast<int64_t>(bio.read(7));
}

void make_trees(Rec& r) {
  if (r.cw * r.ch) {
    r.incl.build(r.cw, r.ch);
    r.imsb.build(r.cw, r.ch);
    r.trees = true;
  }
}

}  // namespace

extern "C" {

// Every packet of a tile, as utils/j2k.py's _read_packet reads them in turn:
// ``packets`` (layer, first record, records) each, ``pk_recs`` their band
// precincts' indices into ``recs`` (cw, ch, first code-block, numbps, code-block
// style each); the packet headers from the tile data, or from ``hdr`` (PPM or
// PPT) at ``*hdr_pos``, which moves on. Out, per code-block: its numbps, its
// segment count, its first segment's index into ``seg_len``/``seg_passes`` and
// its bytes' offset in ``out_data``. Returns 0, or 1 with ``err`` set where
// OpenJPEG fails.
int j2k_tier2(const uint8_t* data, int64_t len, const uint8_t* hdr, int64_t hdr_len,
              int64_t* hdr_pos, int csty, const int32_t* packets, int64_t npk,
              const int32_t* pk_recs, const int32_t* recs, int64_t nrec, int64_t ncblk,
              int32_t* cb_numbps, int32_t* cb_nsegs, int64_t* cb_first_seg,
              int64_t* cb_data_off, int32_t* seg_len, int32_t* seg_passes, int64_t seg_cap,
              uint8_t* out_data, char* err, int errlen) {
  std::vector<Rec> rs(nrec);
  for (int64_t k = 0; k < nrec; ++k) {
    const int32_t* r = recs + 5 * k;
    rs[k].cw = r[0];
    rs[k].ch = r[1];
    rs[k].g0 = r[2];
    rs[k].numbps = r[3];
    rs[k].sty = r[4];
  }
  std::vector<T2Cblk> cb(ncblk);
  std::vector<int64_t> included;
  int64_t pos = 0;
  try {
    for (int64_t p = 0; p < npk; ++p) {
      const int layno = packets[3 * p];
      const int32_t* ids = pk_recs + packets[3 * p + 1];
      const int nids = packets[3 * p + 2];
      if (layno == 0)
        for (int q = 0; q < nids; ++q) {
          Rec& r = rs[ids[q]];
          make_trees(r);
          for (int k = 0; k < r.cw * r.ch; ++k) {
            T2Cblk& c = cb[r.g0 + k];
            c.numsegs = 0;
            c.segs.clear();
            c.chunks.clear();
          }
        }
      if ((csty & 2) && len - pos >= 6 && data[pos] == 0xFF && data[pos + 1] == 0x91) pos += 6;
      Bio bio = hdr ? Bio(hdr, *hdr_pos, hdr_len) : Bio(data, pos, len);
      included.clear();
      if (bio.bit()) {
        for (int q = 0; q < nids; ++q) {
          Rec& r = rs[ids[q]];
          if (!r.trees) make_trees(r);
          for (int k = 0; k < r.cw * r.ch; ++k) {
            T2Cblk& c = cb[r.g0 + k];
            const int inc = c.numsegs ? static_cast<int>(bio.bit()) : r.incl.decode(bio, k, layno + 1);
            if (!inc) {
              c.numnewpasses = 0;
              continue;
            }
            if (!c.numsegs) {
              int i = 0;
              while (!r.imsb.decode(bio, k, i))
                if (++i > 0x7FFFFFFE) throw T2Error{"a zero bit-plane count out of range"};
              c.numbps = r.numbps + 1 - i;
              c.numlenbits = 3;
            }
            c.numnewpasses = numpasses(bio);
            int increment = 0;
            while (bio.bit()) ++increment;
            c.numlenbits += increment;
            int segno = 0;
            if (!c.numsegs) {
              init_seg(c, 0, r.sty, true);
            } else {
              segno = c.numsegs - 1;
              if (c.segs[segno].numpasses == c.segs[segno].maxpasses) init_seg(c, ++segno, r.sty, false);
            }
            int64_t n = c.numnewpasses;
            for (;;) {
              Seg& sg = c.segs[segno];
              sg.numnewpasses = std::min(sg.maxpasses - sg.numpasses, n);
              int bits = c.numlenbits;
              for (int64_t v = sg.numnewpasses; v > 1; v >>= 1) ++bits;
              if (bits > 32) throw T2Error{"invalid bit number in a packet header"};
              sg.newlen = static_cast<int64_t>(bio.read(bits));
              n -= sg.numnewpasses;
              if (n <= 0) break;
              init_seg(c, ++segno, r.sty, false);
            }
            included.push_back(r.g0 + k);
          }
        }
      }
      bio.inalign();
      const uint8_t* hbuf = hdr ? hdr : data;
      const int64_t hend = hdr ? hdr_len : len;
      int64_t hpos = bio.bp;
      if (csty & 4) {
        if (hend - hpos < 2 || hbuf[hpos] != 0xFF || hbuf[hpos + 1] != 0x92)
          throw T2Error{"expected EPH marker"};
        hpos += 2;
      }
      if (hdr) *hdr_pos = hpos;
      else pos = hpos;
      for (int64_t g : included) {  // opj_t2_read_packet_data
        T2Cblk& c = cb[g];
        int segno;
        if (!c.numsegs) {
          segno = 0;
          c.numsegs = 1;
        } else {
          segno = c.numsegs - 1;
          if (c.segs[segno].numpasses == c.segs[segno].maxpasses) {
            ++segno;
            ++c.numsegs;
          }
        }
        for (;;) {
          Seg& sg = c.segs[segno];
          if (pos + sg.newlen > len) throw T2Error{"read: segment too long for a code-block"};
          c.chunks.push_back({pos, sg.newlen});
          pos += sg.newlen;
          sg.len += sg.newlen;
          sg.numpasses += sg.numnewpasses;
          c.numnewpasses -= sg.numnewpasses;
          if (c.numnewpasses <= 0) break;
          ++segno;
          ++c.numsegs;
        }
      }
    }
  } catch (const T2Error& e) {
    std::snprintf(err, errlen, "%s", e.what);
    return 1;
  }
  int64_t nseg = 0, ndata = 0;
  for (int64_t g = 0; g < ncblk; ++g) {
    const T2Cblk& c = cb[g];
    cb_numbps[g] = c.numbps;
    cb_nsegs[g] = c.numsegs;
    cb_first_seg[g] = nseg;
    cb_data_off[g] = ndata;
    if (nseg + c.numsegs > seg_cap) {
      std::snprintf(err, errlen, "more segments than the tile's bytes allow");
      return 1;
    }
    for (int k = 0; k < c.numsegs; ++k) {
      seg_len[nseg] = static_cast<int32_t>(c.segs[k].len);
      seg_passes[nseg++] = static_cast<int32_t>(c.segs[k].numpasses);
    }
    for (const auto& ch : c.chunks) {
      std::memcpy(out_data + ndata, data + ch.first, ch.second);
      ndata += ch.second;
    }
  }
  return 0;
}

// Every code-block of a tile-component, dequantised into ``out`` ((h, w)
// int32 when ``reversible``, else float32, zero-filled), then the inverse
// DWT over its ``nres`` resolutions (``dims``: x0, y0, x1, y1 each).
// Code-block k: ``info`` holds x, y, w, h, orient, numbps, nsegs and its
// first segment's index; ``steps`` its float step size; its bytes start at
// ``offsets[k]`` in ``data``. Returns 0, or 1 + k for a block OpenJPEG fails.
int j2k_reconstruct_comp(const uint8_t* data, const int64_t* offsets, const int32_t* info,
                         const float* steps, const int32_t* lens, const int32_t* passes,
                         int ncblk, int roishift, int cblksty, int reversible, int w, int h,
                         int nres, const int32_t* dims, void* out) {
  std::vector<int32_t> tmp;
  for (int k = 0; k < ncblk; ++k) {
    const int32_t* in = info + 8 * k;
    const int x = in[0], y = in[1], cw = in[2], ch = in[3];
    tmp.assign(static_cast<size_t>(cw) * ch, 0);
    if (t1_decode(data + offsets[k], lens + in[7], passes + in[7], in[6], cw, ch, in[4], in[5],
                  roishift, cblksty, tmp.data(), cw))
      return 1 + k;
    for (int j = 0; j < ch; ++j)
      for (int i = 0; i < cw; ++i) {
        const int32_t v = tmp[static_cast<size_t>(j) * cw + i];
        const size_t at = static_cast<size_t>(y + j) * w + x + i;
        if (reversible) {
          static_cast<int32_t*>(out)[at] = v / 2;
        } else {
          const float s = 0.5f * steps[k];
          static_cast<float*>(out)[at] = static_cast<float>(v) * s;
        }
      }
  }
  if (reversible) {
    std::vector<int64_t> t;
    idwt2d(static_cast<int32_t*>(out), w, nres, dims,
           [&](int32_t* x, int n, int sn, int cas) { idwt53(x, n, sn, cas, 1, t); },
           [&](int32_t* b, size_t st, int rw, int n, int sn, int cas) {
             vertical53(b, st, rw, n, sn, cas, t);
           });
  } else {
    std::vector<float> t;
    idwt2d(static_cast<float*>(out), w, nres, dims,
           [&](float* x, int n, int sn, int cas) { idwt97(x, n, sn, cas, 1, t); },
           [&](float* b, size_t st, int rw, int n, int sn, int cas) {
             vertical97(b, st, rw, n, sn, cas, t);
           });
  }
  return 0;
}

// The RCT (``reversible``, int32 planes) or the ICT (float32 planes), in place.
void j2k_mct(void* c0, void* c1, void* c2, int64_t n, int reversible) {
  if (reversible) {
    int32_t *a = static_cast<int32_t*>(c0), *b = static_cast<int32_t*>(c1),
            *c = static_cast<int32_t*>(c2);
    for (int64_t i = 0; i < n; ++i) {
      const int32_t y = a[i], u = b[i], v = c[i];
      const int32_t g = y - ((u + v) >> 2);
      a[i] = v + g;
      b[i] = g;
      c[i] = u + g;
    }
  } else {
    float *a = static_cast<float*>(c0), *b = static_cast<float*>(c1), *c = static_cast<float*>(c2);
    for (int64_t i = 0; i < n; ++i) {
      const float y = a[i], u = b[i], v = c[i];
      const float r = y + (v * 1.402f);
      const float g = (y - (u * 0.34413f)) - (v * 0.71414f);
      const float bb = y + (u * 1.772f);
      a[i] = r;
      b[i] = g;
      c[i] = bb;
    }
  }
}

// opj_tcd_dc_level_shift_decode of one plane into ``out`` (int32).
void j2k_level_shift(const void* in, int64_t n, int prec, int sgnd, int reversible,
                     int32_t* out) {
  const int32_t shift = sgnd ? 0 : 1 << (prec - 1);
  const int64_t lo = sgnd ? -(int64_t(1) << (prec - 1)) : 0;
  const int64_t hi = sgnd ? (int64_t(1) << (prec - 1)) - 1 : (int64_t(1) << prec) - 1;
  for (int64_t i = 0; i < n; ++i) {
    int64_t v;
    if (reversible) {
      v = static_cast<int64_t>(static_cast<const int32_t*>(in)[i]) + shift;
    } else {
      const float f = static_cast<const float*>(in)[i];
      if (f > 2147483648.0f) v = hi;
      else if (f < -2147483648.0f || std::isnan(f)) v = lo;
      else v = static_cast<int64_t>(std::nearbyint(f)) + shift;
    }
    out[i] = static_cast<int32_t>(v < lo ? lo : (v > hi ? hi : v));
  }
}

}  // extern "C"
