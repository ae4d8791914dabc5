// The block decoders of DDS textures (utils/dds.py), as Pillow's bcn.c
// decodes them: BC1-BC5, BC6H (unsigned and signed) and BC7. Each equals
// utils/dds.py's bcn_decode_python byte for byte; this exists because a
// 2048 x 1536 BC7 texture takes minutes in Python. blp_dxt_decode is the
// DXT1/3/5 of BLP2 textures as BlpImagePlugin's Python decoders decode
// them (5-6-5 widened by a shift alone), equal to utils/blp.py's
// dxt_decode_python.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 bcn_decode.cpp (native/__init__.py
// does it at first use).

#include <cstdint>
#include <cstring>

namespace {

struct Rgba {
  uint8_t r, g, b, a;
};

// BC7 modes: subsets, partition bits, rotation bits, index selection bit,
// colour bits, alpha bits, endpoint p-bits, shared p-bits, index bits,
// second index bits.
const uint8_t kBc7Modes[8][10] = {
    {3, 4, 0, 0, 4, 0, 1, 0, 3, 0}, {2, 6, 0, 0, 6, 0, 0, 1, 3, 0},
    {3, 6, 0, 0, 5, 0, 0, 0, 2, 0}, {2, 6, 0, 0, 7, 0, 1, 0, 2, 0},
    {1, 0, 2, 1, 5, 6, 0, 0, 2, 3}, {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},
    {1, 0, 0, 0, 7, 7, 1, 0, 4, 0}, {2, 6, 0, 0, 5, 5, 1, 0, 2, 0}};
// BC6H modes: subsets, transformed, partition bits, endpoint bits, delta
// bits of r, g and b.
const uint8_t kBc6Modes[14][7] = {
    {2, 1, 5, 10, 5, 5, 5}, {2, 1, 5, 7, 6, 6, 6},   {2, 1, 5, 11, 5, 4, 4},
    {2, 1, 5, 11, 4, 5, 4}, {2, 1, 5, 11, 4, 4, 5},  {2, 1, 5, 9, 5, 5, 5},
    {2, 1, 5, 8, 6, 5, 5},  {2, 1, 5, 8, 5, 6, 5},   {2, 1, 5, 8, 5, 5, 6},
    {2, 0, 5, 6, 6, 6, 6},  {1, 0, 0, 10, 10, 10, 10}, {1, 1, 0, 11, 9, 9, 9},
    {1, 1, 0, 12, 8, 8, 8}, {1, 1, 0, 16, 4, 4, 4}};
const uint8_t kWeights2[4] = {0, 21, 43, 64};
const uint8_t kWeights3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
const uint8_t kWeights4[16] = {0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64};

static const uint16_t kSi2[64] = {
    0xcccc, 0x8888, 0xeeee, 0xecc8, 0xc880, 0xfeec, 0xfec8, 0xec80, 0xc800, 0xffec,
    0xfe80, 0xe800, 0xffe8, 0xff00, 0xfff0, 0xf000, 0xf710, 0x008e, 0x7100, 0x08ce,
    0x008c, 0x7310, 0x3100, 0x8cce, 0x088c, 0x3110, 0x6666, 0x366c, 0x17e8, 0x0ff0,
    0x718e, 0x399c, 0xaaaa, 0xf0f0, 0x5a5a, 0x33cc, 0x3c3c, 0x55aa, 0x9696, 0xa55a,
    0x73ce, 0x13c8, 0x324c, 0x3bdc, 0x6996, 0xc33c, 0x9966, 0x0660, 0x0272, 0x04e4,
    0x4e40, 0x2720, 0xc936, 0x936c, 0x39c6, 0x639c, 0x9336, 0x9cc6, 0x817e, 0xe718,
    0xccf0, 0x0fcc, 0x7744, 0xee22,
};
static const uint32_t kSi3[64] = {
    0xaa685050, 0x6a5a5040, 0x5a5a4200, 0x5450a0a8, 0xa5a50000, 0xa0a05050,
    0x5555a0a0, 0x5a5a5050, 0xaa550000, 0xaa555500, 0xaaaa5500, 0x90909090,
    0x94949494, 0xa4a4a4a4, 0xa9a59450, 0x2a0a4250, 0xa5945040, 0x0a425054,
    0xa5a5a500, 0x55a0a0a0, 0xa8a85454, 0x6a6a4040, 0xa4a45000, 0x1a1a0500,
    0x0050a4a4, 0xaaa59090, 0x14696914, 0x69691400, 0xa08585a0, 0xaa821414,
    0x50a4a450, 0x6a5a0200, 0xa9a58000, 0x5090a0a8, 0xa8a09050, 0x24242424,
    0x00aa5500, 0x24924924, 0x24499224, 0x50a50a50, 0x500aa550, 0xaaaa4444,
    0x66660000, 0xa5a0a5a0, 0x50a050a0, 0x69286928, 0x44aaaa44, 0x66666600,
    0xaa444444, 0x54a854a8, 0x95809580, 0x96969600, 0xa85454a8, 0x80959580,
    0xaa141414, 0x96960000, 0xaaaa1414, 0xa05050a0, 0xa0a5a5a0, 0x96000000,
    0x40804080, 0xa9a8a9a8, 0xaaaaaa44, 0x2a4a5254,
};
static const uint8_t kAi0[64] = {
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 2, 8, 2, 2, 8, 8, 15, 2, 8, 2, 2, 8, 8, 2, 2,
    15, 15, 6, 8, 2, 8, 15, 15, 2, 8, 2, 2, 2, 15, 15, 6, 6, 2, 6, 8, 15, 15, 2, 2, 15, 15, 15, 15, 15, 2, 2, 15,
};
static const uint8_t kAi1[64] = {
    3, 3, 15, 15, 8, 3, 15, 15, 8, 8, 6, 6, 6, 5, 3, 3, 3, 3, 8, 15, 3, 3, 6, 10, 5, 8, 8, 6, 8, 5, 15, 15,
    8, 15, 3, 5, 6, 10, 8, 15, 15, 3, 15, 5, 15, 15, 15, 15, 3, 15, 5, 5, 5, 8, 5, 10, 5, 10, 8, 13, 15, 12, 3, 3,
};
static const uint8_t kAi2[64] = {
    15, 8, 8, 3, 15, 15, 3, 8, 15, 15, 15, 15, 15, 15, 15, 8, 15, 8, 15, 3, 15, 8, 15, 8, 3, 15, 6, 10, 15, 15, 10, 8,
    15, 3, 15, 10, 10, 8, 9, 10, 6, 15, 8, 15, 3, 6, 6, 8, 15, 3, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3, 15, 15, 8,
};
static const uint8_t kBc6Bits[14][75] = {
    {116, 132, 180, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 176, 160, 161, 162, 163, 80, 81, 82, 83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145, 146, 147, 148, 179},
    {117, 164, 165, 0, 1, 2, 3, 4, 5, 6, 176, 177, 132, 16, 17, 18, 19, 20, 21, 22, 133, 178, 116, 32, 33, 34, 35, 36, 37, 38, 179, 181, 180, 48, 49, 50, 51, 52, 53, 112, 113, 114, 115, 64, 65, 66, 67, 68, 69, 160, 161, 162, 163, 80, 81, 82, 83, 84, 85, 128, 129, 130, 131, 96, 97, 98, 99, 100, 101, 144, 145, 146, 147, 148, 149},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 10, 112, 113, 114, 115, 64, 65, 66, 67, 26, 176, 160, 161, 162, 163, 80, 81, 82, 83, 42, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145, 146, 147, 148, 179},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 10, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 26, 160, 161, 162, 163, 80, 81, 82, 83, 42, 177, 128, 129, 130, 131, 96, 97, 98, 99, 176, 178, 144, 145, 146, 147, 116, 179},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 10, 132, 112, 113, 114, 115, 64, 65, 66, 67, 26, 176, 160, 161, 162, 163, 80, 81, 82, 83, 84, 42, 128, 129, 130, 131, 96, 97, 98, 99, 177, 178, 144, 145, 146, 147, 180, 179},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 132, 16, 17, 18, 19, 20, 21, 22, 23, 24, 116, 32, 33, 34, 35, 36, 37, 38, 39, 40, 180, 48, 49, 50, 51, 52, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 176, 160, 161, 162, 163, 80, 81, 82, 83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145, 146, 147, 148, 179},
    {0, 1, 2, 3, 4, 5, 6, 7, 164, 132, 16, 17, 18, 19, 20, 21, 22, 23, 178, 116, 32, 33, 34, 35, 36, 37, 38, 39, 179, 180, 48, 49, 50, 51, 52, 53, 112, 113, 114, 115, 64, 65, 66, 67, 68, 176, 160, 161, 162, 163, 80, 81, 82, 83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 101, 144, 145, 146, 147, 148, 149},
    {0, 1, 2, 3, 4, 5, 6, 7, 176, 132, 16, 17, 18, 19, 20, 21, 22, 23, 117, 116, 32, 33, 34, 35, 36, 37, 38, 39, 165, 180, 48, 49, 50, 51, 52, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 69, 160, 161, 162, 163, 80, 81, 82, 83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145, 146, 147, 148, 179},
    {0, 1, 2, 3, 4, 5, 6, 7, 177, 132, 16, 17, 18, 19, 20, 21, 22, 23, 133, 116, 32, 33, 34, 35, 36, 37, 38, 39, 181, 180, 48, 49, 50, 51, 52, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 176, 160, 161, 162, 163, 80, 81, 82, 83, 84, 85, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145, 146, 147, 148, 179},
    {0, 1, 2, 3, 4, 5, 164, 176, 177, 132, 16, 17, 18, 19, 20, 21, 117, 133, 178, 116, 32, 33, 34, 35, 36, 37, 165, 179, 181, 180, 48, 49, 50, 51, 52, 53, 112, 113, 114, 115, 64, 65, 66, 67, 68, 69, 160, 161, 162, 163, 80, 81, 82, 83, 84, 85, 128, 129, 130, 131, 96, 97, 98, 99, 100, 101, 144, 145, 146, 147, 148, 149},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 53, 54, 55, 56, 10, 64, 65, 66, 67, 68, 69, 70, 71, 72, 26, 80, 81, 82, 83, 84, 85, 86, 87, 88, 42},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 53, 54, 55, 11, 10, 64, 65, 66, 67, 68, 69, 70, 71, 27, 26, 80, 81, 82, 83, 84, 85, 86, 87, 43, 42},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 15, 14, 13, 12, 11, 10, 64, 65, 66, 67, 31, 30, 29, 28, 27, 26, 80, 81, 82, 83, 47, 46, 45, 44, 43, 42}};

const uint8_t* weights(int n) { return n == 2 ? kWeights2 : n == 3 ? kWeights3 : kWeights4; }

int get_bit(const uint8_t* src, int bit) { return (src[bit >> 3] >> (bit & 7)) & 1; }

int get_bits(const uint8_t* src, int bit, int count) {
  if (!count) return 0;
  int by = bit >> 3;
  bit &= 7;
  if (bit + count <= 8) return (src[by] >> bit) & ((1 << count) - 1);
  int x = src[by] | (src[by + 1] << 8);
  return (x >> bit) & ((1 << count) - 1);
}

int subset(int ns, int partition, int n) {
  if (ns == 2) return 1 & (kSi2[partition] >> n);
  if (ns == 3) return 3 & (kSi3[partition] >> (2 * n));
  return 0;
}

Rgba rgb565(int x) {
  int r = (x & 0xf800) >> 8, g = (x & 0x7e0) >> 3, b = (x & 0x1f) << 3;
  return {static_cast<uint8_t>(r | r >> 5), static_cast<uint8_t>(g | g >> 6),
          static_cast<uint8_t>(b | b >> 5), 255};
}

void bc1_colour(Rgba* dst, const uint8_t* src, bool four_always) {
  int c0 = src[0] | src[1] << 8, c1 = src[2] | src[3] << 8;
  uint32_t lut = src[4] | src[5] << 8 | src[6] << 16 | static_cast<uint32_t>(src[7]) << 24;
  Rgba p[4];
  p[0] = rgb565(c0);
  p[1] = rgb565(c1);
  int r0 = p[0].r, g0 = p[0].g, b0 = p[0].b, r1 = p[1].r, g1 = p[1].g, b1 = p[1].b;
  if (c0 > c1 || four_always) {
    p[2] = {static_cast<uint8_t>((2 * r0 + r1) / 3), static_cast<uint8_t>((2 * g0 + g1) / 3),
            static_cast<uint8_t>((2 * b0 + b1) / 3), 255};
    p[3] = {static_cast<uint8_t>((r0 + 2 * r1) / 3), static_cast<uint8_t>((g0 + 2 * g1) / 3),
            static_cast<uint8_t>((b0 + 2 * b1) / 3), 255};
  } else {
    p[2] = {static_cast<uint8_t>((r0 + r1) / 2), static_cast<uint8_t>((g0 + g1) / 2),
            static_cast<uint8_t>((b0 + b1) / 2), 255};
    p[3] = {0, 0, 0, 0};
  }
  for (int n = 0; n < 16; ++n) dst[n] = p[3 & (lut >> (2 * n))];
}

// BC3/BC4/BC5 alpha block into byte ``o`` of each ``stride``-byte pixel.
void bc3_alpha(uint8_t* dst, const uint8_t* src, int stride, int o, bool sign) {
  int a0 = sign ? static_cast<int8_t>(src[0]) + 128 : src[0];
  int a1 = sign ? static_cast<int8_t>(src[1]) + 128 : src[1];
  uint8_t a[8];
  a[0] = static_cast<uint8_t>(a0);
  a[1] = static_cast<uint8_t>(a1);
  if (a0 > a1) {
    for (int k = 1; k < 7; ++k) a[k + 1] = static_cast<uint8_t>(((7 - k) * a0 + k * a1) / 7);
  } else {
    for (int k = 1; k < 5; ++k) a[k + 1] = static_cast<uint8_t>(((5 - k) * a0 + k * a1) / 5);
    a[6] = 0;
    a[7] = 255;
  }
  int lut1 = src[2] | src[3] << 8 | src[4] << 16, lut2 = src[5] | src[6] << 8 | src[7] << 16;
  for (int n = 0; n < 8; ++n) dst[stride * n + o] = a[7 & (lut1 >> (3 * n))];
  for (int n = 0; n < 8; ++n) dst[stride * (8 + n) + o] = a[7 & (lut2 >> (3 * n))];
}

void bc7_lerp(Rgba* dst, const Rgba* e, int s0, int s1) {
  int t0 = 64 - s0, t1 = 64 - s1;
  dst->r = static_cast<uint8_t>((t0 * e[0].r + s0 * e[1].r + 32) >> 6);
  dst->g = static_cast<uint8_t>((t0 * e[0].g + s0 * e[1].g + 32) >> 6);
  dst->b = static_cast<uint8_t>((t0 * e[0].b + s0 * e[1].b + 32) >> 6);
  dst->a = static_cast<uint8_t>((t1 * e[0].a + s1 * e[1].a + 32) >> 6);
}

uint8_t expand(uint8_t v, int bits) {
  v = static_cast<uint8_t>(v << (8 - bits));
  return static_cast<uint8_t>(v | (v >> bits));
}

void bc7_block(Rgba* col, const uint8_t* src) {
  if (!src[0]) {
    for (int i = 0; i < 16; ++i) col[i] = {0, 0, 0, 255};
    return;
  }
  int bit = 0;
  while (!(src[0] & (1 << bit))) ++bit;
  const uint8_t* info = kBc7Modes[bit];
  ++bit;
  int ns = info[0], cb = info[4], ab = info[5], ib = info[8], ib2 = info[9];
  const uint8_t* cw = weights(ib);
  const uint8_t* aw = weights(ab && ib2 ? ib2 : ib);
  int partition = get_bits(src, bit, info[1]);
  bit += info[1];
  int rotation = get_bits(src, bit, info[2]);
  bit += info[2];
  int index_sel = get_bits(src, bit, info[3]);
  bit += info[3];
  int numep = ns << 1;
  Rgba ep[6];
  for (int i = 0; i < numep; ++i, bit += cb) ep[i].r = static_cast<uint8_t>(get_bits(src, bit, cb));
  for (int i = 0; i < numep; ++i, bit += cb) ep[i].g = static_cast<uint8_t>(get_bits(src, bit, cb));
  for (int i = 0; i < numep; ++i, bit += cb) ep[i].b = static_cast<uint8_t>(get_bits(src, bit, cb));
  for (int i = 0; i < numep; ++i) {
    if (ab) {
      ep[i].a = static_cast<uint8_t>(get_bits(src, bit, ab));
      bit += ab;
    } else {
      ep[i].a = 0xff;
    }
  }
  auto with_p = [&](Rgba& e, int p) {
    e.r = static_cast<uint8_t>(e.r << 1 | p);
    e.g = static_cast<uint8_t>(e.g << 1 | p);
    e.b = static_cast<uint8_t>(e.b << 1 | p);
    if (ab) e.a = static_cast<uint8_t>(e.a << 1 | p);
  };
  if (info[6]) {
    ++cb;
    if (ab) ++ab;
    for (int i = 0; i < numep; ++i) with_p(ep[i], get_bits(src, bit++, 1));
  }
  if (info[7]) {
    ++cb;
    if (ab) ++ab;
    for (int i = 0; i < numep; i += 2) {
      int p = get_bits(src, bit++, 1);
      with_p(ep[i], p);
      with_p(ep[i + 1], p);
    }
  }
  for (int i = 0; i < numep; ++i) {
    ep[i].r = expand(ep[i].r, cb);
    ep[i].g = expand(ep[i].g, cb);
    ep[i].b = expand(ep[i].b, cb);
    if (ab) ep[i].a = expand(ep[i].a, ab);
  }
  int cibit = bit, aibit = cibit + 16 * info[8] - ns;
  for (int i = 0; i < 16; ++i) {
    int s = subset(ns, partition, i) << 1;
    int n = ib;
    if (i == 0 || (ns == 2 && i == kAi0[partition]) ||
        (ns == 3 && (i == kAi1[partition] || i == kAi2[partition])))
      --n;
    int i0 = get_bits(src, cibit, n);
    cibit += n;
    if (ab && ib2) {
      int n2 = i == 0 ? ib2 - 1 : ib2;
      int i1 = get_bits(src, aibit, n2);
      aibit += n2;
      if (index_sel)
        bc7_lerp(&col[i], &ep[s], aw[i1], cw[i0]);
      else
        bc7_lerp(&col[i], &ep[s], cw[i0], aw[i1]);
    } else {
      bc7_lerp(&col[i], &ep[s], cw[i0], cw[i0]);
    }
    uint8_t t;
    if (rotation == 1) t = col[i].r, col[i].r = col[i].a, col[i].a = t;
    if (rotation == 2) t = col[i].g, col[i].g = col[i].a, col[i].a = t;
    if (rotation == 3) t = col[i].b, col[i].b = col[i].a, col[i].a = t;
  }
}

uint16_t sext(uint16_t v, int prec) {
  int x = v;
  if (x & (1 << (prec - 1))) x |= -1 << prec;
  return static_cast<uint16_t>(x);
}

int unquantize(uint16_t v, int prec, bool sign) {
  if (!sign) {
    int x = v;
    if (prec >= 15 || x == 0) return x;
    if (x == (1 << prec) - 1) return 0xffff;
    return ((x << 15) + 0x4000) >> (prec - 1);
  }
  int x = static_cast<int16_t>(v);
  if (prec >= 16) return x;
  bool neg = x < 0;
  if (neg) x = -x;
  if (x != 0) x = x >= (1 << (prec - 1)) - 1 ? 0x7fff : ((x << 15) + 0x4000) >> (prec - 1);
  return neg ? -x : x;
}

float half_to_float(uint16_t h) {
  union {
    uint32_t u;
    float f;
  } o, m;
  m.u = 0x77800000;
  o.u = static_cast<uint32_t>(h & 0x7fff) << 13;
  o.f *= m.f;
  m.u = 0x47800000;
  if (o.f >= m.f) o.u |= 255u << 23;
  o.u |= static_cast<uint32_t>(h & 0x8000) << 16;
  return o.f;
}

uint8_t bc6_channel(int v, bool sign) {
  float f;
  if (sign)
    f = v < 0 ? half_to_float(static_cast<uint16_t>(0x8000 | ((-v) * 31) / 32))
              : half_to_float(static_cast<uint16_t>((v * 31) / 32));
  else
    f = half_to_float(static_cast<uint16_t>((v * 31) / 64));
  if (f < 0.0f) return 0;
  if (f > 1.0f) return 255;
  return static_cast<uint8_t>(f * 255.0f);
}

void bc6_block(Rgba* col, const uint8_t* src, bool sign) {
  int bit = 5, epbits = 75, ib = 3, mode = src[0] & 0x1f;
  if ((mode & 3) == 0 || (mode & 3) == 1) {
    mode &= 3;
    bit = 2;
  } else if ((mode & 3) == 2) {
    mode = 2 + (mode >> 2);
    epbits = 72;
  } else {
    mode = 10 + (mode >> 2);
    epbits = 60;
    ib = 4;
  }
  if (mode >= 14) {
    std::memset(col, 0, 16 * sizeof(Rgba));
    return;
  }
  const uint8_t* info = kBc6Modes[mode];
  const uint8_t* cw = weights(ib);
  int numep = info[0] == 2 ? 12 : 6, epb = info[3];
  uint16_t ep[12] = {0};
  for (int i = 0; i < epbits; ++i) {
    int d = kBc6Bits[mode][i];
    ep[d >> 4] = static_cast<uint16_t>(ep[d >> 4] | get_bit(src, bit + i) << (d & 15));
  }
  bit += epbits;
  int partition = get_bits(src, bit, info[2]);
  bit += info[2];
  int mask = (1 << epb) - 1;
  if (sign)
    for (int c = 0; c < 3; ++c) ep[c] = sext(ep[c], epb);
  if (sign || info[1])
    for (int i = 3; i < numep; i += 3)
      for (int c = 0; c < 3; ++c) ep[i + c] = sext(ep[i + c], info[4 + c]);
  if (info[1])  // the sums are not sign-extended again, as in bcn.c
    for (int i = 3; i < numep; ++i) ep[i] = static_cast<uint16_t>((ep[i] + ep[i % 3]) & mask);
  int ueps[12];
  for (int i = 0; i < numep; ++i) ueps[i] = unquantize(ep[i], epb, sign);
  for (int i = 0; i < 16; ++i) {
    int s = subset(info[0], partition, i) * 6;
    int n = (i == 0 || (info[0] == 2 && i == kAi0[partition])) ? ib - 1 : ib;
    int w = cw[get_bits(src, bit, n)];
    bit += n;
    int t = 64 - w;
    col[i].r = bc6_channel((ueps[s] * t + ueps[s + 3] * w) >> 6, sign);
    col[i].g = bc6_channel((ueps[s + 1] * t + ueps[s + 4] * w) >> 6, sign);
    col[i].b = bc6_channel((ueps[s + 2] * t + ueps[s + 5] * w) >> 6, sign);
    col[i].a = 0;
  }
}

}  // namespace

extern "C" {

// Blocks of bcn.c's format ``n`` (1 BC1 ... 7 BC7; ``sign`` for BC5S and
// BC6H signed) covering ``width`` x ``height`` into ``out``: RGBA pixels,
// or one byte a pixel for BC4. ``data`` holds every block.
void bcn_decode(const uint8_t* data, int n, int sign, int width, int height, uint8_t* out) {
  const int bw = (width + 3) / 4, bh = (height + 3) / 4, size = (n == 1 || n == 4) ? 8 : 16;
  const int channels = n == 4 ? 1 : 4;
  for (int by = 0; by < bh; ++by) {
    for (int bx = 0; bx < bw; ++bx) {
      const uint8_t* src = data + (static_cast<int64_t>(by) * bw + bx) * size;
      Rgba col[16];
      std::memset(col, 0, sizeof(col));
      switch (n) {
        case 1: bc1_colour(col, src, false); break;
        case 2:
          bc1_colour(col, src + 8, true);
          for (int k = 0; k < 16; ++k) {
            int v = 0xf & (src[k >> 1] >> (4 * (k & 1)));
            col[k].a = static_cast<uint8_t>(v << 4 | v);
          }
          break;
        case 3:
          bc1_colour(col, src + 8, true);
          bc3_alpha(reinterpret_cast<uint8_t*>(col), src, 4, 3, false);
          break;
        case 4: bc3_alpha(reinterpret_cast<uint8_t*>(col), src, 1, 0, false); break;
        case 5:
          bc3_alpha(reinterpret_cast<uint8_t*>(col), src, 4, 0, sign);
          bc3_alpha(reinterpret_cast<uint8_t*>(col), src + 8, 4, 1, sign);
          if (sign)
            for (int k = 0; k < 16; ++k) col[k].b = 128;
          break;
        case 6: bc6_block(col, src, sign); break;
        default: bc7_block(col, src); break;
      }
      const uint8_t* px = reinterpret_cast<const uint8_t*>(col);
      for (int y = 0; y < 4 && by * 4 + y < height; ++y)
        for (int x = 0; x < 4 && bx * 4 + x < width; ++x)
          std::memcpy(out + ((static_cast<int64_t>(by) * 4 + y) * width + bx * 4 + x) * channels,
                      px + (y * 4 + x) * channels, channels);
    }
  }
}

// BLP2's DXT blocks (fmt 1, 3 or 5) as BlpImagePlugin's decode_dxt1/3/5:
// block rows of 4 lines of 4 * ceil(width / 4) pixels, each pixel RGBA, or
// RGB for DXT1 without ``alpha``, into ``out``.
void blp_dxt_decode(const uint8_t* data, int fmt, int alpha, int width, int height,
                    uint8_t* out) {
  const int bw = (width + 3) / 4, bh = (height + 3) / 4, size = fmt == 1 ? 8 : 16;
  const int bands = fmt == 1 && !alpha ? 3 : 4;
  const int64_t line = static_cast<int64_t>(bw) * 4 * bands;
  for (int by = 0; by < bh; ++by) {
    for (int bx = 0; bx < bw; ++bx) {
      const uint8_t* blk = data + (static_cast<int64_t>(by) * bw + bx) * size;
      const uint8_t* col = fmt == 1 ? blk : blk + 8;
      const int c0 = col[0] | col[1] << 8, c1 = col[2] | col[3] << 8;
      const uint32_t code = col[4] | col[5] << 8 | col[6] << 16 | static_cast<uint32_t>(col[7]) << 24;
      int e[2][3];
      for (int k = 0; k < 2; ++k) {
        const int v = k ? c1 : c0;
        e[k][0] = ((v >> 11) & 31) << 3;
        e[k][1] = ((v >> 5) & 63) << 2;
        e[k][2] = (v & 31) << 3;
      }
      const bool four = fmt != 1 || c0 > c1;
      uint64_t abits = 0;
      if (fmt == 5)
        for (int k = 0; k < 6; ++k) abits |= static_cast<uint64_t>(blk[2 + k]) << (8 * k);
      for (int p = 0; p < 16; ++p) {
        const int j = p / 4, i = p % 4, c = (code >> (2 * p)) & 3;
        int rgb[3], a = 255;
        for (int ch = 0; ch < 3; ++ch) {
          if (c < 2) {
            rgb[ch] = e[c][ch];
          } else if (four) {
            rgb[ch] = c == 2 ? (2 * e[0][ch] + e[1][ch]) / 3 : (2 * e[1][ch] + e[0][ch]) / 3;
          } else {
            rgb[ch] = c == 2 ? (e[0][ch] + e[1][ch]) / 2 : 0;
          }
        }
        if (fmt == 1) {
          if (c == 3 && !four) a = 0;
        } else if (fmt == 3) {
          a = ((blk[p / 2] >> (4 * (p & 1))) & 15) * 17;
        } else {
          const int a0 = blk[0], a1 = blk[1], k = (abits >> (3 * p)) & 7;
          if (k == 0) a = a0;
          else if (k == 1) a = a1;
          else if (a0 > a1) a = ((8 - k) * a0 + (k - 1) * a1) / 7;
          else if (k == 6) a = 0;
          else if (k == 7) a = 255;
          else a = ((6 - k) * a0 + (k - 1) * a1) / 5;
        }
        uint8_t* px = out + (static_cast<int64_t>(by) * 4 + j) * line + (bx * 4 + i) * bands;
        px[0] = static_cast<uint8_t>(rgb[0]);
        px[1] = static_cast<uint8_t>(rgb[1]);
        px[2] = static_cast<uint8_t>(rgb[2]);
        if (bands == 4) px[3] = static_cast<uint8_t>(a);
      }
    }
  }
}

}  // extern "C"
