// The WebP decoder of utils/webp.py: a VP8 key frame (RFC 6386, as
// libwebp's vp8_dec.c, tree_dec.c, quant_dec.c and frame_dec.c decode it)
// with its ALPH chunk, or a VP8L lossless image (libwebp's vp8l_dec.c), to
// RGBA as libwebp's default output writes it (the fancy 4:2:0 upsampler,
// VP8YUVToR/G/B). It equals the plain Python decoders of utils/vp8.py,
// utils/vp8l.py and utils/webp.py byte for byte; it exists because a
// 2048 x 1536 picture takes minutes in Python.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 webp_decode.cpp (native/__init__.py
// does it at first use).

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};
const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};
const uint8_t kCoeffsProba0[4 * 8 * 3 * 11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};
const uint8_t kCoeffsUpdateProba[4 * 8 * 3 * 11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};
const uint8_t kBModesProba[10 * 10 * 9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,
};


const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCats[4] = {kCat3, kCat4, kCat5, kCat6};
const int8_t kYModesIntra4[18] = {0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8, -9};
enum { DC = 0, TM = 1, VE = 2, HE = 3 };

// ---------------------------------------------------------------- VP8 lossy

class BoolDecoder {
 public:
  BoolDecoder() = default;
  BoolDecoder(const uint8_t* data, int64_t start, int64_t end)
      : data_(data), pos_(start), end_(end), limit_(8 * (end - start) - 8) {
    value_ = next() << 8;
    value_ |= next();
  }
  // VP8GetSigned's bit: libwebp always shifts once there (``ahead_``)
  int sign() {
    int64_t before = shifts_;
    int b = bit(128);
    ahead_ = shifts_ == before ? 1 : 0;
    return b;
  }
  int bit(int prob) {
    // libwebp's eof_: a bit wanted after more than 8 * size - 8 shifts
    if (shifts_ + ahead_ > limit_) throw Error("a VP8 partition ends early (libwebp: premature end of data)");
    ahead_ = 0;
    unsigned split = 1 + (((range_ - 1) * static_cast<unsigned>(prob)) >> 8);
    unsigned big = split << 8;
    int bit;
    if (value_ >= big) {
      bit = 1;
      range_ -= split;
      value_ -= big;
    } else {
      bit = 0;
      range_ = split;
    }
    while (range_ < 128) {
      value_ <<= 1;
      range_ <<= 1;
      ++shifts_;
      if (++count_ == 8) {
        count_ = 0;
        value_ |= next();
      }
    }
    return bit;
  }
  int literal(int n) {
    int v = 0;
    while (n--) v = (v << 1) | bit(128);
    return v;
  }
  int signed_value(int n) {
    int v = literal(n);
    return bit(128) ? -v : v;
  }

 private:
  unsigned next() {
    ++pos_;
    return pos_ <= end_ ? data_[pos_ - 1] : 0;
  }
  const uint8_t* data_ = nullptr;
  int64_t pos_ = 0, end_ = 0, limit_ = 0, shifts_ = 0;
  int ahead_ = 0;
  unsigned value_ = 0, range_ = 255;
  int count_ = 0;
};

inline int clip(int v, int top) { return v < 0 ? 0 : v > top ? top : v; }
inline int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

struct Quant {
  int y1[2], y2[2], uv[2];
};

struct Header {
  int width, height;
  BoolDecoder br;
  int use_segment = 0, update_map = 0, absolute = 1;
  int quantizer[4] = {0, 0, 0, 0}, strength[4] = {0, 0, 0, 0};
  int segment_proba[3] = {255, 255, 255};
  int simple = 0, level = 0, sharpness = 0, use_lf_delta = 0, filter_type = 0;
  int ref_delta[4] = {0, 0, 0, 0}, mode_delta[4] = {0, 0, 0, 0};
  std::vector<BoolDecoder> parts;
  Quant quant[4];
  uint8_t proba[4 * 8 * 3 * 11];
  int use_skip = 0, skip_proba = 0;
};

void parse_header(const uint8_t* data, int64_t n, Header& h) {
  if (n < 10) throw Error("a VP8 frame shorter than its header");
  uint32_t bits = data[0] | data[1] << 8 | data[2] << 16;
  if ((bits & 1) || ((bits >> 1) & 7) > 3 || !((bits >> 4) & 1))
    throw Error("not a displayable VP8 key frame");
  if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a)
    throw Error("a VP8 key frame without its start code");
  h.width = (data[6] | data[7] << 8) & 0x3fff;
  h.height = (data[8] | data[9] << 8) & 0x3fff;
  if (!h.width || !h.height) throw Error("a VP8 frame of size 0");
  int64_t part0 = bits >> 5;
  if (10 + part0 > n) throw Error("the first VP8 partition runs past the frame");
  h.br = BoolDecoder(data, 10, 10 + part0);
  BoolDecoder& br = h.br;
  br.literal(2);
  h.use_segment = br.bit(128);
  if (h.use_segment) {
    h.update_map = br.bit(128);
    if (br.bit(128)) {
      h.absolute = br.bit(128);
      for (int s = 0; s < 4; ++s) h.quantizer[s] = br.bit(128) ? br.signed_value(7) : 0;
      for (int s = 0; s < 4; ++s) h.strength[s] = br.bit(128) ? br.signed_value(6) : 0;
    }
    if (h.update_map)
      for (int s = 0; s < 3; ++s) h.segment_proba[s] = br.bit(128) ? br.literal(8) : 255;
  }
  h.simple = br.bit(128);
  h.level = br.literal(6);
  h.sharpness = br.literal(3);
  h.use_lf_delta = br.bit(128);
  if (h.use_lf_delta && br.bit(128)) {
    for (int i = 0; i < 4; ++i)
      if (br.bit(128)) h.ref_delta[i] = br.signed_value(6);
    for (int i = 0; i < 4; ++i)
      if (br.bit(128)) h.mode_delta[i] = br.signed_value(6);
  }
  h.filter_type = h.level == 0 ? 0 : h.simple ? 1 : 2;
  int last = (1 << br.literal(2)) - 1;
  int64_t start = 10 + part0;
  if (n - start < 3 * last) throw Error("the VP8 partition sizes run past the frame");
  int64_t at = start + 3 * last, left = n - start - 3 * last;
  for (int p = 0; p < last; ++p) {
    const uint8_t* sz = data + start + 3 * p;
    int64_t size = std::min<int64_t>(sz[0] | sz[1] << 8 | sz[2] << 16, left);
    h.parts.emplace_back(data, at, at + size);
    at += size;
    left -= size;
  }
  if (at >= n) throw Error("the last VP8 partition is empty");
  h.parts.emplace_back(data, at, n);
  int base = br.literal(7);
  int dq[5];
  for (int i = 0; i < 5; ++i) dq[i] = br.bit(128) ? br.signed_value(4) : 0;
  for (int s = 0; s < 4; ++s) {
    int q = h.use_segment ? h.quantizer[s] + (h.absolute ? 0 : base) : base;
    Quant& m = h.quant[s];
    m.y1[0] = kDcTable[clip(q + dq[0], 127)];
    m.y1[1] = kAcTable[clip(q, 127)];
    m.y2[0] = kDcTable[clip(q + dq[1], 127)] * 2;
    m.y2[1] = std::max((kAcTable[clip(q + dq[2], 127)] * 101581) >> 16, 8);
    m.uv[0] = kDcTable[clip(q + dq[3], 117)];
    m.uv[1] = kAcTable[clip(q + dq[4], 127)];
  }
  br.bit(128);
  for (int i = 0; i < 4 * 8 * 3 * 11; ++i)
    h.proba[i] = br.bit(kCoeffsUpdateProba[i]) ? static_cast<uint8_t>(br.literal(8))
                                               : kCoeffsProba0[i];
  h.use_skip = br.bit(128);
  h.skip_proba = h.use_skip ? br.literal(8) : 0;
}

inline const uint8_t* proba_at(const Header& h, int t, int band, int ctx) {
  return h.proba + ((t * 8 + band) * 3 + ctx) * 11;
}

int get_coeffs(BoolDecoder& br, const Header& h, int t, int ctx, const int* dq, int n,
               int* out) {
  const uint8_t* p = proba_at(h, t, kBands[n], ctx);
  while (n < 16) {
    if (!br.bit(p[0])) return n;
    while (!br.bit(p[1])) {
      if (++n == 16) return 16;
      p = proba_at(h, t, kBands[n], 0);
    }
    int v;
    if (!br.bit(p[2])) {
      v = 1;
      p = proba_at(h, t, kBands[n + 1], 1);
    } else {
      if (!br.bit(p[3])) {
        v = !br.bit(p[4]) ? 2 : 3 + br.bit(p[5]);
      } else if (!br.bit(p[6])) {
        if (!br.bit(p[7])) {
          v = 5 + br.bit(159);
        } else {
          v = 7 + 2 * br.bit(165);
          v += br.bit(145);
        }
      } else {
        int bit1 = br.bit(p[8]);
        int cat = 2 * bit1 + br.bit(p[9 + bit1]);
        v = 0;
        for (const uint8_t* tab = kCats[cat]; *tab; ++tab) v += v + br.bit(*tab);
        v += 3 + (8 << cat);
      }
      p = proba_at(h, t, kBands[n + 1], 2);
    }
    // libwebp keeps the dequantised coefficient in an int16_t
    out[kZigzag[n]] = static_cast<int16_t>((br.sign() ? -v : v) * dq[n > 0]);
    ++n;
  }
  return 16;
}

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

// TransformOne: dst (stride ``stride``) plus the inverse DCT of ``in``.
void idct_add(const int* in, int* dst, int stride) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    int a = in[i] + in[8 + i], b = in[i] - in[8 + i];
    int c = mul2(in[4 + i]) - mul1(in[12 + i]), d = mul1(in[4 + i]) + mul2(in[12 + i]);
    tmp[4 * i + 0] = a + d;
    tmp[4 * i + 1] = b + c;
    tmp[4 * i + 2] = b - c;
    tmp[4 * i + 3] = a - d;
  }
  for (int i = 0; i < 4; ++i) {
    int dc = tmp[i] + 4;
    int a = dc + tmp[8 + i], b = dc - tmp[8 + i];
    int c = mul2(tmp[4 + i]) - mul1(tmp[12 + i]), d = mul1(tmp[4 + i]) + mul2(tmp[12 + i]);
    int* row = dst + i * stride;
    row[0] = clip255(row[0] + ((a + d) >> 3));
    row[1] = clip255(row[1] + ((b + c) >> 3));
    row[2] = clip255(row[2] + ((b - c) >> 3));
    row[3] = clip255(row[3] + ((a - d) >> 3));
  }
}

inline int w16(int x) { return static_cast<int16_t>(static_cast<uint16_t>(x)); }
inline int mulhi(int x, int k) { return (x * k) >> 16; }

// One pass of libwebp's Transform_SSE2 over rows r0..r3 (4 lanes): every sum
// in 16-bit lanes, the constants' products by mulhi.
void pass_sse2(const int* r0, const int* r1, const int* r2, const int* r3, int out[4][4]) {
  for (int i = 0; i < 4; ++i) {
    int a = w16(r0[i] + r2[i]), b = w16(r0[i] - r2[i]);
    int c = w16(w16(r1[i] - r3[i]) + w16(mulhi(r1[i], -30068) - mulhi(r3[i], 20091)));
    int d = w16(w16(r1[i] + r3[i]) + w16(mulhi(r1[i], 20091) + mulhi(r3[i], -30068)));
    out[0][i] = w16(a + d);
    out[1][i] = w16(b + c);
    out[2][i] = w16(b - c);
    out[3][i] = w16(a - d);
  }
}

// libwebp's Transform_SSE2 (the full transform on x86): as idct_add while
// values stay in 16 bits, else wrapped there.
void idct_add_sse2(const int* in, int* dst, int stride) {
  int v[4][4], t[4][4], o[4][4];
  pass_sse2(in, in + 4, in + 8, in + 12, v);                // v[k][col]
  for (int i = 0; i < 4; ++i) {
    t[0][i] = w16(v[i][0] + 4);
    t[1][i] = v[i][1];
    t[2][i] = v[i][2];
    t[3][i] = v[i][3];
  }
  pass_sse2(t[0], t[1], t[2], t[3], o);                     // o[k][row]
  for (int i = 0; i < 4; ++i) {
    int* row = dst + i * stride;
    for (int k = 0; k < 4; ++k) row[k] = clip255(row[k] + (o[k][i] >> 3));
  }
}

// libwebp's DoTransform by the block's class (NzCodeBits): 3 the full SSE2
// transform, 2 and 1 TransformAC3/TransformDC (C, as the full one in int
// arithmetic), 0 none.
void transform(const int* in, int* dst, int stride, int kind) {
  if (kind == 3)
    idct_add_sse2(in, dst, stride);
  else if (kind)
    idct_add(in, dst, stride);
}

inline int nz_class(int nz, int dc) { return nz > 3 ? 3 : nz > 1 ? 2 : dc != 0; }

void iwht(const int* in, int out[16]) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    int a0 = in[i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
    int a2 = in[4 + i] - in[8 + i], a3 = in[i] - in[12 + i];
    tmp[i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    int dc = tmp[4 * i] + 3;
    int a0 = dc + tmp[4 * i + 3], a1 = tmp[4 * i + 1] + tmp[4 * i + 2];
    int a2 = tmp[4 * i + 1] - tmp[4 * i + 2], a3 = dc - tmp[4 * i + 3];
    out[4 * i + 0] = (a0 + a1) >> 3;
    out[4 * i + 1] = (a3 + a2) >> 3;
    out[4 * i + 2] = (a0 - a1) >> 3;
    out[4 * i + 3] = (a3 - a2) >> 3;
  }
}

inline int avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }
inline int avg2(int a, int b) { return (a + b + 1) >> 1; }

// VP8PredLuma4[mode] at ``d`` in a work block of stride ``s``.
void predict4(int mode, int* d, int s) {
  const int* t = d - s;
  int A = t[0], B = t[1], C = t[2], D = t[3], E = t[4], F = t[5], G = t[6], H = t[7];
  int X = t[-1], I = d[-1], J = d[s - 1], K = d[2 * s - 1], L = d[3 * s - 1];
#define DST(x, y) d[(x) + (y) * s]
  switch (mode) {
    case DC: {
      int dc = (A + B + C + D + I + J + K + L + 4) >> 3;
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) DST(x, y) = dc;
      break;
    }
    case TM: {
      int left[4] = {I, J, K, L};
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) DST(x, y) = clip255(left[y] + t[x] - X);
      break;
    }
    case VE: {
      int v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D), avg3(C, D, E)};
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) DST(x, y) = v[x];
      break;
    }
    case HE: {
      int v[4] = {avg3(X, I, J), avg3(I, J, K), avg3(J, K, L), avg3(K, L, L)};
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) DST(x, y) = v[y];
      break;
    }
    case 4:  // RD
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case 5:  // VR
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case 6:  // LD
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case 7:  // VL
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case 8:  // HD
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    default:  // HU
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
      break;
  }
#undef DST
}

// 16x16 or 8x8 prediction at ``d`` (stride ``s``), DC narrowed at the edges.
void predict_block(int mode, int* d, int s, int size, int mb_x, int mb_y) {
  const int* top = d - s;
  int shift = size == 16 ? 5 : 4;
  if (mode == DC) {
    int st = 0, sl = 0, val;
    for (int i = 0; i < size; ++i) st += top[i], sl += d[i * s - 1];
    if (mb_x == 0 && mb_y == 0)
      val = 0x80;
    else if (mb_y == 0)
      val = (sl + (size >> 1)) >> (shift - 1);
    else if (mb_x == 0)
      val = (st + (size >> 1)) >> (shift - 1);
    else
      val = (st + sl + size) >> shift;
    for (int y = 0; y < size; ++y)
      for (int x = 0; x < size; ++x) d[y * s + x] = val;
  } else {
    for (int y = 0; y < size; ++y)
      for (int x = 0; x < size; ++x)
        d[y * s + x] = mode == TM ? clip255(d[y * s - 1] + top[x] - top[-1])
                       : mode == VE ? top[x] : d[y * s - 1];
  }
}

struct FInfo {
  int limit = 0, ilevel = 0, hev = 0, inner = 0;
};

// One edge's filter on ``count`` lines: ``p`` the first pixel after the
// edge, ``step`` across the edge, ``next`` along it.
void filter_edge(uint8_t* p, int step, int next, int count, int thresh, int ithresh, int hev_t,
                 bool mb_edge, bool simple) {
  const int t2 = 2 * thresh + 1;
  for (int k = 0; k < count; ++k, p += next) {
    int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
    int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
    if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t2) continue;
    if (!simple && !(std::abs(p3 - p2) <= ithresh && std::abs(p2 - p1) <= ithresh &&
                     std::abs(p1 - p0) <= ithresh && std::abs(q3 - q2) <= ithresh &&
                     std::abs(q2 - q1) <= ithresh && std::abs(q1 - q0) <= ithresh))
      continue;
    bool hev = simple || std::abs(p1 - p0) > hev_t || std::abs(q1 - q0) > hev_t;
    if (hev) {
      int a = 3 * (q0 - p0) + std::clamp(p1 - q1, -128, 127);
      p[-step] = static_cast<uint8_t>(clip255(p0 + std::clamp((a + 3) >> 3, -16, 15)));
      p[0] = static_cast<uint8_t>(clip255(q0 - std::clamp((a + 4) >> 3, -16, 15)));
    } else if (mb_edge) {
      int a = std::clamp(3 * (q0 - p0) + std::clamp(p1 - q1, -128, 127), -128, 127);
      int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7, a3 = (9 * a + 63) >> 7;
      p[-3 * step] = static_cast<uint8_t>(clip255(p2 + a3));
      p[-2 * step] = static_cast<uint8_t>(clip255(p1 + a2));
      p[-step] = static_cast<uint8_t>(clip255(p0 + a1));
      p[0] = static_cast<uint8_t>(clip255(q0 - a1));
      p[step] = static_cast<uint8_t>(clip255(q1 - a2));
      p[2 * step] = static_cast<uint8_t>(clip255(q2 - a3));
    } else {
      int a = 3 * (q0 - p0);
      int a1 = std::clamp((a + 4) >> 3, -16, 15), a2 = std::clamp((a + 3) >> 3, -16, 15);
      int a3 = (a1 + 1) >> 1;
      p[-2 * step] = static_cast<uint8_t>(clip255(p1 + a3));
      p[-step] = static_cast<uint8_t>(clip255(p0 + a2));
      p[0] = static_cast<uint8_t>(clip255(q0 - a1));
      p[step] = static_cast<uint8_t>(clip255(q1 - a3));
    }
  }
}

struct Planes {
  int w, h;                       // macroblock-aligned luma size
  std::vector<uint8_t> y, u, v;   // unfiltered, then filtered in place
};

void reconstruct(Planes& P, int mb_x, int mb_y, int mbw, bool is4, const int* ymodes, int uvmode,
                 const int* coeffs, const int* kinds) {
  const int S = 21;
  int w[17 * 21];
  const int y0 = 16 * mb_y, x0 = 16 * mb_x, W = P.w;
  const uint8_t* Y = P.y.data();
  if (mb_y > 0) {
    for (int i = 0; i < 16; ++i) w[1 + i] = Y[(y0 - 1) * W + x0 + i];
    w[0] = mb_x > 0 ? Y[(y0 - 1) * W + x0 - 1] : 129;
    for (int i = 0; i < 4; ++i)
      w[17 + i] = mb_x < mbw - 1 ? Y[(y0 - 1) * W + x0 + 16 + i] : Y[(y0 - 1) * W + x0 + 15];
  } else {
    for (int i = 0; i < S; ++i) w[i] = 127;
  }
  for (int r = 1; r <= 16; ++r) w[r * S] = mb_x > 0 ? Y[(y0 + r - 1) * W + x0 - 1] : 129;
  if (is4) {
    for (int r = 4; r <= 12; r += 4)
      for (int i = 0; i < 4; ++i) w[r * S + 17 + i] = w[17 + i];
    for (int n = 0; n < 16; ++n) {
      int* d = w + (1 + 4 * (n >> 2)) * S + 1 + 4 * (n & 3);
      predict4(ymodes[n], d, S);
      transform(coeffs + 16 * n, d, S, kinds[n]);
    }
  } else {
    predict_block(ymodes[0], w + S + 1, S, 16, mb_x, mb_y);
    for (int n = 0; n < 16; ++n)
      transform(coeffs + 16 * n, w + (1 + 4 * (n >> 2)) * S + 1 + 4 * (n & 3), S, kinds[n]);
  }
  for (int r = 0; r < 16; ++r)
    for (int c = 0; c < 16; ++c) P.y[(y0 + r) * W + x0 + c] = static_cast<uint8_t>(w[(r + 1) * S + 1 + c]);
  const int CW = W / 2, r0 = 8 * mb_y, c0 = 8 * mb_x;
  for (int k = 0; k < 2; ++k) {
    std::vector<uint8_t>& C = k ? P.v : P.u;
    int cwk[9 * 9];
    if (mb_y > 0) {
      for (int i = 0; i < 8; ++i) cwk[1 + i] = C[(r0 - 1) * CW + c0 + i];
      cwk[0] = mb_x > 0 ? C[(r0 - 1) * CW + c0 - 1] : 129;
    } else {
      for (int i = 0; i < 9; ++i) cwk[i] = 127;
    }
    for (int r = 1; r <= 8; ++r) cwk[r * 9] = mb_x > 0 ? C[(r0 + r - 1) * CW + c0 - 1] : 129;
    predict_block(uvmode, cwk + 10, 9, 8, mb_x, mb_y);
    const int* plane = kinds + 16 + 4 * k;      // DoUVTransform: all four full past a DC
    bool full = false;
    for (int n = 0; n < 4; ++n) full = full || plane[n] >= 2;
    for (int n = 0; n < 4; ++n)
      transform(coeffs + 16 * (16 + 4 * k + n), cwk + (1 + 4 * (n >> 1)) * 9 + 1 + 4 * (n & 1),
                9, full ? 3 : plane[n]);
    for (int r = 0; r < 8; ++r)
      for (int c = 0; c < 8; ++c)
        C[(r0 + r) * CW + c0 + c] = static_cast<uint8_t>(cwk[(r + 1) * 9 + 1 + c]);
  }
}

void loop_filter(Planes& P, const std::vector<FInfo>& finfo, int mbw, int mbh, bool simple) {
  for (int mb_y = 0; mb_y < mbh; ++mb_y) {
    for (int mb_x = 0; mb_x < mbw; ++mb_x) {
      const FInfo& f = finfo[mb_y * mbw + mb_x];
      if (f.limit == 0) continue;
      for (int k = 0; k < (simple ? 1 : 3); ++k) {
        const int size = k ? 8 : 16, stride = k ? P.w / 2 : P.w;
        uint8_t* base = (k == 0 ? P.y.data() : k == 1 ? P.u.data() : P.v.data()) +
                        size * mb_y * stride + size * mb_x;
        if (mb_x > 0)
          filter_edge(base, 1, stride, size, f.limit + 4, f.ilevel, f.hev, true, simple);
        if (f.inner)
          for (int s = 4; s < size; s += 4)
            filter_edge(base + s, 1, stride, size, f.limit, f.ilevel, f.hev, false, simple);
        if (mb_y > 0)
          filter_edge(base, stride, 1, size, f.limit + 4, f.ilevel, f.hev, true, simple);
        if (f.inner)
          for (int s = 4; s < size; s += 4)
            filter_edge(base + s * stride, stride, 1, size, f.limit, f.ilevel, f.hev, false,
                        simple);
      }
    }
  }
}

void decode_vp8(const uint8_t* data, int64_t n, Planes& P, int& width, int& height) {
  Header h;
  parse_header(data, n, h);
  width = h.width;
  height = h.height;
  const int mbw = (h.width + 15) >> 4, mbh = (h.height + 15) >> 4;
  P.w = 16 * mbw;
  P.h = 16 * mbh;
  P.y.assign(static_cast<size_t>(P.w) * P.h, 0);
  P.u.assign(static_cast<size_t>(P.w / 2) * (P.h / 2), 0);
  P.v.assign(static_cast<size_t>(P.w / 2) * (P.h / 2), 0);
  FInfo strengths[4][2];
  for (int s = 0; s < 4; ++s) {
    int base = h.use_segment ? h.strength[s] + (h.absolute ? 0 : h.level) : h.level;
    for (int i4 = 0; i4 < 2; ++i4) {
      int level = base;
      if (h.use_lf_delta) level += h.ref_delta[0] + (i4 ? h.mode_delta[0] : 0);
      level = clip(level, 63);
      FInfo& f = strengths[s][i4];
      if (level > 0) {
        int ilevel = level;
        if (h.sharpness > 0) {
          ilevel >>= h.sharpness > 4 ? 2 : 1;
          ilevel = std::min(ilevel, 9 - h.sharpness);
        }
        ilevel = std::max(ilevel, 1);
        f.limit = 2 * level + ilevel;
        f.ilevel = ilevel;
        f.hev = level >= 40 ? 2 : level >= 15 ? 1 : 0;
      }
    }
  }
  std::vector<FInfo> finfo(static_cast<size_t>(mbw) * mbh);
  std::vector<int> intra_t(4 * mbw, DC), nz_top(mbw, 0), nzdc_top(mbw, 0);
  BoolDecoder& br = h.br;
  std::vector<int> coeffs(24 * 16);
  for (int mb_y = 0; mb_y < mbh; ++mb_y) {
    BoolDecoder& tb = h.parts[mb_y & (h.parts.size() - 1)];
    int intra_l[4] = {DC, DC, DC, DC};
    int nz_left = 0, nzdc_left = 0;
    for (int mb_x = 0; mb_x < mbw; ++mb_x) {
      int segment = 0;
      if (h.update_map)
        segment = !br.bit(h.segment_proba[0]) ? br.bit(h.segment_proba[1])
                                             : 2 + br.bit(h.segment_proba[2]);
      int skip = h.use_skip ? br.bit(h.skip_proba) : 0;
      bool is4 = !br.bit(145);
      int modes[16];
      if (!is4) {
        int ymode = br.bit(156) ? (br.bit(128) ? TM : HE) : (br.bit(163) ? VE : DC);
        modes[0] = ymode;
        for (int i = 0; i < 4; ++i) intra_t[4 * mb_x + i] = intra_l[i] = ymode;
      } else {
        for (int y = 0; y < 4; ++y) {
          int ymode = intra_l[y];
          for (int x = 0; x < 4; ++x) {
            const uint8_t* prob = kBModesProba + (intra_t[4 * mb_x + x] * 10 + ymode) * 9;
            int i = kYModesIntra4[br.bit(prob[0])];
            while (i > 0) i = kYModesIntra4[2 * i + br.bit(prob[i])];
            ymode = -i;
            intra_t[4 * mb_x + x] = ymode;
          }
          for (int x = 0; x < 4; ++x) modes[4 * y + x] = intra_t[4 * mb_x + x];
          intra_l[y] = ymode;
        }
      }
      int uvmode = !br.bit(142) ? DC : !br.bit(114) ? VE : br.bit(183) ? TM : HE;
      std::fill(coeffs.begin(), coeffs.end(), 0);
      int kinds[24] = {0};                      // each block's NzCodeBits
      const Quant& q = h.quant[segment];
      if (!skip) {
        int first, ac;
        bool any_nz = false;
        if (!is4) {
          int dc[16] = {0};
          int nz = get_coeffs(tb, h, 1, nzdc_top[mb_x] + nzdc_left, q.y2, 0, dc);
          nzdc_top[mb_x] = nzdc_left = nz > 0;
          if (nz > 1) {
            int out[16];
            iwht(dc, out);
            for (int i = 0; i < 16; ++i) coeffs[16 * i] = static_cast<int16_t>(out[i]);
          } else {
            int dc0 = static_cast<int16_t>((dc[0] + 3) >> 3);
            for (int i = 0; i < 16; ++i) coeffs[16 * i] = dc0;
          }
          first = 1;
          ac = 0;
        } else {
          first = 0;
          ac = 3;
        }
        int tnz = nz_top[mb_x] & 0x0f, lnz = nz_left & 0x0f;
        for (int y = 0; y < 4; ++y) {
          int l = lnz & 1;
          for (int x = 0; x < 4; ++x) {
            int* blk = &coeffs[16 * (4 * y + x)];
            int nz = get_coeffs(tb, h, ac, l + (tnz & 1), q.y1, first, blk);
            kinds[4 * y + x] = nz_class(nz, blk[0]);
            l = nz > first;
            tnz = (tnz >> 1) | (l << 7);
            any_nz |= nz > 1 || blk[0] != 0;
          }
          tnz >>= 4;
          lnz = (lnz >> 1) | (l << 7);
        }
        int out_t = tnz, out_l = lnz >> 4;
        for (int ch = 0; ch < 4; ch += 2) {
          tnz = nz_top[mb_x] >> (4 + ch);
          lnz = nz_left >> (4 + ch);
          for (int y = 0; y < 2; ++y) {
            int l = lnz & 1;
            for (int x = 0; x < 2; ++x) {
              int* blk = &coeffs[16 * (16 + 2 * ch + 2 * y + x)];
              int nz = get_coeffs(tb, h, 2, l + (tnz & 1), q.uv, 0, blk);
              kinds[16 + 2 * ch + 2 * y + x] = nz_class(nz, blk[0]);
              l = nz > 0;
              tnz = (tnz >> 1) | (l << 3);
              any_nz |= nz > 1 || blk[0] != 0;
            }
            tnz >>= 2;
            lnz = (lnz >> 1) | (l << 5);
          }
          out_t |= (tnz << 4) << ch;
          out_l |= (lnz & 0xf0) << ch;
        }
        nz_top[mb_x] = out_t;
        nz_left = out_l;
        skip = !any_nz;
      } else {
        nz_top[mb_x] = nz_left = 0;
        if (!is4) nzdc_top[mb_x] = nzdc_left = 0;
      }
      if (h.filter_type) {
        FInfo f = strengths[segment][is4];
        f.inner = is4 || !skip;
        finfo[mb_y * mbw + mb_x] = f;
      }
      reconstruct(P, mb_x, mb_y, mbw, is4, modes, uvmode, coeffs.data(), kinds);
    }
  }
  if (h.filter_type) loop_filter(P, finfo, mbw, mbh, h.filter_type == 1);
}

// --------------------------------------------------------- YUV -> RGB

inline int yuv_clip8(int v) { return (v & ~16383) == 0 ? v >> 6 : v < 0 ? 0 : 255; }
inline int mult_hi(int v, int c) { return (v * c) >> 8; }

void put_rgb(int y, int u, int v, uint8_t* out) {
  out[0] = static_cast<uint8_t>(yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234));
  out[1] = static_cast<uint8_t>(
      yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708));
  out[2] = static_cast<uint8_t>(yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685));
}

// libwebp's UpsampleRgbaLinePair: the chroma rows ``tu/tv`` (above) and
// ``cu/cv``; ``bottom`` may be null.
void upsample_pair(const uint8_t* top_y, const uint8_t* bot_y, const uint8_t* tu,
                   const uint8_t* tv, const uint8_t* cu, const uint8_t* cv, uint8_t* top,
                   uint8_t* bot, int len) {
  auto load = [](int u, int v) { return static_cast<uint32_t>(u) | static_cast<uint32_t>(v) << 16; };
  const int last_pair = (len - 1) >> 1;
  uint32_t tl = load(tu[0], tv[0]), l = load(cu[0], cv[0]);
  {
    uint32_t uv0 = (3 * tl + l + 0x00020002u) >> 2;
    put_rgb(top_y[0], uv0 & 0xff, uv0 >> 16, top);
  }
  if (bot_y) {
    uint32_t uv0 = (3 * l + tl + 0x00020002u) >> 2;
    put_rgb(bot_y[0], uv0 & 0xff, uv0 >> 16, bot);
  }
  for (int x = 1; x <= last_pair; ++x) {
    uint32_t t = load(tu[x], tv[x]), c = load(cu[x], cv[x]);
    uint32_t avg = tl + t + l + c + 0x00080008u;
    uint32_t d12 = (avg + 2 * (t + l)) >> 3, d03 = (avg + 2 * (tl + c)) >> 3;
    uint32_t a = (d12 + tl) >> 1, b = (d03 + t) >> 1;
    put_rgb(top_y[2 * x - 1], a & 0xff, (a >> 16) & 0xff, top + (2 * x - 1) * 4);
    put_rgb(top_y[2 * x], b & 0xff, (b >> 16) & 0xff, top + 2 * x * 4);
    if (bot_y) {
      uint32_t e = (d03 + l) >> 1, f = (d12 + c) >> 1;
      put_rgb(bot_y[2 * x - 1], e & 0xff, (e >> 16) & 0xff, bot + (2 * x - 1) * 4);
      put_rgb(bot_y[2 * x], f & 0xff, (f >> 16) & 0xff, bot + 2 * x * 4);
    }
    tl = t;
    l = c;
  }
  if (!(len & 1)) {
    uint32_t uv0 = (3 * tl + l + 0x00020002u) >> 2;
    put_rgb(top_y[len - 1], uv0 & 0xff, uv0 >> 16, top + (len - 1) * 4);
    if (bot_y) {
      uv0 = (3 * l + tl + 0x00020002u) >> 2;
      put_rgb(bot_y[len - 1], uv0 & 0xff, uv0 >> 16, bot + (len - 1) * 4);
    }
  }
}

// ------------------------------------------------------------- VP8L

class BitReader {
 public:
  BitReader(const uint8_t* data, int64_t n) : data_(data), n_(n) {}
  uint32_t read(int bits) {
    if (bits == 0) return 0;
    if (pos_ + bits > 8 * n_) throw Error("the lossless bitstream ends early");
    uint32_t v = 0;
    for (int k = 0; k < bits;) {
      int64_t byte = pos_ >> 3;
      int off = pos_ & 7, take = std::min(8 - off, bits - k);
      v |= static_cast<uint32_t>((data_[byte] >> off) & ((1 << take) - 1)) << k;
      k += take;
      pos_ += take;
    }
    return v;
  }
  // the next 16 bits without consuming them (zeros past the end)
  uint32_t peek16() const {
    uint32_t v = 0;
    int64_t byte = pos_ >> 3;
    for (int k = 0; k < 4 && byte + k < n_; ++k) v |= static_cast<uint32_t>(data_[byte + k]) << (8 * k);
    return (v >> (pos_ & 7)) & 0xffff;
  }
  void skip(int bits) {
    if (pos_ + bits > 8 * n_) throw Error("the lossless bitstream ends early");
    pos_ += bits;
  }

 private:
  const uint8_t* data_;
  int64_t n_, pos_ = 0;
};

uint32_t reverse_bits(uint32_t code, int len) {
  uint32_t r = 0;
  for (int i = 0; i < len; ++i) r |= ((code >> i) & 1) << (len - 1 - i);
  return r;
}

// A canonical code, least-significant bit first: codes of up to kFast
// bits through a table of the next kFast bits, longer ones (VP8L codes are at
// most 15 bits) bit by bit in canonical order.
class Huffman {
 public:
  static constexpr int kFast = 10;
  explicit Huffman(const std::vector<int>& lengths) {
    int count = 0, maxlen = 0;
    for (size_t s = 0; s < lengths.size(); ++s)
      if (lengths[s]) ++count, single_ = static_cast<int>(s), maxlen = std::max(maxlen, lengths[s]);
    if (!count) throw Error("a Huffman code without symbols");
    if (count == 1) return;
    single_ = -1;
    count_.assign(maxlen + 1, 0);
    for (int n : lengths)
      if (n) ++count_[n];
    int left = 1;
    for (int n = 1; n <= maxlen; ++n) {
      left = 2 * left - count_[n];
      if (left < 0) throw Error("an over-subscribed Huffman code");
    }
    if (left) throw Error("an incomplete Huffman code");
    for (int n = 1; n <= maxlen; ++n)
      for (size_t s = 0; s < lengths.size(); ++s)
        if (lengths[s] == n) symbols_.push_back(static_cast<int>(s));
    std::vector<uint32_t> next(maxlen + 2, 0);
    uint32_t code = 0;
    for (int n = 1; n <= maxlen; ++n) {
      code = (code + count_[n - 1]) << 1;
      next[n] = code;
    }
    bits_ = std::min(maxlen, kFast);
    table_.assign(static_cast<size_t>(1) << bits_, 0);
    for (int s : symbols_) {
      int len = lengths[s];
      uint32_t c = next[len]++;
      if (len > bits_) continue;
      uint32_t rev = reverse_bits(c, len);
      for (uint32_t fill = rev; fill < table_.size(); fill += 1u << len)
        table_[fill] = static_cast<uint32_t>(s) << 4 | static_cast<uint32_t>(len);
    }
  }
  int read(BitReader& br) const {
    if (single_ >= 0) return single_;
    uint32_t e = table_[br.peek16() & ((1u << bits_) - 1)];
    if (e & 15) {
      br.skip(static_cast<int>(e & 15));
      return static_cast<int>(e >> 4);
    }
    int code = 0, first = 0, index = 0;
    for (size_t n = 1; n < count_.size(); ++n) {
      code |= static_cast<int>(br.read(1));
      if (code - first < count_[n]) return symbols_[index + code - first];
      index += count_[n];
      first = (first + count_[n]) << 1;
      code <<= 1;
    }
    throw Error("a Huffman code out of its table");
  }

 private:
  int single_ = -1, bits_ = 0;
  std::vector<int> count_, symbols_;
  std::vector<uint32_t> table_;
};

const int kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};
const uint8_t kCodeToPlane[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a, 0x38, 0x05, 0x37, 0x39,
    0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04, 0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b, 0x46, 0x4a,
    0x24, 0x2c, 0x58, 0x45, 0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56, 0x5a, 0x23, 0x2d,
    0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e, 0x66, 0x6a, 0x22, 0x2e,
    0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e, 0x78, 0x01, 0x77, 0x79, 0x53, 0x5d, 0x11, 0x1f,
    0x64, 0x6c, 0x42, 0x4e, 0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b, 0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e,
    0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e, 0x30, 0x73, 0x7d, 0x51, 0x5f, 0x40, 0x72,
    0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70};

std::vector<int> code_lengths(BitReader& br, int alphabet) {
  std::vector<int> lengths(alphabet, 0);
  if (br.read(1)) {
    int two = br.read(1);
    int first = br.read(br.read(1) ? 8 : 1);
    if (first < alphabet) lengths[first] = 1;
    if (two) {
      int second = br.read(8);
      if (second < alphabet) lengths[second] = 1;
    }
    return lengths;
  }
  int num = br.read(4) + 4;
  std::vector<int> cl(19, 0);
  for (int i = 0; i < num; ++i) cl[kCodeLengthOrder[i]] = br.read(3);
  Huffman table(cl);
  int max_symbol = alphabet;
  if (br.read(1)) {
    max_symbol = 2 + br.read(2 + 2 * br.read(3));
    if (max_symbol > alphabet) throw Error("more code lengths than symbols");
  }
  int symbol = 0, prev = 8;
  while (symbol < alphabet) {
    if (max_symbol-- == 0) break;
    int code = table.read(br);
    if (code < 16) {
      lengths[symbol++] = code;
      if (code) prev = code;
      continue;
    }
    static const int extra[3] = {2, 3, 7}, offset[3] = {3, 3, 11};
    int repeat = br.read(extra[code - 16]) + offset[code - 16];
    if (symbol + repeat > alphabet) throw Error("a code-length repeat past the alphabet");
    int value = code == 16 ? prev : 0;
    while (repeat--) lengths[symbol++] = value;
  }
  return lengths;
}

int prefix_value(int symbol, BitReader& br) {
  if (symbol < 4) return symbol + 1;
  int extra = (symbol - 2) >> 1;
  return ((2 + (symbol & 1)) << extra) + static_cast<int>(br.read(extra)) + 1;
}

inline int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

struct Transform {
  int kind, bits, xsize;
  std::vector<uint32_t> data;  // predictor/cross-colour tiles, or the palette
};

std::vector<uint32_t> image_stream(BitReader& br, int xsize, int ysize, bool top,
                                   std::vector<Transform>* transforms, int* out_xsize);

std::vector<uint32_t> entropy_decode(BitReader& br, int xsize, int ysize,
                                     const std::vector<std::vector<Huffman>>& groups,
                                     const std::vector<uint32_t>& meta, int meta_bits,
                                     int cache_bits) {
  const int64_t total = static_cast<int64_t>(xsize) * ysize;
  std::vector<uint32_t> out(total);
  std::vector<uint32_t> cache(cache_bits ? 1u << cache_bits : 0);
  const int shift = 32 - cache_bits, mx = subsample(xsize, meta_bits);
  int64_t pos = 0, cached = 0;
  auto fill_cache = [&]() {
    for (; cached < pos; ++cached) cache[(out[cached] * 0x1e35a7bdu) >> shift] = out[cached];
  };
  while (pos < total) {
    int y = static_cast<int>(pos / xsize), x = static_cast<int>(pos % xsize);
    const std::vector<Huffman>& g =
        groups[meta.empty() ? 0 : meta[(y >> meta_bits) * mx + (x >> meta_bits)]];
    int code = g[0].read(br);
    if (code < 256) {
      uint32_t r = g[1].read(br), b = g[2].read(br), a = g[3].read(br);
      out[pos++] = a << 24 | r << 16 | static_cast<uint32_t>(code) << 8 | b;
    } else if (code < 256 + 24) {
      int length = prefix_value(code - 256, br);
      int dcode = prefix_value(g[4].read(br), br);
      int64_t d;
      if (dcode > 120) {
        d = dcode - 120;
      } else {
        int plane = kCodeToPlane[dcode - 1];
        d = std::max<int64_t>(static_cast<int64_t>(plane >> 4) * xsize + 8 - (plane & 15), 1);
      }
      if (d > pos || length > total - pos) throw Error("a backward reference out of the image");
      for (int k = 0; k < length; ++k) out[pos + k] = out[pos + k - d];
      pos += length;
    } else {
      if (!cache_bits) throw Error("a colour-cache code without a cache");
      fill_cache();
      out[pos] = cache[code - 280];
      ++pos;
    }
    if (cache_bits) fill_cache();
  }
  return out;
}

std::vector<uint32_t> image_stream(BitReader& br, int xsize, int ysize, bool top,
                                   std::vector<Transform>* transforms, int* out_xsize) {
  if (top) {
    int seen = 0;
    while (br.read(1)) {
      int kind = br.read(2);
      if (seen & (1 << kind)) throw Error("a transform twice");
      seen |= 1 << kind;
      Transform t{kind, 0, xsize, {}};
      if (kind == 0 || kind == 1) {
        t.bits = br.read(3) + 2;
        t.data = image_stream(br, subsample(xsize, t.bits), subsample(ysize, t.bits), false,
                              nullptr, nullptr);
      } else if (kind == 3) {
        int num = br.read(8) + 1;
        t.bits = num > 16 ? 0 : num > 4 ? 1 : num > 2 ? 2 : 3;
        std::vector<uint32_t> raw = image_stream(br, num, 1, false, nullptr, nullptr);
        t.data.assign(static_cast<size_t>(1) << (8 >> t.bits), 0);
        uint8_t acc[4] = {0, 0, 0, 0};
        for (int i = 0; i < num; ++i) {
          uint32_t v = 0;
          for (int c = 0; c < 4; ++c) {
            acc[c] = static_cast<uint8_t>(acc[c] + ((raw[i] >> (8 * c)) & 0xff));
            v |= static_cast<uint32_t>(acc[c]) << (8 * c);
          }
          t.data[i] = v;
        }
        xsize = subsample(xsize, t.bits);
      }
      transforms->push_back(std::move(t));
    }
    *out_xsize = xsize;
  }
  int cache_bits = 0;
  if (br.read(1)) {
    cache_bits = br.read(4);
    if (cache_bits < 1 || cache_bits > 11) throw Error("colour cache bits out of range");
  }
  std::vector<uint32_t> meta;
  int meta_bits = 0, groups = 1;
  if (top && br.read(1)) {
    meta_bits = br.read(3) + 2;
    meta = image_stream(br, subsample(xsize, meta_bits), subsample(ysize, meta_bits), false,
                        nullptr, nullptr);
    for (uint32_t& m : meta) {
      m = (m >> 8) & 0xffff;
      groups = std::max(groups, static_cast<int>(m) + 1);
    }
  }
  const int sizes[5] = {256 + 24 + (cache_bits ? 1 << cache_bits : 0), 256, 256, 256, 40};
  std::vector<std::vector<Huffman>> tables;
  tables.reserve(groups);
  for (int g = 0; g < groups; ++g) {
    std::vector<Huffman> codes;
    for (int k = 0; k < 5; ++k) codes.emplace_back(code_lengths(br, sizes[k]));
    tables.push_back(std::move(codes));
  }
  return entropy_decode(br, xsize, ysize, tables, meta, meta_bits, cache_bits);
}

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  return (((a & 0xff00ff00u) + (b & 0xff00ff00u)) & 0xff00ff00u) |
         (((a & 0x00ff00ffu) + (b & 0x00ff00ffu)) & 0x00ff00ffu);
}
inline uint32_t average2(uint32_t a, uint32_t b) { return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b); }
inline int ch(uint32_t v, int s) { return static_cast<int>((v >> s) & 0xff); }

uint32_t predict(int mode, uint32_t L, uint32_t T, uint32_t TR, uint32_t TL) {
  switch (mode) {
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 5: return average2(average2(L, TR), T);
    case 6: return average2(L, TL);
    case 7: return average2(L, T);
    case 8: return average2(TL, T);
    case 9: return average2(T, TR);
    case 10: return average2(average2(L, TL), average2(T, TR));
    case 11: {
      int diff = 0;
      for (int s = 0; s < 32; s += 8)
        diff += std::abs(ch(L, s) - ch(TL, s)) - std::abs(ch(T, s) - ch(TL, s));
      return diff <= 0 ? T : L;
    }
    case 12: {
      uint32_t out = 0;
      for (int s = 0; s < 32; s += 8)
        out |= static_cast<uint32_t>(clip255(ch(L, s) + ch(T, s) - ch(TL, s))) << s;
      return out;
    }
    case 13: {
      uint32_t avg = average2(L, T), out = 0;
      for (int s = 0; s < 32; s += 8) {
        int a = ch(avg, s), b = ch(TL, s);
        out |= static_cast<uint32_t>(clip255(a + (a - b) / 2)) << s;
      }
      return out;
    }
    default: return 0xff000000u;
  }
}

void inverse(const Transform& t, std::vector<uint32_t>& px, int& width, int ysize) {
  const int xsize = t.xsize;
  if (t.kind == 2) {
    for (uint32_t& v : px) {
      uint32_t g = (v >> 8) & 0xff;
      uint32_t r = (((v >> 16) & 0xff) + g) & 0xff, b = ((v & 0xff) + g) & 0xff;
      v = (v & 0xff00ff00u) | r << 16 | b;
    }
    return;
  }
  if (t.kind == 3) {
    std::vector<uint32_t> out(static_cast<size_t>(xsize) * ysize);
    const int per = 1 << t.bits, width_bits = 8 >> t.bits, mask = (1 << width_bits) - 1;
    for (int y = 0; y < ysize; ++y)
      for (int x = 0; x < xsize; ++x) {
        uint32_t packed = (px[static_cast<size_t>(y) * width + x / per] >> 8) & 0xff;
        out[static_cast<size_t>(y) * xsize + x] = t.data[(packed >> (width_bits * (x % per))) & mask];
      }
    px.swap(out);
    width = xsize;
    return;
  }
  const int tiles = subsample(xsize, t.bits);
  if (t.kind == 1) {
    for (int y = 0; y < ysize; ++y)
      for (int x = 0; x < xsize; ++x) {
        uint32_t m = t.data[(y >> t.bits) * tiles + (x >> t.bits)];
        int g2r = static_cast<int8_t>(m & 0xff), g2b = static_cast<int8_t>((m >> 8) & 0xff);
        int r2b = static_cast<int8_t>((m >> 16) & 0xff);
        uint32_t& v = px[static_cast<size_t>(y) * xsize + x];
        int green = static_cast<int8_t>((v >> 8) & 0xff);
        int red = (ch(v, 16) + ((g2r * green) >> 5)) & 0xff;
        int blue = ch(v, 0) + ((g2b * green) >> 5);
        blue = (blue + ((r2b * static_cast<int8_t>(red)) >> 5)) & 0xff;
        v = (v & 0xff00ff00u) | static_cast<uint32_t>(red) << 16 | static_cast<uint32_t>(blue);
      }
    return;
  }
  for (int y = 0; y < ysize; ++y)
    for (int x = 0; x < xsize; ++x) {
      size_t i = static_cast<size_t>(y) * xsize + x;
      uint32_t pred;
      if (y == 0)
        pred = x == 0 ? 0xff000000u : px[i - 1];
      else if (x == 0)
        pred = px[i - xsize];
      else
        pred = predict((t.data[(y >> t.bits) * tiles + (x >> t.bits)] >> 8) & 15, px[i - 1],
                       px[i - xsize], px[i - xsize + 1], px[i - xsize - 1]);
      px[i] = add_pixels(px[i], pred);
    }
}

std::vector<uint32_t> decode_vp8l_stream(const uint8_t* data, int64_t n, int width, int height) {
  BitReader br(data, n);
  std::vector<Transform> transforms;
  int xsize = width;
  std::vector<uint32_t> px = image_stream(br, width, height, true, &transforms, &xsize);
  for (auto t = transforms.rbegin(); t != transforms.rend(); ++t) inverse(*t, px, xsize, height);
  return px;
}

void unfilter_alpha(std::vector<uint8_t>& a, int width, int height, int method) {
  if (method == 0) return;
  for (int y = 0; y < height; ++y) {
    uint8_t* row = a.data() + static_cast<size_t>(y) * width;
    const uint8_t* prev = y ? row - width : nullptr;
    if (!prev || method == 1) {
      uint8_t pred = prev ? prev[0] : 0;
      for (int x = 0; x < width; ++x) pred = row[x] = static_cast<uint8_t>(pred + row[x]);
    } else if (method == 2) {
      for (int x = 0; x < width; ++x) row[x] = static_cast<uint8_t>(prev[x] + row[x]);
    } else {
      int left = prev[0], top_left = prev[0];
      for (int x = 0; x < width; ++x) {
        int top = prev[x];
        int g = clip255(left + top - top_left);
        left = (row[x] + g) & 0xff;
        top_left = top;
        row[x] = static_cast<uint8_t>(left);
      }
    }
  }
}

}  // namespace

extern "C" {

// One WebP image to ``out`` ((height, width, 4) RGBA as libwebp's default
// output writes it): ``kind`` 0 a ``VP8 `` payload (with an ``ALPH``
// payload, or ``alph_size`` < 0 for opaque), 1 a ``VP8L`` payload. Returns
// 0, or 1 with a message in ``err``.
int webp_decode_image(const uint8_t* img, int64_t img_size, int kind, const uint8_t* alph,
                      int64_t alph_size, int width, int height, uint8_t* out, char* err,
                      int err_len) {
  try {
    if (kind == 1) {
      if (img_size < 5) throw Error("not a VP8L bitstream");
      std::vector<uint32_t> px = decode_vp8l_stream(img + 5, img_size - 5, width, height);
      for (size_t i = 0; i < px.size(); ++i) {
        out[4 * i] = static_cast<uint8_t>(px[i] >> 16);
        out[4 * i + 1] = static_cast<uint8_t>(px[i] >> 8);
        out[4 * i + 2] = static_cast<uint8_t>(px[i]);
        out[4 * i + 3] = static_cast<uint8_t>(px[i] >> 24);
      }
      return 0;
    }
    Planes P;
    int w, h;
    decode_vp8(img, img_size, P, w, h);
    if (w != width || h != height) throw Error("a VP8 frame of another size");
    const int CW = P.w / 2;
    for (int k = 1;; ++k) {
      if (k == 1) {
        upsample_pair(P.y.data(), nullptr, P.u.data(), P.v.data(), P.u.data(), P.v.data(), out,
                      nullptr, w);
      }
      if (2 * k - 1 >= h) break;
      const uint8_t* tu = P.u.data() + (k - 1) * CW;
      const uint8_t* tv = P.v.data() + (k - 1) * CW;
      uint8_t* top = out + static_cast<size_t>(2 * k - 1) * w * 4;
      if (2 * k >= h) {
        upsample_pair(P.y.data() + static_cast<size_t>(2 * k - 1) * P.w, nullptr, tu, tv, tu, tv,
                      top, nullptr, w);
        break;
      }
      upsample_pair(P.y.data() + static_cast<size_t>(2 * k - 1) * P.w,
                    P.y.data() + static_cast<size_t>(2 * k) * P.w, tu, tv,
                    P.u.data() + k * CW, P.v.data() + k * CW, top, top + w * 4, w);
    }
    std::vector<uint8_t> alpha(static_cast<size_t>(w) * h, 255);
    if (alph_size >= 0) {
      if (alph_size < 1) throw Error("an empty ALPH chunk");
      int head = alph[0], method = head & 3, filt = (head >> 2) & 3;
      if (method > 1 || ((head >> 4) & 3) > 1 || (head >> 6)) throw Error("an ALPH chunk of an unknown kind");
      if (method == 0) {
        if (alph_size - 1 < static_cast<int64_t>(w) * h) throw Error("an ALPH chunk shorter than the image");
        std::memcpy(alpha.data(), alph + 1, alpha.size());
      } else {
        std::vector<uint32_t> px = decode_vp8l_stream(alph + 1, alph_size - 1, w, h);
        for (size_t i = 0; i < px.size(); ++i) alpha[i] = static_cast<uint8_t>(px[i] >> 8);
      }
      unfilter_alpha(alpha, w, h, filt);
    }
    for (size_t i = 0; i < alpha.size(); ++i) out[4 * i + 3] = alpha[i];
    return 0;
  } catch (const std::exception& e) {
    std::strncpy(err, e.what(), err_len - 1);
    err[err_len - 1] = 0;
    return 1;
  }
}

}  // extern "C"
