"""DirectDraw Surface (DDS) files, as Pillow's ``DdsImagePlugin`` reads them.

The first surface only (mip levels, cube faces and array slices after it
are ignored, as Pillow ignores them). Pixel formats, in the order Pillow
tests the header's flags:

- uncompressed bit masks (``DDPF_RGB``, "RGB" or "RGBA" with alpha): each
  channel ``int(value / max * 255)`` of its mask, as Pillow's Python
  decoder computes it;
- luminance ("L" at 8 bits, "LA" at 16 with alpha) and 8-bit palette ("P",
  a 1024-byte RGBA palette after the header);
- FourCC block compression: DXT1, DXT3, DXT5 ("RGBA"), ATI1/BC4U ("L"),
  ATI2/BC5U and BC5S ("RGB"), and the DX10 header's DXGI formats BC1-BC5
  (typeless and unorm; BC5 snorm), BC6H (UF16 and SF16, "RGB"), BC7
  (typeless, unorm, sRGB; "RGBA") and R8G8B8A8 (typeless, unorm, sRGB).

Every other FourCC or DXGI format (BC4 signed, the sRGB forms of BC1-BC3,
BGRA, ...) is refused, as Pillow refuses it, and so is a file whose data
ends early. The block decoders follow Pillow's ``bcn.c`` to the bit: BC1's
three-colour mode when c0 <= c1 (BC2 and BC3 always take four), the 5-6-5
expansion and the interpolations' integer division; BC4/BC5 alpha ramps
(signed BC5 shifted by 128); BC7's eight modes with their partition and
anchor tables, p-bits, rotation and index selection (a block with no mode
bit set is opaque black); BC6H's 14 modes, the deltas' sums masked and
not sign-extended again, unquantised, interpolated, scaled by 31/64
(31/32 signed) into a half float and then to 8 bits as ``(uint8)(f *
255.0f)``, clamped to 0..1 first.

The blocks decode in ``native/src/bcn_decode.cpp`` where ``g++`` builds it
(``native/codecs.bcn_decode``); the plain numpy/Python decoders here are
its reference.
"""
from __future__ import annotations

import struct

import numpy as np

from coma_tpu_torch.utils.modes import Decoded

_DDPF_ALPHAPIXELS, _DDPF_FOURCC, _DDPF_PALETTE8 = 0x1, 0x4, 0x20
_DDPF_RGB, _DDPF_LUMINANCE = 0x40, 0x20000

# Pillow's pixel formats: name -> (bcn.c's n, block bytes, PIL mode)
BCN = {"BC1": (1, 8, "RGBA"), "BC2": (2, 16, "RGBA"), "BC3": (3, 16, "RGBA"),
       "BC4": (4, 8, "L"), "BC5": (5, 16, "RGB"), "BC5S": (5, 16, "RGB"),
       "BC6H": (6, 16, "RGB"), "BC6HS": (6, 16, "RGB"), "BC7": (7, 16, "RGBA")}
_FOURCC = {b"DXT1": "BC1", b"DXT3": "BC2", b"DXT5": "BC3", b"BC4U": "BC4", b"ATI1": "BC4",
           b"BC5S": "BC5S", b"BC5U": "BC5", b"ATI2": "BC5"}
_DXGI = {70: "BC1", 71: "BC1", 73: "BC2", 74: "BC2", 76: "BC3", 77: "BC3", 79: "BC4", 80: "BC4",
         82: "BC5", 83: "BC5", 84: "BC5S", 95: "BC6H", 96: "BC6HS", 97: "BC7", 98: "BC7",
         99: "BC7", 27: "RGBA8", 28: "RGBA8", 29: "RGBA8"}

# bcn.c's tables: BC7 modes (subsets, partition bits, rotation bits, index
# selection bit, colour bits, alpha bits, endpoint p-bits, shared p-bits,
# index bits, second index bits)
BC7_MODES = ((3, 4, 0, 0, 4, 0, 1, 0, 3, 0), (2, 6, 0, 0, 6, 0, 0, 1, 3, 0),
             (3, 6, 0, 0, 5, 0, 0, 0, 2, 0), (2, 6, 0, 0, 7, 0, 1, 0, 2, 0),
             (1, 0, 2, 1, 5, 6, 0, 0, 2, 3), (1, 0, 2, 0, 7, 8, 0, 0, 2, 2),
             (1, 0, 0, 0, 7, 7, 1, 0, 4, 0), (2, 6, 0, 0, 5, 5, 1, 0, 2, 0))
# two-subset partitions, one bit a pixel
BC7_SI2 = (0xcccc, 0x8888, 0xeeee, 0xecc8, 0xc880, 0xfeec, 0xfec8, 0xec80, 0xc800, 0xffec, 0xfe80,
           0xe800, 0xffe8, 0xff00, 0xfff0, 0xf000, 0xf710, 0x008e, 0x7100, 0x08ce, 0x008c, 0x7310,
           0x3100, 0x8cce, 0x088c, 0x3110, 0x6666, 0x366c, 0x17e8, 0x0ff0, 0x718e, 0x399c, 0xaaaa,
           0xf0f0, 0x5a5a, 0x33cc, 0x3c3c, 0x55aa, 0x9696, 0xa55a, 0x73ce, 0x13c8, 0x324c, 0x3bdc,
           0x6996, 0xc33c, 0x9966, 0x0660, 0x0272, 0x04e4, 0x4e40, 0x2720, 0xc936, 0x936c, 0x39c6,
           0x639c, 0x9336, 0x9cc6, 0x817e, 0xe718, 0xccf0, 0x0fcc, 0x7744, 0xee22)
# three-subset partitions, two bits a pixel
BC7_SI3 = (0xaa685050, 0x6a5a5040, 0x5a5a4200, 0x5450a0a8, 0xa5a50000, 0xa0a05050, 0x5555a0a0,
           0x5a5a5050, 0xaa550000, 0xaa555500, 0xaaaa5500, 0x90909090, 0x94949494, 0xa4a4a4a4,
           0xa9a59450, 0x2a0a4250, 0xa5945040, 0x0a425054, 0xa5a5a500, 0x55a0a0a0, 0xa8a85454,
           0x6a6a4040, 0xa4a45000, 0x1a1a0500, 0x0050a4a4, 0xaaa59090, 0x14696914, 0x69691400,
           0xa08585a0, 0xaa821414, 0x50a4a450, 0x6a5a0200, 0xa9a58000, 0x5090a0a8, 0xa8a09050,
           0x24242424, 0x00aa5500, 0x24924924, 0x24499224, 0x50a50a50, 0x500aa550, 0xaaaa4444,
           0x66660000, 0xa5a0a5a0, 0x50a050a0, 0x69286928, 0x44aaaa44, 0x66666600, 0xaa444444,
           0x54a854a8, 0x95809580, 0x96969600, 0xa85454a8, 0x80959580, 0xaa141414, 0x96960000,
           0xaaaa1414, 0xa05050a0, 0xa0a5a5a0, 0x96000000, 0x40804080, 0xa9a8a9a8, 0xaaaaaa44,
           0x2a4a5254)
# anchor indices: the second subset's of two, the second's and third's of three
BC7_AI0 = (15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 2, 8, 2, 2, 8, 8, 15,
           2, 8, 2, 2, 8, 8, 2, 2, 15, 15, 6, 8, 2, 8, 15, 15, 2, 8, 2, 2, 2, 15, 15, 6, 6, 2, 6, 8,
           15, 15, 2, 2, 15, 15, 15, 15, 15, 2, 2, 15)
BC7_AI1 = (3, 3, 15, 15, 8, 3, 15, 15, 8, 8, 6, 6, 6, 5, 3, 3, 3, 3, 8, 15, 3, 3, 6, 10, 5, 8, 8, 6,
           8, 5, 15, 15, 8, 15, 3, 5, 6, 10, 8, 15, 15, 3, 15, 5, 15, 15, 15, 15, 3, 15, 5, 5, 5, 8,
           5, 10, 5, 10, 8, 13, 15, 12, 3, 3)
BC7_AI2 = (15, 8, 8, 3, 15, 15, 3, 8, 15, 15, 15, 15, 15, 15, 15, 8, 15, 8, 15, 3, 15, 8, 15, 8, 3,
           15, 6, 10, 15, 15, 10, 8, 15, 3, 15, 10, 10, 8, 9, 10, 6, 15, 8, 15, 3, 6, 6, 8, 15, 3,
           15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3, 15, 15, 8)
WEIGHTS = {2: (0, 21, 43, 64), 3: (0, 9, 18, 27, 37, 46, 55, 64),
           4: (0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64)}
# BC6H modes: (subsets, transformed, partition bits, endpoint bits, delta bits r g b)
BC6_MODES = ((2, 1, 5, 10, 5, 5, 5), (2, 1, 5, 7, 6, 6, 6), (2, 1, 5, 11, 5, 4, 4),
             (2, 1, 5, 11, 4, 5, 4), (2, 1, 5, 11, 4, 4, 5), (2, 1, 5, 9, 5, 5, 5),
             (2, 1, 5, 8, 6, 5, 5), (2, 1, 5, 8, 5, 6, 5), (2, 1, 5, 8, 5, 5, 6),
             (2, 0, 5, 6, 6, 6, 6), (1, 0, 0, 10, 10, 10, 10), (1, 1, 0, 11, 9, 9, 9),
             (1, 1, 0, 12, 8, 8, 8), (1, 1, 0, 16, 4, 4, 4))
# BC6H's field layouts: for each mode, where each header bit goes, as
# 16 * endpoint word (r0 g0 b0 r1 g1 b1 r2 g2 b2 r3 g3 b3) + bit
BC6_BITS = (
    (116, 132, 180, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33,
     34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 164, 112, 113, 114, 115, 64, 65, 66, 67,
     68, 176, 160, 161, 162, 163, 80, 81, 82, 83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100,
     178, 144, 145, 146, 147, 148, 179),
    (117, 164, 165, 0, 1, 2, 3, 4, 5, 6, 176, 177, 132, 16, 17, 18, 19, 20, 21, 22, 133, 178, 116,
     32, 33, 34, 35, 36, 37, 38, 179, 181, 180, 48, 49, 50, 51, 52, 53, 112, 113, 114, 115, 64, 65,
     66, 67, 68, 69, 160, 161, 162, 163, 80, 81, 82, 83, 84, 85, 128, 129, 130, 131, 96, 97, 98,
     99, 100, 101, 144, 145, 146, 147, 148, 149),
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37,
     38, 39, 40, 41, 48, 49, 50, 51, 52, 10, 112, 113, 114, 115, 64, 65, 66, 67, 26, 176, 160, 161,
     162, 163, 80, 81, 82, 83, 42, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145,
     146, 147, 148, 179),
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37,
     38, 39, 40, 41, 48, 49, 50, 51, 10, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 26, 160, 161,
     162, 163, 80, 81, 82, 83, 42, 177, 128, 129, 130, 131, 96, 97, 98, 99, 176, 178, 144, 145,
     146, 147, 116, 179),
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37,
     38, 39, 40, 41, 48, 49, 50, 51, 10, 132, 112, 113, 114, 115, 64, 65, 66, 67, 26, 176, 160,
     161, 162, 163, 80, 81, 82, 83, 84, 42, 128, 129, 130, 131, 96, 97, 98, 99, 177, 178, 144, 145,
     146, 147, 180, 179),
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 132, 16, 17, 18, 19, 20, 21, 22, 23, 24, 116, 32, 33, 34, 35, 36,
     37, 38, 39, 40, 180, 48, 49, 50, 51, 52, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 176,
     160, 161, 162, 163, 80, 81, 82, 83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178,
     144, 145, 146, 147, 148, 179),
    (0, 1, 2, 3, 4, 5, 6, 7, 164, 132, 16, 17, 18, 19, 20, 21, 22, 23, 178, 116, 32, 33, 34, 35,
     36, 37, 38, 39, 179, 180, 48, 49, 50, 51, 52, 53, 112, 113, 114, 115, 64, 65, 66, 67, 68, 176,
     160, 161, 162, 163, 80, 81, 82, 83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 101,
     144, 145, 146, 147, 148, 149),
    (0, 1, 2, 3, 4, 5, 6, 7, 176, 132, 16, 17, 18, 19, 20, 21, 22, 23, 117, 116, 32, 33, 34, 35,
     36, 37, 38, 39, 165, 180, 48, 49, 50, 51, 52, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 69,
     160, 161, 162, 163, 80, 81, 82, 83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178,
     144, 145, 146, 147, 148, 179),
    (0, 1, 2, 3, 4, 5, 6, 7, 177, 132, 16, 17, 18, 19, 20, 21, 22, 23, 133, 116, 32, 33, 34, 35,
     36, 37, 38, 39, 181, 180, 48, 49, 50, 51, 52, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68,
     176, 160, 161, 162, 163, 80, 81, 82, 83, 84, 85, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178,
     144, 145, 146, 147, 148, 179),
    (0, 1, 2, 3, 4, 5, 164, 176, 177, 132, 16, 17, 18, 19, 20, 21, 117, 133, 178, 116, 32, 33, 34,
     35, 36, 37, 165, 179, 181, 180, 48, 49, 50, 51, 52, 53, 112, 113, 114, 115, 64, 65, 66, 67,
     68, 69, 160, 161, 162, 163, 80, 81, 82, 83, 84, 85, 128, 129, 130, 131, 96, 97, 98, 99, 100,
     101, 144, 145, 146, 147, 148, 149),
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37,
     38, 39, 40, 41, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 64, 65, 66, 67, 68, 69, 70, 71, 72,
     73, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89),
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37,
     38, 39, 40, 41, 48, 49, 50, 51, 52, 53, 54, 55, 56, 10, 64, 65, 66, 67, 68, 69, 70, 71, 72,
     26, 80, 81, 82, 83, 84, 85, 86, 87, 88, 42),
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37,
     38, 39, 40, 41, 48, 49, 50, 51, 52, 53, 54, 55, 11, 10, 64, 65, 66, 67, 68, 69, 70, 71, 27,
     26, 80, 81, 82, 83, 84, 85, 86, 87, 43, 42),
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37,
     38, 39, 40, 41, 48, 49, 50, 51, 15, 14, 13, 12, 11, 10, 64, 65, 66, 67, 31, 30, 29, 28, 27,
     26, 80, 81, 82, 83, 47, 46, 45, 44, 43, 42))


def _u16(x) -> np.ndarray:
    return x.astype(np.int32)


def _rgb565(c: np.ndarray) -> np.ndarray:
    """(N,) 5-6-5 words -> (N, 3) as bcn.c expands them (high bits repeated)."""
    r = (c & 0xF800) >> 8
    g = (c & 0x7E0) >> 3
    b = (c & 0x1F) << 3
    return np.stack([r | r >> 5, g | g >> 6, b | b >> 5], -1)


def _bc1_colour(blocks: np.ndarray, four_always: bool) -> np.ndarray:
    """(N, 8) BC1 colour blocks -> (N, 16, 4) RGBA."""
    c0 = _u16(blocks[:, 0]) | _u16(blocks[:, 1]) << 8
    c1 = _u16(blocks[:, 2]) | _u16(blocks[:, 3]) << 8
    lut = blocks[:, 4:8].copy().view("<u4")[:, 0].astype(np.int64)
    p0, p1 = _rgb565(c0), _rgb565(c1)
    four = (c0 > c1) | four_always
    p2 = np.where(four[:, None], (2 * p0 + p1) // 3, (p0 + p1) // 2)
    p3 = np.where(four[:, None], (p0 + 2 * p1) // 3, 0)
    a = np.full(len(blocks), 255)
    table = np.stack([np.concatenate([p0, a[:, None]], 1), np.concatenate([p1, a[:, None]], 1),
                      np.concatenate([p2, a[:, None]], 1),
                      np.concatenate([p3, np.where(four, 255, 0)[:, None]], 1)], 1)
    idx = (lut[:, None] >> (2 * np.arange(16))) & 3
    return np.take_along_axis(table, idx[..., None], 1)


def _bc3_alpha(blocks: np.ndarray, signed: bool) -> np.ndarray:
    """(N, 8) BC3/BC4/BC5 alpha blocks -> (N, 16) values."""
    if signed:
        a0 = blocks[:, 0].view(np.int8).astype(np.int32) + 128
        a1 = blocks[:, 1].view(np.int8).astype(np.int32) + 128
    else:
        a0, a1 = _u16(blocks[:, 0]), _u16(blocks[:, 1])
    k = np.arange(1, 7)
    eight = (((7 - k) * a0[:, None] + k * a1[:, None]) // 7)
    k5 = np.arange(1, 5)
    six = (((5 - k5) * a0[:, None] + k5 * a1[:, None]) // 5)
    six = np.concatenate([six, np.zeros((len(blocks), 1), np.int32),
                          np.full((len(blocks), 1), 255)], 1)
    table = np.concatenate([a0[:, None], a1[:, None],
                            np.where((a0 > a1)[:, None], eight, six)], 1) & 0xFF
    bits = np.zeros(len(blocks), np.int64)
    for i in range(6):
        bits |= blocks[:, 2 + i].astype(np.int64) << (8 * i)
    idx = (bits[:, None] >> (3 * np.arange(16))) & 7
    return np.take_along_axis(table, idx, 1)


def _get_bits(v: int, bit: int, count: int) -> int:
    return (v >> bit) & ((1 << count) - 1) if count else 0


def _bc7_block(block: bytes) -> list:
    """One BC7 block -> 16 (r, g, b, a), as bcn.c's ``decode_bc7_block``."""
    v = int.from_bytes(block, "little")
    if not block[0]:
        return [(0, 0, 0, 255)] * 16
    mode = (block[0] & -block[0]).bit_length() - 1
    bit = mode + 1
    ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2 = BC7_MODES[mode]
    cw = WEIGHTS[ib]
    aw = WEIGHTS[ib2 if ab and ib2 else ib]
    partition, bit = _get_bits(v, bit, pb), bit + pb
    rotation, bit = _get_bits(v, bit, rb), bit + rb
    index_sel, bit = _get_bits(v, bit, isb), bit + isb
    numep = ns * 2
    ep = [[0, 0, 0, 0xFF] for _ in range(numep)]
    for c in range(3):
        for i in range(numep):
            ep[i][c], bit = _get_bits(v, bit, cb), bit + cb
    if ab:
        for i in range(numep):
            ep[i][3], bit = _get_bits(v, bit, ab), bit + ab
    nc = 4 if ab else 3
    if epb:
        cb, ab = cb + 1, ab + 1 if ab else 0
        for i in range(numep):
            p, bit = _get_bits(v, bit, 1), bit + 1
            for c in range(nc):
                ep[i][c] = (ep[i][c] << 1 | p) & 0xFF
    if spb:
        cb, ab = cb + 1, ab + 1 if ab else 0
        for i in range(0, numep, 2):
            p, bit = _get_bits(v, bit, 1), bit + 1
            for j in range(2):
                for c in range(nc):
                    ep[i + j][c] = (ep[i + j][c] << 1 | p) & 0xFF
    for i in range(numep):
        for c in range(nc):
            bits_c = cb if c < 3 else ab
            x = (ep[i][c] << (8 - bits_c)) & 0xFF
            ep[i][c] = x | x >> bits_c
    cibit = bit
    aibit = cibit + 16 * ib - ns
    out = []
    for i in range(16):
        s = _subset(ns, partition, i) * 2
        n = ib
        if i == 0 or (ns == 2 and i == BC7_AI0[partition]) or \
                (ns == 3 and i in (BC7_AI1[partition], BC7_AI2[partition])):
            n -= 1
        i0, cibit = _get_bits(v, cibit, n), cibit + n
        if ab and ib2:
            n2 = ib2 - 1 if i == 0 else ib2
            i1, aibit = _get_bits(v, aibit, n2), aibit + n2
            s0, s1 = (aw[i1], cw[i0]) if index_sel else (cw[i0], aw[i1])
        else:
            s0 = s1 = cw[i0]
        e0, e1 = ep[s], ep[s + 1]
        px = [((64 - s0) * e0[c] + s0 * e1[c] + 32) >> 6 & 0xFF for c in range(3)]
        px.append(((64 - s1) * e0[3] + s1 * e1[3] + 32) >> 6 & 0xFF)
        if rotation:
            px[rotation - 1], px[3] = px[3], px[rotation - 1]
        out.append(tuple(px))
    return out


def _subset(ns: int, partition: int, n: int) -> int:
    if ns == 2:
        return BC7_SI2[partition] >> n & 1
    if ns == 3:
        return BC7_SI3[partition] >> (2 * n) & 3
    return 0


def _sext(x: int, prec: int) -> int:
    """bcn.c's ``bc6_sign_extend``, kept in 16 bits."""
    if x & (1 << (prec - 1)):
        x |= -1 << prec
    return x & 0xFFFF


def _unquantize(v: int, prec: int, signed: bool) -> int:
    if not signed:
        if prec >= 15 or v == 0:
            return v
        if v == (1 << prec) - 1:
            return 0xFFFF
        return ((v << 15) + 0x4000) >> (prec - 1)
    x = v - 0x10000 if v & 0x8000 else v
    if prec >= 16:
        return x
    neg = x < 0
    x = -x if neg else x
    if x:
        x = 0x7FFF if x >= (1 << (prec - 1)) - 1 else ((x << 15) + 0x4000) >> (prec - 1)
    return -x if neg else x


def _bc6_channel(v: int, signed: bool) -> int:
    """An interpolated endpoint value -> bcn.c's 8 bits: scaled into a half
    float, then ``(uint8)(f * 255.0f)`` of it clamped to 0..1."""
    if signed:
        h = (0x8000 | (-v * 31) // 32) if v < 0 else (v * 31) // 32
    else:
        h = (v * 31) // 64
    f = np.array(h & 0xFFFF, np.uint16).view(np.float16).astype(np.float32)
    if f < 0:
        return 0
    if f > 1:
        return 255
    return int(f * np.float32(255.0))


def _bc6_block(block: bytes, signed: bool) -> list:
    """One BC6H block -> 16 (r, g, b), as bcn.c's ``decode_bc6_block``."""
    v = int.from_bytes(block, "little")
    mode, bit, epbits, ib = block[0] & 0x1F, 5, 75, 3
    if mode & 3 in (0, 1):
        mode, bit = mode & 3, 2
    elif mode & 3 == 2:
        mode, epbits = 2 + (mode >> 2), 72
    else:
        mode, epbits, ib = 10 + (mode >> 2), 60, 4
    if mode >= 14:
        return [(0, 0, 0)] * 16
    ns, tr, pb, epb, rb, gb, bb = BC6_MODES[mode]
    cw = WEIGHTS[ib]
    numep = 12 if ns == 2 else 6
    ep = [0] * 12
    for i in range(epbits):
        d = BC6_BITS[mode][i]
        ep[d >> 4] |= ((v >> (bit + i)) & 1) << (d & 15)
    bit += epbits
    partition, bit = _get_bits(v, bit, pb), bit + pb
    mask = (1 << epb) - 1
    if signed:
        ep[0:3] = [_sext(x, epb) for x in ep[0:3]]
    if signed or tr:
        for i in range(3, numep, 3):
            ep[i], ep[i + 1], ep[i + 2] = _sext(ep[i], rb), _sext(ep[i + 1], gb), \
                _sext(ep[i + 2], bb)
    if tr:                      # the sums are not sign-extended again, as in bcn.c
        for i in range(3, numep):
            ep[i] = (ep[i] + ep[i % 3]) & mask
    ueps = [_unquantize(x, epb, signed) for x in ep[:numep]]
    out = []
    for i in range(16):
        s = _subset(ns, partition, i) * 6
        n = ib - 1 if i == 0 or (ns == 2 and i == BC7_AI0[partition]) else ib
        i0, bit = _get_bits(v, bit, n), bit + n
        w = cw[i0]
        out.append(tuple(_bc6_channel((ueps[s + c] * (64 - w) + ueps[s + 3 + c] * w) >> 6, signed)
                         for c in range(3)))
    return out


def bcn_decode_python(data: bytes, fmt: str, width: int, height: int) -> np.ndarray:
    """Pillow's ``bcn`` decoder of ``fmt``'s blocks: (H, W, 4) RGBA or (H, W)
    for BC4 ("L"), RGB formats with their fourth byte left at 0."""
    n, size, _ = BCN[fmt]
    bw, bh = -(-width // 4), -(-height // 4)
    blocks = np.frombuffer(data, np.uint8, bw * bh * size).reshape(-1, size)
    if n == 1:
        px = _bc1_colour(blocks, False)
    elif n == 2:
        px = _bc1_colour(blocks[:, 8:], True)
        nib = np.repeat(blocks[:, :8], 2, 1).astype(np.int32)
        nib[:, 0::2] &= 0xF
        nib[:, 1::2] >>= 4
        px[..., 3] = nib << 4 | nib
    elif n == 3:
        px = _bc1_colour(blocks[:, 8:], True)
        px[..., 3] = _bc3_alpha(blocks[:, :8], False)
    elif n == 4:
        px = _bc3_alpha(blocks, False)[..., None]
    elif n == 5:
        signed = fmt == "BC5S"
        px = np.zeros((len(blocks), 16, 4), np.int32)
        px[..., 0] = _bc3_alpha(blocks[:, :8], signed)
        px[..., 1] = _bc3_alpha(blocks[:, 8:], signed)
        px[..., 2] = 128 if signed else 0
    elif n == 6:
        signed = fmt == "BC6HS"
        px = np.array([[p + (0,) for p in _bc6_block(b.tobytes(), signed)] for b in blocks])
    else:
        px = np.array([_bc7_block(b.tobytes()) for b in blocks])
    px = np.asarray(px, np.int32).reshape(bh, bw, 4, 4, -1).transpose(0, 2, 1, 3, 4)
    img = px.reshape(bh * 4, bw * 4, -1)[:height, :width].astype(np.uint8)
    return img[..., 0] if n == 4 else img


def _bcn(data: bytes, fmt: str, width: int, height: int, native) -> np.ndarray:
    from coma_tpu_torch.native import codecs

    if native is None:
        native = codecs.bcn_available()
    if native:
        return codecs.bcn_decode(data, BCN[fmt][0], fmt in ("BC5S", "BC6HS"), width, height)
    return bcn_decode_python(data, fmt, width, height)


def _masked(data: bytes, pos: int, bitcount: int, masks: tuple, width: int,
            height: int) -> np.ndarray:
    """Pillow's ``DdsRgbDecoder``: each channel ``int(v / max * 255)`` of its
    mask, the pixels little-endian words of ``bitcount // 8`` bytes, whatever
    the bit count (none: every pixel 0); past the end of the file they read
    as zeros."""
    nbytes = bitcount // 8
    count = width * height
    buf = np.frombuffer(data, np.uint8)
    start = pos + np.arange(count, dtype=np.int64) * nbytes
    value = np.zeros(count, np.uint64)
    for k in range(min(nbytes, 4)):                # the masks are 32 bits: no more bytes reach them
        at = start + k
        inside = at < len(data)
        byte = np.zeros(count, np.uint64)
        byte[inside] = buf[at[inside]]
        value |= byte << np.uint64(8 * k)
    out = []
    for mask in masks:
        if mask == 0:
            out.append(np.zeros(count, np.uint8))
            continue
        shift = (mask & -mask).bit_length() - 1
        total = mask >> shift
        ch = ((value & np.uint64(mask)) >> np.uint64(shift)).astype(np.float64)
        out.append((ch / total * 255).astype(np.int64).astype(np.uint8))
    return np.stack(out, -1).reshape(height, width, len(masks))


def decode_dds(data: bytes, name: str = "<bytes>", native=None) -> Decoded:
    """A DDS file's first surface -> what ``np.asarray(PIL.Image.open(f))``
    gives, and its mode; a ``ValueError`` naming ``name`` where Pillow refuses
    it."""
    try:
        return _decode(data, native)
    except ValueError as err:
        raise ValueError(f"{name}: DDS: {err}") from None


def _decode(data: bytes, native) -> Decoded:
    if len(data) < 128 or data[:4] != b"DDS ":
        raise ValueError("not a DDS file, or a header cut short")
    if struct.unpack_from("<I", data, 4)[0] != 124:
        raise ValueError("a header size other than 124")
    height, width = struct.unpack_from("<2I", data, 12)
    pfflags, fourcc, bitcount = struct.unpack_from("<I4sI", data, 80)
    pos = 128
    if pfflags & _DDPF_RGB:
        n = 4 if pfflags & _DDPF_ALPHAPIXELS else 3
        masks = struct.unpack_from(f"<{n}I", data, 92)
        px = _masked(data, pos, bitcount, masks, width, height)
        return Decoded(px, "RGBA" if n == 4 else "RGB")
    palette = None
    if pfflags & _DDPF_LUMINANCE:
        if bitcount == 8:
            mode = "L"
        elif bitcount == 16 and pfflags & _DDPF_ALPHAPIXELS:
            mode = "LA"
        else:
            raise ValueError(f"unsupported bit count {bitcount} for {pfflags}")
    elif pfflags & _DDPF_PALETTE8:
        mode, palette = "P", np.frombuffer(data, np.uint8, 1024, pos).reshape(256, 4)
        pos += 1024
    elif pfflags & _DDPF_FOURCC:
        if fourcc == b"DX10":
            if len(data) < 132:             # Pillow's read of the DXGI format fails
                raise ValueError("a DX10 header cut short")
            dxgi = struct.unpack_from("<I", data, 128)[0]
            pos += 20
            if dxgi not in _DXGI:
                raise ValueError(f"unimplemented DXGI format {dxgi}")
            fmt = _DXGI[dxgi]
        elif fourcc in _FOURCC:
            fmt = _FOURCC[fourcc]
        else:
            raise ValueError(f"unimplemented pixel format {fourcc!r}")
        if fmt == "RGBA8":
            mode = "RGBA"
        else:
            need = -(-width // 4) * -(-height // 4) * BCN[fmt][1]
            if len(data) - pos < need:
                raise ValueError("image file is truncated")
            px = _bcn(data[pos:pos + need], fmt, width, height, native)
            mode = BCN[fmt][2]
            return Decoded(px if mode != "RGB" else np.ascontiguousarray(px[..., :3]), mode)
    else:
        raise ValueError(f"unknown pixel format flags {pfflags}")
    channels = {"L": 1, "LA": 2, "P": 1, "RGBA": 4}[mode]
    need = width * height * channels
    if len(data) - pos < need:
        raise ValueError("image file is truncated")
    px = np.frombuffer(data, np.uint8, need, pos).reshape(height, width, channels)
    if channels == 1:
        px = px[..., 0]
    if mode == "P":
        return Decoded(px, "P", palette[:, :3].copy())
    return Decoded(px, mode)
