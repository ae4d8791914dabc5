"""Kodak PhotoCD files, as Pillow's ``PcdImagePlugin`` reads them.

``PCD_`` at byte 2048; the 768 x 512 base image from sector 96 (byte
196608), in pairs of rows of 768 Y, 768 Y, 384 C1 and 384 C2 bytes, each
chroma sample shared by the 2 x 2 block it sits over, as libImaging's
``PcdDecode.c`` reads it. The PhotoYCC triples become RGB through
``UnpackYCC.c``'s tables (:func:`ycc_to_rgb`). Orientation bits 1 and 3
(byte 3586, ``& 3``) rotate the image 90 or 270 degrees to 512 x 768,
as PIL's ``tile_post_rotate`` does. Mode "RGB"; a file that ends before
the last pair of rows is refused, as PIL refuses it.
"""
from __future__ import annotations

import numpy as np

from coma_tpu_torch.utils.modes import Decoded, NotThisFormat

WIDTH, HEIGHT, OFFSET = 768, 512, 96 * 2048


def _table(k: float, centre: int) -> np.ndarray:
    """A table of ``UnpackYCC.c``: ``(int)(k (v - centre) + 0.5)``."""
    return np.trunc(k * (np.arange(256) - centre) + 0.5).astype(np.int32)


# PhotoYCC -> RGB: luma 1.3584 Y; C1 centred on 156, C2 on 137
_L = _table(1.3584, 0)
_CB, _GB = _table(2.2179, 156), _table(-0.4303, 156)
_CR, _GR = _table(1.8215, 137), _table(-0.9271, 137)


def ycc_to_rgb(ycc: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 PhotoYCC -> (..., 3) uint8 RGB: PIL's ``YCC;P`` unpacker,
    ``l + CR[c2]``, ``l + GR[c2] + GB[c1]`` and ``l + CB[c1]`` with
    ``l = L[y]``, clipped to 0..255."""
    l = _L[ycc[..., 0]]
    c1, c2 = ycc[..., 1], ycc[..., 2]
    rgb = np.stack([l + _CR[c2], l + _GR[c2] + _GB[c1], l + _CB[c1]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def decode_pcd(data: bytes, name: str = "<bytes>") -> Decoded:
    """A PhotoCD file's bytes -> what ``np.asarray(PIL.Image.open(f))``
    gives (mode "RGB"); ``NotThisFormat`` where PIL's plugin does not take
    it, a ``ValueError`` naming ``name`` where PIL refuses it."""
    if data[2048:2052] != b"PCD_":
        raise NotThisFormat(f"{name}: not a Kodak PhotoCD file")
    if len(data) < 2048 + 1539:
        # PIL's _open reads byte 1538 of the 1539 after 2048
        raise NotThisFormat(f"{name}: a PhotoCD header cut short")
    orientation = data[2048 + 1538] & 3
    pair = 3 * WIDTH                                  # two rows of Y, one of C1 and C2
    if len(data) < OFFSET + pair * (HEIGHT // 2):
        raise ValueError(f"{name}: PhotoCD: image file is truncated")
    body = np.frombuffer(data, np.uint8, pair * (HEIGHT // 2), OFFSET).reshape(HEIGHT // 2, pair)
    y = body[:, :2 * WIDTH].reshape(HEIGHT, WIDTH)
    # PcdDecode.c's chroma of column x: ptr[(x + 4 W) / 2] and ptr[(x + 5 W) / 2]
    x = np.arange(WIDTH)
    c1 = np.repeat(body[:, (x + 4 * WIDTH) // 2], 2, axis=0)
    c2 = np.repeat(body[:, (x + 5 * WIDTH) // 2], 2, axis=0)
    rgb = ycc_to_rgb(np.stack([y, c1, c2], -1))
    if orientation == 1:                               # PIL's rotate(90, expand=True)
        rgb = np.rot90(rgb, 1)
    elif orientation == 3:
        rgb = np.rot90(rgb, 3)
    return Decoded(np.ascontiguousarray(rgb), "RGB")
