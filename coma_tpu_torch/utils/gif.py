"""Write animated GIF89a files with numpy alone (the card machine has no PIL).

Counterpart of the PIL call in ``coma_tpu/visualization/video.py:53-62``:
frames share one global 256-colour palette, each frame is LZW-coded, a
Netscape block makes the animation loop forever (``loop=0``), and every
frame waits ``max(1, int(1000 / fps))`` ms, written in the format's
hundredths of a second as PIL writes it (``int(ms / 10)``).

The palette is exact when the frames hold at most 256 colours. Otherwise it
is a median cut of the frames' colour histogram at 5 bits per channel,
each box's colour the mean of the pixels in it, and a pixel takes the
palette entry nearest its 5-bit cell's mean colour.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

MAX_CODE = 4096   # GIF's 12-bit LZW table


def _median_cut(colors: np.ndarray, weights: np.ndarray, n: int) -> list:
    """Split the weighted colours (K, 3) into at most ``n`` boxes of indices."""
    boxes = [np.arange(len(colors))]
    while len(boxes) < n:
        spans = [np.ptp(colors[b], axis=0).max() if len(b) > 1 else -1 for b in boxes]
        i = int(np.argmax(spans))
        if spans[i] <= 0:
            break
        box = boxes.pop(i)
        axis = int(np.argmax(np.ptp(colors[box], axis=0)))
        order = box[np.argsort(colors[box, axis], kind="stable")]
        cum = np.cumsum(weights[order])
        cut = int(np.clip(np.searchsorted(cum, cum[-1] / 2), 0, len(order) - 2)) + 1
        boxes += [order[:cut], order[cut:]]
    return boxes


def quantize(frames: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(S, H, W, 3) uint8 -> (palette (256, 3) uint8, indices (S, H, W) uint8)."""
    rgb = frames.reshape(-1, 3).astype(np.int64)
    packed = (rgb[:, 0] << 16) | (rgb[:, 1] << 8) | rgb[:, 2]
    uniq, inverse = np.unique(packed, return_inverse=True)
    palette = np.zeros((256, 3), np.uint8)
    if len(uniq) <= 256:
        palette[:len(uniq)] = np.stack([uniq >> 16, (uniq >> 8) & 255, uniq & 255], 1)
        return palette, inverse.reshape(frames.shape[:-1]).astype(np.uint8)
    cell = ((rgb[:, 0] >> 3) << 10) | ((rgb[:, 1] >> 3) << 5) | (rgb[:, 2] >> 3)
    count = np.bincount(cell, minlength=1 << 15).astype(np.float64)
    sums = np.stack([np.bincount(cell, rgb[:, c], minlength=1 << 15) for c in range(3)], 1)
    occupied = np.flatnonzero(count)
    means = sums[occupied] / count[occupied, None]
    for k, box in enumerate(_median_cut(means, count[occupied], 256)):
        w = count[occupied][box]
        palette[k] = np.round((means[box] * w[:, None]).sum(0) / w.sum())
    d = ((means[:, None, :] - palette[None].astype(np.float64)) ** 2).sum(-1)
    lut = np.zeros(1 << 15, np.uint8)
    lut[occupied] = np.argmin(d, axis=1)
    return palette, lut[cell].reshape(frames.shape[:-1])


def lzw_encode(indices: np.ndarray, min_code_size: int = 8) -> bytes:
    """GIF's variable-width LZW of a flat uint8 index stream: a clear code
    first and whenever the 12-bit table fills, widths growing from 9 bits as
    the decoder's table does, the end code last."""
    clear, end = 1 << min_code_size, (1 << min_code_size) + 1
    codes, widths = [clear], [min_code_size + 1]
    table, next_code = {}, end + 1
    data = indices.tolist()
    prefix = data[0]
    for px in data[1:]:
        key = (prefix << 8) | px
        hit = table.get(key)
        if hit is not None:
            prefix = hit
            continue
        codes.append(prefix)
        widths.append((next_code - 1).bit_length())
        if next_code < MAX_CODE:
            table[key] = next_code
            next_code += 1
        else:
            codes.append(clear)
            widths.append(12)
            table, next_code = {}, end + 1
        prefix = px
    codes.append(prefix)
    widths.append(max(min_code_size + 1, (next_code - 1).bit_length()))
    codes.append(end)
    widths.append(max(min_code_size + 1, next_code.bit_length()
                      if next_code < MAX_CODE else 12))
    return _pack_bits(np.asarray(codes, np.int64), np.asarray(widths, np.int64))


def _pack_bits(codes: np.ndarray, widths: np.ndarray) -> bytes:
    """Codes least-significant bit first, as GIF packs them."""
    total = int(widths.sum())
    starts = np.concatenate([[0], np.cumsum(widths)[:-1]])
    rep = np.repeat(np.arange(len(codes)), widths)
    bit_in_code = np.arange(total) - starts[rep]
    bits = ((codes[rep] >> bit_in_code) & 1).astype(np.uint8)
    return np.packbits(bits, bitorder="little").tobytes()


def _sub_blocks(data: bytes) -> bytes:
    out = bytearray()
    for i in range(0, len(data), 255):
        chunk = data[i:i + 255]
        out += bytes([len(chunk)]) + chunk
    return bytes(out + b"\x00")


def encode_gif(frames: np.ndarray, fps: int = 8) -> bytes:
    """(S, H, W, 3) uint8 frames -> the bytes of a looping GIF89a."""
    frames = np.asarray(frames, np.uint8)
    S, H, W, _ = frames.shape
    palette, indices = quantize(frames)
    delay_cs = int(max(1, int(1000 / fps)) / 10)
    le16 = lambda v: int(v).to_bytes(2, "little")
    out = bytearray(b"GIF89a" + le16(W) + le16(H) + bytes([0xF7, 0, 0]) + palette.tobytes())
    out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + le16(0) + b"\x00"
    for s in range(S):
        out += b"\x21\xf9\x04\x00" + le16(delay_cs) + b"\x00\x00"
        out += b"\x2c" + le16(0) + le16(0) + le16(W) + le16(H) + b"\x00"
        out += b"\x08" + _sub_blocks(lzw_encode(indices[s].reshape(-1)))
    return bytes(out + b"\x3b")


def write_gif(frames: np.ndarray, out_path: str, fps: int = 8) -> None:
    with open(out_path, "wb") as fh:
        fh.write(encode_gif(frames, fps))
