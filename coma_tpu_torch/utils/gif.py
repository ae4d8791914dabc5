"""Write animated GIF89a files as PIL writes them, with numpy alone (the card
machine has no PIL).

Counterpart of the PIL call in ``coma_tpu/visualization/video.py:53-62``
(``save_all=True, duration=max(1, int(1000 / fps)), loop=0``). PIL's GIF
writer converts each RGB frame on its own with
``convert("P", palette=ADAPTIVE)``, libImaging's median-cut ``quantize(256)``
(``Quant.c``), drops a frame whose colours equal the previous frame's
(adding its duration to that frame) and stores each delay as
``int(ms / 10)`` hundredths of a second. :func:`quantize` reproduces the
median cut, value for value:

- the pixel hash: colours are counted at ``scale`` bits dropped, the least
  scale that leaves at most 65536 distinct ones (libImaging's hash of
  ``(r, g, b) >> scale`` has no collisions, so its table order never
  matters);
- the boxes: a heap of boxes by pixel count (``QuantHeap.c``, ties as its
  sift resolves them), each split on the axis of largest extent weighted
  77, 150, 29 at the colour where the running count first passes half, the
  boxes of volume one set aside, 255 splits at most;
- the palette: each box's mean colour over the frame's pixels,
  ``int(0.5 + sum / count)``, in the tree's left-to-right order;
- the mapping: each colour starts at its box's entry and takes the nearest
  entry (squared RGB distance, the first in the box entry's stable
  distance order on a tie) among those within four times that distance of
  the box's entry.

Each kept frame is written whole with its own 256-entry palette (the first
as the global table), LZW-coded; a Netscape block makes it loop forever.
Decoded by PIL, the frames equal those it decodes from ``coma_tpu``'s file;
``utils/gif_reader.py`` reads them back.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

MAX_CODE = 4096            # GIF's 12-bit LZW table
MAX_HASH_ENTRIES = 65536   # libImaging's pixel hash before it drops a bit
_WEIGHTS = (77, 150, 29)   # split-axis weights of Quant.c's split()


class _Box:
    __slots__ = ("entries", "count", "volume", "left", "right")

    def __init__(self, entries: np.ndarray, count: int):
        self.entries, self.count = entries, count
        self.volume, self.left, self.right = 0, None, None


class _Heap:
    """``QuantHeap.c``: a 1-based binary max-heap by pixel count whose sifts
    resolve ties exactly as libImaging's."""

    def __init__(self):
        self.heap = [None]

    def add(self, box: _Box) -> None:
        self.heap.append(box)
        k = len(self.heap) - 1
        while k != 1:
            if box.count - self.heap[k // 2].count <= 0:
                break
            self.heap[k] = self.heap[k // 2]
            k >>= 1
        self.heap[k] = box

    def remove(self):
        h = self.heap
        if len(h) == 1:
            return None
        top, v = h[1], h.pop()
        n = len(h) - 1
        if n == 0:
            return top
        k = 1
        while k * 2 <= n:
            child = k * 2
            if child < n and h[child].count - h[child + 1].count < 0:
                child += 1
            if v.count - h[child].count > 0:
                break
            h[k] = h[child]
            k = child
        h[k] = v
        return top


def _volume(box: _Box, values: np.ndarray) -> int:
    if not box.volume:
        v = values[box.entries]
        box.volume = int(np.prod(v.max(0).astype(np.int64) - v.min(0) + 1))
    return box.volume


def _split(box: _Box, values: np.ndarray, counts: np.ndarray) -> None:
    """``split``/``splitlists``: the higher part of the chosen axis goes
    left, up to and including the colour where the running count first
    exceeds half the box's; if that leaves nothing right, the box's lowest
    colour goes right."""
    v = values[box.entries]
    extent = (v.max(0).astype(np.int64) - v.min(0)) * _WEIGHTS
    axis = 0
    for i in (1, 2):
        if extent[axis] < extent[i]:
            axis = i
    column = v[:, axis]
    order = np.argsort(-column.astype(np.int64), kind="stable")
    running = np.cumsum(counts[box.entries][order])
    cross = int(np.argmax(running * 2 > box.count)) if running[-1] * 2 > box.count \
        else len(order) - 1
    left = column >= column[order[cross]]
    if left.all():
        left = column != column.min()
    box.left = _Box(box.entries[left], int(counts[box.entries[left]].sum()))
    box.right = _Box(box.entries[~left], int(counts[box.entries[~left]].sum()))


def _leaves(box: _Box) -> List[_Box]:
    if box.left is None:
        return [box]
    return _leaves(box.left) + _leaves(box.right)


def quantize(frame: np.ndarray, colours: int = 256) -> Tuple[np.ndarray, np.ndarray]:
    """(H, W, 3) uint8 -> (palette (n, 3) uint8, indices (H, W) uint8):
    libImaging's median cut, as ``Image.convert("P", palette=ADAPTIVE)``."""
    px = np.asarray(frame, np.uint8).reshape(-1, 3).astype(np.int64)
    N = len(px)
    for scale in range(9):
        s = px >> scale
        keys, entry_of = np.unique(s[:, 0] << 16 | s[:, 1] << 8 | s[:, 2], return_inverse=True)
        if len(keys) <= MAX_HASH_ENTRIES:
            break
    counts = np.bincount(entry_of, minlength=len(keys)).astype(np.int64)
    values = np.stack([keys >> 16, (keys >> 8) & 255, keys & 255], 1)
    root = _Box(np.arange(len(keys)), N)
    heap = _Heap()
    heap.add(root)
    for _ in range(colours - 1):
        box = heap.remove()
        while box is not None and _volume(box, values) == 1:
            box = heap.remove()
        if box is None:
            break
        _split(box, values, counts)
        heap.add(box.left)
        heap.add(box.right)
    leaves = _leaves(root)
    box_of_entry = np.zeros(len(keys), np.int64)
    for b, leaf in enumerate(leaves):
        box_of_entry[leaf.entries] = b
    box_of_pixel = box_of_entry[entry_of]
    n = len(leaves)
    total = np.bincount(box_of_pixel, minlength=n).astype(np.float64)
    palette = np.stack([(0.5 + np.bincount(box_of_pixel, px[:, c], minlength=n) / total)
                        .astype(np.int64) for c in range(3)], 1)
    return palette.astype(np.uint8), _map_pixels(px, box_of_pixel, palette).reshape(
        frame.shape[:2])


def _map_pixels(px: np.ndarray, box_of_pixel: np.ndarray, palette: np.ndarray) -> np.ndarray:
    """``map_image_pixels_from_median_box``: each distinct colour's entry,
    box by box (the candidates of a box's colours are a prefix of its
    entry's distance order)."""
    packed = px[:, 0] << 16 | px[:, 1] << 8 | px[:, 2]
    colours, first, inverse = np.unique(packed, return_index=True, return_inverse=True)
    rgb, box = px[first], box_of_pixel[first]
    between = ((palette[:, None, :] - palette[None, :, :]) ** 2).sum(-1)     # avgDist
    order = np.argsort(between, axis=1, kind="stable")                       # qsort's order
    ordered = np.take_along_axis(between, order, 1)
    choice = np.empty(len(colours), np.int64)
    by_box = np.argsort(box, kind="stable")
    starts = np.searchsorted(box[by_box], np.arange(len(palette) + 1))
    pal32 = palette.astype(np.int32)
    for e in range(len(palette)):
        sel = by_box[starts[e]:starts[e + 1]]
        if not len(sel):
            continue
        c = rgb[sel].astype(np.int32)
        d0 = ((c - pal32[e]) ** 2).sum(-1)
        reach = np.searchsorted(ordered[e], 4 * d0, side="right")
        choice[sel] = e
        # colours whose reach holds more than their own entry, in groups of
        # similar reach
        for bits in range(1, 9):
            group = np.flatnonzero((reach > 1 << (bits - 1)) & (reach <= 1 << bits))
            if not len(group):
                continue
            m = int(reach[group].max())
            cand = order[e, :m]
            dist = ((c[group, None, :] - pal32[cand][None]) ** 2).sum(-1)
            dist = np.where(ordered[e, :m][None] <= 4 * d0[group, None], dist,
                            np.iinfo(np.int32).max)
            best = dist.min(1)
            pick = cand[np.argmax(dist == best[:, None], axis=1)]
            choice[sel[group]] = np.where(best < d0[group], pick, e)
    return choice[inverse].astype(np.uint8)


def pil_frames(frames: np.ndarray, fps: int = 8) -> List[Tuple[np.ndarray, np.ndarray, int]]:
    """The frames PIL's writer keeps: per kept frame (palette (256, 3),
    indices (H, W), duration in ms), a frame whose colours equal the
    previous kept frame's merged into it."""
    duration = max(1, int(1000 / fps))
    kept: list = []
    for frame in np.asarray(frames, np.uint8):
        palette, indices = quantize(frame)
        full = np.zeros((256, 3), np.uint8)
        full[:len(palette)] = palette
        if kept and np.array_equal(full[indices], kept[-1][0][kept[-1][1]]):
            kept[-1][2] += duration
            continue
        kept.append([full, indices, duration])
    return [tuple(k) for k in kept]


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
    """(S, H, W, 3) uint8 frames -> the bytes of a looping GIF89a that PIL
    decodes to the frames it decodes from its own file of them."""
    kept = pil_frames(frames, fps)
    H, W = kept[0][1].shape
    le16 = lambda v: int(v).to_bytes(2, "little")
    out = bytearray(b"GIF89a" + le16(W) + le16(H) + bytes([0xF7, 0, 0]) + kept[0][0].tobytes())
    out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + le16(0) + b"\x00"
    for k, (palette, indices, ms) in enumerate(kept):
        out += b"\x21\xf9\x04\x00" + le16(int(ms / 10)) + b"\x00\x00"
        out += b"\x2c" + le16(0) + le16(0) + le16(W) + le16(H)
        out += b"\x00" if k == 0 else b"\x87" + palette.tobytes()
        out += b"\x08" + _sub_blocks(lzw_encode(indices.reshape(-1)))
    return bytes(out + b"\x3b")


def write_gif(frames: np.ndarray, out_path: str, fps: int = 8) -> None:
    with open(out_path, "wb") as fh:
        fh.write(encode_gif(frames, fps))
