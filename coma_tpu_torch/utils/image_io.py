"""One reader for every image file ``coma_tpu`` opens with PIL.

:func:`read_image` gives, for a PNG or a JPEG file, the array that
``np.asarray(PIL.Image.open(path).convert(mode))`` gives: the JPEG through
``utils/jpeg.py`` (libjpeg-turbo's decoder, equal to Pillow's), the PNG through
``utils/png.py``. The card machine has no PIL. Any other format raises a
``ValueError`` naming the file; so does a JPEG the decoder does not read
(arithmetic, lossless, 12-bit, CMYK).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from coma_tpu_torch.utils.jpeg import decode_jpeg
from coma_tpu_torch.utils.png import decode_png, to_gray, to_rgb

_PNG = b"\x89PNG\r\n\x1a\n"
_JPEG = b"\xff\xd8"


def read_image(path: str, mode: Optional[str] = None) -> np.ndarray:
    """uint8 pixels of the PNG or JPEG file at ``path``. ``mode`` None: the
    file's own channels, (H, W, C) (palette images expanded to RGB); "RGB":
    (H, W, 3), gray repeated and alpha dropped; "L": (H, W), PIL's
    ``(19595 R + 38470 G + 7471 B + 2^15) >> 16``."""
    if mode not in (None, "RGB", "L"):
        raise ValueError(f"mode {mode!r}: only None, 'RGB' and 'L' are read")
    with open(path, "rb") as fh:
        data = fh.read()
    if data.startswith(_PNG):
        image = decode_png(data, str(path))
    elif data.startswith(_JPEG):
        image = decode_jpeg(data, str(path))
    else:
        raise ValueError(f"{path}: neither a PNG nor a JPEG file")
    if mode == "RGB":
        return to_rgb(image)
    if mode == "L":
        return to_gray(image)
    return image
