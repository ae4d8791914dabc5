#!/usr/bin/env python3
"""Damage the committed image fixtures and hold the port's readers against
Pillow on the results.

    python3 tools/fuzz_image_readers.py [--seed 0] [--trials 20] [--jpeg-scan 300]
                                        [--formats jpg,gif,tif,webp,blp,ccitt,zstd,jp2,lab,
                                                   rare,subbyte_tiles]

Needs Pillow (the CPU test host has it). Each small fixture of
``tests/data/images/`` (its manifest's files under 64 kB, not the gzipped
atlases nor the damaged set) is changed ``--trials`` times from a numpy
seed: one to three bytes overwritten (mostly in the first 600, where the
headers are), the file cut at a random length, or a byte inserted or
dropped. ``--formats`` keeps the fixtures with those extensions, or the
TIFF fixtures of those compressions (``ccitt``, ``thunderscan``, ``lzma``,
``zstd``, ``ojpeg``; see :data:`TIFF_CODECS`), or, for ``lab``, the fixtures
Pillow opens as "LAB" (PSD and CIELab TIFF), for ``rare`` those of
:data:`RARE` (FITS, FLI/FLC, XPM, FTEX, GBR, PIXAR, IMT, McIdas, XV
thumbnails, IPTC/NAA; the PhotoCD fixture is stored gzipped and left out),
for ``subbyte_tiles`` the tiled TIFFs below 8 bits a pixel. Pillow opens
and loads each result from a file, as ``read_image``'s paths are opened (so
Pillow memory-maps what it maps), and converts it to modes None, RGB and L;
``utils/image_io.decode_image`` and ``utils/modes.to_mode`` do the same (a
conversion both refuse, as "LAB" to "L", agrees).
Every outcome falls in one of: equal arrays, both refuse, different arrays,
Pillow reads and the port refuses, the port reads and Pillow refuses. The
counts are printed by outcome, then each divergence class by format, outcome
and the refusing side's message (digits folded to ``#``), with one example
input. ``--jpeg-scan N`` also changes one byte in the scan of a seeded JPEG N
times. Files whose size passes 4 million pixels are skipped; the process caps
its address space at 6 GiB, and a port decode that runs out of it counts as
a refusal. The exit status is 1 when any divergence remains, else 0.
"""
from __future__ import annotations

import argparse
import collections
import io
import json
import os
import re
import resource
import sys
import warnings

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "data", "images")
MODES = (None, "RGB", "L")
AGREE = ("equal", "both refuse")
# --formats names for the TIFF compressions: their tag values
TIFF_CODECS = {"ccitt": (2, 3, 4, 32771), "thunderscan": (32809,), "lzma": (34925,),
               "zstd": (50000,), "ojpeg": (6,)}
# --formats rare: the extensions of the formats read through PIL's smaller plugins
RARE = (".fits", ".fli", ".flc", ".xpm", ".ftc", ".ftu", ".gbr", ".pxr", ".imt", ".area", ".xv",
        ".iptc")
_SCRATCH = {}


def pillow(data: bytes):
    """Pillow's three arrays, "big", or its refusal's message (a str)."""
    import tempfile

    from PIL import Image

    if "path" not in _SCRATCH:
        fd, _SCRATCH["path"] = tempfile.mkstemp(prefix="fuzzed_")
        os.close(fd)
    with open(_SCRATCH["path"], "wb") as fh:
        fh.write(data)
    try:
        with Image.open(_SCRATCH["path"]) as im:
            if im.size[0] * im.size[1] > 4_000_000:
                return "big"
            im.load()
            return [_convert(lambda m: np.asarray(im if m is None else im.convert(m)), m)
                    for m in MODES]
    except Image.DecompressionBombError:    # past this tool's own pixel limit: skipped too
        return "big"
    except Exception as err:                # every refusal of Pillow's counts as one
        return f"{type(err).__name__}: {err}"


def _convert(convert, mode):
    """``convert(mode)``, or None where that conversion is refused (a
    decoded image of a mode that does not convert, as "LAB" to "L")."""
    if mode is None:
        return convert(mode)
    try:
        return convert(mode)
    except ValueError as err:
        if "conversion from" in str(err):
            return None
        raise


def port(data: bytes):
    """The port's three arrays, or its refusal's message (a str)."""
    from coma_tpu_torch.utils.image_io import decode_image
    from coma_tpu_torch.utils.modes import to_mode

    try:
        decoded = decode_image(data, "fuzzed")
        return [_convert(lambda m: to_mode(decoded, m), m) for m in MODES]
    except (ValueError, MemoryError) as err:
        return f"{type(err).__name__}: {err}"


def outcome(want, got) -> tuple:
    """(outcome, the refusing side's message or "")."""
    if isinstance(want, str) and isinstance(got, str):
        return "both refuse", ""
    if isinstance(want, str):
        return "port reads, Pillow refuses", want
    if isinstance(got, str):
        return "Pillow reads, port refuses", got
    same = all((a is None and b is None) or (
        a is not None and b is not None and a.shape == b.shape and a.dtype == b.dtype
        and np.array_equal(a, b, equal_nan=a.dtype.kind == "f")) for a, b in zip(want, got))
    return ("equal" if same else "different arrays"), ""


def fold(message: str) -> str:
    """A message as a class: the file name dropped, digits folded."""
    message = re.sub(r" at 0x[0-9a-f]+", "", message.replace("fuzzed: ", ""))
    return re.sub(r"\d+", "#", message)[:110]


def tiff_compression(name: str) -> int:
    """A TIFF fixture's compression tag (0 where its directory is unread)."""
    from coma_tpu_torch.utils.tiff import _Ifd

    with open(os.path.join(FIXTURES, name), "rb") as fh:
        try:
            return _Ifd(fh.read(), name).get(259, (1,))[0]
        except ValueError:
            return 0


def subbyte_tiles(name: str) -> bool:
    """Whether a TIFF fixture is tiled below 8 bits a pixel."""
    from coma_tpu_torch.utils.tiff import _Ifd

    with open(os.path.join(FIXTURES, name), "rb") as fh:
        try:
            ifd = _Ifd(fh.read(), name)
        except ValueError:
            return False
    return 322 in ifd.tags and sum(ifd.get(258, (1,))) < 8


def damage(data: bytes, rng) -> bytes:
    b = bytearray(data)
    kind = rng.integers(0, 3)
    if kind == 0:
        for _ in range(rng.integers(1, 4)):
            k = rng.integers(0, min(len(b), 600) if rng.random() < 0.7 else len(b))
            b[k] = rng.integers(0, 256)
    elif kind == 1:
        b = b[:rng.integers(0, len(b))]
    else:
        k = rng.integers(0, len(b))
        b[k:k + 1] = bytes([rng.integers(0, 256)]) * rng.integers(0, 3)
    return bytes(b)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--trials", type=int, default=20)
    parser.add_argument("--jpeg-scan", type=int, default=0)
    parser.add_argument("--formats", default="",
                        help="comma-separated extensions, TIFF compressions (ccitt, "
                        "thunderscan, lzma, zstd, ojpeg), lab, rare or subbyte_tiles, to keep "
                        "(default: every fixture)")
    args = parser.parse_args()
    resource.setrlimit(resource.RLIMIT_AS, (6 << 30, 6 << 30))
    warnings.simplefilter("ignore")
    from PIL import Image

    Image.MAX_IMAGE_PIXELS = 4_000_000
    sys.path.insert(0, REPO)
    rng = np.random.default_rng(args.seed)
    names = [e.strip(".").lower() for e in args.formats.split(",") if e.strip()]
    keep = {"." + e for e in names if e not in TIFF_CODECS and e not in ("lab", "rare",
                                                                        "subbyte_tiles")}
    if "rare" in names:
        keep.update(RARE)
    codecs = {c for e in names for c in TIFF_CODECS.get(e, ())}
    with open(os.path.join(FIXTURES, "manifest.json")) as fh:
        entries = [e for e in json.load(fh)["files"] if "stored" not in e and e["bytes"] < 64_000]
    lab = {e["file"] for e in entries if e.get("mode") == "LAB"} if "lab" in names else set()
    files = [e["file"] for e in entries]
    if names:
        files = [f for f in files if os.path.splitext(f)[1].lower() in keep or f in lab
                 or (codecs and f.endswith(".tif") and tiff_compression(f) in codecs)
                 or ("subbyte_tiles" in names and f.endswith(".tif") and subbyte_tiles(f))]
    counts, classes, examples = collections.Counter(), collections.Counter(), {}
    for name in files:
        with open(os.path.join(FIXTURES, name), "rb") as fh:
            data = fh.read()
        for trial in range(args.trials):
            damaged = damage(data, rng)
            want = pillow(damaged)
            if isinstance(want, str) and want == "big":
                continue
            result, message = outcome(want, port(damaged))
            counts[result] += 1
            if result not in AGREE:
                key = (os.path.splitext(name)[1], result, fold(message))
                classes[key] += 1
                examples.setdefault(key, f"{name} trial {trial}")
    print(f"fixtures: {len(files)}, damaged files: {sum(counts.values())}")
    for result, n in counts.most_common():
        print(f"  {result}: {n}")
    for (ext, result, message), n in sorted(classes.items()):
        print(f"  {ext} {result}: {n}  [{message or '-'}]  e.g. {examples[ext, result, message]}")
    diverged = sum(classes.values())
    if args.jpeg_scan and (not keep or ".jpg" in keep):
        sys.path.insert(0, os.path.join(REPO, "tools"))
        from make_image_fixtures import seeded_rgb

        buf = io.BytesIO()
        Image.fromarray(seeded_rgb((24, 40), 160)).save(buf, "JPEG", quality=85)
        data = buf.getvalue()
        scan, scan_classes = collections.Counter(), collections.Counter()
        for _ in range(args.jpeg_scan):
            b = bytearray(data)
            b[rng.integers(len(data) // 3, len(data) - 2)] = rng.integers(0, 256)
            result, message = outcome(pillow(bytes(b)), port(bytes(b)))
            scan[result] += 1
            if result not in AGREE:
                scan_classes[result, fold(message)] += 1
        print(f"a seeded JPEG with one scan byte changed, {args.jpeg_scan} times:")
        for result, n in scan.most_common():
            print(f"  {result}: {n}")
        for (result, message), n in sorted(scan_classes.items()):
            print(f"  {result}: {n}  [{message or '-'}]")
        diverged += sum(scan_classes.values())
    print(f"divergences: {diverged}")
    if "path" in _SCRATCH:
        os.remove(_SCRATCH["path"])
    return 1 if diverged else 0


if __name__ == "__main__":
    sys.exit(main())
