"""ctypes bindings of ``src/image_codecs.cpp``: the LZW, PackBits, run-length
and QOI decoders of the image readers (``utils/gif_reader.py``,
``utils/tiff.py``, ``utils/psd.py``, ``utils/tga.py``, ``utils/{sgi,pcx,
icns,sun,msp,qoi}.py``), FLI/FLC's frame decoder (``utils/fli.py``), the
sub-byte TIFF tile gathering (``utils/tiff.py``) and Little CMS's Lab
interpolation (``utils/lcms.py``), of ``src/bcn_decode.cpp`` (DDS's and BLP's blocks), of
``src/webp_decode.cpp``, of ``src/tiff_codecs.cpp`` (TIFF's CCITT and
Zstandard strips), of ``src/j2k_decode.cpp`` (JPEG 2000's tier-1 and
reconstruction, ``utils/j2k.py``) and of ``src/av1_decode.cpp`` (AVIF's AV1
decoder, ``utils/avif.py``), built with ``g++`` at first use like the other
native sources. Each reader keeps its plain Python decoder as the reference
and falls back to it where :func:`available` is false, except the AV1
decoder, which has no plain twin: where it does not build,
``native.BuildError`` says why."""
from __future__ import annotations

import ctypes

import numpy as np

from coma_tpu_torch import native

CODECS_SRC = native._SRC_DIR / "image_codecs.cpp"
BCN_SRC = native._SRC_DIR / "bcn_decode.cpp"


def _declare(lib: ctypes.CDLL) -> None:
    lib.lzw_decode.restype = ctypes.c_int64
    lib.lzw_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                               ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
    lib.packbits_decode.restype = ctypes.c_int64
    lib.packbits_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                                    ctypes.c_int64]
    lib.packbits_rows_decode.restype = ctypes.c_int
    lib.packbits_rows_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                                         ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    lib.tga_rle_decode.restype = ctypes.c_int
    lib.tga_rle_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                                   ctypes.c_void_p]
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    for fn, args, res in (
            ("qoi_decode", [ctypes.c_char_p, i64, i64, i64, ctypes.c_int, ptr], ctypes.c_int),
            ("sgi_rle_decode", [ctypes.c_char_p, i64, i64, i64, ctypes.c_int, ctypes.c_int, ptr],
             ctypes.c_int),
            ("pcx_rle_decode", [ctypes.c_char_p, i64, i64, i64, i64, i64, i64, i64, ptr],
             ctypes.c_int),
            ("icns_rle_decode", [ctypes.c_char_p, i64, i64, i64, ptr], ctypes.c_int),
            ("sun_rle_decode", [ctypes.c_char_p, i64, i64, i64, ptr], ctypes.c_int),
            ("msp_rle_decode", [ctypes.c_char_p, i64, i64, i64, ptr, i64], i64),
            ("lab_tetra_interp", [ptr, i64, ptr, ctypes.c_int, ptr], None),
            ("fli_decode", [ctypes.c_char_p, i64, i64, i64, ptr, ptr], i64),
            ("tile_bits_gather", [ptr, i64, i64, i64, i64, ctypes.c_int, i64, ptr], None)):
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = res


def _lib():
    return native.load_library(CODECS_SRC, _declare)


def available() -> bool:
    """Whether the codecs library builds and loads in this process."""
    return _lib() is not None


def _need():
    lib = _lib()
    if lib is None:
        raise RuntimeError("the native image codecs are not available (no g++)")
    return lib


def lzw_decode(data: bytes, min_code_size: int, tiff: bool, cap: int, end_from: int = 0) -> bytes:
    """GIF (``tiff`` False) or TIFF LZW of ``data``, at most ``cap`` bytes;
    an end code ending before byte ``end_from`` is passed over."""
    out = np.zeros(max(cap, 1), np.uint8)
    n = _need().lzw_decode(data, len(data), min_code_size, int(tiff), out.ctypes.data, cap,
                           end_from)
    if n < 0:
        raise ValueError("an LZW code that is not in the table (corrupt data)")
    return out[:n].tobytes()


def packbits_decode(data: bytes, cap: int) -> bytes:
    out = np.zeros(max(cap, 1), np.uint8)
    n = _need().packbits_decode(data, len(data), out.ctypes.data, cap)
    return out[:n].tobytes()


def packbits_rows_decode(data: bytes, pos: int, row: int, rows: int) -> bytes:
    """PackBits from ``data[pos:]`` as PIL decodes a Photoshop channel:
    ``rows`` rows of ``row`` bytes, packets cut at each row's end."""
    out = np.zeros(max(row * rows, 1), np.uint8)
    if _need().packbits_rows_decode(data, len(data), pos, row, rows, out.ctypes.data):
        raise ValueError("image file is truncated")
    return out[:row * rows].tobytes()


def tga_rle_decode(data: bytes, pos: int, row_bytes: int, rows: int, pixel_bytes: int) -> bytes:
    out = np.zeros(max(row_bytes * rows, 1), np.uint8)
    status = _need().tga_rle_decode(data, len(data), pos, row_bytes, rows, pixel_bytes,
                                    out.ctypes.data)
    if status == 1:
        raise ValueError("the run-length data ends before the image is full")
    if status == 2:
        raise ValueError("a run-length packet crosses the end of a row")
    return out[:row_bytes * rows].tobytes()


def qoi_decode(data: bytes, pos: int, pixels: int, channels: int) -> bytes:
    out = np.zeros(max(pixels * channels, 1), np.uint8)
    if _need().qoi_decode(data, len(data), pos, pixels, channels, out.ctypes.data):
        raise ValueError("the QOI data ends before the image is full")
    return out[:pixels * channels].tobytes()


def sgi_rle_decode(data: bytes, width: int, height: int, bands: int, bpc: int) -> bytes:
    out = np.zeros(max(width * height * bands * bpc, 1), np.uint8)
    if _need().sgi_rle_decode(data, len(data), width, height, bands, bpc, out.ctypes.data):
        raise ValueError("an RLE table, row or packet runs past the file or its row")
    return out[:width * height * bands * bpc].tobytes()


def pcx_rle_decode(data: bytes, pos: int, row_bytes: int, rows: int, bands: int, size: int,
                   stride: int) -> bytes:
    out = np.zeros(max(row_bytes * rows, 1), np.uint8)
    status = _need().pcx_rle_decode(data, len(data), pos, row_bytes, rows, bands, size, stride,
                                    out.ctypes.data)
    if status == 1:
        raise ValueError("image file is truncated")
    if status == 2:
        raise ValueError("a run passes the end of a row (buffer overrun)")
    return out[:row_bytes * rows].tobytes()


def icns_rle_decode(data: bytes, pos: int, pixels: int) -> bytes:
    out = np.zeros(max(3 * pixels, 1), np.uint8)
    status = _need().icns_rle_decode(data, len(data), pos, pixels, out.ctypes.data)
    if status == 1:
        raise ValueError("error reading channel (it does not end at the image's size)")
    if status == 2:
        raise ValueError("not enough image data")
    return out[:3 * pixels].tobytes()


def sun_rle_decode(data: bytes, pos: int, want: int) -> bytes:
    out = np.zeros(max(want, 1), np.uint8)
    if _need().sun_rle_decode(data, len(data), pos, want, out.ctypes.data):
        raise ValueError("image file is truncated")
    return out[:want].tobytes()


def msp_rle_decode(data: bytes, width: int, height: int) -> bytes:
    """The joined rows, at most ``(width + 7) // 8 * height`` bytes of them
    (the raw decoder reads no more)."""
    cap = (width + 7) // 8 * height
    out = np.zeros(max(cap, 1), np.uint8)
    n = _need().msp_rle_decode(data, len(data), width, height, out.ctypes.data, cap)
    if n == -1:
        raise ValueError("truncated MSP file (row map or row)")
    if n == -2:
        raise ValueError("corrupted MSP file (a run cut short)")
    return out[:min(n, cap)].tobytes()


def lab_tetra_interp(lab: np.ndarray, table: np.ndarray, grid: int) -> np.ndarray:
    """(N, 3) uint8 Lab bytes (a and b offset) -> (N, 3) uint8 sRGB through
    the (grid^3 * 3,) int32 CLUT: ``utils/lcms.tetra_interp_python`` and
    Little CMS's ``FROM_16_TO_8``."""
    lab = np.ascontiguousarray(lab, np.uint8)
    table = np.ascontiguousarray(table, np.int32)
    if lab.ndim != 2 or lab.shape[1] != 3 or table.size != 3 * grid ** 3:
        raise ValueError(f"Lab {lab.shape}, CLUT {table.shape} at grid {grid}")
    out = np.zeros(lab.shape, np.uint8)
    _need().lab_tetra_interp(lab.ctypes.data, len(lab), table.ctypes.data, grid, out.ctypes.data)
    return out


def fli_decode(buf: bytes, width: int, height: int, img: np.ndarray) -> tuple:
    """libImaging's ``FliDecode`` on ``buf`` into ``img`` ((height, width)
    uint8, C-contiguous, written in place): (status, error), as
    ``utils/fli.frame_decode_python`` returns them."""
    if img.shape != (height, width) or img.dtype != np.uint8 or not img.flags.c_contiguous:
        raise ValueError(f"an FLI image buffer of {img.shape} {img.dtype}")
    error = ctypes.c_int(0)
    status = _need().fli_decode(buf, len(buf), width, height, img.ctypes.data,
                                ctypes.addressof(error))
    return int(status), error.value


def tile_bits_gather(raw: np.ndarray, across: int, tile_row_bytes: int, tile_width: int,
                     bits: int, width: int) -> np.ndarray:
    """``utils/tiff.tile_bits_gather_python``: sub-byte tiles side by side
    -> the image's rows of ``ceil(width * bits / 8)`` bytes."""
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.ndim != 2 or raw.shape[1] != across * tile_row_bytes or \
            tile_row_bytes * 8 < tile_width * bits:
        raise ValueError(f"sub-byte tiles {raw.shape}, {across} across of {tile_row_bytes} bytes")
    out = np.zeros((raw.shape[0], (width * bits + 7) // 8), np.uint8)
    _need().tile_bits_gather(raw.ctypes.data, raw.shape[0], across, tile_row_bytes, tile_width,
                             bits, width, out.ctypes.data)
    return out


def _declare_bcn(lib: ctypes.CDLL) -> None:
    lib.bcn_decode.restype = None
    lib.bcn_decode.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, ctypes.c_void_p]
    lib.blp_dxt_decode.restype = None
    lib.blp_dxt_decode.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_void_p]


def bcn_available() -> bool:
    """Whether ``src/bcn_decode.cpp`` builds and loads in this process."""
    return native.load_library(BCN_SRC, _declare_bcn) is not None


def bcn_decode(data: bytes, n: int, sign: bool, width: int, height: int) -> np.ndarray:
    """Pillow's ``bcn`` decoder ``n`` (1-7) over every block in ``data``:
    (H, W, 4) RGBA, or (H, W) for BC4."""
    lib = native.load_library(BCN_SRC, _declare_bcn)
    if lib is None:
        raise RuntimeError("the native BCn decoder is not available (no g++)")
    out = np.zeros((height, width, 1 if n == 4 else 4), np.uint8)
    lib.bcn_decode(data, n, int(sign), width, height, out.ctypes.data)
    return out[..., 0] if n == 4 else out


def blp_dxt_decode(data: bytes, fmt: str, width: int, height: int, alpha: bool) -> bytes:
    """BLP2's DXT1/3/5 blocks as ``BlpImagePlugin`` decodes them (see
    ``utils/blp.dxt_decode_python``)."""
    lib = native.load_library(BCN_SRC, _declare_bcn)
    if lib is None:
        raise RuntimeError("the native BCn decoder is not available (no g++)")
    bw, bh = (width + 3) // 4, (height + 3) // 4
    bands = 3 if fmt == "DXT1" and not alpha else 4
    out = np.zeros(bh * 4 * bw * 4 * bands, np.uint8)
    lib.blp_dxt_decode(data, int(fmt[-1]), int(alpha), width, height, out.ctypes.data)
    return out.tobytes()


WEBP_SRC = native._SRC_DIR / "webp_decode.cpp"


def _declare_webp(lib: ctypes.CDLL) -> None:
    lib.webp_decode_image.restype = ctypes.c_int
    lib.webp_decode_image.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
                                      ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]


def webp_available() -> bool:
    """Whether ``src/webp_decode.cpp`` builds and loads in this process."""
    return native.load_library(WEBP_SRC, _declare_webp) is not None


def webp_decode_image(payload: bytes, lossless: bool, alph, width: int,
                      height: int) -> np.ndarray:
    """One WebP image chunk's payload (``VP8L`` when ``lossless``, else
    ``VP8 `` with the ``ALPH`` payload ``alph`` or None) -> (H, W, 4) RGBA."""
    lib = native.load_library(WEBP_SRC, _declare_webp)
    if lib is None:
        raise RuntimeError("the native WebP decoder is not available (no g++)")
    out = np.zeros((height, width, 4), np.uint8)
    err = ctypes.create_string_buffer(256)
    if lib.webp_decode_image(payload, len(payload), int(lossless), alph or b"",
                             -1 if alph is None else len(alph), width, height, out.ctypes.data,
                             err, len(err)):
        raise ValueError(err.value.decode())
    return out


TIFF_SRC = native._SRC_DIR / "tiff_codecs.cpp"


def _declare_tiff(lib: ctypes.CDLL) -> None:
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    lib.fax_decode.restype = ctypes.c_int
    lib.fax_decode.argtypes = [ctypes.c_char_p, i64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               i64, i64, i64, ptr, ptr, i64, ctypes.POINTER(ctypes.c_int)]
    lib.zstd_decode.restype = ctypes.c_int
    lib.zstd_decode.argtypes = [ctypes.c_char_p, i64, i64, ptr, ctypes.c_char_p, i64]


def _tiff_lib():
    lib = native.load_library(TIFF_SRC, _declare_tiff)
    if lib is None:
        raise RuntimeError("the native TIFF codecs are not available (no g++)")
    return lib


def tiff_available() -> bool:
    """Whether ``src/tiff_codecs.cpp`` builds and loads in this process."""
    return native.load_library(TIFF_SRC, _declare_tiff) is not None


_FAX_ERRORS = {1: "premature end of CCITT data (libtiff fails the strip)",
               2: "CCITT Group 4 data ends before its first row (libtiff fails the strip)",
               3: "a run array overflow (libtiff fails the strip)"}


def fax_decode(data: bytes, parity: int, compression: int, width: int, rows: int,
               buf: np.ndarray, carry) -> None:
    """libtiff's CCITT decoder of one strip into ``buf`` ((rows, row bytes)
    uint8, C-contiguous), ``carry`` (``utils.tiff_codecs.FaxCarry``) the
    codec's state from strip to strip: ``utils/tiff_codecs.fax_decode_python``."""
    mode = ctypes.c_int(int(carry.no_eol))
    try:
        status = _tiff_lib().fax_decode(data, len(data), parity, compression, int(carry.two_d),
                                        width, rows, buf.shape[1], buf.ctypes.data,
                                        carry.runs.ctypes.data, carry.runs.shape[1] - 1,
                                        ctypes.byref(mode))
    finally:
        carry.no_eol = bool(mode.value)
    if status:
        raise ValueError(_FAX_ERRORS[status])


def zstd_decode(data: bytes, cap: int) -> bytes:
    """One Zstandard TIFF strip of ``cap`` bytes:
    ``utils/tiff_codecs.zstd_decode_python``."""
    out = np.zeros(max(cap, 1), np.uint8)
    err = ctypes.create_string_buffer(256)
    if _tiff_lib().zstd_decode(data, len(data), cap, out.ctypes.data, err, len(err)):
        raise ValueError(err.value.decode())
    return out[:cap].tobytes()


J2K_SRC = native._SRC_DIR / "j2k_decode.cpp"


def _declare_j2k(lib: ctypes.CDLL) -> None:
    i64, ptr, i32 = ctypes.c_int64, ctypes.c_void_p, ctypes.c_int
    lib.j2k_reconstruct_comp.restype = i32
    lib.j2k_reconstruct_comp.argtypes = [ctypes.c_char_p, ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
                                         i32, i32, i32, i32, ptr, ptr]
    lib.j2k_tier2.restype = i32
    lib.j2k_tier2.argtypes = [ctypes.c_char_p, i64, ctypes.c_char_p, i64, ptr, i32, ptr, i64,
                              ptr, ptr, i64, i64, ptr, ptr, ptr, ptr, ptr, ptr, i64, ptr,
                              ctypes.c_char_p, i32]
    lib.j2k_mct.restype = None
    lib.j2k_mct.argtypes = [ptr, ptr, ptr, i64, i32]
    lib.j2k_level_shift.restype = None
    lib.j2k_level_shift.argtypes = [ptr, i64, i32, i32, i32, ptr]


def _j2k_lib():
    lib = native.load_library(J2K_SRC, _declare_j2k)
    if lib is None:
        raise RuntimeError("the native JPEG 2000 decoder is not available (no g++)")
    return lib


def j2k_available() -> bool:
    """Whether ``src/j2k_decode.cpp`` builds and loads in this process."""
    return native.load_library(J2K_SRC, _declare_j2k) is not None


def j2k_reconstruct_comp(data: bytes, blocks: np.ndarray, lens: np.ndarray,
                         passes: np.ndarray, roishift: int, cblksty: int, w: int, h: int,
                         dims, reversible: bool) -> np.ndarray:
    """A tile-component's code-blocks decoded, dequantised and placed, then
    the inverse DWT over ``dims`` (each resolution's x0, y0, x1, y1):
    ``utils/j2k``'s plain path, sample for sample. ``blocks`` (N, 10)
    int64: x, y, w, h, band, numbps, segments, first segment, offset of the
    bytes in ``data`` and the step size's float32 bits; ``lens``/``passes``
    each segment's bytes and passes."""
    blocks = np.ascontiguousarray(blocks, np.int64).reshape(-1, 10)
    info = np.ascontiguousarray(blocks[:, :8], np.int32)
    offsets = np.ascontiguousarray(blocks[:, 8])
    steps = np.ascontiguousarray(blocks[:, 9].astype(np.uint32)).view(np.float32)
    lens = np.ascontiguousarray(lens, np.int32) if len(lens) else np.zeros(1, np.int32)
    passes = np.ascontiguousarray(passes, np.int32) if len(passes) else np.zeros(1, np.int32)
    if len(info) and (int((info[:, 6] + info[:, 7]).max()) > len(lens)
                      or int(offsets.max()) > len(data)):
        raise ValueError("code-block segments past their arrays")
    dims_a = np.ascontiguousarray(dims, np.int32)
    out = np.zeros((h, w), np.int32 if reversible else np.float32)
    status = _j2k_lib().j2k_reconstruct_comp(
        data, offsets.ctypes.data, info.ctypes.data, steps.ctypes.data, lens.ctypes.data,
        passes.ctypes.data, len(info), roishift, cblksty, int(reversible), w, h,
        len(dims_a), dims_a.ctypes.data, out.ctypes.data)
    if status:
        raise ValueError("opj_t1_decode_cblk(): unsupported bpno_plus_one >= 31")
    return out


def j2k_tier2(data: bytes, hdr, csty: int, packets: np.ndarray, pk_recs: np.ndarray,
              recs: np.ndarray, ncblk: int):
    """Every packet of a tile (``utils/j2k._read_packet`` in turn):
    ``packets`` (layer, first record, records) rows, ``pk_recs`` their band
    precincts, ``recs`` (cw, ch, first code-block, numbps, code-block style)
    rows; ``hdr`` None, or a dict of the PPM/PPT stream (``data``, ``pos``,
    which moves on). Returns per code-block (numbps, segments, first
    segment, offset of its bytes), each segment's bytes and passes, and the
    code-blocks' bytes joined."""
    packets = np.ascontiguousarray(packets, np.int32).reshape(-1, 3)
    pk_recs = np.ascontiguousarray(pk_recs, np.int32) if len(pk_recs) else np.zeros(1, np.int32)
    recs = np.ascontiguousarray(recs, np.int32).reshape(-1, 5)
    if len(recs) and int((recs[:, 2] + recs[:, 0] * recs[:, 1]).max()) > ncblk:
        raise ValueError("band precincts past the code-blocks")
    if len(packets) and int((packets[:, 1] + packets[:, 2]).max()) > len(pk_recs):
        raise ValueError("packets past their band precincts")
    numbps = np.zeros(max(ncblk, 1), np.int32)
    nsegs = np.zeros(max(ncblk, 1), np.int32)
    first = np.zeros(max(ncblk, 1), np.int64)
    offset = np.zeros(max(ncblk, 1), np.int64)
    hbuf = b"" if hdr is None else hdr["data"]
    hpos = ctypes.c_int64(0 if hdr is None else hdr["pos"])
    cap = 3 * (len(data) + len(hbuf) + 16)
    lens = np.zeros(cap, np.int32)
    passes = np.zeros(cap, np.int32)
    out = np.zeros(max(len(data), 1), np.uint8)
    err = ctypes.create_string_buffer(256)
    if _j2k_lib().j2k_tier2(data, len(data), hbuf if hdr is not None else None, len(hbuf),
                            ctypes.byref(hpos), csty, packets.ctypes.data, len(packets),
                            pk_recs.ctypes.data, recs.ctypes.data, len(recs), ncblk,
                            numbps.ctypes.data, nsegs.ctypes.data, first.ctypes.data,
                            offset.ctypes.data, lens.ctypes.data, passes.ctypes.data, cap,
                            out.ctypes.data, err, len(err)):
        raise ValueError(err.value.decode())
    if hdr is not None:
        hdr["pos"] = hpos.value
    return (np.stack([numbps[:ncblk], nsegs[:ncblk], first[:ncblk], offset[:ncblk]], 1), lens,
            passes, out.tobytes())


def j2k_mct(planes, reversible: bool) -> None:
    """The RCT or ICT in place on three C-contiguous planes."""
    dtype = np.int32 if reversible else np.float32
    for p in planes[:3]:
        assert p.dtype == dtype and p.flags.c_contiguous
    _j2k_lib().j2k_mct(planes[0].ctypes.data, planes[1].ctypes.data, planes[2].ctypes.data,
                       planes[0].size, int(reversible))


def j2k_level_shift(plane: np.ndarray, prec: int, sgnd: bool, reversible: bool) -> np.ndarray:
    plane = np.ascontiguousarray(plane, np.int32 if reversible else np.float32)
    out = np.zeros(plane.shape, np.int32)
    _j2k_lib().j2k_level_shift(plane.ctypes.data, plane.size, prec, int(sgnd), int(reversible),
                               out.ctypes.data)
    return out


AV1_SRC = native._SRC_DIR / "av1_decode.cpp"
AV1_INFO = ("width", "height", "mono_chrome", "subsampling_x", "subsampling_y",
            "matrix_coefficients", "color_range", "tiles", "use_128x128_superblock",
            "reduced_still_picture_header", "disable_cdf_update", "uniform_tile_spacing_flag",
            "base_q_idx", "q_context", "reduced_tx_set", "loop_filter_level_0",
            "loop_filter_level_1", "loop_filter_level_2", "loop_filter_level_3",
            "loop_filter_sharpness", "delta_q_present", "enable_cdef", "tx_mode_select",
            "cdef_bits", "cdef_damping", "restoration_type_0", "restoration_type_1",
            "restoration_type_2", "restoration_unit_size_0", "restoration_unit_size_1",
            "allow_screen_content_tools", "allow_intrabc", "separate_uv_delta_q",
            "using_qmatrix", "qm_y", "qm_u", "qm_v", "apply_grain", "num_y_points",
            "num_cb_points", "num_cr_points", "chroma_scaling_from_luma", "ar_coeff_lag",
            "grain_scale_shift", "overlap_flag", "clip_to_restricted_range")
# FrameRestorationType's values in AV1_INFO
RESTORE_NONE, RESTORE_WIENER, RESTORE_SGRPROJ, RESTORE_SWITCHABLE = 0, 1, 2, 3
# the transform sizes, in the order of the AV1 specification (and of the
# decoder's bit masks)
TX_NAMES = ("TX_4X4", "TX_8X8", "TX_16X16", "TX_32X32", "TX_64X64", "TX_4X8", "TX_8X4",
            "TX_8X16", "TX_16X8", "TX_16X32", "TX_32X16", "TX_32X64", "TX_64X32", "TX_4X16",
            "TX_16X4", "TX_8X32", "TX_32X8", "TX_16X64", "TX_64X16")
# what av1_decode reports the frame reached; qm_levels_<plane>_<size> is the
# bit mask of the quantizer matrix levels that weighted a coded transform
# block of that plane and size, grain_planes the bit mask of the planes film
# grain was applied to, grain_subsampling_* the subsampling it ran at (-1:
# none)
AV1_STATS = ("tx_sizes", "tx_types", "delta_q_max", "deblocked_edges", "cdef_blocks",
             "wiener_units_0", "wiener_units_1", "wiener_units_2", "sgrproj_units_0",
             "sgrproj_units_1", "sgrproj_units_2", "palette_y_blocks", "palette_uv_blocks",
             "palette_y_sizes", "palette_uv_sizes", "intrabc_blocks", "intrabc_chroma_blocks",
             "intrabc_half_sample", "vartx_splits") + tuple(
                 f"qm_levels_{p}_{t}" for p in range(3) for t in TX_NAMES) + (
             "qm_unweighted_blocks", "grain_planes", "grain_subsampling_x",
             "grain_subsampling_y")


def _declare_av1(lib: ctypes.CDLL) -> None:
    i32, i64, ptr = ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p
    lib.av1_probe.restype = ctypes.c_int
    lib.av1_probe.argtypes = [ctypes.c_char_p, i64, ptr]
    lib.av1_decode.restype = ctypes.c_int
    lib.av1_decode.argtypes = [ctypes.c_char_p, i64, ptr, ptr, ptr, ptr, i32, ptr]
    lib.yuv_to_rgb.restype = None
    lib.yuv_to_rgb.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, ptr, ptr]


def av1_library() -> ctypes.CDLL:
    """``src/av1_decode.cpp`` built and loaded; ``native.BuildError`` (the
    source's name and g++'s stderr) where it does not build."""
    return native.require_library(AV1_SRC, _declare_av1)


def av1_probe(payload: bytes) -> tuple:
    """(status, {AV1_INFO name: value}) of an AV1 item's first frame: status 0,
    or ``src/av1_decode.cpp``'s refusal or fault code (negative)."""
    lib = av1_library()
    info = np.zeros(len(AV1_INFO), np.int32)
    status = lib.av1_probe(payload, len(payload), info.ctypes.data)
    return int(status), dict(zip(AV1_INFO, info.tolist()))


def av1_decode(payload: bytes, info: dict) -> tuple:
    """(status, [Y, U, V] uint8 planes cropped to the frame (one for
    monochrome), the per-tile exit-process padding checks, {AV1_STATS name:
    value}) of the first frame ``av1_probe`` described."""
    lib = av1_library()
    w, h = info["width"], info["height"]
    sx, sy = info["subsampling_x"], info["subsampling_y"]
    planes = [np.zeros((h, w), np.uint8)]
    chroma = ((h + sy) >> sy, (w + sx) >> sx)
    planes += [np.zeros(chroma, np.uint8), np.zeros(chroma, np.uint8)]
    padding = np.zeros(max(info["tiles"], 1), np.int32)
    stats = np.zeros(len(AV1_STATS), np.int32)
    status = lib.av1_decode(payload, len(payload), planes[0].ctypes.data, planes[1].ctypes.data,
                            planes[2].ctypes.data, padding.ctypes.data, len(padding),
                            stats.ctypes.data)
    return (int(status), planes[:1 if info["mono_chrome"] else 3], padding.astype(bool),
            dict(zip(AV1_STATS, stats.tolist())))


def yuv_to_rgb(planes: list, sx: int, sy: int, constants: tuple) -> np.ndarray:
    """libyuv's conversion of 8-bit Y, U, V planes with ``constants`` (YG,
    YB, UB, UG, VG, VR): (H, W, 3) uint8; ``utils/avif.yuv_to_rgb_plain``."""
    lib = av1_library()
    y, u, v = (np.ascontiguousarray(p, np.uint8) for p in planes)
    h, w = y.shape
    if u.shape != ((h + sy) >> sy, (w + sx) >> sx) or v.shape != u.shape:
        raise ValueError(f"planes {y.shape}, {u.shape}, {v.shape} at subsampling ({sx}, {sy})")
    k = np.asarray(constants, np.int32)
    out = np.empty((h, w, 3), np.uint8)
    lib.yuv_to_rgb(y.ctypes.data, u.ctypes.data, v.ctypes.data, w, h, sx, sy, k.ctypes.data,
                   out.ctypes.data)
    return out
