"""Step videos: the GIF writer, the frames, and ``--save_step_video``.

The port's GIF writer (``utils/gif.py``) is held against ``coma_tpu``'s PIL
call (``visualization/video.py:write_gif``): Pillow decodes both files to
the same frames (each frame quantised on its own by libImaging's median
cut, a frame equal to the one before merged into it), durations and loop,
and the port's reader (``utils/gif_reader.py``, which ``chip_smoke.py``'s
``decode_gif`` uses) decodes the port's file to the same frames.
``compose_step_frames`` equals ``coma_tpu``'s on the same per-step outputs,
decoded by one numpy function on both sides (so the comparison is of the
composition: clip, scale, nearest upsampling, side by side, uint8). The CLI
writes one ``.steps.gif`` per batch with ⌈50/3⌉ = 17 frames of the
composed size.
"""
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from coma_tpu.visualization import video as j_video
from coma_tpu_torch.utils import gif, gif_reader
from coma_tpu_torch.visualization import video as t_video


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def pil_frames(data: bytes):
    im = Image.open(io.BytesIO(data))
    frames, durations = [], []
    for i in range(im.n_frames):
        im.seek(i)
        frames.append(np.asarray(im.convert("RGB")))
        durations.append(im.info.get("duration"))
    return np.stack(frames), durations, im.info.get("loop")


def coma_tpu_gif(frames: np.ndarray, tmp_path, fps: int = 8) -> bytes:
    path = tmp_path / "coma_tpu.gif"
    j_video.write_gif(frames, str(path), fps=fps)
    return path.read_bytes()


@pytest.mark.parametrize("kind", ["few_colours", "many_colours"])
def test_gif_decodes_to_the_quantised_frames(kind, tmp_path):
    """Pillow decodes the port's GIF to the frames it decodes from
    ``coma_tpu``'s; at most 256 colours they are the frames themselves; the
    port's reader agrees."""
    rng = np.random.default_rng(41)
    if kind == "few_colours":      # at most 256 colours: the palette is exact
        frames = (rng.integers(0, 5, size=(4, 24, 40, 3)) * 60).astype(np.uint8)
    else:
        yy, xx = np.mgrid[:48, :80] / 48
        base = np.stack([yy * 200, xx * 120, 80 + 40 * np.sin(6 * xx)], -1)
        frames = np.uint8(np.clip(base[None] + rng.normal(0, 20, size=(5, 48, 80, 3)), 0, 255))
    data = gif.encode_gif(frames, fps=8)
    want, want_durations, want_loop = pil_frames(coma_tpu_gif(frames, tmp_path))
    if kind == "few_colours":
        np.testing.assert_array_equal(want, frames)
    else:
        assert np.abs(want.astype(int) - frames).mean() < 8
    got, durations, loop = pil_frames(data)
    np.testing.assert_array_equal(got, want)
    assert durations == want_durations == [120] * len(frames)    # PIL's int(125 / 10) cs
    assert loop == want_loop == 0
    dec, delays, loop = chip_smoke.decode_gif(data)
    np.testing.assert_array_equal(dec, want)
    assert delays == [12] * len(frames) and loop == 0


def test_step_video_gif_equals_coma_tpus(tmp_path):
    """The frames that showed the fault (three 64 x 64 many-colour frames:
    a global 5-bit median cut differed from PIL's at every pixel, by up to
    27 levels), repeated frames (PIL merges them, adding durations) and a
    frame of more than 65536 colours (libImaging's hash then drops bits)."""
    rng = np.random.default_rng(42)
    yy, xx = np.mgrid[:64, :64] / 64
    base = np.stack([yy * 200, xx * 120, 80 + 40 * np.sin(6 * xx)], -1)
    cases = {"three_64": np.uint8(np.clip(base[None] + rng.normal(0, 20, (3, 64, 64, 3)), 0, 255)),
             "repeated": np.repeat(rng.integers(0, 256, (2, 1, 20, 30, 3)), [3, 2], 0)[:, 0]
             .astype(np.uint8),
             "scaled_hash": rng.integers(0, 256, (2, 300, 260, 3)).astype(np.uint8)}
    for name, frames in cases.items():
        want = pil_frames(coma_tpu_gif(frames, tmp_path))
        got = pil_frames(gif.encode_gif(frames))
        np.testing.assert_array_equal(got[0], want[0], err_msg=name)
        assert got[1:] == want[1:], name
        mine = gif_reader.decode_gif_frames(gif.encode_gif(frames))
        np.testing.assert_array_equal(mine[0], want[0])
        assert mine[1:] == want[1:]
    assert pil_frames(gif.encode_gif(cases["repeated"]))[1] == [370, 250]


def test_seeded_step_video_equals_the_manifest_hash():
    """``chip_smoke.py`` phase 16d's check, on this host: the seeded step
    video written by the port and read by the port's reader, against
    Pillow's decoding of ``coma_tpu``'s file (the manifest's hash)."""
    import json
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(root, "tools"))
    from make_image_fixtures import array_sha, step_video_frames

    with open(os.path.join(root, "tests", "data", "images", "manifest.json")) as fh:
        entry = json.load(fh)["step_video"]
    frames = step_video_frames(*(entry[k] for k in ("frames", "height", "width", "seed")))
    decoded, durations, loop = gif_reader.decode_gif_frames(gif.encode_gif(frames))
    assert list(decoded.shape) == entry["decoded_shape"]
    assert array_sha(decoded) == entry["sha256"]
    assert durations == entry["durations"] and loop == entry["loop"]


def test_lzw_fills_and_clears_the_table():
    """A long, varied stream outgrows the 4096-entry table several times."""
    idx = np.random.default_rng(42).integers(0, 256, size=(1, 300, 200)).astype(np.uint8)
    palette = np.stack([np.arange(256)] * 3, 1).astype(np.uint8)
    frames = palette[idx]
    got, _, _ = pil_frames(gif.encode_gif(frames))
    np.testing.assert_array_equal(got, frames)


def fake_decode(latents: np.ndarray) -> np.ndarray:
    """(N, 4, h, w) -> (N, 3, 8h, 8w) in about [-1, 1], float32 numpy."""
    x = np.tanh(latents[:, :3] * np.float32(0.7))
    return np.repeat(np.repeat(x, 8, axis=2), 8, axis=3).astype(np.float32)


def test_compose_step_frames_matches_coma_tpu():
    rng = np.random.default_rng(43)
    S, B, h = 7, 2, 6
    pred_x0 = np.float32(rng.normal(size=(S, B, 4, h, h)) * 0.5)
    mask_lat = np.float32(rng.uniform(size=(S, B, 1, h, h)) > 0.5)
    j_inter = {"pred_x0": jnp.asarray(pred_x0.transpose(0, 1, 3, 4, 2)),
               "mask_lat": jnp.asarray(mask_lat.transpose(0, 1, 3, 4, 2))}
    j_dec = lambda lat: jnp.asarray(fake_decode(np.asarray(lat).transpose(0, 3, 1, 2))
                                    .transpose(0, 2, 3, 1))
    t_dec = lambda lat: torch.from_numpy(fake_decode(lat.numpy()))
    t_inter = {"pred_x0": torch.from_numpy(pred_x0), "mask_lat": torch.from_numpy(mask_lat)}
    for sample, every in ((0, 1), (1, 3)):
        want = j_video.compose_step_frames(j_inter, j_dec, sample=sample, every=every)
        got = t_video.compose_step_frames(t_inter, t_dec, sample=sample, every=every)
        assert got.shape == want.shape == (len(range(0, S, every)), 48, 96, 3)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_cli_writes_the_step_video(tmp_path, monkeypatch):
    from coma_tpu_torch.cli import inpaint as t_cli
    from tests.test_torch_inpaint import make_tree

    composed, compose = [], t_video.compose_step_frames

    def recorded(*args, **kwargs):
        composed.append(compose(*args, **kwargs))
        return composed[-1]

    monkeypatch.setattr(t_video, "compose_step_frames", recorded)
    make_tree(tmp_path)
    monkeypatch.chdir(tmp_path)
    t_cli.main(["--device", "cpu", "--random_weights", "--tiny", "--num_img_per_combination",
                "2", "--batch_size", "4", "--save_step_video"])
    gifs = sorted((tmp_path / "results" / "generation" / "inpaintings").rglob("*.steps.gif"))
    pngs = sorted((tmp_path / "results" / "generation" / "inpaintings").rglob("*.png"))
    assert len(gifs) == 1 and len(pngs) == 4 and len(composed) == 1
    assert gifs[0].name == "00000.steps.gif"
    frames, durations, loop = pil_frames(gifs[0].read_bytes())
    assert frames.shape == (17, 64, 128, 3) == composed[0].shape and loop == 0
    want, want_durations, _ = pil_frames(coma_tpu_gif(composed[0], tmp_path))
    np.testing.assert_array_equal(frames, want)
    assert durations == want_durations
