"""Step videos: the GIF encoder, the frames, and ``--save_step_video``.

The port's numpy GIF89a encoder is decoded by PIL (an independent decoder,
here on the CPU host) and by ``chip_smoke.py``'s numpy decoder: the frames
equal the palette-quantised frames exactly, with a 256-entry global
palette, ``loop=0`` and PIL's delay for ``fps=8``. ``compose_step_frames``
equals ``coma_tpu``'s on the same per-step outputs, decoded by one numpy
function on both sides (so the comparison is of the composition: clip,
scale, nearest upsampling, side by side, uint8). The CLI writes one
``.steps.gif`` per batch with ⌈50/3⌉ = 17 frames of the composed size.
"""
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from coma_tpu.visualization import video as j_video
from coma_tpu_torch.utils import gif
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


@pytest.mark.parametrize("kind", ["few_colours", "many_colours"])
def test_gif_decodes_to_the_quantised_frames(kind):
    rng = np.random.default_rng(41)
    if kind == "few_colours":      # at most 256 colours: the palette is exact
        frames = (rng.integers(0, 5, size=(4, 24, 40, 3)) * 60).astype(np.uint8)
    else:
        yy, xx = np.mgrid[:48, :80] / 48
        base = np.stack([yy * 200, xx * 120, 80 + 40 * np.sin(6 * xx)], -1)
        frames = np.uint8(np.clip(base[None] + rng.normal(0, 20, size=(5, 48, 80, 3)), 0, 255))
    data = gif.encode_gif(frames, fps=8)
    palette, indices = gif.quantize(frames)
    want = palette[indices]
    if kind == "few_colours":
        np.testing.assert_array_equal(want, frames)
    else:
        assert np.abs(want.astype(int) - frames).mean() < 8
    got, durations, loop = pil_frames(data)
    np.testing.assert_array_equal(got, want)
    assert durations == [120] * len(frames) and loop == 0    # PIL's int(125 / 10) cs
    dec, delays, loop = chip_smoke.decode_gif(data)
    np.testing.assert_array_equal(dec, want)
    assert delays == [12] * len(frames) and loop == 0


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
    palette, indices = gif.quantize(composed[0])
    np.testing.assert_array_equal(frames, palette[indices])
