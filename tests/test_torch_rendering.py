"""Stage 1's object renders, the port against ``coma_tpu`` (and PIL and
OpenCV, which ``coma_tpu`` calls) on the CPU.

Same seeded numpy inputs on both sides; tolerances:

- PNG reading (palette, 16-bit, low-bit gray) and the bilinear resize:
  equal to PIL;
- the textured OBJ loader: every mesh field equal, texture layers within
  1/255 of PIL's decode and resize;
- ``rasterize_attributes`` at 64²: coverage, material and winner equal (a
  scene of exactly tied depths included), zbuf, UVs, normals and aux within
  1e-5, through both routes;
- ``render_textured``, one case per option: RGB within 1e-4 on at least
  99.9% of pixels and within 0.15 everywhere (a shadow-map tap whose
  ``round`` flips between XLA's and PyTorch's light-frame products moves a
  pixel by a PCF step; the count beyond 1e-4 is printed); the all-features
  sphere within 2.5/255 of ``tests/golden/photoreal_sphere.npz``;
- candidate masks: equal to ``cv2.fillConvexPoly`` of ``cv2.convexHull``
  (2,000 seeded quads in [-20, 84]² on a 64² canvas, and degenerate hulls)
  and to ``coma_tpu``'s grids; valid-mask ids and camera pickles equal.
"""
import os
import pickle
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from coma_tpu.geometry.mesh import load_obj_textured as j_load_obj_textured
from coma_tpu.lifting import rasterizer as JR
from coma_tpu.pipelines import canonicalize_assets as j_canon
from coma_tpu.pipelines import mask_select as j_select
from coma_tpu.pipelines import rendering as JP
from coma_tpu_torch.geometry import mesh as t_mesh
from coma_tpu_torch.geometry import polygon
from coma_tpu_torch.lifting import rasterizer as TR
from coma_tpu_torch.pipelines import canonicalize_assets as t_canon
from coma_tpu_torch.pipelines import mask_select as t_select
from coma_tpu_torch.pipelines import rendering as TP
from coma_tpu_torch.utils.png import read_png, to_gray, to_rgb
from coma_tpu_torch.utils.resize import resize_bilinear
from tests.test_geometry import CUBE_F, CUBE_V
from tests.test_textured_rendering import _sphere_scene

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "photoreal_sphere.npz")


def t(x):
    return torch.as_tensor(np.asarray(x))


# ------------------------------------------------------------------ images

def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _png_bytes(rows, W, H, depth, ctype, extra=b"", interlace=0):
    """A PNG of unfiltered rows, written by hand: PIL writes neither 16-bit
    colour nor low-bit palettes on request."""
    raw = b"".join(b"\x00" + r for r in rows)
    ihdr = struct.pack(">IIBBBBB", W, H, depth, ctype, 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr) + extra
            + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))


def _packed_rows(idx, depth):
    rows = []
    for row in idx:
        bits = "".join(format(int(v), f"0{depth}b") for v in row)
        bits += "0" * (-len(bits) % 8)
        rows.append(bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8)))
    return rows


def _png_cases():
    rng = np.random.default_rng(0)
    W, H = 7, 5
    cases = []
    for ctype, C in ((0, 1), (2, 3), (4, 2), (6, 4)):
        a = rng.integers(0, 65536, size=(H, W, C)).astype(">u2")
        a[0, 0] = 100                                 # a 16-bit gray value below 256
        cases.append((f"16bit-type{ctype}", _png_bytes([r.tobytes() for r in a], W, H, 16, ctype)))
    palette = rng.integers(0, 256, size=(256, 3)).astype(np.uint8)
    for depth in (1, 2, 4, 8):
        idx = rng.integers(0, 2 ** depth, size=(H, W))
        extra = _chunk(b"PLTE", palette[: 2 ** depth].tobytes()) + _chunk(b"tRNS", b"\x00")
        cases.append((f"palette{depth}", _png_bytes(_packed_rows(idx, depth), W, H, depth, 3,
                                                    extra)))
        if depth < 8:
            cases.append((f"gray{depth}", _png_bytes(_packed_rows(idx, depth), W, H, depth, 0)))
    return cases


@pytest.mark.parametrize("name,data", _png_cases(), ids=[c[0] for c in _png_cases()])
def test_png_reader_matches_pil(tmp_path, name, data):
    path = str(tmp_path / f"{name}.png")
    with open(path, "wb") as fh:
        fh.write(data)
    got = read_png(path)
    with Image.open(path) as im:
        np.testing.assert_array_equal(to_rgb(got), np.asarray(im.convert("RGB")))
        np.testing.assert_array_equal(to_gray(got), np.asarray(im.convert("L")))


def test_png_reader_refuses_interlaced(tmp_path):
    path = str(tmp_path / "interlaced.png")
    with open(path, "wb") as fh:
        fh.write(_png_bytes([b"\x00"], 1, 1, 8, 0, interlace=1))
    with pytest.raises(ValueError, match="interlaced.png"):
        read_png(path)


@pytest.mark.parametrize("h,w,size", [(8, 8, 256), (300, 517, 256), (1024, 700, 256),
                                      (3, 5, 7), (256, 256, 256), (100, 1000, 64)])
def test_resize_matches_pil_bilinear(h, w, size):
    a = np.random.default_rng(h * w).integers(0, 256, size=(h, w, 3)).astype(np.uint8)
    want = np.asarray(Image.fromarray(a).resize((size, size), Image.BILINEAR))
    np.testing.assert_array_equal(resize_bilinear(a, (size, size)), want)


# ------------------------------------------------------------------ loader

def write_textured_asset(root, n=3, seed=0):
    """A box of ``n`` x ``n`` quads per side in three materials: a textured
    one (an RGB PNG of 37 x 53), a palette-PNG one, a Kd-only one, some
    faces without UVs, negative indices, a tab-separated ``usemtl``; plus a
    16-bit texture and a missing one. Returns the OBJ's path."""
    rng = np.random.default_rng(seed)
    Image.fromarray((rng.uniform(size=(37, 53, 3)) * 255).astype(np.uint8)).save(
        os.path.join(root, "wood.png"))
    Image.fromarray(rng.integers(0, 256, size=(20, 24)).astype(np.uint8), "L").convert(
        "P", palette=Image.ADAPTIVE, colors=16).save(os.path.join(root, "pal.png"))
    with open(os.path.join(root, "deep.png"), "wb") as fh:
        a = rng.integers(0, 65536, size=(9, 11, 3)).astype(">u2")
        fh.write(_png_bytes([r.tobytes() for r in a], 11, 9, 16, 2))
    with open(os.path.join(root, "m.mtl"), "w") as fh:
        fh.write("newmtl wood\nKd 0.5 0.4 0.3\nmap_Kd wood.png\n"
                 "newmtl pal\nKd 0.2 0.2 0.9\nmap_Kd pal.png\n"
                 "newmtl deep\nmap_Kd deep.png\n"
                 "newmtl lost\nKd 0.3 0.6 0.3\nmap_Kd nowhere.png\n"
                 "newmtl red\nKd 0.8 0.1 0.1\n")
    lines = ["mtllib m.mtl"]
    verts, quads = [], []
    g = np.linspace(-0.3, 0.3, n + 1)
    for axis in range(3):
        for sign in (-0.3, 0.3):
            base = len(verts)
            for a in g:
                for b in g:
                    p = [0.0, 0.0, 0.0]
                    p[axis] = sign
                    p[(axis + 1) % 3], p[(axis + 2) % 3] = a, b
                    verts.append([p[0], p[1] + 0.4, p[2]])
            for i in range(n):
                for j in range(n):
                    k = base + i * (n + 1) + j
                    quads.append((k, k + 1, k + n + 2, k + n + 1))
    lines += [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in verts]
    lines += [f"vt {u:.4f} {v:.4f}" for u, v in rng.uniform(-0.5, 1.5, size=(len(verts), 2))]
    mats = [None, "wood", "pal", "deep", "lost", "red"]   # None: before any usemtl
    for q_idx, q in enumerate(quads):
        mat = mats[q_idx * len(mats) // len(quads)]
        if mat is not None and (q_idx == 0 or mats[(q_idx - 1) * len(mats) // len(quads)] != mat):
            lines.append(("usemtl\t" if mat == "red" else "usemtl ") + mat)
        if mat == "red":
            lines.append("f " + " ".join(str(i + 1) for i in q))            # no UVs
        elif q_idx % 7 == 3:
            lines.append("f " + " ".join(f"{i - len(verts)}/{i - len(verts)}" for i in q))
        else:
            lines.append("f " + " ".join(f"{i + 1}/{i + 1}" for i in q))
    path = os.path.join(root, "asset.obj")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return path


def test_load_obj_textured_matches(tmp_path, capsys):
    path = write_textured_asset(str(tmp_path))
    want, got = j_load_obj_textured(path), t_mesh.load_obj_textured(path)
    for field in ("vertices", "faces", "uvs", "face_uvs", "face_material"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
        assert getattr(got, field).dtype == getattr(want, field).dtype
    assert got.textures.shape == want.textures.shape and got.textures.dtype == np.float32
    np.testing.assert_allclose(got.textures, want.textures, atol=1 / 255, rtol=0)
    assert (got.face_uvs == -1).any() and (got.face_material == 0).any()
    assert "WARNING" not in capsys.readouterr().out


def test_load_obj_textured_keeps_kd_for_a_jpeg(tmp_path, capsys):
    """``coma_tpu`` decodes a JPEG ``map_Kd`` through PIL; the port keeps
    the material's Kd layer and names the file (a logged divergence)."""
    Image.fromarray(np.full((8, 8, 3), 200, np.uint8)).save(str(tmp_path / "t.jpg"))
    (tmp_path / "m.mtl").write_text("newmtl j\nKd 0.1 0.9 0.2\nmap_Kd t.jpg\n")
    (tmp_path / "a.obj").write_text("mtllib m.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0 0\n"
                                    "usemtl j\nf 1/1 2/1 3/1\n")
    got = t_mesh.load_obj_textured(str(tmp_path / "a.obj"), tex_size=4)
    np.testing.assert_allclose(got.textures[1], np.broadcast_to([0.1, 0.9, 0.2], (4, 4, 3)),
                               atol=1e-7)
    assert "t.jpg" in capsys.readouterr().out


# -------------------------------------------------------------- rasterizer

def _soup(seed, n=40, res=64):
    rng = np.random.default_rng(seed)
    centre = rng.uniform(-8, res + 8, size=(n, 1, 2))
    size = np.where(rng.uniform(size=(n, 1, 1)) < 0.7, 4.0, 30.0)
    xy = centre + rng.normal(size=(n, 3, 2)) * size
    z = rng.uniform(1, 5, size=(n, 1, 1)) + rng.normal(size=(n, 3, 1)) * 0.3
    tri = np.concatenate([xy, z], axis=-1).astype(np.float32)
    # exact ties: a coplanar copy of each of the first 8 triangles (constant
    # depth) behind a later index, and one triangle repeated
    tri[:8, :, 2] = 2.0
    tri = np.concatenate([tri, tri[:8], tri[3:4]], axis=0)
    T = len(tri)
    return dict(tri_px=tri, tri_uv=rng.uniform(-1, 2, size=(T, 3, 2)).astype(np.float32),
                tri_mat=np.arange(T, dtype=np.int32),
                tri_n=rng.normal(size=(T, 3)).astype(np.float32),
                tri_aux=rng.normal(size=(T, 3, 3)).astype(np.float32))


@pytest.mark.parametrize("window", [16, 4, 0])
@pytest.mark.parametrize("seed,flip_y", [(0, True), (1, False)])
def test_rasterize_attributes_matches(seed, flip_y, window):
    """``tri_mat`` is the triangle index, so the material image is the
    winner: on the tied copies the lower index must win."""
    s = _soup(seed)
    want = JR.rasterize_attributes(*(jnp.asarray(s[k]) for k in ("tri_px", "tri_uv", "tri_mat",
                                                                  "tri_n")),
                                   64, 64, flip_y=flip_y, tri_aux=jnp.asarray(s["tri_aux"]))
    got = TR.rasterize_attributes(*(t(s[k]) for k in ("tri_px", "tri_uv", "tri_mat", "tri_n")),
                                  64, 64, flip_y=flip_y, tri_aux=t(s["tri_aux"]), window=window)
    want = [np.asarray(a) for a in want]
    got = [a.numpy() for a in got]
    cov = np.isfinite(want[0])
    np.testing.assert_array_equal(np.isfinite(got[0]), cov)
    np.testing.assert_array_equal(got[2], want[2])
    assert got[2].dtype == want[2].dtype
    assert np.isin(np.arange(8), got[2]).any() and not np.isin(np.arange(40, 48), got[2]).any()
    np.testing.assert_allclose(got[0][cov], want[0][cov], rtol=0, atol=1e-5)
    for a, b in zip(got[1:], want[1:]):
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def _sphere_inputs(s, shadows):
    j = dict(tri_px=s["tri_px"], tri_uv=s["tri_uv"], tri_mat=s["tri_mat"], tri_n=s["tri_n"],
             textures=s["tex"])
    if shadows:
        j.update(tri_w=s["tri_w"], shadow_casters=s["casters"])
    return j


RENDER_CASES = {
    "flat": dict(),
    "shadow": dict(shadows=True),
    "ao": dict(shadows=True, ao_samples=8),
    "soft_light": dict(shadows=True, light_samples=4, light_cone_deg=8.0),
    "specular": dict(specular=0.5, roughness=0.35),
    "sky_env": dict(env=True),
    "tonemap": dict(tonemap=True),
    "rsm_gi": dict(shadows=True, gi_samples=8),
}


def _render_both(case):
    s = _sphere_scene()
    kw = dict(case)
    inputs = _sphere_inputs(s, kw.pop("shadows", False))
    jkw, tkw = dict(kw), dict(kw)
    if jkw.pop("env", False):
        tkw.pop("env")
        jkw["env_map"], tkw["env_map"] = JR.make_sky_env(), TR.make_sky_env(device="cpu")
    common = dict(flip_y=False, light_dir=(0.4, 0.0, 1.0), ambient=0.3)
    want, wcov = JR.render_textured(**{k: jnp.asarray(v) for k, v in inputs.items()},
                                    height=s["res"], width=s["res"], **common, **jkw)
    got, gcov = TR.render_textured(**{k: t(v) for k, v in inputs.items()},
                                   height=s["res"], width=s["res"], **common, **tkw)
    return np.asarray(want), np.asarray(wcov), got.numpy(), gcov.numpy()


@pytest.mark.parametrize("name", list(RENDER_CASES))
def test_render_textured_matches(name):
    want, wcov, got, gcov = _render_both(RENDER_CASES[name])
    np.testing.assert_array_equal(gcov, wcov)
    diff = np.abs(got - want)
    beyond = int((diff > 1e-4).sum())
    print(f"{name}: {beyond} of {diff.size} values beyond 1e-4, max {diff.max():.3e}")
    assert beyond <= 1e-3 * diff.size
    assert diff.max() <= 0.15


def test_render_textured_golden_sphere():
    """The all-features sphere (shadows, AO, soft light, GGX, sky, ACES) of
    ``tests/test_textured_rendering.py``, against the committed golden."""
    s = _sphere_scene()
    inputs = {k: t(v) for k, v in _sphere_inputs(s, True).items()}
    rgb, _ = TR.render_textured(**inputs, height=s["res"], width=s["res"], flip_y=False,
                                light_dir=(0.4, 0.0, 1.0), ambient=0.3, ao_samples=8,
                                light_samples=8, light_cone_deg=8.0, specular=0.5,
                                roughness=0.35, env_map=TR.make_sky_env(device="cpu"),
                                tonemap=True)
    want = np.load(GOLDEN)["rgb"].astype(np.float32) / 255.0
    np.testing.assert_allclose(rgb.numpy(), want, atol=2.5 / 255.0, rtol=0)


def test_sky_env_and_hemisphere_dirs_match():
    np.testing.assert_allclose(TR.make_sky_env(device="cpu").numpy(),
                               np.asarray(JR.make_sky_env()), atol=1e-6)
    np.testing.assert_allclose(TR.cosine_hemisphere_dirs(8, device="cpu").numpy(),
                               np.asarray(JR.cosine_hemisphere_dirs(8)), atol=1e-6)
    d = np.random.default_rng(3).normal(size=(50, 3)).astype(np.float32)
    np.testing.assert_allclose(TR.sample_env(TR.make_sky_env(device="cpu"), t(d)).numpy(),
                               np.asarray(JR.sample_env(JR.make_sky_env(), jnp.asarray(d))),
                               atol=1e-6)


# ----------------------------------------------------------- mask grids

def _cv2_fill(quad, h, w):
    import cv2

    mask = np.zeros((h, w), np.uint8)
    cv2.fillConvexPoly(mask, cv2.convexHull(np.int32(quad)), 255)
    return mask


DEGENERATE = [
    [[5, 5]] * 4,                                   # one point
    [[0, 0], [0, 0], [3, 3], [6, 6]],               # collinear: two
    [[0, 0], [5, 5], [10, 10], [3, 3]],
    [[-5, 3], [70, 3], [70, 3], [-5, 3]],           # horizontal, clipped
    [[10, -3], [10, 80], [10, 80], [10, -3]],       # vertical, clipped
    [[0, 0], [5, 0], [10, 0], [5, 5]],              # collinear point on the hull
    [[-10, -10], [-10, -10], [-5, -5], [-1, -1]],   # off the canvas
    [[63, 63], [64, 64], [63, 64], [70, 70]],
    [[-100, 30], [200, 31], [201, 33], [-99, 32]],  # clipped on both sides
]


def test_polygon_fill_matches_opencv():
    rng = np.random.default_rng(0)
    quads = np.concatenate([rng.integers(-20, 85, size=(2000, 4, 2)), np.int64(DEGENERATE)])
    got = polygon.fill_convex_hulls(quads, 64, 64, "cpu").numpy()
    bad = [i for i, q in enumerate(quads) if not np.array_equal(got[i], _cv2_fill(q, 64, 64))]
    assert not bad, (len(bad), quads[bad[0]].tolist())
    rect = rng.integers(-30, 120, size=(200, 4, 2))
    got = polygon.fill_convex_hulls(rect, 48, 96, "cpu").numpy()
    assert all(np.array_equal(g, _cv2_fill(q, 48, 96)) for q, g in zip(rect, got))


def test_convex_hull_matches_opencv_as_a_cycle():
    import cv2

    rng = np.random.default_rng(1)
    for q in list(rng.integers(-5, 6, size=(300, 4, 2))) + [np.int64(d) for d in DEGENERATE]:
        want = cv2.convexHull(np.int32(q)).reshape(-1, 2).tolist()
        got = polygon.convex_hull(q).tolist()
        assert len(got) == len(want)
        k = got.index(want[0])
        assert got[k:] + got[:k] == want


def _camera_pair(view_num=4, resolution=(64, 64), **kw):
    j = JP.build_camera_ring(1.0, ortho_scale_world=4.0, view_num=view_num,
                             resolution=resolution, **kw)
    p = TP.build_camera_ring(1.0, ortho_scale_world=4.0, view_num=view_num,
                             resolution=resolution, device="cpu", **kw)
    return j, p


@pytest.mark.parametrize("view", [0, 1, 3])
def test_candidate_mask_grid_matches(view):
    jc, tc = _camera_pair(elevation_deg=15.0, z_scale=0.8)
    bounds = (np.array([-0.4, -0.3, 0.0]), np.array([0.5, 0.35, 0.9]))
    kw = dict(bbox_size=(0.6, 0.6, 1.1), stride_x=0.1, stride_y=0.1,
              azimuth_z=np.pi / 2 + 2 * np.pi / 4 * view)
    want = JP.candidate_mask_grid(jc[view], bounds, **kw)
    got = TP.candidate_mask_grid(tc[view], bounds, **kw)
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_select_valid_masks_and_pickle_match(tmp_path):
    rng = np.random.default_rng(5)
    seg = np.zeros((32, 32), np.uint8)
    seg[8:24, 6:20] = 255
    masks = (rng.uniform(size=(40, 32, 32)) < rng.uniform(0.2, 1.0, size=(40, 1, 1))) * 255
    masks = masks.astype(np.uint8)
    masks[0] = 255
    masks[1] = 0
    want = j_select.select_valid_masks(seg, list(masks), 0.5, 0.9)
    got = t_select.select_valid_masks(t(seg), t(masks), 0.5, 0.9)
    assert got == want and 0 < len(got) < 40
    assert t_select.select_valid_masks(t(seg * 0), t(masks), 0.0, 1.0) == []
    ids = [f"{i:05d}" for i in got]
    for mod, name in ((j_select, "j.pickle"), (t_select, "t.pickle")):
        mod.save_valid_mask_ids(str(tmp_path / name), "Chair", "c", "a", "view:00000", ids)
    with open(tmp_path / "j.pickle", "rb") as a, open(tmp_path / "t.pickle", "rb") as b:
        assert pickle.load(a) == pickle.load(b)


# ------------------------------------------------ cameras, pickles, preview

def test_camera_ring_perturbations_and_pickle_match(tmp_path):
    jc, tc = _camera_pair(view_num=8, resolution=(512, 512), elevation_deg=15.0, z_scale=0.8)
    for a, b in zip(jc, tc):
        np.testing.assert_array_equal(b.R.numpy(), np.asarray(a.R))
        np.testing.assert_array_equal(b.t.numpy(), np.asarray(a.t))
        assert (b.scale, b.resolution) == (a.scale, a.resolution)
    cfg = dict(need_perturb=True, rotation_x=[[-5, 5], [10, 20]], rotation_y=[[-5, 5]],
               displacement_z=[[1.73, 1.83]])
    pj = JP.sample_perturbations(cfg, 6, np.random.default_rng(42))
    pt = TP.sample_perturbations(cfg, 6, np.random.default_rng(42))
    for a, b in zip(pj, pt):
        for k in a:
            np.testing.assert_array_equal(b[k], a[k])
    pts = np.random.default_rng(0).normal(size=(7, 3))
    np.testing.assert_array_equal(TP.render_points_px(tc[2], pts),
                                  JP.render_points_px(jc[2], pts))
    R = TP.euler_xyz_to_matrix(0.3, -0.2, 1.1)
    np.testing.assert_array_equal(R, JP.euler_xyz_to_matrix(0.3, -0.2, 1.1))
    np.testing.assert_allclose(TP._matrix_to_euler_xyz(R), [0.3, -0.2, 1.1], atol=1e-12)
    disp = np.array([0.0, 0.1, 1.8])
    JP.save_camera_pickle(str(tmp_path / "j" / "v.pickle"), jc[3], R, R, disp, disp)
    TP.save_camera_pickle(str(tmp_path / "t" / "v.pickle"), tc[3], R, R, disp, disp)
    with open(tmp_path / "j" / "v.pickle", "rb") as a, open(tmp_path / "t" / "v.pickle", "rb") as b:
        want, got = pickle.load(a), pickle.load(b)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
        assert type(got[k]) is type(want[k])


def test_render_object_views_preview_matches():
    jc, tc = _camera_pair(view_num=2, resolution=(64, 64))
    verts = CUBE_V - 0.5
    want = JP.render_object_views(jc[1], verts, CUBE_F)
    got = TP.render_object_views(tc[1], verts, CUBE_F)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1].dtype == np.uint8 and got[1].shape == want[1].shape
    assert np.abs(got[1].astype(int) - want[1]).max() <= 1


def test_canonicalize_asset_matches():
    from coma_tpu.geometry.mesh import Mesh as JMesh

    verts = np.random.default_rng(2).normal(size=(30, 3))
    faces = np.arange(30).reshape(10, 3)
    for mode in ("bottom", "center"):
        want = j_canon.canonicalize_asset(JMesh(verts, faces), (90.0, 0.0, 10.0), mode)
        got = t_canon.canonicalize_asset(t_mesh.Mesh(verts, faces), (90.0, 0.0, 10.0), mode)
        np.testing.assert_array_equal(got.vertices, want.vertices)
        np.testing.assert_array_equal(got.faces, want.faces)
    assert t_canon.CANONICALIZATION == j_canon.CANONICALIZATION
