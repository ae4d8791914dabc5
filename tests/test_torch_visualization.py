"""The port's visualization (``visualization/viz.py``, ``cli/visualize.py``)
against ``coma_tpu``'s on the same inputs.

The PLY is byte-equal. ``coma_tpu`` draws the preview and the slice grid
with matplotlib, which the card machine lacks; the port's images differ by
design (ROADMAP Queue 3), so the tests hold the data matplotlib is given:
the preview's face colours (captured from ``set_fc``) and the six slice
panels (captured from ``imshow``) are equal, and the panels' colours equal
matplotlib's ``inferno`` with ``vmin=0``. The CLIs run on tiny inputs with
``--device cpu``.
"""
import matplotlib
import numpy as np
import pytest
from matplotlib.colors import Normalize

from coma_tpu.visualization import viz as J
from coma_tpu_torch.cli import visualize as t_cli
from coma_tpu_torch.utils.colormap import inferno_rgb
from coma_tpu_torch.utils.png import read_png
from coma_tpu_torch.visualization import viz as T


def sphere_mesh(n_lat=6, n_lon=8):
    from coma_tpu_torch.visualization.contact_viz import uv_sphere

    return uv_sphere(np.zeros(3), 0.5, n_lat, n_lon)


@pytest.mark.parametrize("weights", ["ramp", "random", "constant"])
def test_vertex_colored_mesh_is_byte_equal(tmp_path, weights):
    verts, faces = sphere_mesh()
    w = {"ramp": np.linspace(0, 1, len(verts)),
         "random": np.random.default_rng(0).uniform(-2, 3, len(verts)),
         "constant": np.full(len(verts), 0.3)}[weights]
    J.save_vertex_colored_mesh(str(tmp_path / "j.ply"), verts, faces, w)
    T.save_vertex_colored_mesh(str(tmp_path / "t.ply"), verts, faces, w)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


def test_preview_face_colors_equal(monkeypatch, tmp_path):
    verts, faces = sphere_mesh()
    w = np.random.default_rng(1).uniform(size=len(verts))
    from mpl_toolkits.mplot3d import art3d

    seen = []
    original = art3d.Poly3DCollection.set_facecolor

    def spy(self, c):
        seen.append(np.array(c, copy=True))
        return original(self, c)

    monkeypatch.setattr(art3d.Poly3DCollection, "set_fc", spy, raising=False)
    J.render_mesh_preview(str(tmp_path / "j.png"), verts, faces, w, resolution=64)
    assert len(seen) == 1
    np.testing.assert_array_equal(T.preview_face_colors(faces, w), seen[0][:, :3])


def test_mesh_preview_image(tmp_path):
    verts, faces = sphere_mesh()
    w = np.linspace(0, 1, len(verts))
    img = T.render_mesh_preview(str(tmp_path / "p.png"), verts, faces, w, resolution=64,
                                device="cpu")
    assert img.shape == (64, 64, 3) and np.isfinite(img).all()
    assert img.min() >= 0 and img.max() <= 1
    png = read_png(str(tmp_path / "p.png"))
    np.testing.assert_array_equal(png, np.round(img * 255).astype(np.uint8))
    colors = T.preview_face_colors(faces, w)
    covered = (img != 1.0).any(-1)
    assert 0.1 < covered.mean() < 0.9       # the sphere is framed, white around it
    assert img[0, 0].tolist() == [1.0, 1.0, 1.0]
    drawn = {tuple(c) for c in np.float32(img[covered])}
    assert drawn <= {tuple(c) for c in np.float32(colors)}   # flat face colours only


@pytest.mark.parametrize("shape", [(16, 16, 16), (10, 12, 14)])
def test_slice_panels_equal_imshow_inputs(monkeypatch, tmp_path, shape):
    field = np.random.default_rng(2).uniform(size=shape).astype(np.float32) ** 2
    field[3] = 0.0                                # an all-zero slice: vmax 0
    from matplotlib.axes import Axes

    seen = []
    original = Axes.imshow

    def spy(self, X, *args, **kwargs):
        seen.append((np.array(X, copy=True), kwargs))
        return original(self, X, *args, **kwargs)

    monkeypatch.setattr(Axes, "imshow", spy)
    J.visualize_occupancy_slices(str(tmp_path / "j.png"), field)
    panels = T.occupancy_slice_panels(field)
    assert len(seen) == len(panels) == 6
    for (want, kwargs), got in zip(seen, panels):
        assert kwargs == {"cmap": "inferno", "vmin": 0}
        np.testing.assert_array_equal(got, want)
        mpl = matplotlib.colormaps["inferno"](Normalize(vmin=0, vmax=want.max())(want))
        np.testing.assert_array_equal(inferno_rgb(got, vmin=0.0), mpl[..., :3])


def test_slice_grid_image(tmp_path):
    field = np.random.default_rng(3).uniform(size=(8, 8, 8))
    img = T.visualize_occupancy_slices(str(tmp_path / "s.png"), field)
    P, g = T.PANEL_PX, T.GAP_PX
    assert img.shape == (2 * P + 3 * g, 3 * P + 4 * g, 3)
    panels = T.occupancy_slice_panels(field)
    pick = np.arange(P) * 8 // P
    for k, panel in enumerate(panels):
        r, c = divmod(k, 3)
        y0, x0 = g + r * (P + g), g + c * (P + g)
        np.testing.assert_allclose(img[y0:y0 + P, x0:x0 + P],
                                   inferno_rgb(panel, vmin=0.0)[pick][:, pick], atol=1e-7)
    assert img[0, 0].tolist() == [1.0, 1.0, 1.0]
    assert read_png(str(tmp_path / "s.png")).shape == img.shape


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_inferno_matches_matplotlib(dtype):
    v = np.concatenate([np.linspace(-0.5, 1.5, 1001), [0.0, 1.0, 0.5]]).astype(dtype)
    want = matplotlib.colormaps["inferno"](Normalize(vmin=0.0, vmax=v.max())(v))[:, :3]
    np.testing.assert_array_equal(inferno_rgb(v, vmin=0.0), want)


def test_frames_to_video_without_ffmpeg(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    assert T.frames_to_video(str(tmp_path), str(tmp_path / "v.mp4")) is False
    assert J.frames_to_video(str(tmp_path), str(tmp_path / "v.mp4")) is False


def test_write_message_on_img():
    img = np.zeros((64, 64, 3), np.uint8)
    out = T.write_message_on_img(img, "NO HUMANS")
    want = J.write_message_on_img(img, "NO HUMANS")
    assert out.shape == img.shape and img.max() == 0        # the input is untouched
    assert (out[..., 0] > 0).any() and not (out[..., 1:] > 0).any()     # a red stamp
    rows = np.nonzero(out[..., 0].any(1))[0]
    want_rows = np.nonzero(want[..., 0].any(1))[0]
    assert rows.min() >= 64 - 20 and abs(rows.min() - want_rows.min()) <= 3   # same anchor
    assert np.nonzero(out[..., 0].any(0))[0].min() == 0                 # x = max(0, H - 150)


def test_visualize_cli_human(tmp_path, monkeypatch):
    from coma_tpu_torch.geometry.mesh import save_obj

    monkeypatch.chdir(tmp_path)
    verts, faces = sphere_mesh()
    save_obj("star.obj", verts, faces)
    np.save("aff.npy", np.linspace(0, 1, len(verts)))
    t_cli.main(["human", "--affordance_npy", "aff.npy", "--smplx_star_pth", "star.obj",
                "--out", "out", "--device", "cpu"])
    from coma_tpu.cli import visualize as j_cli

    j_cli.main(["human", "--affordance_npy", "aff.npy", "--smplx_star_pth", "star.obj",
                "--out", "want"])
    assert open("out.ply", "rb").read() == open("want.ply", "rb").read()
    assert read_png("out.png").shape == (512, 512, 3)


def test_visualize_cli_object(tmp_path, monkeypatch):
    from coma_tpu_torch.utils.ply import write_ply_pointcloud

    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(200, 3)).astype(np.float32)
    colors = rng.uniform(size=(200, 3)).astype(np.float32)
    write_ply_pointcloud("obj.ply", pts, colors=colors)
    t_cli.main(["object", "--ply", "obj.ply", "--out", "obj.png", "--device", "cpu"])
    img = read_png("obj.png")
    assert img.shape == (512, 512, 3)
    drawn = img[(img != 255).any(-1)]
    assert len(drawn) > 200
    from coma_tpu_torch.utils.ply import read_ply_pointcloud

    want = {tuple(c) for c in np.round(read_ply_pointcloud("obj.ply")[2] * 255).astype(np.uint8)}
    assert {tuple(c) for c in drawn} <= want     # every pixel is one point's colour


def test_splat_z_buffer_takes_the_nearest_point():
    import torch

    # two points on the view axis: the one nearer the camera wins
    from coma_tpu_torch.visualization.volume import _orbit_axes

    _, _, fwd = (a.numpy() for a in _orbit_axes(t_cli.OBJECT_ELEV, t_cli.OBJECT_AZIM))
    pts = np.stack([-fwd, fwd, np.array([1.0, 1.0, 1.0]), np.array([-1.0, -1.0, -1.0])])
    colors = np.eye(4, 3)
    img = t_cli.splat_points(pts, colors, 32, t_cli.OBJECT_ELEV, t_cli.OBJECT_AZIM,
                             torch.device("cpu"))
    assert (img == torch.tensor([1.0, 0.0, 0.0])).all(-1).any()     # point 0, nearer
    assert not (img == torch.tensor([0.0, 1.0, 0.0])).all(-1).any()


def test_visualize_cli_occupancy(tmp_path, monkeypatch, rng):
    monkeypatch.chdir(tmp_path)
    info = dict(prob_field=rng.uniform(size=(8, 8, 8)), spatial_grid_metadata={})
    np.save("occ.npy", info)
    t_cli.main(["occupancy", "--occupancy_npy", "occ.npy", "--out", "occ.png",
                "--resolution", "32", "--device", "cpu"])
    from coma_tpu_torch.visualization.volume import save_occupancy_volume_render

    want = save_occupancy_volume_render(None, info["prob_field"], resolution=32, device="cpu")
    np.testing.assert_array_equal(read_png("occ.png"), (want * 255).astype(np.uint8))
    t_cli.main(["occupancy", "--occupancy_npy", "occ.npy", "--out", "occ_slices.png",
                "--mode", "slices", "--device", "cpu"])
    assert read_png("occ_slices.png").shape == T.visualize_occupancy_slices(
        None, info["prob_field"]).shape


def test_visualize_cli_without_card_raises(tmp_path, monkeypatch):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    monkeypatch.chdir(tmp_path)
    np.save("occ.npy", dict(prob_field=np.ones((4, 4, 4)), spatial_grid_metadata={}))
    with pytest.raises(RuntimeError, match="cuda"):
        t_cli.main(["occupancy", "--occupancy_npy", "occ.npy", "--out", "o.png"])
