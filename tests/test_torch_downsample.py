"""Port parity of the downsampling stages: mesh IO and normals, poisson-disk
sampling (native library and pure-Python fallback), and the object and human
downsample pickles, each against ``coma_tpu`` on the same seeded inputs.

Indices and integer fields must be equal; arrays within atol 1e-12 (both
packages run the same float64 numpy, so in practice they are equal).
"""
import pickle

import numpy as np
import pytest

from coma_tpu import native as j_native
from coma_tpu.geometry import mesh as j_mesh
from coma_tpu.geometry import sampling as j_sampling
from coma_tpu.pipelines import downsample as j_down
from coma_tpu_torch import native as t_native
from coma_tpu_torch.geometry import mesh as t_mesh
from coma_tpu_torch.geometry import sampling as t_sampling
from coma_tpu_torch.pipelines import downsample as t_down
from tests.test_geometry import CUBE_F, CUBE_V

ATOL = 1e-12


def assert_same(a, b, key=""):
    """Equal dicts/lists/arrays: exact for integers and strings, atol 1e-12
    for floats."""
    if isinstance(a, dict):
        assert set(a) == set(b), key
        for k in a:
            assert_same(a[k], b[k], f"{key}.{k}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, key
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=0, atol=ATOL, err_msg=key)
        else:
            np.testing.assert_array_equal(a, b, err_msg=key)
    elif isinstance(a, list):
        assert len(a) == len(b), key
        assert [type(x) for x in a] == [type(x) for x in b], key
        assert_same(np.asarray(a), np.asarray(b), key)
    else:
        assert type(a) == type(b) and a == b, key


def bumpy_sphere(n_lat=9, n_lon=14, seed=0):
    """A closed, seeded, non-convex surface: a UV sphere with radial noise."""
    rng = np.random.default_rng(seed)
    lat = np.linspace(0.15, np.pi - 0.15, n_lat)
    lon = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    r = 1.0 + 0.1 * rng.normal(size=(n_lat, n_lon))
    v = np.stack([r * np.sin(lat)[:, None] * np.cos(lon), r * np.sin(lat)[:, None] * np.sin(lon),
                  r * np.cos(lat)[:, None] * np.ones_like(lon)], -1).reshape(-1, 3)
    faces = []
    for i in range(n_lat - 1):
        for j in range(n_lon):
            a, b = i * n_lon + j, i * n_lon + (j + 1) % n_lon
            faces += [[a, b + n_lon, b], [a, a + n_lon, b + n_lon]]
    return v, np.asarray(faces, np.int64)


@pytest.fixture(params=["native", "pure"])
def path(request, monkeypatch):
    """Both packages on the native library, or both on the Python fallback."""
    if request.param == "native":
        if not (t_native.available() and j_native.available()):
            pytest.skip("no C++ toolchain")
    else:
        monkeypatch.setattr(t_native, "available", lambda: False)
        monkeypatch.setattr(j_native, "available", lambda: False)
    return request.param


def test_obj_round_trip_slashed_faces_and_quads(tmp_path):
    src = tmp_path / "m.obj"
    src.write_text(
        "# comment\nv 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0.5 0.5 1\n"
        "vt 0 0\nvn 0 0 1\n"
        "f 1/1/1 2/1/1 3/1/1 4/1/1\n"   # a quad, v/vt/vn
        "f 1//1 2//1 5//1\n"            # v//vn
        "f -2/1 -3/1 -1/1\n"            # negative, v/vt
    )
    got, want = t_mesh.load_obj(str(src)), j_mesh.load_obj(str(src))
    assert_same(got.vertices, want.vertices)
    assert_same(got.faces, want.faces)
    assert got.faces.shape == (4, 3)     # the quad fans into two triangles
    t_mesh.save_obj(str(tmp_path / "t.obj"), got.vertices, got.faces)
    j_mesh.save_obj(str(tmp_path / "j.obj"), want.vertices, want.faces)
    assert (tmp_path / "t.obj").read_text() == (tmp_path / "j.obj").read_text()
    again = t_mesh.load_obj(str(tmp_path / "t.obj"))
    assert_same(again.vertices, got.vertices)
    assert_same(again.faces, got.faces)


@pytest.mark.parametrize("mesh", ["cube", "bumpy", "isolated"])
def test_face_areas_and_vertex_normals(mesh):
    if mesh == "cube":
        v, f = CUBE_V, CUBE_F
    elif mesh == "bumpy":
        v, f = bumpy_sphere()
    else:   # a vertex no face uses keeps a zero normal
        v, f = np.concatenate([CUBE_V, [[5.0, 5.0, 5.0]]]), CUBE_F
    assert_same(t_mesh.face_areas(v, f), j_mesh.face_areas(v, f))
    assert_same(t_mesh.face_cross_products(v, f), j_mesh.face_cross_products(v, f))
    normals = t_mesh.compute_vertex_normals(v, f)
    assert_same(normals, j_mesh.compute_vertex_normals(v, f))
    assert_same(t_mesh.normalize_rows(v), j_mesh.normalize_rows(v))
    assert_same(t_mesh.Mesh(v, f).vertex_normals, normals)


@pytest.mark.parametrize("n", [20, 45])
def test_poisson_disk_samples_equal(path, n):
    v, f = bumpy_sphere()
    got = t_sampling.sample_points_poisson_disk(t_mesh.Mesh(v, f), n, seed=7)
    want = j_sampling.sample_points_poisson_disk(j_mesh.Mesh(v, f), n, seed=7)
    assert got[0].shape == (n, 3)
    assert_same(got[0], want[0])
    assert_same(got[1], want[1])


@pytest.mark.parametrize("method", ["poisson_disk", "uniform"])
def test_simplify_mesh_indices_equal(path, method):
    v, f = bumpy_sphere(seed=1)
    got = t_sampling.simplify_mesh_and_get_indices(t_mesh.Mesh(v, f), 30, method, seed=3)
    want = j_sampling.simplify_mesh_and_get_indices(j_mesh.Mesh(v, f), 30, method, seed=3)
    assert got[0] == want[0]
    assert_same(got[1], want[1])
    assert_same(got[2], want[2])


def test_native_path_name_and_inside_test():
    assert t_native.path_name() in ("native C++ (g++)", "pure Python fallback")
    if not (t_native.available() and j_native.available()):
        pytest.skip("no C++ toolchain")
    pts = np.random.default_rng(0).uniform(-0.5, 1.5, size=(300, 3))
    np.testing.assert_array_equal(t_native.points_inside_mesh(pts, CUBE_V, CUBE_F),
                                  j_native.points_inside_mesh(pts, CUBE_V, CUBE_F))


def test_downsample_object_pickle_equal(path, tmp_path):
    v, f = bumpy_sphere(seed=2)
    obj = str(tmp_path / "asset.obj")
    j_mesh.save_obj(obj, v, f)
    got = t_down.downsample_object("BEHAVE", "backpack", "behave_asset", obj, 40, seed=5)
    want = j_down.downsample_object("BEHAVE", "backpack", "behave_asset", obj, 40, seed=5)
    assert_same(got, want)
    for mod, name in ((t_down, "t"), (j_down, "j")):
        mod.save_object_downsample(got if name == "t" else want, str(tmp_path / name / "a.pickle"),
                                   obj, str(tmp_path / name / "asset.obj"))
    with open(tmp_path / "t" / "a.pickle", "rb") as a, open(tmp_path / "j" / "a.pickle", "rb") as b:
        assert_same(pickle.load(a), pickle.load(b))


@pytest.mark.parametrize("num_points", [25, 10_000])   # a downsample, and FULL
def test_downsample_human_template_pickle_equal(path, tmp_path, num_points):
    v, f = bumpy_sphere(seed=4)
    v = v.astype(np.float32)                # the star template is float32
    got = t_down.downsample_human_template(v, f, num_points, seed=11)
    want = j_down.downsample_human_template(v, f, num_points, seed=11)
    assert_same(got, want)
    paths = [mod.save_human_downsample(d, num_points, str(tmp_path / name))
             for mod, d, name in ((t_down, got, "t"), (j_down, want, "j"))]
    assert paths[0].endswith("FULL.pickle" if num_points >= len(v) else f"_{num_points}.pickle")
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert_same(pickle.load(a), pickle.load(b))
    t_down.save_star_template(v, f, str(tmp_path / "t"))
    j_down.save_star_template(v, f, str(tmp_path / "j"))
    assert (tmp_path / "t" / "smplx_star.obj").read_text() \
        == (tmp_path / "j" / "smplx_star.obj").read_text()
