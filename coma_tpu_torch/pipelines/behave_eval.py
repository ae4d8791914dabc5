"""BEHAVE dataset toolkit: Kinect calibration + the GT evaluation path.

Counterpart of ``coma_tpu/pipelines/behave_eval.py``. Reference parity: the
load-bearing parts of the vendored BEHAVE tooling (``utils/behave.py``,
1.4k LoC):
- :class:`KinectCalib` — color/depth intrinsics and extrinsics, point
  projection, depth-map -> point cloud (``behave.py:31-120``); numpy, with
  scipy's spline, k-d tree and ``griddata`` on the host.
- :func:`prepare_affordance_extraction_inputs_for_behave` — put GT BEHAVE
  frames in the same canonical frame as generated samples (raw2normal,
  lowres center, fit params; ``behave.py:1062-1215``). Fed to
  ``pipelines/extract.aggregate_samples_streaming``, it builds the
  ground-truth ComA state (K1 on the card).
- :func:`evaluate_against_gt` — the paper-table machinery: SIM/MAE between
  predicted and GT aggregated contact distributions
  (``constants/coma/quant.py`` quant_keys + ``utils/evaluation.py``).

Images are read with ``utils/png.py`` (the card machine has no PIL): 16-bit
depth maps and PNG masks and colour frames. BEHAVE's colour frames are JPEG,
which the port does not decode; reading one raises, naming the file.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Any, Dict, Optional

import numpy as np
import torch

from coma_tpu_torch.affordance.contact import aggregate_contact
from coma_tpu_torch.affordance.evaluation import quant_metrics
from coma_tpu_torch.affordance.io import load_pickle
from coma_tpu_torch.geometry.mesh import compute_vertex_normals, normalize_rows
from coma_tpu_torch.geometry.transforms import rodrigues
from coma_tpu_torch.utils.image_io import read_image


@dataclasses.dataclass
class KinectCalib:
    """Azure-Kinect color/depth calibration (pinhole + OpenCV distortion).

    Constructed from the BEHAVE calibration json dict (``behave.py:31-81``).
    """

    calibration_matrix: np.ndarray   # (3, 3) color intrinsics
    dist_coeffs: np.ndarray
    image_size: tuple
    depth_matrix: np.ndarray
    depth2color_R: np.ndarray
    depth2color_t: np.ndarray
    pc_table: Optional[np.ndarray] = None   # (H, W, 2) precomputed xy table

    @classmethod
    def from_json(cls, calibration: Dict[str, Any], pc_table=None) -> "KinectCalib":
        color = calibration["color"]
        K = np.eye(3)
        K[0, 0], K[1, 1] = color["fx"], color["fy"]
        K[:2, 2] = (color["cx"], color["cy"])
        depth = calibration["depth"]
        Kd = np.eye(3)
        Kd[0, 0], Kd[1, 1] = depth["fx"], depth["fy"]
        Kd[:2, 2] = (depth["cx"], depth["cy"])
        return cls(
            calibration_matrix=K,
            dist_coeffs=np.asarray(color["opencv"][4:]),
            image_size=(color["width"], color["height"]),
            depth_matrix=Kd,
            depth2color_R=np.asarray(
                calibration["depth_to_color"]["rotation"]
            ).reshape(3, 3),
            depth2color_t=np.asarray(calibration["depth_to_color"]["translation"]),
            pc_table=pc_table,
        )

    def project_points(self, points: np.ndarray) -> np.ndarray:
        """Color-camera points (N, 3) -> distorted pixel coords (N, 2)
        (``behave.py:project_points:87-92``)."""
        x = points[:, 0] / points[:, 2]
        y = points[:, 1] / points[:, 2]
        k = np.zeros(8)
        k[: len(self.dist_coeffs)] = self.dist_coeffs[:8]
        r2 = x * x + y * y
        radial = (1 + k[0] * r2 + k[1] * r2**2 + k[4] * r2**3) / (
            1 + k[5] * r2 + k[6] * r2**2 + k[7] * r2**3
        )
        xd = x * radial + 2 * k[2] * x * y + k[3] * (r2 + 2 * x * x)
        yd = y * radial + k[2] * (r2 + 2 * y * y) + 2 * k[3] * x * y
        fx, fy = self.calibration_matrix[0, 0], self.calibration_matrix[1, 1]
        cx, cy = self.calibration_matrix[:2, 2]
        return np.stack([xd * fx + cx, yd * fy + cy], axis=-1)

    def dmap2pc(self, depth_mm: np.ndarray, return_mask: bool = False):
        """Depth map (mm) -> point cloud via the precomputed xy table
        (``behave.py:dmap2pc:93-105``)."""
        assert self.pc_table is not None, "needs the precomputed pc table"
        table = np.dstack([self.pc_table, np.ones(self.pc_table.shape[:2] + (1,))])
        d = depth_mm.astype(np.float64) / 1000.0
        d[depth_mm == 0] = np.nan
        pc = table * d[..., None]
        valid = np.isfinite(pc[:, :, 0])
        if return_mask:
            return pc[valid], valid
        return pc[valid]

    # -- multi-kinect depth<->color machinery (behave.py:107-198) ----------

    def interpolate_depth(self, depth_im: np.ndarray) -> np.ndarray:
        """Fill depth holes by 1-D linear interpolation over the raveled map
        (``behave.py:interpolate_depth:107-115``, borrowed from PROX)."""
        zero_mask = np.asarray(depth_im == 0.0).ravel()
        flat = depth_im.astype(np.float64).ravel()
        flat[zero_mask] = np.interp(
            np.flatnonzero(zero_mask), np.flatnonzero(~zero_mask),
            flat[~zero_mask]
        )
        return flat.reshape(depth_im.shape)

    def pc2color(self, pointcloud: np.ndarray) -> np.ndarray:
        """Depth-camera points -> RGB pixel coords
        (``behave.py:pc2color:117-124``)."""
        pc_color = pointcloud @ self.depth2color_R.T + self.depth2color_t
        return self.project_points(pc_color)

    def valid_pixmask(self, color_pixels: np.ndarray) -> np.ndarray:
        w, h = self.image_size
        return ((color_pixels[:, 0] >= 0) & (color_pixels[:, 0] < w)
                & (color_pixels[:, 1] >= 0) & (color_pixels[:, 1] < h))

    def pc2color_valid(self, pointcloud: np.ndarray):
        """(pixels, points) with out-of-frame projections removed
        (``behave.py:pc2color_valid:126-135``)."""
        projected = self.pc2color(pointcloud)
        mask = self.valid_pixmask(projected)
        return projected[mask, :], pointcloud[mask, :]

    def dmap2colorpc(self, color: np.ndarray, depth_mm: np.ndarray):
        """Depth in the COLOR camera -> (points, per-point colors)
        (``behave.py:dmap2colorpc:188-193``)."""
        pc, mask = self.dmap2pc(depth_mm, return_mask=True)
        return pc, color[mask].astype(np.float64) / 255.0

    def get_pc_colors(self, pointcloud: np.ndarray, color_frame: np.ndarray,
                      projected_color_pc: np.ndarray = None) -> np.ndarray:
        """Sample per-point RGB by bivariate-spline interpolation of the
        color frame at the projected coords (``behave.py:160-174``)."""
        from scipy.interpolate import RectBivariateSpline

        if projected_color_pc is None:
            projected_color_pc = self.pc2color(pointcloud)
        pc_colors = np.ones_like(pointcloud, dtype=np.float64)
        for i in range(3):
            spline = RectBivariateSpline(
                np.arange(color_frame.shape[0]),
                np.arange(color_frame.shape[1]),
                color_frame[:, :, i],
            )
            pc_colors[:, i] = spline(
                projected_color_pc[:, 1], projected_color_pc[:, 0], grid=False
            )
        return np.clip(pc_colors / 255.0, 0, 1)

    def color_to_pc(self, colorpts: np.ndarray, pc_depth: np.ndarray,
                    projected_color_pc: np.ndarray = None,
                    k: int = 4, std: float = 1.0) -> np.ndarray:
        """Lift color-pixel locations to 3D as a distance-weighted blend of
        the k nearest projected depth points (``behave.py:143-158``)."""
        from scipy.spatial import cKDTree

        if projected_color_pc is None:
            projected_color_pc = self.pc2color(pc_depth)
        tree = cKDTree(projected_color_pc)
        dists, inds = tree.query(colorpts, k=k)
        weights = np.exp(-dists / (2 * std**2))
        w = weights / weights.sum(axis=1, keepdims=True)
        return (pc_depth[inds.reshape(-1), :].reshape(-1, k, 3)
                * w[:, :, None]).sum(axis=1)

    def pc2dmap(self, points: np.ndarray) -> np.ndarray:
        """Reproject a point cloud to a color-frame depth map via
        nearest-grid interpolation (``behave.py:pc2dmap:176-186``).

        Quirks kept reference-exact on purpose: the zeros-init + full-grid
        assignment is equivalent to ``dmap = depth``, and nearest-neighbor
        griddata EXTRAPOLATES — pixels outside the cloud's footprint carry
        the nearest point's depth rather than 0, so ``dmap == 0`` is NOT a
        validity mask here (unlike the kinect depth readers above)."""
        from scipy.interpolate import griddata

        p2d = self.project_points(points)
        cw, ch = self.image_size
        px, py = np.meshgrid(np.arange(cw, dtype=np.float64),
                             np.arange(ch, dtype=np.float64))
        depth = griddata(p2d, points[:, 2], (px, py), method="nearest")
        dmap = np.zeros((ch, cw))
        dmap[py.astype(int), px.astype(int)] = depth
        return dmap


def prepare_affordance_extraction_inputs_for_behave(
    human_mesh_pth: str,
    human_mesh_pth_type: str,
    human_downsample_metadata: Dict[str, Any],
    object_downsample_metadata: Dict[str, Any],
    human_use_downsample_pcd_raw: bool,
    object_use_downsample_pcd_raw: bool,
    lowres_center_pth: str,
    raw2normal_pth: str,
    obj_param_pth: str,
    eps: float,
) -> Dict[str, np.ndarray]:
    """GT BEHAVE frame -> the canonical frame of generated samples.

    The object's raw scan coordinates are first un-normalized
    (``(v - t_raw2normal) @ R_raw2normal``), recentred on the low-res
    template center, then posed with the per-frame fit (Rodrigues angle +
    translation) — exactly ``behave.py:1140-1175``.

    The fit's rotation is float32, as ``coma_tpu`` computes it (its
    float64 request is float32 without JAX's x64 mode); the products with it
    are float64.
    """
    if human_mesh_pth_type == "obj":
        from coma_tpu_torch.geometry.mesh import load_obj

        mesh = load_obj(human_mesh_pth)
        human_verts_orig = mesh.vertices
        human_faces_orig = mesh.faces
    else:
        data = load_pickle(human_mesh_pth)
        human_verts_orig = np.asarray(data["verts"])
        human_faces_orig = np.asarray(data["faces"], np.int64)
    human_vertex_normals_orig = normalize_rows(
        compute_vertex_normals(human_verts_orig, human_faces_orig), eps
    )

    obj_verts_orig = np.asarray(object_downsample_metadata["obj_vertices_original"])
    obj_vertex_normals_orig = normalize_rows(
        np.asarray(object_downsample_metadata["obj_vertex_normals_original"])
    )

    assert not human_use_downsample_pcd_raw, "human must use mesh representation"
    h_idx = np.asarray(human_downsample_metadata["downsample_indices"], np.int64)
    human_verts = human_verts_orig[h_idx]
    human_vertex_normals = human_vertex_normals_orig[h_idx]

    if object_use_downsample_pcd_raw:
        obj_verts = np.asarray(object_downsample_metadata["downsampled_pcd_points_raw"])
        obj_vertex_normals = np.asarray(
            object_downsample_metadata["downsampled_pcd_normal_raw"]
        )
    else:
        o_idx = np.asarray(object_downsample_metadata["downsample_indices"], np.int64)
        obj_verts = obj_verts_orig[o_idx]
        obj_vertex_normals = obj_vertex_normals_orig[o_idx]

    # BEHAVE-specific canonicalization
    lowres_center = np.asarray(load_pickle(lowres_center_pth)["obj_lowres_center"])
    raw2normal = load_pickle(raw2normal_pth)
    R_r2n = np.asarray(raw2normal["R_raw2normal"])
    t_r2n = np.asarray(raw2normal["t_raw2normal"])

    obj_verts = (obj_verts - t_r2n[None]) @ R_r2n - lowres_center[None]
    obj_vertex_normals = obj_vertex_normals @ R_r2n

    obj_param = load_pickle(obj_param_pth)
    angle = np.asarray(obj_param["angle"], np.float64)
    trans = np.asarray(obj_param["trans"], np.float64).reshape(1, 3)
    rotvec = torch.from_numpy(np.float32(angle[None] if angle.ndim == 1 else angle))
    R_fit = rodrigues(rotvec).numpy()[0]
    obj_verts = obj_verts @ R_fit.T + trans
    obj_vertex_normals = normalize_rows(obj_vertex_normals @ R_fit.T, eps)

    return dict(
        human_verts=human_verts.astype(np.float32),
        human_normals=human_vertex_normals.astype(np.float32),
        obj_verts=obj_verts.astype(np.float32),
        obj_normals=obj_vertex_normals.astype(np.float32),
    )


def evaluate_against_gt(
    pred_state, gt_state, significant_contact_ratio: float = 0.0, eps: float = 1e-12
) -> Dict[str, Dict[str, float]]:
    """SIM/MAE between predicted and GT aggregated contact distributions.

    Reference: the quant_mode outputs named in ``constants/coma/quant.py``
    (aggr_object_contact_metrics / aggr_human_contact_metrics) computed via
    ``utils/evaluation.py``.
    """
    out = {}
    for which, key in (("human", "aggr_human_contact_metrics"),
                       ("obj", "aggr_object_contact_metrics")):
        pred, _ = aggregate_contact(pred_state, which, significant_contact_ratio)
        gt, _ = aggregate_contact(gt_state, which, significant_contact_ratio)
        out[key] = quant_metrics(pred, gt.to(pred.device), eps)
    return out


# --------------------------------------------------------------------------
# BEHAVE sequence reading (reference: utils/behave.py:418-630 SeqInfo /
# KinectFrameReader / FrameDataReader). numpy based — no psbody/cv2.
# --------------------------------------------------------------------------

class SeqInfo:
    """Sequence metadata from ``<seq>/info.json`` (``behave.py:418-466``):
    category, gender, kinect ids, calibration paths (made absolute)."""

    def __init__(self, seq_path: str):
        import json

        with open(os.path.join(seq_path, "info.json")) as fh:
            self.info = json.load(fh)
        for name in ("config", "empty", "intrinsic"):
            if self.info.get(name) is not None:
                self.info[name] = os.path.join(seq_path, self.info[name])

    def get_obj_name(self, convert: bool = False) -> str:
        """COCO-detector name conversion (``behave.py:424-430``)."""
        cat = self.info["cat"]
        if convert:
            if "chair" in cat:
                return "chair"
            if "ball" in cat:
                return "sports ball"
        return cat

    @property
    def kids(self):
        return list(self.info.get("kinects", range(3)))

    def kinect_count(self) -> int:
        return len(self.kids)


class BehaveSequence:
    """Frame-level reader for one BEHAVE sequence directory.

    Frames are subdirectories named ``t<sec>.<subframe>`` holding
    ``k{kid}.color.jpg`` / ``k{kid}.depth.png`` plus per-frame fits:
    ``person/<save_name>/person_fit.pkl`` and
    ``<obj>/<save_name>/<obj>_fit.pkl``. Combines the reference's
    KinectFrameReader (``:479``) and FrameDataReader (``:631``) surface that
    the evaluation path needs; fit params feed
    :func:`prepare_affordance_extraction_inputs_for_behave`.
    """

    def __init__(self, seq_path: str, ext: str = "jpg", empty: str = None):
        self.seq_path = seq_path.rstrip("/")
        self.ext = ext
        self.seq_info = SeqInfo(self.seq_path)
        self.kids = self.seq_info.kids
        self.frames = self._list_frames()
        # ``empty``: an empty-room sequence dir; its per-kinect average depth
        # becomes the background model for depth filtering
        # (``behave.py:prepare_bkgs:581-587``)
        self.bkgs = (
            None if empty is None
            else {k: sequence_background_depth(empty, k) for k in self.kids}
        )

    def _list_frames(self):
        def key(name):
            t, sub = name.split(".")[:2]
            return (int(t.replace("t", "")), int(sub))

        return sorted(
            (
                f
                for f in os.listdir(self.seq_path)
                if os.path.isdir(os.path.join(self.seq_path, f)) and f.startswith("t")
            ),
            key=key,
        )

    def __len__(self):
        return len(self.frames)

    def frame_folder(self, idx: int) -> str:
        return os.path.join(self.seq_path, self.frames[idx])

    def frame_index(self, frame_time: str) -> int:
        return self.frames.index(frame_time)

    def times2indices(self, frame_times):
        return [self.frame_index(t) for t in frame_times]

    def get_color_image(self, idx: int, kid: int) -> np.ndarray:
        """(H, W, 3) uint8, PIL's ``convert("RGB")`` of the JPEG (BEHAVE's)
        or PNG frame."""
        pth = os.path.join(self.frame_folder(idx), f"k{kid}.color.{self.ext}")
        return read_image(pth, "RGB")

    def get_depth_image(self, idx: int, kid: int) -> np.ndarray:
        """uint16 depth in mm (``k{kid}.depth.png``): PIL's array of the file."""
        pth = os.path.join(self.frame_folder(idx), f"k{kid}.depth.png")
        return read_image(pth)

    def objfit_param_file(self, idx: int, save_name: str) -> str:
        name = self.seq_info.get_obj_name(convert=True)
        return os.path.join(
            self.frame_folder(idx), name, save_name, f"{name}_fit.pkl"
        )

    def get_objfit_params(self, idx: int, save_name: str):
        """(angle (3,), trans (3,)) or (None, None) (``behave.py:736-744``)."""
        pth = self.objfit_param_file(idx, save_name)
        if save_name is None or not os.path.isfile(pth):
            return None, None
        with open(pth, "rb") as fh:
            fit = pickle.load(fh)
        return fit["angle"], fit["trans"]

    def smplfit_param_file(self, idx: int, save_name: str) -> str:
        return os.path.join(
            self.frame_folder(idx), "person", save_name, "person_fit.pkl"
        )

    def get_smplfit_params(self, idx: int, save_name: str):
        """(pose, betas, trans) or Nones (``behave.py:746-755``)."""
        pth = self.smplfit_param_file(idx, save_name)
        if save_name is None or not os.path.isfile(pth):
            return None, None, None
        with open(pth, "rb") as fh:
            fit = pickle.load(fh)
        return fit["pose"], fit["betas"], fit["trans"]

    def smplfit_meshfile_as_smplx(self, idx: int, save_name: str, ext: str = "ply") -> str:
        return os.path.join(
            self.frame_folder(idx), "person", save_name, f"person_fit_smplx.{ext}"
        )

    def get_person_pointcloud(self, idx: int):
        """(N, 3) scan points of the segmented person, or None."""
        pth = os.path.join(self.frame_folder(idx), "person", "person.ply")
        if not os.path.isfile(pth):
            return None
        from coma_tpu_torch.utils.ply import read_ply_pointcloud

        return read_ply_pointcloud(pth)[0]

    # -- multi-kinect frame access (KinectFrameReader, behave.py:479-607) --

    def get_color_images(self, idx: int, kids=None):
        return [self.get_color_image(idx, k)
                for k in (self.kids if kids is None else kids)]

    def get_depth_images(self, idx: int, kids=None):
        return [self.get_depth_image(idx, k)
                for k in (self.kids if kids is None else kids)]

    def __getitem__(self, idx: int):
        """(colors, depths) across all kinects, background-filtered when an
        empty-room sequence was given (``behave.py:__getitem__:533-549``)."""
        colors = self.get_color_images(idx)
        depths = self.get_depth_images(idx)
        if self.bkgs is not None:
            depths = [remove_background_depth(d, self.bkgs[k], tol=30)
                      for d, k in zip(depths, self.kids)]
        return colors, depths

    def frame_time(self, idx: int) -> str:
        return self.frames[idx]

    def get_timestamps(self):
        """float seconds for every frame (``behave.py:594-597``)."""
        return [float(x.replace("t", "").split(".")[0]
                      + "." + x.split(".")[1]) for x in self.frames]

    def get_frame_idx(self, timestr: str) -> int:
        """index of a ``t<sec>.<sub>`` frame name, -1 if absent
        (``behave.py:599-604``)."""
        try:
            return self.frames.index(timestr)
        except ValueError:
            return -1

    def cvt_end(self, end):
        return len(self) if end is None else min(end, len(self))

    # -- mocap / keypoints / masks (FrameDataReader, behave.py:660-822) ----

    def get_mocap_pose(self, idx: int, kid: int = 1):
        return self._mocap_field(idx, kid, "pose")

    def get_mocap_beta(self, idx: int, kid: int = 1):
        return self._mocap_field(idx, kid, "betas")

    def _mocap_field(self, idx, kid, field):
        import json

        pth = os.path.join(self.frame_folder(idx), f"k{kid}.mocap.json")
        if not os.path.isfile(pth):
            return None
        with open(pth) as fh:
            return np.asarray(json.load(fh)[field])

    def get_body_kpts(self, idx: int, kid: int, tol: float = 0.5):
        """(J, 3) 2D joints + confidence; low-confidence scores zeroed
        (``behave.py:get_body_kpts:774-781``)."""
        import json

        pth = os.path.join(self.frame_folder(idx), f"k{kid}.color.json")
        if not os.path.isfile(pth):
            return None
        with open(pth) as fh:
            J2d = np.asarray(json.load(fh)["body_joints"]).reshape(-1, 3)
        J2d[:, 2][J2d[:, 2] < tol] = 0
        return J2d

    def get_body_j3d(self, idx: int):
        """(J, 4) triangulated joints+score (``behave.py:761-772``)."""
        import json

        pth = self.get_pcpath(idx, "person").replace(".ply", "_J3d.json")
        if not os.path.isfile(pth):
            return None
        with open(pth) as fh:
            return np.asarray(json.load(fh)["body_joints3d"]).reshape(-1, 4)

    def get_mask_file(self, idx: int, kid: int, cat: str) -> str:
        """Person/object mask path with the reference's fallback chain
        (``behave.py:get_mask_file:795-813``)."""
        folder = self.frame_folder(idx)
        if cat == "person":
            for ext in ("png", "jpg"):
                f = os.path.join(folder, f"k{kid}.person_mask.{ext}")
                if os.path.isfile(f):
                    return f
            return f
        if cat == "obj":
            for ext in ("png", "jpg"):
                f = os.path.join(folder, f"k{kid}.obj_rend_mask.{ext}")
                if not os.path.isfile(f):
                    f = os.path.join(folder, f"k{kid}.obj_mask.{ext}")
                if os.path.isfile(f):
                    return f
            return f
        raise NotImplementedError(cat)

    def get_mask(self, idx: int, kid: int, cat: str = "person",
                 ret_bool: bool = True):
        pth = self.get_mask_file(idx, kid, cat)
        if not os.path.isfile(pth):
            return None
        mask = read_image(pth, "L")
        return mask > 127 if ret_bool else mask

    def get_person_mask(self, idx: int, kids=None, ret_bool: bool = True):
        return [self.get_mask(idx, k, "person", ret_bool)
                for k in (self.kids if kids is None else kids)]

    # -- segmented scan point clouds (behave.py:640-658, 824-834) ----------

    def get_pcpath(self, idx: int, cat: str, convert: bool = False) -> str:
        name = ("person" if cat == "person"
                else self.seq_info.get_obj_name(convert))
        return os.path.join(self.frame_folder(idx), name, f"{name}.ply")

    def get_pc(self, idx: int, cat: str = "person", convert: bool = False):
        """(points, colors, normals) of the segmented scan, or None. Falls
        back to the other object naming like the reference
        (``behave.py:get_pc:640-645``)."""
        pth = self.get_pcpath(idx, cat, convert)
        if not os.path.isfile(pth):
            pth = self.get_pcpath(idx, cat, not convert)
        if not os.path.isfile(pth):
            return None
        from coma_tpu_torch.utils.ply import read_ply_pointcloud

        return read_ply_pointcloud(pth)

    def get_pcfiles(self, frames, cat: str, convert: bool = False):
        return [self.get_pcpath(x, cat, convert) for x in frames]

    def pc_exists(self, idx: int, cat: str, convert: bool = False) -> bool:
        return os.path.isfile(self.get_pcpath(idx, cat, convert))

    def get_pointcloud(self, idx: int, kid: int, calib: KinectCalib):
        """Native convenience: unproject this frame's depth map through the
        kinect calibration (depth holes NOT filled; compose with
        ``calib.interpolate_depth`` when needed)."""
        return calib.dmap2pc(self.get_depth_image(idx, kid))


def sequence_background_depth(empty_seq: str, kid: int,
                              start: int = 0) -> np.ndarray:
    """Average depth of an empty-room sequence for one kinect — the
    background model (``behave.py:get_seq_bkg:610-621``)."""
    depths = []
    for frame in sorted(os.listdir(empty_seq))[start:]:
        pth = os.path.join(empty_seq, frame, f"k{kid}.depth.png")
        if os.path.isfile(pth):
            depths.append(read_image(pth).astype(np.float64))
    return np.stack(depths, axis=-1).mean(axis=-1)


def remove_background_depth(depth: np.ndarray, bkg: np.ndarray,
                            tol: float = 100) -> np.ndarray:
    """Zero pixels within ``tol`` mm of the background model
    (``behave.py:remove_background:624-628``)."""
    out = depth.copy()
    out[np.abs(depth.astype(np.float64) - bkg) < tol] = 0
    return out
