#!/usr/bin/env python3
"""Phase 14 of ``chip_smoke.py`` alone: the BEHAVE ground-truth evaluation
(K1 at quant:full), ``cli/visualize`` and ``cli/train_segmenter`` on the card.

    python3 tools/item14_torch.py

Builds the CUDA kernels, writes seeded stand-ins for what the full script
takes from its earlier phases (phase 4's human-contact, object-contact and
occupancy products; phase 4b's SMPL-X-shaped npz, its star pose and its
backpack downsample pickle), then runs ``chip_smoke.phase14`` with the same
checks, timings and kernel counters. Needs a card; prints its name and power
limit. For measuring a change to these paths without the other phases.
"""
from __future__ import annotations

import json
import os
import pickle
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from coma_tpu_torch.ops import build  # noqa: E402


def write_inputs(root: str, rng) -> dict:
    from coma_tpu_torch.models.smplx import SMPLXModel, star_pose_vertices
    from coma_tpu_torch.utils.colormap import jet_rgb
    from coma_tpu_torch.utils.ply import write_ply_pointcloud

    cs.write_smplx_npz(f"{root}/smplx.npz", rng)
    star = star_pose_vertices(SMPLXModel.from_npz(f"{root}/smplx.npz", device=cs.DEVICE))
    _, faces = cs.human_template()
    with open(f"{root}/smplx_star.pickle", "wb") as fh:
        pickle.dump(dict(vertices=star.cpu().numpy(), faces=faces), fh)
    np.save(f"{root}/human_contact.npy", rng.uniform(size=cs.H_FULL) ** 4)
    pts, normals = cs.backpack(rng, 180)
    write_ply_pointcloud(f"{root}/object_contact.ply", pts, normals=normals,
                         colors=jet_rgb(rng.uniform(size=180)))
    ijk = np.mgrid[0:cs.OCC_R, 0:cs.OCC_R, 0:cs.OCC_R] + 0.5
    blob = np.exp(-sum((ijk[a] - c) ** 2 for a, c in enumerate((15, 9, 18))) / 18.0)
    np.save(f"{root}/occupancy.npy", dict(prob_field=0.7 * blob / blob.max(),
                                          spatial_grid_metadata=dict(voxel_size=2.4 / cs.OCC_R)))
    verts, obj_faces = cs.backpack_mesh()
    with open(f"{root}/backpack_180.pickle", "wb") as fh:
        pickle.dump(dict(obj_vertices_original=verts, obj_faces_original=obj_faces), fh)
    products = {k: f"{root}/{name}" for k, name in (
        ("human_contact", "human_contact.npy"), ("object_contact", "object_contact.ply"),
        ("occupancy", "occupancy.npy"))}
    return dict(products=products, star=f"{root}/smplx_star.pickle",
                obj=f"{root}/backpack_180.pickle", npz=f"{root}/smplx.npz")


def main() -> int:
    if not torch.cuda.is_available():
        print("item14_torch: torch.cuda.is_available() is false; this script needs a card",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    label = cs.card_label()
    print(f"device: {torch.cuda.get_device_name(0)} ({label}), torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    build.build_all()
    print(f"built {', '.join(build.SOURCES)} in {time.perf_counter() - t0:.1f} s", flush=True)
    os.makedirs(cs.SCRATCH, exist_ok=True)
    inputs = tempfile.mkdtemp(prefix="item14_", dir=cs.SCRATCH)
    try:
        files = write_inputs(inputs, np.random.default_rng(cs.SEED + 16))
        out = cs.phase14(files["products"], files["star"], files["obj"], files["npz"], label)
    finally:
        shutil.rmtree(inputs, ignore_errors=True)
    print(json.dumps({part: {k: v for k, v in r.items() if k != "metrics"}
                      for part, r in out.items()}))
    print(f"phase 14 alone: {time.perf_counter() - t0:.1f} s [{label}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
