#!/usr/bin/env python3
"""Where the orientation product of ``coma_tpu`` and ``coma_tpu_torch`` parts
at a small learn_coma tree: a rounding tie, or a different summation order.

    python3 tools/orientation_bins.py [--V 16] [--n_good 4]

Builds ``tests/test_torch_learn_coma.py``'s tree at ``V`` body vertices and
``n_good`` surviving samples, runs both packages' ``learn_coma`` on the CPU
(JAX on its CPU platform), and for the ``qual:backpack_orientation`` product
prints: the largest difference of the product and its element; how far the
two packages' aggregated grids differ; how many of that element's 250 bins
round to another 1e-6 step (``p * n_bin`` before ``round``,
``coma_tpu/affordance/contact.py:257``); the distance of its ``p * n_bin`` to
the nearest tie; and, on one package's grid, how the two derivations' sums
(the normalisation and the entropy) differ.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import pickle
import shutil
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
KEY = "qual:backpack_orientation"


def run_tree(root: str, V: int, n_good: int) -> None:
    import torch

    import tests.test_torch_learn_coma as T
    from coma_tpu.cli import learn_coma as j_learn_coma
    from coma_tpu.models import smplx as j_smplx
    from coma_tpu_torch.cli import learn_coma as t_learn_coma

    T.V, T.N_GOOD = V, n_good
    T.write_tree(os.path.join(root, "src"))
    for name in ("jax", "port"):
        shutil.copytree(os.path.join(root, "src"), os.path.join(root, name))
    from_npz = j_smplx.SMPLXModel.from_npz

    def with_face_rows(path, **kwargs):     # as the test hands coma_tpu's save_obj its rows
        model = from_npz(path, **kwargs)
        return dataclasses.replace(model, faces=tuple(map(tuple, model.faces_array.tolist())))

    j_smplx.SMPLXModel.from_npz = staticmethod(with_face_rows)
    argv = ["--smplx_model_path", "smplx.npz", "--num_human_downsample_points_list", "16",
            "20000", "--obj_pth", "asset.obj", "--supercategory", T.SC, "--category", T.CAT,
            "--asset_id", T.ASSET]
    cwd = os.getcwd()
    try:
        os.chdir(os.path.join(root, "jax"))
        j_learn_coma.main(argv)
        os.chdir(os.path.join(root, "port"))
        torch.set_num_threads(2)
        t_learn_coma.main(argv + ["--device", "cpu"])
    finally:
        os.chdir(cwd)


def diagnose(root: str) -> None:
    import jax.numpy as jnp
    import torch

    from tests.test_torch_learn_coma import ASSET, CAT, PROMPT, SC

    rel = f"results/coma/extracted_coma/{SC}/{CAT}/{ASSET}/{KEY}:{PROMPT}.pickle"
    states = {}
    for name in ("jax", "port"):
        with open(os.path.join(root, name, rel), "rb") as fh:
            states[name] = pickle.load(fh)
    eps = float(states["jax"]["eps"])
    grids = {n: np.asarray(s["prob_grid_canon_human_wrt_obj"])[:, 0] for n, s in states.items()}

    def derive(lib, g):
        """(p * n_bin, the v1 score) as each package computes them."""
        if lib == "jax":
            x = jnp.asarray(g)
            scaled = x / (jnp.sum(x, axis=-1, keepdims=True) + eps) * 1e6
            p = jnp.round(scaled) / 1e6
            plogp = jnp.where(p == 0.0, 0.0, p * jnp.log(p))
            return np.asarray(scaled), np.asarray(jnp.sum(plogp, -1) / jnp.log(1e6) + 1.0)
        x = torch.as_tensor(np.array(g))
        scaled = x / (torch.sum(x, dim=-1, keepdim=True) + eps) * 1e6
        p = torch.round(scaled) / 1e6
        plogp = torch.where(p == 0.0, 0.0, p * torch.log(p))
        log_n = torch.log(torch.tensor(1e6, dtype=p.dtype))
        return scaled.numpy(), (torch.sum(plogp, -1) / log_n + 1.0).numpy()

    def product(score):
        return (score - score.min()) / (score.max() - score.min())

    sj, scj = derive("jax", grids["jax"])
    st, sct = derive("port", grids["port"])
    diff = np.abs(product(scj) - product(sct))
    k = int(np.argmax(diff))
    rel_grid = np.abs(grids["jax"] - grids["port"]) / np.maximum(np.abs(grids["jax"]), 1e-30)
    tie = np.abs(np.abs(sj[k] - np.floor(sj[k])) - 0.5)
    print(f"product: largest difference {diff[k]:.4g} at element {k} of {len(diff)}")
    print(f"aggregated grids: largest relative difference {rel_grid.max():.4g}")
    print(f"element {k}: {int((np.round(sj[k]) != np.round(st[k])).sum())} of {sj.shape[-1]} bins "
          f"round to another step; p*n_bin differs by up to {np.abs(sj[k] - st[k]).max():.4g}; "
          f"nearest tie {tie.min():.4g} away")
    for name in ("jax", "port"):
        a_scaled, a_score = derive("jax", grids[name])
        b_scaled, b_score = derive("port", grids[name])
        print(f"{name}'s grid through both derivations: p*n_bin up to "
              f"{np.abs(a_scaled - b_scaled).max():.4g} apart, "
              f"{int((np.round(a_scaled[k]) != np.round(b_scaled[k])).sum())} of element {k}'s "
              f"bins round differently, scores up to {np.abs(a_score - b_score).max():.4g} apart")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--V", type=int, default=16)
    ap.add_argument("--n_good", type=int, default=4)
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    root = tempfile.mkdtemp(prefix="orientation_bins_")
    try:
        run_tree(root, args.V, args.n_good)
        diagnose(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
