"""SMPL model assets: pkl/npz readers and a synthetic test model.

Real SMPL weights are license-gated and not shipped. This module loads
them from the standard `.pkl` (chumpy arrays unpickled through a stub,
without chumpy) or from a plain `.npz`. `synthetic_smpl_model` builds a
structurally faithful model from a seed; it gives the same arrays as
`poco_tpu.smpl.assets.synthetic_smpl_model` for the same arguments.
"""

from __future__ import annotations

import io
import os
import pickle
from typing import Any

import numpy as np
import torch

from ..constants import (
    SMPL_NUM_BETAS,
    SMPL_NUM_JOINTS,
    SMPL_PARENTS,
    SMPL_VERTEX_JOINT_IDS,
)
from ..device import resolve_device
from .lbs import SmplParams

NUM_EXTRA_JOINTS = 9  # J_regressor_extra rows (49-joint convention)


class _ChumpyStubUnpickler(pickle.Unpickler):
    """Unpickle SMPL pkl files without chumpy installed."""

    def find_class(self, module: str, name: str) -> Any:
        if module.startswith("chumpy"):
            return _ChArray
        if module == "scipy.sparse.csc" and name == "csc_matrix":
            from scipy.sparse import csc_matrix

            return csc_matrix
        return super().find_class(module, name)


class _ChArray(np.ndarray):
    """Stand-in for chumpy.Ch: the data lives in the ndarray base."""

    def __setstate__(self, state):
        if not isinstance(state, dict):  # chumpy pickles a dict state
            super().__setstate__(state)


def _to_np(x: Any) -> np.ndarray:
    if hasattr(x, "todense"):  # scipy sparse matrix
        return np.asarray(x.todense())
    return np.asarray(x)


def load_smpl_pkl(path: str) -> dict[str, Any]:
    """Load a standard SMPL .pkl into plain numpy arrays."""
    with open(path, "rb") as f:
        data = _ChumpyStubUnpickler(io.BytesIO(f.read()), encoding="latin1").load()
    return {
        k: v if isinstance(v, (str, int, float)) else _to_np(v)
        for k, v in data.items()
    }


def _params(arrays: dict[str, np.ndarray], parents, vertex_ids, device) -> SmplParams:
    device = resolve_device(device)
    tensors = {
        k: torch.as_tensor(np.ascontiguousarray(v)).to(device)
        for k, v in arrays.items()
    }
    return SmplParams(
        **tensors,
        parents=tuple(int(x) for x in parents),
        vertex_joint_ids=tuple(int(x) for x in vertex_ids),
    )


def _params_from_dict(
    d: dict[str, Any], j_regressor_extra: np.ndarray | None, device
) -> SmplParams:
    v_template = np.asarray(d["v_template"], np.float32)
    num_verts = v_template.shape[0]
    posedirs = np.asarray(d["posedirs"], np.float32)
    if posedirs.ndim == 3:  # (V, 3, 207) -> (207, V*3)
        posedirs = posedirs.reshape(num_verts * 3, -1).T
    parents = d.get("kintree_table")
    if parents is not None:
        parents = np.asarray(parents)[0].astype(np.int64)
        parents[0] = -1
    else:
        parents = SMPL_PARENTS
    if j_regressor_extra is None:
        j_regressor_extra = np.zeros((NUM_EXTRA_JOINTS, num_verts), np.float32)
    vids = (
        SMPL_VERTEX_JOINT_IDS
        if num_verts > SMPL_VERTEX_JOINT_IDS.max()
        else SMPL_VERTEX_JOINT_IDS % num_verts
    )
    arrays = {
        "v_template": v_template,
        "shapedirs": np.asarray(d["shapedirs"], np.float32)[..., :SMPL_NUM_BETAS],
        "posedirs": posedirs,
        "j_regressor": np.asarray(_to_np(d["J_regressor"]), np.float32),
        "lbs_weights": np.asarray(d["weights"], np.float32),
        "j_regressor_extra": np.asarray(j_regressor_extra, np.float32),
        "faces": np.asarray(d.get("f", np.zeros((0, 3))), np.int32),
    }
    return _params(arrays, parents, vids, device)


def load_smpl_model(
    model_path: str, extra_regressor_path: str | None = None, device="cuda"
) -> SmplParams:
    """Load SMPL weights from .pkl or .npz, plus the (9, V) extra-joint
    regressor npy (the reference's J_regressor_extra)."""
    if model_path.endswith(".npz"):
        d = dict(np.load(model_path, allow_pickle=True))
    else:
        d = load_smpl_pkl(model_path)
    extra = None
    if extra_regressor_path and os.path.exists(extra_regressor_path):
        extra = np.load(extra_regressor_path).astype(np.float32)
    return _params_from_dict(d, extra, device)


def synthetic_smpl_model(
    num_verts: int = 432,
    num_betas: int = SMPL_NUM_BETAS,
    seed: int = 0,
    device="cuda",
) -> SmplParams:
    """Deterministic structurally valid SMPL model for tests and benches:
    a real kinematic tree, row-normalized regressors, softmax skinning
    weights and small blendshapes, drawn from `seed`."""
    rng = np.random.RandomState(seed)
    v_template = rng.uniform(-1.0, 1.0, (num_verts, 3)).astype(np.float32)
    shapedirs = (0.03 * rng.randn(num_verts, 3, num_betas)).astype(np.float32)
    posedirs = (0.01 * rng.randn(207, num_verts * 3)).astype(np.float32)

    j_reg = rng.rand(SMPL_NUM_JOINTS, num_verts).astype(np.float32) ** 4
    j_reg /= j_reg.sum(axis=1, keepdims=True)

    w = rng.randn(num_verts, SMPL_NUM_JOINTS).astype(np.float32) * 2.0
    w = np.exp(w - w.max(axis=1, keepdims=True))
    w /= w.sum(axis=1, keepdims=True)

    extra = rng.rand(NUM_EXTRA_JOINTS, num_verts).astype(np.float32) ** 4
    extra /= extra.sum(axis=1, keepdims=True)

    faces = rng.randint(0, num_verts, (2 * num_verts, 3)).astype(np.int32)

    arrays = {
        "v_template": v_template,
        "shapedirs": shapedirs,
        "posedirs": posedirs,
        "j_regressor": j_reg,
        "lbs_weights": w,
        "j_regressor_extra": extra,
        "faces": faces,
    }
    return _params(
        arrays, SMPL_PARENTS, SMPL_VERTEX_JOINT_IDS % num_verts, device
    )


def resolve_smpl_params(
    model_dir: str | None = None, gender: str = "neutral", device="cuda"
) -> SmplParams:
    """Real SMPL weights if found, else the synthetic test model.

    Looks for `SMPL_{GENDER}.{npz,pkl}` (and the other standard names)
    under `model_dir` or the `POCO_TPU_SMPL_DIR` environment variable. A
    missing gendered model falls back to the neutral one, never to the
    synthetic geometry.
    """
    model_dir = model_dir or os.environ.get("POCO_TPU_SMPL_DIR", "")

    def _find(g: str) -> str | None:
        for ext in ("npz", "pkl"):
            for name in (
                f"SMPL_{g.upper()}.{ext}",
                f"smpl_{g.lower()}.{ext}",
                f"basicmodel_{g[0].lower()}_lbs_10_207_0_v1.1.0.{ext}",
            ):
                path = os.path.join(model_dir, name)
                if os.path.exists(path):
                    return path
        return None

    if model_dir:
        path = _find(gender)
        if path is None and gender != "neutral":
            path = _find("neutral")
            if path is not None:
                print(
                    f"SMPL {gender} model not found in {model_dir}; "
                    "using the neutral model for gendered GT"
                )
        if path is not None:
            extra = os.path.join(model_dir, "J_regressor_extra.npy")
            return load_smpl_model(path, extra, device)
        print(
            f"no SMPL weights found in {model_dir}; using the SYNTHETIC "
            "test model — metrics will not be meaningful"
        )
    return synthetic_smpl_model(device=device)
