"""The numbers that decide `correct`, each read against the reference.

Frames: every sampled request's outputs, as they reached host memory,
against the reference's on the same frame and boxes.
  mesh_mm    the widest distance of a vertex or 3D joint, in mm;
  params_rel the widest gap of any other output, a row's largest |a - b|
             over that row's largest |b| (a row of zeros counts 1e-6).
Training: the first three steps against the reference's, and again
three late steps of the window (the same names with `late_` before them).
  loss_rel   the widest |loss - loss_ref| / |loss_ref| of the three;
  grad_leaf  the worst leaf's |‖g‖ - ‖g_ref‖| of the first gradient,
             over max(‖g_ref‖ of the leaf, the median leaf's);
  loss1_rel  the same of the first step alone;
  update_leaf the same of the parameters' change after three steps;
  update_median the median leaf's gap of that change.
A leaf whose reference gradient is under a thousandth of the median
leaf's (nought to rounding, as a bias before a softmax) is left out of
both leaf numbers. A missing output, a shape that differs or a value
that is not finite reads infinity."""

from __future__ import annotations

import math

import numpy as np

MESH_KEYS = ("smpl_vertices", "smpl_joints3d")
PARAM_KEYS = ("pred_pose", "pred_shape", "pred_cam", "var_pose", "smpl_joints2d",
              "pred_fullimg_cam_t")
LEAF_FLOOR = 1e-3   # of the median leaf's reference gradient norm


def _finite_or_inf(x: float) -> float:
    return x if math.isfinite(x) else math.inf


def frames_readings(served: list[dict], reference: list[dict]) -> dict[str, float]:
    mesh, params = 0.0, 0.0
    for got, want in zip(served, reference):
        for key in MESH_KEYS + PARAM_KEYS:
            if key not in want:
                continue
            a, b = got.get(key), np.asarray(want[key], np.float64)
            if a is None or np.shape(a) != b.shape:
                return {"mesh_mm": math.inf, "params_rel": math.inf}
            a = np.asarray(a, np.float64)
            if key in MESH_KEYS:
                mesh = max(mesh, _finite_or_inf(float(np.linalg.norm(a - b, axis=-1).max()) * 1e3))
            else:
                rows = len(b)
                gap = np.abs(a - b).reshape(rows, -1).max(1)
                scale = np.maximum(np.abs(b).reshape(rows, -1).max(1), 1e-6)
                params = max(params, _finite_or_inf(float((gap / scale).max())))
    if len(served) != len(reference):
        return {"mesh_mm": math.inf, "params_rel": math.inf}
    return {"mesh_mm": mesh, "params_rel": params}


def leaf_gap(program: dict[str, float], reference: dict[str, float], keep) -> float:
    """The worst leaf's |program - reference| over max(reference, the
    median kept leaf's reference), over the leaves in `keep`."""
    if not keep:
        return math.inf
    median = float(np.median([reference[k] for k in keep]))
    worst = max(abs(program.get(k, 0.0) - reference[k]) / max(reference[k], median) for k in keep)
    return _finite_or_inf(worst)


def kept_leaves(ref_grad_norms: dict[str, float]) -> list[str]:
    median = float(np.median(list(ref_grad_norms.values())))
    return [k for k, v in ref_grad_norms.items() if v >= LEAF_FLOOR * median]


def train_readings(losses: list[float], ref_losses: list[float],
                   grad: dict[str, float], ref_grad: dict[str, float],
                   update: dict[str, float], ref_update: dict[str, float]) -> dict[str, float]:
    if len(losses) != len(ref_losses) or not losses:
        gaps = [math.inf]
    else:
        gaps = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    keep = kept_leaves(ref_grad)
    return {
        "loss_rel": _finite_or_inf(max(gaps)),
        "loss1_rel": _finite_or_inf(gaps[0]),
        "grad_leaf": leaf_gap(grad, ref_grad, keep),
        "update_leaf": leaf_gap(update, ref_update, keep),
        "update_median": median_gap(update, ref_update, keep),
        "leaves_left_out": float(len(ref_grad) - len(keep)),
    }


def median_gap(program: dict[str, float], reference: dict[str, float], keep) -> float:
    """The median over the kept leaves of |program - reference| over
    max(reference, the median kept leaf's reference)."""
    if not keep:
        return math.inf
    median = float(np.median([reference[k] for k in keep]))
    gaps = [abs(program.get(k, 0.0) - reference[k]) / max(reference[k], median) for k in keep]
    return _finite_or_inf(float(np.median(gaps)))


def prefixed(prefix: str, readings: dict[str, float]) -> dict[str, float]:
    return {prefix + k: v for k, v in readings.items()}


def judge(readings: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """Each reading beside its limit; correct when every one is within."""
    checks = {k: {"value": readings.get(k, math.inf), "limit": limits[k]} for k in limits}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
