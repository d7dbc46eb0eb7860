"""Uncertainty post-processing: sigma -> per-joint / global confidence.

Reference contract: pocolib/utils/poco_utils.py:21-94 (prepare_uncert,
get_global_uncert, get_kinematic_uncert). numpy and scipy only: the
runner hands it the per-sample `var_pose` on the host (port of
`poco_tpu.eval.uncertainty`).
"""

from __future__ import annotations

import numpy as np
from scipy.special import gammaln

from ..constants import SMPL_PARENTS


def kinematic_uncert(var: np.ndarray) -> np.ndarray:
    """Accumulate uncertainty down the kinematic chain.

    Each child joint inherits its parent's (already accumulated)
    uncertainty (reference poco_utils.py:21-25). Processing joints in
    index order is valid because SMPL parents always precede children.

    Args:
        var: (B, 24) per-joint uncertainty.
    """
    var = np.array(var, copy=True)
    for j in range(1, var.shape[1]):
        parent = SMPL_PARENTS[j]
        if parent >= 0:
            var[:, j] += var[:, parent]
    return var


def prepare_uncert(
    var: np.ndarray,
    loss_ver: str = "norm_flow_res_gaus",
    kinematic: bool = False,
    return_conf: bool = False,
) -> np.ndarray:
    """Collapse raw head output to a (B, J) uncertainty per loss version.

    Reference: poco_utils.py:62-94 — (B,J,3,3) means over the rotation
    dims; `gauss_logsigma` exponentiates; `delta` uses alpha/gamma^2;
    genG variants use the Gamma-function moment ratio.
    """
    var = np.asarray(var, np.float64)
    if var.ndim == 4:
        var = var.mean(axis=(-1, -2))
    elif var.ndim == 3:
        var = var.mean(axis=-1)

    if loss_ver == "gauss_logsigma":
        var = np.exp(var)
    elif loss_ver == "delta":
        half = var.shape[1] // 2
        alpha, gamma = var[:, :half], var[:, half:]
        var = alpha / (gamma**2)
    elif loss_ver in ("genG", "mse_genG"):
        half = var.shape[1] // 2
        alpha, beta = var[:, :half], var[:, half:]
        var = (alpha**2) * np.exp(
            gammaln(3.0 / (beta + 1e-6)) - gammaln(1.0 / (beta + 1e-6))
        )
    elif loss_ver == "gauss_genG":
        third = var.shape[1] // 3
        var = var[:, :third]

    var = var.astype(np.float32)
    if kinematic:
        var = kinematic_uncert(var)
    if return_conf:
        var = 1.0 - var
    return var


def global_uncert(
    var: np.ndarray,
    backbone: str = "hrnet_w48_cls-cliff",
    sensitivity_threshold: float = 0.40,
) -> np.ndarray:
    """Scalar per-sample uncertainty for confidence-sorted rendering.

    Reference: poco_utils.py:50-60 — CLIFF models use the root (hips)
    uncertainty with a 2x sensitivity clamp, PARE models use the joint
    mean with a 1x clamp.

    Args:
        var: (B, 24) prepared uncertainty.
    Returns:
        (B,) global uncertainty in [0, 1].
    """
    var = np.array(var, copy=True)
    if "cliff" in backbone:
        var[var[:, 0] > 2 * sensitivity_threshold] = 1.0
        return var[:, 0]
    var[var[:, 0] > sensitivity_threshold] = 1.0
    return var.mean(axis=-1)
