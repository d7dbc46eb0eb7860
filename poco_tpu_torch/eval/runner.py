"""Evaluation: dataset -> per-sample metrics -> reports (port of
`poco_tpu.eval.runner`).

Replaces the reference's validation/test loop (pocolib/core/trainer.py:
298-465) and its offline pkl re-slicer (pocolib/utils/compute_error.py:
29-85):

  * the gendered GT meshes come from three SMPL forwards inside the eval
    step, on the device, instead of a torch SMPL per dataset item on the
    host (base_dataset.py:341-379); every SMPL forward on a CUDA device
    launches the skinning kernel;
  * Procrustes alignment is one batched SVD;
  * each batch goes to the device once and its per-sample metrics come
    back once;
  * over several processes (`parallel.distributed`) every process loads
    the whole batch, runs its contiguous rows of it (padded to a multiple
    of the process count) and gathers the per-sample metrics of all, so
    every process holds the one-process result.

Numbers are fp32 throughout; callers keep TF32 off for both cuBLAS and
cuDNN (`python -m poco_tpu_torch.cli.eval` does), as the JAX package runs
at `Precision.HIGHEST`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.profiler import record_function

from ..constants import (
    PW3D_OCCLUDED_SEQUENCES,
    PW3D_TEST_SEQUENCES,
    SMPL_J24_TO_COMMON_J14,
    SMPL_JOINT_NAMES,
)
from ..ops.preprocess import normalize_image
from ..ops.rotation import average_rotmats, axis_angle_to_rotmat, flip_pose_rotmat
from ..parallel import distributed
from ..parallel.mesh import pad_to_multiple
from ..smpl.lbs import SmplParams, smpl_forward
from ..train.step import best_model_metric
from .metrics import (
    joints_from_vertices,
    mpjpe,
    pa_mpjpe,
    uncert_error_correlation,
    vertex_error,
)
from .uncertainty import prepare_uncert


# the eval step's profiler ranges, in the order they run
EVAL_STAGES = ("eval_step/forward", "eval_step/flip_tta", "eval_step/gt_meshes",
               "eval_step/joints", "eval_step/metrics")


def make_gendered_eval_step(
    model,
    j_regressor_eval: torch.Tensor | None = None,
    flip_test: bool = False,
):
    """The eval step, with the gendered GT meshes made on the device.

    Args:
        model: a POCO module in eval mode (or any callable
            `model(batch, smpl)` that returns the same keys).
        j_regressor_eval: optional (17, V) H36M regressor on the model's
            device; without it the 14 common joints come from the SMPL
            skeleton.
        flip_test: horizontal-flip test-time augmentation: the mirrored
            crop runs through the same forward, its pose is un-flipped
            (`flip_pose_rotmat`), the two rotations are averaged on SO(3)
            (`average_rotmats`), the betas averaged, and one more SMPL pass
            gives the evaluated mesh.
    Returns:
        step(batch, smpl_n, smpl_m, smpl_f) -> dict of per-sample metric
        tensors (mpjpe, pa_mpjpe, v2v: (B,); with an uncertainty head also
        var_pose and pose_dist: (B, 24)). The batch holds the model's
        inputs plus pose (B, 72), betas (B, 10) and gender (B,) int
        (-1 neutral, 0 male, 1 female). SMPL forwards a batch: 5, or 4
        with the regressor; 2 more with flip_test.

    Each stage runs in a `torch.profiler.record_function` range named in
    `EVAL_STAGES` (free when no profiler runs), so a profile of the step
    splits its device time by stage.
    """
    if getattr(model, "training", False):
        raise ValueError("the eval step needs the model in eval mode (model.eval())")

    @torch.inference_mode()
    def step(batch: dict, smpl_n: SmplParams, smpl_m: SmplParams, smpl_f: SmplParams):
        with record_function("eval_step/forward"):
            out = model(batch, smpl_n)
        pred_verts = out["smpl_vertices"]
        pred_pose_eval = out["pred_pose"]
        pred_shape_eval = out["pred_shape"]

        if flip_test:
            with record_function("eval_step/flip_tta"):
                fb = dict(batch)
                fb["img"] = batch["img"].flip(2)  # NHWC: mirror the width
                if "bbox_info" in fb:
                    # CLIFF conditioning under a mirror: cx negates, cy and
                    # the scale term do not change (image_utils.py:174-187)
                    fb["bbox_info"] = fb["bbox_info"] * torch.tensor(
                        [-1.0, 1.0, 1.0], dtype=fb["bbox_info"].dtype,
                        device=fb["bbox_info"].device,
                    )
                if "center" in fb and "orig_shape" in fb:
                    # w - cx, as the JAX package (and so the reference)
                    # mirrors it; the discrete mirror of pixel centers is
                    # w - 1 - cx. Kept for parity.
                    w = fb["orig_shape"][:, 1]
                    fb["center"] = torch.stack([w - fb["center"][:, 0], fb["center"][:, 1]], dim=1)
                out_flip = model(fb, smpl_n)
                pred_pose_eval = average_rotmats(
                    out["pred_pose"], flip_pose_rotmat(out_flip["pred_pose"])
                )
                pred_shape_eval = 0.5 * (out["pred_shape"] + out_flip["pred_shape"])
                pred_verts = smpl_forward(smpl_n, pred_shape_eval, pred_pose_eval).vertices

        with record_function("eval_step/gt_meshes"):
            bsz = batch["pose"].shape[0]
            gt_rotmat = axis_angle_to_rotmat(
                batch["pose"].float().reshape(-1, 3)
            ).reshape(bsz, 24, 3, 3)
            betas = batch["betas"].float()
            out_n = smpl_forward(smpl_n, betas, gt_rotmat)
            out_m = smpl_forward(smpl_m, betas, gt_rotmat)
            out_f = smpl_forward(smpl_f, betas, gt_rotmat)
            # gender: -1 unknown -> neutral GT (datasets without a gender
            # field); 0 male, 1 female
            gender = batch["gender"].reshape(-1, 1, 1)

            def by_gender(f, m, n):
                return torch.where(gender == 1, f, torch.where(gender == 0, m, n))

            gt_verts = by_gender(out_f.vertices, out_m.vertices, out_n.vertices)
            gt_joints24 = by_gender(out_f.joints_lbs, out_m.joints_lbs, out_n.joints_lbs)

        with record_function("eval_step/joints"):
            if j_regressor_eval is not None:
                pred_j14 = joints_from_vertices(j_regressor_eval, pred_verts)
                gt_j14 = joints_from_vertices(j_regressor_eval, gt_verts)
            else:
                # No regressor: 14 LSP-ordered joints from the SMPL skeleton
                # (the GT meshes give skeleton joints only, so the
                # prediction takes one more SMPL pass), centered on the hip
                # midpoint (LSP positions 2 and 3).
                sel = torch.as_tensor(SMPL_J24_TO_COMMON_J14, device=gt_joints24.device)
                pred_j = smpl_forward(smpl_n, pred_shape_eval, pred_pose_eval).joints_lbs[:, sel]
                gt_j = gt_joints24[:, sel]
                pred_j14 = pred_j - (pred_j[:, 2:3] + pred_j[:, 3:4]) / 2.0
                gt_j14 = gt_j - (gt_j[:, 2:3] + gt_j[:, 3:4]) / 2.0

        with record_function("eval_step/metrics"):
            metrics = {
                "mpjpe": mpjpe(pred_j14, gt_j14),
                "pa_mpjpe": pa_mpjpe(pred_j14, gt_j14),
                # raw vertices, no alignment: the reference protocol
                # (eval_utils.py:104-118 compares unaligned meshes)
                "v2v": vertex_error(pred_verts, gt_verts),
            }
            if out.get("var_pose") is not None:
                metrics["var_pose"] = out["var_pose"]
                # Per-joint rotation distance, the x of the reference's
                # calibration Pearson (eval_utils.py:154-160), always from
                # the primary pass: sigma was trained to scale the
                # single-pass residual, even under flip_test.
                metrics["pose_dist"] = ((out["pred_pose"] - gt_rotmat) ** 2).mean(dim=(-1, -2))
        return metrics

    return step


@dataclasses.dataclass
class EvalResult:
    imgnames: list[str]
    mpjpe_mm: np.ndarray
    pa_mpjpe_mm: np.ndarray
    v2v_mm: np.ndarray
    uncert: np.ndarray | None = None
    pose_dist: np.ndarray | None = None  # (N, 24) per-joint rotmat MSE

    def summary(self) -> dict[str, float]:
        s = {
            "mpjpe": float(self.mpjpe_mm.mean()),
            "pa_mpjpe": float(self.pa_mpjpe_mm.mean()),
            "v2v": float(self.v2v_mm.mean()),
        }
        s["best_model_metric"] = best_model_metric(s["pa_mpjpe"], s["mpjpe"])
        if self.uncert is not None:
            per_sample_var = self.uncert.mean(axis=-1)

            def corr(a, b) -> float:
                # in float32, as the JAX package computes it
                return float(uncert_error_correlation(
                    torch.as_tensor(a, dtype=torch.float32),
                    torch.as_tensor(b, dtype=torch.float32),
                ))

            # per-sample mm-space correlation
            s["uncert_mpjpe_corr"] = corr(per_sample_var, self.mpjpe_mm)
            if self.pose_dist is not None and self.uncert.shape == self.pose_dist.shape:
                # the reference's calibration Pearson (trainer.py:380-383):
                # per-joint rotation distance against per-joint prepared
                # sigma, both flattened over (N, 24)
                s["uncert_pose_corr"] = corr(
                    self.uncert.reshape(-1), self.pose_dist.reshape(-1)
                )
            # Var-MPJPE (reference trainer.py:374-377): per-sample error
            # over predicted variance; low means accurate and confident
            s["val_var"] = float(per_sample_var.mean())
            s["mpjpe_var"] = float((self.mpjpe_mm / (per_sample_var + 1e-9)).mean())
        return s

    def per_joint_stats(self) -> dict | None:
        """Across-joint calibration diagnostics: per joint, the mean
        prepared sigma and mean rotation distance (the two vectors whose
        flattened Pearson is `uncert_pose_corr`), and each vector's
        coefficient of variation across joints (reference
        pocolib/utils/poco_utils.py:97-294 tracks the same quantities)."""
        if (
            self.uncert is None
            or self.pose_dist is None
            or self.uncert.shape != self.pose_dist.shape
        ):
            return None
        sig = self.uncert.mean(axis=0)
        err = self.pose_dist.mean(axis=0)

        def _cov(v: np.ndarray) -> float:
            m = float(v.mean())
            return float(v.std() / m) if m > 0 else float("nan")

        return {
            "joint_names": list(SMPL_JOINT_NAMES[: sig.shape[0]]),
            "sigma_mean": [round(float(x), 5) for x in sig],
            "pose_dist_mean": [round(float(x), 6) for x in err],
            "sigma_cov": round(_cov(sig), 4),
            "pose_dist_cov": round(_cov(err), 4),
        }


def _sample_names(host_batch: dict, n_valid: int, offset: int) -> list[str]:
    """Exactly n_valid names: the imgname list, else sample_index, else a
    running counter, so the names stay aligned with the metric arrays."""
    raw = host_batch.get("imgname")
    if raw is None:
        raw = host_batch.get("sample_index")
    if raw is None:
        raw = range(offset, offset + n_valid)
    names = [str(n) for n in list(raw)[:n_valid]]
    return names + [str(i) for i in range(offset + len(names), offset + n_valid)]


def run_eval(
    model,
    dataset,
    smpl_neutral: SmplParams,
    smpl_male: SmplParams | None = None,
    smpl_female: SmplParams | None = None,
    batch_size: int = 32,
    loss_ver: str = "norm_flow_res_gaus",
    j_regressor_eval: torch.Tensor | None = None,
    max_batches: int | None = None,
    flip_test: bool = False,
) -> EvalResult:
    """Evaluate a dataset on the model's device, in batches of
    `batch_size` (the last one short).

    The SMPLs and the regressor must lie on the model's device. Each
    batch's arrays go to it once, the image normalized there; string
    lists stay on the host. Over several processes each runs its share of
    every batch (collective: every process must call it).
    """
    from ..data.dataset import DataLoader

    world = distributed.data_count()
    device = next(model.parameters()).device
    smpl_male = smpl_male or smpl_neutral
    smpl_female = smpl_female or smpl_neutral
    step = make_gendered_eval_step(model, j_regressor_eval, flip_test=flip_test)
    loader = DataLoader(dataset, batch_size=batch_size, shuffle=False, drop_last=False)

    names: list[str] = []
    accum: dict[str, list[np.ndarray]] = {}
    for bi, host_batch in enumerate(loader):
        if max_batches is not None and bi >= max_batches:
            break
        n_valid = host_batch["pose"].shape[0]
        names.extend(_sample_names(host_batch, n_valid, len(names)))
        arrays = {k: np.asarray(v) for k, v in host_batch.items() if not isinstance(v, list)}
        if world > 1:
            arrays = {k: pad_to_multiple(v, world)[0] for k, v in arrays.items()}
            lo, hi = distributed.local_shard_bounds(len(arrays["pose"]))
            arrays = {k: v[lo:hi] for k, v in arrays.items()}
        batch = {
            k: torch.from_numpy(np.ascontiguousarray(v)).to(device, non_blocking=True)
            for k, v in arrays.items()
        }
        if "img" in batch:
            batch["img"] = normalize_image(batch["img"].float())
        metrics = step(batch, smpl_neutral, smpl_male, smpl_female)
        # one copy back a batch: the metrics packed side by side (and
        # gathered over processes, the padding rows dropped)
        rows = len(batch["pose"])
        widths = [v[0].numel() for v in metrics.values()]
        packed = torch.cat([v.reshape(rows, -1).float() for v in metrics.values()], 1)
        host = distributed.allgather(packed.cpu().numpy())[:n_valid]
        for (k, v), part in zip(metrics.items(), np.split(host, np.cumsum(widths)[:-1], 1)):
            accum.setdefault(k, []).append(part.reshape((n_valid, *v.shape[1:])))

    mpj = np.concatenate(accum["mpjpe"]) * 1000.0
    pa = np.concatenate(accum["pa_mpjpe"]) * 1000.0
    v2v = np.concatenate(accum["v2v"]) * 1000.0
    uncert = None
    if "var_pose" in accum:
        uncert = prepare_uncert(np.concatenate(accum["var_pose"]), loss_ver=loss_ver)
    pose_dist = np.concatenate(accum["pose_dist"]) if "pose_dist" in accum else None
    return EvalResult(
        imgnames=names, mpjpe_mm=mpj, pa_mpjpe_mm=pa, v2v_mm=v2v,
        uncert=uncert, pose_dist=pose_dist,
    )


def pw3d_split_report(
    imgnames: list[str],
    mpjpe_mm: np.ndarray,
    pa_mpjpe_mm: np.ndarray,
    v2v_mm: np.ndarray,
) -> dict[str, dict[str, float]]:
    """3DPW All / Test-sequences / Occluded-sequences report; membership
    by sequence-name substring of each image path (reference
    pocolib/utils/compute_error.py:29-85)."""
    imgnames = [str(n) for n in imgnames]

    def split(idx) -> dict[str, float]:
        return {
            "mpjpe": float(np.mean(mpjpe_mm[idx])),
            "pa_mpjpe": float(np.mean(pa_mpjpe_mm[idx])),
            "pve": float(np.mean(v2v_mm[idx])),
        }

    report = {"all": split(slice(None))}
    for name, seqs in (
        ("test_seq", PW3D_TEST_SEQUENCES),
        ("occluded_seq", PW3D_OCCLUDED_SEQUENCES),
    ):
        idx = np.asarray(
            [i for i, n in enumerate(imgnames) if any(s in n for s in seqs)], np.int64
        )
        if len(idx):
            report[name] = split(idx)
    return report
