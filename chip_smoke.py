#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--reps 20]

Phases, each of which raises (exit code 1) on failure:
  1. environment: torch/CUDA versions, the card's name and power limit,
     and the card's peak rates from NVIDIA's data sheet (an unknown card
     raises); TF32 is switched off for matmuls and convolutions;
  2. build every CUDA kernel of the port from `poco_tpu_torch/csrc/`
     (nvcc, in parallel), printing the `-Xptxas -v` report;
  3. kernel check: the skinning kernel (`skinning`, 3xTF32 tensor cores)
     and its fp32-FMA yardstick (`skinning_simt`) against the plain torch
     version on the card, at the main path's shapes (B = 1, 8, 128 at
     V=6890) and a ragged one;
  4. main path at full width: POCO-CLIFF (HRNet-W48-cls, configs/
     poco_cliff.yaml) with seeded random weights and a V=6890 synthetic
     SMPL answers `detect_forward` requests of 1, 8 and 128 boxes on a
     720x1280 image; `skinning` must launch once per request and
     `skinning_simt` never; a 2-box request is held against the same
     weights on the CPU;
  4b. POCO-PARE (HRNet-W32, PARE head, feat-pose uncertainty, 3-layer
     flow; configs/poco_pare.yaml) the same way: requests of 1, 8 and 128
     boxes, launches, shapes, card against CPU (the vertices against the
     CPU's float64 forward, see `vertices_gate`);
  4c. the flow head: `model(batch, smpl)` with a GT pose at B=128 for both
     POCO models gives a finite (B, 24) `log_phi`; card against CPU at B=2;
  4d. the HMR baseline (ResNet-50, configs/spin_hmr.yaml): one 8-box
     request, launches, shapes, card against CPU (the vertices as in 4b);
  5. crops/s at batch 128, fp32: POCO-CLIFF with the kernel and, in turns,
     with the plain skinning in its place (the yardstick); POCO-PARE with
     the kernel;
  6. a torch.profiler trace of 128-crop requests of POCO-CLIFF and of
     POCO-PARE: device busy and idle share, the skinning kernel's share,
     the top device kernels; and the SMPL stage alone with the kernel and
     with the plain skinning;
  7. kernel timing, last (after CUDA-graph capture the eager launches of
     phases 5 and 6 would run slower): both kernels at phase 3's shapes,
     in turns, from CUDA events around CUDA-graph replays, with the
     inputs hot in L2 and cold (rotating over sets larger than L2),
     beside the card's bound for the same work.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Without a CUDA device it exits 1 and
prints no result.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from poco_tpu_torch.config import model_config_from_hparams, update_hparams
from poco_tpu_torch.constants import IMG_NORM_STD
from poco_tpu_torch.demo.tester import detect_forward
from poco_tpu_torch.models.poco import build_hmr, build_poco_cliff, build_poco_pare
from poco_tpu_torch.ops import kernels
from poco_tpu_torch.ops.preprocess import preprocess_crops
from poco_tpu_torch.ops.rotation import axis_angle_to_rotmat
from poco_tpu_torch.ops.skinning import skinning, skinning_reference, skinning_simt
from poco_tpu_torch.smpl import lbs as lbs_module
from poco_tpu_torch.smpl.assets import synthetic_smpl_model
from poco_tpu_torch.smpl.lbs import smpl_forward
from poco_tpu_torch.utils.weights import calibrate_batchnorm, randomize_batchnorm

REPO = Path(__file__).resolve().parent


@dataclasses.dataclass(frozen=True)
class Peaks:
    """Published peaks of one card at its full power limit, dense rates."""

    bytes_per_s: float      # device memory
    fp32_flop_per_s: float  # fp32 outside the tensor cores
    tf32_flop_per_s: float  # TF32 on the tensor cores


# NVIDIA's data sheets, keyed by the name nvidia-smi prints (sparse
# tensor rates halved to dense). A card not listed raises.
PEAKS = {
    "NVIDIA H100 80GB HBM3": Peaks(3.35e12, 67e12, 495e12),  # H100 SXM
    "NVIDIA H100 PCIe": Peaks(2.0e12, 51e12, 378e12),
    "NVIDIA H100 NVL": Peaks(3.9e12, 60e12, 417.5e12),
    "NVIDIA H200": Peaks(4.8e12, 67e12, 494.5e12),  # H200 SXM
}

SKIN_TOL = 1e-4       # kernel vs plain, fp32 sums in another order
HEAD_TOL = 2e-3       # pred_cam / pred_shape / var_pose, card vs CPU
METERS_TOL = 1e-4     # joints3d / vertices, card vs CPU (0.1 mm budget)
GOLDEN_TOL = 5e-4     # vertices, the 0.5 mm golden-gate budget (BASELINE.md)
CROP_TOL = 0.1        # crop pixels, card vs CPU, in grey levels (see card_vs_cpu)
LOG_PHI_ATOL, LOG_PHI_RTOL = 2e-3, 1e-4   # flow log-likelihood, card vs CPU


def check(ok: bool, message: str) -> None:
    if not ok:
        raise RuntimeError(message)


def cuda_ms(fn, iters: int, warmup: int = 10) -> float:
    """Mean device time of one call, from CUDA events over `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def card_peaks(name: str) -> Peaks:
    if name not in PEAKS:
        raise RuntimeError(
            f"no published peaks for {name!r}: add its data sheet figures to "
            f"PEAKS (known: {sorted(PEAKS)})"
        )
    return PEAKS[name]


def phase_environment() -> tuple[str, Peaks]:
    print("== 1. environment")
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  devices {torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else (
        f"{torch.cuda.get_device_name(0)}, power limit not read"
    )
    peaks = card_peaks(card.split(",")[0].strip())
    print(f"card: {card}; peaks used: {peaks.bytes_per_s / 1e12:g} TB/s, "
          f"fp32 {peaks.fp32_flop_per_s / 1e12:g} TFLOP/s, "
          f"TF32 {peaks.tf32_flop_per_s / 1e12:g} TFLOP/s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: matmul.allow_tf32=False cudnn.allow_tf32=False")
    return card, peaks


def phase_build() -> None:
    print("== 2. build")
    start = time.perf_counter()
    reports = kernels.build()
    print(f"built {sorted(reports)} in {time.perf_counter() - start:.2f} s "
          f"(nvcc {kernels.nvcc_path()})")
    for name, rep in reports.items():
        print(f"-- {name}: {rep['seconds']:.2f} s\n{rep['log'].strip()}")


def skinning_inputs(batch: int, num_verts: int, seed: int):
    rng = np.random.RandomState(seed)
    w = rng.randn(num_verts, 24).astype(np.float32) * 2.0
    w = np.exp(w - w.max(axis=1, keepdims=True))
    w /= w.sum(axis=1, keepdims=True)
    tfms = np.broadcast_to(np.eye(4, dtype=np.float32), (batch, 24, 4, 4)).copy()
    aa = torch.from_numpy((0.5 * rng.randn(batch * 24, 3)).astype(np.float32))
    tfms[:, :, :3, :3] = axis_angle_to_rotmat(aa).numpy().reshape(batch, 24, 3, 3)
    tfms[:, :, :3, 3] = 0.2 * rng.randn(batch, 24, 3)
    vp = rng.randn(batch, num_verts, 3).astype(np.float32)
    return [torch.from_numpy(a).cuda() for a in (w, tfms, vp)]


def skinning_bytes(batch: int, num_verts: int) -> int:
    """W, the transforms and v_posed read once, out written once."""
    return 4 * (num_verts * 24 + batch * 24 * 16 + 2 * batch * num_verts * 3)


def skinning_bound(batch: int, num_verts: int, peaks: Peaks) -> dict:
    """Least time for the work: bytes once each way against operations on
    the fastest engine that keeps fp32 accuracy, the tensor cores with a
    3xTF32 split (three TF32 products of the 24 x 12 blend) plus the
    affine in fp32. `fp32_fma_ms` is the blend and affine all in fp32 FMA,
    the operation bound of the fp32-FMA kernel."""
    t_bytes = skinning_bytes(batch, num_verts) / peaks.bytes_per_s * 1e3
    t_ops = (3 * 2 * 24 * 12 * batch * num_verts / peaks.tf32_flop_per_s
             + 18 * batch * num_verts / peaks.fp32_flop_per_s) * 1e3
    t_fma = (24 * 12 * 2 + 18) * batch * num_verts / peaks.fp32_flop_per_s * 1e3
    return {
        "ms": max(t_bytes, t_ops),
        "by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes_ms": t_bytes,
        "ops_ms": t_ops,
        "fp32_fma_ms": t_fma,
    }


def cold_sets(args, l2_bytes: int = 50 * 2**20):
    """Copies of one input set at distinct addresses, at least 4 and more
    than twice the L2 in all, so that none is in L2 when its turn comes."""
    batch, num_verts = args[2].shape[:2]
    n = max(4, math.ceil(2 * l2_bytes / skinning_bytes(batch, num_verts)))
    return [[a.clone() for a in args] for _ in range(n)]


def graph_ms(fn, arg_sets, replays: int, keep_outputs: bool) -> float:
    """Mean device time of one call of `fn`, from CUDA events around
    replays of a CUDA graph that holds one call for each input set in
    turn, so that the host's cost of a launch is not counted (the gaps
    between the graph's kernels are). With `keep_outputs` every call
    writes a fresh output, so no call finds its output in L2."""
    fn(*arg_sets[0])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    outs = []
    with torch.cuda.graph(graph):
        for a in arg_sets:
            out = fn(*a)
            if keep_outputs:
                outs.append(out)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del out, outs, graph
    return start.elapsed_time(end) / (replays * len(arg_sets))


def hot_ms(fn, args, calls: int = 200) -> float:
    """Device time of one call on inputs that stay in L2."""
    return graph_ms(fn, [args] * 20, replays=calls // 20, keep_outputs=False)


def cold_ms(fn, sets, calls: int = 40) -> float:
    """Device time of one call on inputs and outputs that are not in L2."""
    return graph_ms(fn, sets, replays=max(1, calls // len(sets)), keep_outputs=True)


SKIN_SHAPES = ((128, 6890), (8, 6890), (1, 6890), (3, 1001))


KERNELS_UNDER_TEST = {"v2": skinning, "v1": skinning_simt}


def phase_kernel_check() -> dict[str, float]:
    """`skinning` (v2) and `skinning_simt` (v1) against the plain version
    at each shape; returns each one's largest error."""
    print("== 3. kernel check")
    worst = {label: 0.0 for label in KERNELS_UNDER_TEST}
    for batch, num_verts in SKIN_SHAPES:
        args = skinning_inputs(batch, num_verts, seed=batch + num_verts)
        ref = skinning_reference(*args)
        for label, fn in KERNELS_UNDER_TEST.items():
            out = fn(*args)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            print(f"skinning {label} B={batch} V={num_verts}: max_abs_err "
                  f"{err:.3e} (tolerance {SKIN_TOL}, rtol 0)")
            check(err <= SKIN_TOL, f"skinning {label} disagrees with its plain version: {err}")
            worst[label] = max(worst[label], err)
    return worst


def phase_kernel_timing(peaks: Peaks) -> dict:
    """v2 and v1 timed hot and cold at each shape, in turns v2, v1, v1,
    v2, beside the bound. It runs last: once a CUDA graph has been
    captured, the process's eager launches run slower (a 128-crop request
    about 2% longer on an H100), so phases 5 and 6 must come first."""
    print("== 7. kernel timing")
    times = None
    for batch, num_verts in SKIN_SHAPES:
        args = skinning_inputs(batch, num_verts, seed=batch + num_verts)
        sets = cold_sets(args)
        hot = {k: [] for k in KERNELS_UNDER_TEST}
        cold = {k: [] for k in KERNELS_UNDER_TEST}
        for label in ("v2", "v1", "v1", "v2"):
            fn = KERNELS_UNDER_TEST[label]
            hot[label].append(hot_ms(fn, args))
            cold[label].append(cold_ms(fn, sets))
        plain_hot = hot_ms(skinning_reference, args, calls=40)
        plain_cold = cold_ms(skinning_reference, sets, calls=len(sets))
        del sets
        bound = skinning_bound(batch, num_verts, peaks)
        print(f"skinning B={batch} V={num_verts}: bound {bound['ms']:.5f} ms "
              f"({bound['by']}: bytes {bound['bytes_ms']:.5f}, 3xTF32 + fp32 affine "
              f"{bound['ops_ms']:.5f}; fp32 FMA alone {bound['fp32_fma_ms']:.5f})")
        for label in KERNELS_UNDER_TEST:
            for kind, ts in (("hot", hot[label]), ("cold", cold[label])):
                mean = statistics.fmean(ts)
                print(f"  {label} {kind:4s} {mean:.5f} ms (turns {ts[0]:.5f}, "
                      f"{ts[1]:.5f}) = {bound['ms'] / mean:.3f} of bound")
        print(f"  plain hot {plain_hot:.5f} ms, cold {plain_cold:.5f} ms; "
              "no single PyTorch call computes it")
        if times is None:  # the main path's largest request
            times = {
                "ms": statistics.fmean(hot["v2"]),
                "cold_ms": statistics.fmean(cold["v2"]),
                "earlier_ms": statistics.fmean(hot["v1"]),
                "earlier_cold_ms": statistics.fmean(cold["v1"]),
                "plain_ms": plain_hot,
                "bound_ms": bound["ms"],
                "bound_by": bound["by"],
            }
    return times


def random_boxes(rng, n: int, h: int, w: int):
    centers = np.stack(
        [rng.uniform(100, w - 100, n), rng.uniform(100, h - 100, n)], axis=1
    ).astype(np.float32)
    scales = rng.uniform(0.8, 3.0, n).astype(np.float32)
    return centers, scales


def max_point_dist(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.norm(a.cpu() - b.cpu(), dim=-1).max())


def calibrated_model(build, config: Path, seed: int, device, crops: torch.Tensor):
    """`build` on `device` with the config's settings and seeded weights;
    every BN layer randomized, then pinned to the statistics of `crops`
    (the head's too, where it has BN layers)."""
    cfg = model_config_from_hparams(update_hparams(str(config)))
    torch.manual_seed(seed)
    model = build(device=device, **dataclasses.asdict(cfg))
    randomize_batchnorm(model, torch.Generator().manual_seed(seed + 1))
    crops = crops.to(device)
    calibrate_batchnorm(model.backbone, crops)
    if any(isinstance(m, torch.nn.BatchNorm2d) for m in model.head.modules()):
        with torch.no_grad():
            calibrate_batchnorm(model.head, model.backbone(crops))
    return model


def request_crops(image, centers, scales, device="cuda") -> dict:
    return preprocess_crops(
        torch.from_numpy(image).to(device), torch.from_numpy(centers).to(device),
        torch.from_numpy(scales).to(device),
    )


def check_shapes(out: dict, n: int, extra: dict) -> None:
    expect = {
        "pred_pose": (n, 24, 3, 3), "pred_shape": (n, 10), "pred_cam": (n, 3),
        "smpl_vertices": (n, 6890, 3), "smpl_joints3d": (n, 49, 3),
        "smpl_joints2d": (n, 49, 2), **extra,
    }
    for key, shape in expect.items():
        check(tuple(out[key].shape) == shape, f"{key}: {tuple(out[key].shape)}")
        check(bool(torch.isfinite(out[key]).all()), f"{key}: not finite")


def drive_requests(label: str, model, smpl, image, requests) -> tuple[int, list]:
    """The main path: `detect_forward` once per request, with the kernels'
    counts set to 0 just before and read just after."""
    skinning.launches = skinning_simt.launches = 0
    outputs = [detect_forward(model, smpl, image, c, s) for c, s in requests]
    torch.cuda.synchronize()
    launches = skinning.launches
    print(f"{label} requests {[len(c) for c, _ in requests]}: skinning launches "
          f"{launches}, skinning_simt launches {skinning_simt.launches}")
    check(launches == len(requests), f"{label}: skinning must launch once per request")
    check(skinning_simt.launches == 0, f"{label}: the yardstick kernel ran on the main path")
    return launches, outputs


def fp64_forward(model, smpl, batch: dict) -> dict:
    """The model in float64 on the CPU, on the same float32 crops."""
    model64 = copy.deepcopy(model).cpu().double()
    smpl64 = dataclasses.replace(smpl.to("cpu"), **{
        f.name: getattr(smpl, f.name).cpu().double() for f in dataclasses.fields(smpl)
        if torch.is_tensor(getattr(smpl, f.name)) and getattr(smpl, f.name).is_floating_point()
    })
    with torch.inference_mode():
        return model64({k: v.cpu().double() for k, v in batch.items()}, smpl64)


def vertices_gate(label: str, on_card, on_cpu, truth) -> None:
    """Vertices against the float64 forward on the same crops: one fp32
    forward sits up to about 1e-4 m from its float64 forward here (PARE's
    random part attention and 6D decoder carry fp32 reassociation noise to
    the vertices), so two fp32 forwards cannot be held to 0.1 mm of each
    other. The card must lie within max(0.1 mm, 3 x the CPU's fp32
    distance) of the float64 truth, and within the 0.5 mm golden-gate
    budget (the JAX package's own PARE gate,
    tests/test_fullwidth_parity.py:105-134)."""
    card = max_point_dist(on_card, truth)
    cpu = max_point_dist(on_cpu, truth)
    limit = min(max(METERS_TOL, 3.0 * cpu), GOLDEN_TOL)
    print(f"{label} smpl_vertices on the card's crops: from the float64 forward card "
          f"{card:.3e} m, CPU fp32 {cpu:.3e} m (tolerance {limit:.3e} m)")
    check(card <= limit, f"{label} smpl_vertices: {card} m from the float64 forward")


def card_vs_cpu(label, model, build, smpl, image, centers, scales, head_keys,
                vertices_vs_fp64: bool = False) -> None:
    """The same weights and request on the CPU: head outputs within
    HEAD_TOL, joints3d (and vertices) within METERS_TOL.

    With `vertices_vs_fp64` (POCO-PARE, HMR) the vertices are held apart
    from the crop: the card's crop gather rounds its bilinear weights
    otherwise than the CPU's (sample coordinates near 1e3 px carry ~1e-4
    px of fp32 rounding, a few hundredths of a grey level), and these
    random models carry that input difference to ~1e-4 m at the
    vertices. So the crops are compared on their own (within CROP_TOL
    grey levels), and the model's vertices on the card's crops go to
    `vertices_gate`."""
    cpu_model = build(device="cpu", **dataclasses.asdict(model.cfg))
    cpu_model.load_state_dict(model.state_dict())
    on_card = detect_forward(model, smpl, image, centers, scales)
    cpu_smpl = smpl.to("cpu")
    on_cpu = detect_forward(cpu_model, cpu_smpl, image, centers, scales)
    for key in head_keys:
        err = float((on_card[key].cpu() - on_cpu[key]).abs().max())
        print(f"{label} card vs cpu {key}: max_abs_err {err:.3e} (tolerance {HEAD_TOL})")
        check(err <= HEAD_TOL, f"{label} {key}: card and CPU disagree by {err}")
    for key in ("smpl_joints3d",) if vertices_vs_fp64 else ("smpl_joints3d", "smpl_vertices"):
        dist = max_point_dist(on_card[key], on_cpu[key])
        print(f"{label} card vs cpu {key}: max distance {dist:.3e} m (tolerance {METERS_TOL})")
        check(dist <= METERS_TOL, f"{label} {key}: card and CPU disagree by {dist} m")
    if not vertices_vs_fp64:
        return
    card_crops = {k: v.cpu() for k, v in request_crops(image, centers, scales).items()}
    cpu_crops = request_crops(image, centers, scales, "cpu")
    grey = float((card_crops["img"] - cpu_crops["img"]).abs().max()) * 255 * max(IMG_NORM_STD)
    print(f"{label} card vs cpu crops: max difference {grey:.4f} grey levels "
          f"(tolerance {CROP_TOL}); whole request smpl_vertices "
          f"{max_point_dist(on_card['smpl_vertices'], on_cpu['smpl_vertices']):.3e} m apart")
    check(grey <= CROP_TOL, f"{label}: card and CPU crops disagree by {grey} grey levels")
    truth = fp64_forward(cpu_model, cpu_smpl, card_crops)
    with torch.inference_mode():
        cpu_fp32 = cpu_model(card_crops, cpu_smpl)
    vertices_gate(label, on_card["smpl_vertices"].cpu(), cpu_fp32["smpl_vertices"],
                  truth["smpl_vertices"].float())


def phase_main_path(seed: int) -> dict:
    print("== 4. main path: POCO-CLIFF detect_forward at full width")
    rng = np.random.RandomState(seed)
    h, w = 720, 1280
    image = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    centers, scales = random_boxes(rng, 16, h, w)
    with torch.no_grad():
        calib = request_crops(image, centers, scales)["img"].permute(0, 3, 1, 2)
    model = calibrated_model(build_poco_cliff, REPO / "configs/poco_cliff.yaml", seed,
                             "cuda", calib)
    print(f"config: {model.cfg}")
    smpl = synthetic_smpl_model(num_verts=6890, seed=seed, device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {n_params} parameters; SMPL V={smpl.v_template.shape[0]}")

    requests = [random_boxes(rng, n, h, w) for n in (1, 8, 128)]
    launches, outputs = drive_requests("cliff", model, smpl, image, requests)
    for (c, _), out in zip(requests, outputs):
        n = len(c)
        check_shapes(out, n, {"pred_fullimg_cam_t": (n, 3), "var_pose": (n, 24)})

    c2, s2 = random_boxes(rng, 2, h, w)
    card_vs_cpu("cliff", model, build_poco_cliff, smpl, image, c2, s2,
                ("pred_cam", "pred_shape", "var_pose"))
    return {"launches": launches, "model": model, "smpl": smpl, "image": image,
            "request": requests[-1], "calib": calib, "rng": rng}


def phase_pare(ctx: dict, seed: int) -> dict:
    print("== 4b. POCO-PARE detect_forward at full width")
    model = calibrated_model(build_poco_pare, REPO / "configs/poco_pare.yaml", seed + 2,
                             "cuda", ctx["calib"])
    print(f"config: {model.cfg}")
    print(f"model: {sum(p.numel() for p in model.parameters())} parameters")
    rng, (h, w) = ctx["rng"], ctx["image"].shape[:2]
    requests = [random_boxes(rng, n, h, w) for n in (1, 8, 128)]
    launches, outputs = drive_requests("pare", model, ctx["smpl"], ctx["image"], requests)
    for (c, _), out in zip(requests, outputs):
        n = len(c)
        check_shapes(out, n, {"var_pose": (n, 24), "pred_segm_mask": (n, 25, 56, 56),
                              "uncert_feat": (n, 24 * 128)})
        check("pred_fullimg_cam_t" not in out, "pare: a full-image camera was emitted")
    c2, s2 = random_boxes(rng, 2, h, w)
    card_vs_cpu("pare", model, build_poco_pare, ctx["smpl"], ctx["image"], c2, s2,
                ("pred_cam", "pred_shape", "var_pose"), vertices_vs_fp64=True)
    return {"launches": launches, "model": model, "request": requests[-1]}


def gt_batch(image, centers, scales, rng, device) -> dict:
    """A request's crops with a seeded GT pose and GT_POSE_COND mask."""
    n = len(centers)
    batch = request_crops(image, centers, scales, device)
    aa = torch.from_numpy((0.3 * rng.randn(n, 24, 3)).astype(np.float32))
    batch["gt_pose_rotmat"] = axis_angle_to_rotmat(aa).to(device)
    batch["gt_pose_cond_mask"] = torch.from_numpy(rng.rand(n) < 0.5).to(device)
    return batch


def phase_flow(ctx: dict, pare: dict, seed: int) -> int:
    """log_phi with a GT pose at B=128 on the card (both POCO models),
    and card against CPU at B=2. Returns the skinning launches."""
    print("== 4c. flow head: log_phi with a GT pose")
    rng, image, smpl = np.random.RandomState(seed + 3), ctx["image"], ctx["smpl"]
    h, w = image.shape[:2]
    big = gt_batch(image, *random_boxes(rng, 128, h, w), rng, "cuda")
    small = gt_batch(image, *random_boxes(rng, 2, h, w), rng, "cpu")
    launches = 0
    for label, model, build in (("cliff", ctx["model"], build_poco_cliff),
                                ("pare", pare["model"], build_poco_pare)):
        skinning.launches = 0
        with torch.inference_mode():
            out = model(big, smpl)
        torch.cuda.synchronize()
        launches += skinning.launches
        log_phi = out["log_phi"]
        print(f"{label} log_phi: shape {tuple(log_phi.shape)}, range "
              f"[{float(log_phi.min()):.4f}, {float(log_phi.max()):.4f}], "
              f"skinning launches {skinning.launches}")
        check(tuple(log_phi.shape) == (128, 24), f"{label} log_phi: {tuple(log_phi.shape)}")
        check(bool(torch.isfinite(log_phi).all()), f"{label} log_phi: not finite")
        check(skinning.launches == 1, f"{label}: skinning must launch once a forward")
        cpu_model = build(device="cpu", **dataclasses.asdict(model.cfg))
        cpu_model.load_state_dict(model.state_dict())
        with torch.inference_mode():
            on_card = model({k: v.cuda() for k, v in small.items()}, smpl)["log_phi"].cpu()
            on_cpu = cpu_model(small, smpl.to("cpu"))["log_phi"]
        excess = float(((on_card - on_cpu).abs() - LOG_PHI_RTOL * on_cpu.abs()).max())
        print(f"{label} card vs cpu log_phi: max_abs_err "
              f"{float((on_card - on_cpu).abs().max()):.3e} (tolerance {LOG_PHI_ATOL} + "
              f"{LOG_PHI_RTOL} x |log_phi|)")
        check(excess <= LOG_PHI_ATOL, f"{label} log_phi: card and CPU disagree")
    return launches


def phase_hmr(ctx: dict, seed: int) -> int:
    print("== 4d. HMR baseline detect_forward at full width")
    model = calibrated_model(build_hmr, REPO / "configs/spin_hmr.yaml", seed + 4,
                             "cuda", ctx["calib"])
    print(f"config: {model.cfg}")
    print(f"model: {sum(p.numel() for p in model.parameters())} parameters")
    rng, (h, w) = ctx["rng"], ctx["image"].shape[:2]
    requests = [random_boxes(rng, 8, h, w)]
    launches, (out,) = drive_requests("hmr", model, ctx["smpl"], ctx["image"], requests)
    check_shapes(out, 8, {"uncert_feat": (8, 2048)})
    check("var_pose" not in out and out["log_phi"] is None, "hmr: an uncertainty was emitted")
    c2, s2 = random_boxes(rng, 2, h, w)
    card_vs_cpu("hmr", model, build_hmr, ctx["smpl"], ctx["image"], c2, s2,
                ("pred_cam", "pred_shape"), vertices_vs_fp64=True)
    return launches


def timed_requests(run, reps: int) -> list[float]:
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - start)
    return times


def print_times(label: str, batch: int, ts: list[float], card: str) -> None:
    med = statistics.median(ts)
    print(f"throughput fp32, batch {batch}, {label}, {len(ts)} requests: "
          f"median {med * 1e3:.3f} ms (min {min(ts) * 1e3:.3f}, "
          f"max {max(ts) * 1e3:.3f}) = {batch / med:.1f} crops/s on {card}")


def phase_throughput(ctx: dict, pare: dict, reps: int, card: str) -> None:
    """Crops/s at batch 128. POCO-CLIFF: the plain skinning swapped into the
    SMPL stage is timed in turns (kernel, plain, plain, kernel) as its
    yardstick. POCO-PARE: with the kernel, at least 10 requests."""
    print("== 5. throughput")
    c, s = ctx["request"]

    def run():
        detect_forward(ctx["model"], ctx["smpl"], ctx["image"], c, s)

    for _ in range(3):
        run()
    times = {"kernel": [], "plain": []}
    for turn in ("kernel", "plain", "plain", "kernel"):
        if turn == "plain":
            lbs_module.skinning = skinning_reference
        try:
            times[turn] += timed_requests(run, max(1, reps // 2))
        finally:
            lbs_module.skinning = skinning
    for turn, ts in times.items():
        print_times(f"POCO-CLIFF, skinning {turn}", len(c), ts, card)

    pc, ps = pare["request"]

    def run_pare():
        detect_forward(pare["model"], ctx["smpl"], ctx["image"], pc, ps)

    for _ in range(3):
        run_pare()
    print_times("POCO-PARE, skinning kernel", len(pc), timed_requests(run_pare, max(10, reps)),
                card)


def profile_request(label: str, run) -> None:
    """Device busy and idle share, ops, the skinning kernel's share and the
    top device kernels of `run` (one 128-crop request), over 3 requests."""
    from torch.profiler import ProfilerActivity, profile

    n = 3
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(n):
            run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - start) * 1e6
    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    if not spans:
        print(f"{label} device time: not measured (the profiler recorded no device events)")
        return
    busy, end, by_name = 0.0, float("-inf"), {}
    for s0, s1, name in spans:
        busy += max(0.0, s1 - max(s0, end))
        end = max(end, s1)
        by_name[name] = by_name.get(name, 0.0) + (s1 - s0)
    skin_us = sum(t for name, t in by_name.items() if "skin_tc_kernel" in name)
    print(f"{label}: device busy {busy / n / 1e3:.3f} ms per request of "
          f"{wall_us / n / 1e3:.3f} ms wall: busy share {busy / wall_us:.4f}, "
          f"idle share {1 - busy / wall_us:.4f}")
    print(f"{label}: skinning kernel {skin_us / n / 1e3:.4f} ms per request = "
          f"{skin_us / busy:.5f} of device time; {len(spans) // n} device ops per request")
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {t / busy:7.4f}  {t / n / 1e3:9.4f} ms  {name[:100]}")


def phase_profile(ctx: dict, pare: dict) -> None:
    """Where a 128-crop request spends device time (torch.profiler), for
    POCO-CLIFF and POCO-PARE, and the SMPL stage alone."""
    print("== 6. profile: one 128-crop request")
    c, s = ctx["request"]
    smpl = ctx["smpl"]
    rot = axis_angle_to_rotmat(0.3 * torch.randn(len(c), 24, 3, device="cuda"))
    betas = torch.randn(len(c), 10, device="cuda")
    stage_ms = cuda_ms(lambda: smpl_forward(smpl, betas, rot), iters=20)
    lbs_module.skinning = skinning_reference
    try:
        stage_plain_ms = cuda_ms(lambda: smpl_forward(smpl, betas, rot), iters=20)
    finally:
        lbs_module.skinning = skinning
    print(f"SMPL stage (smpl_forward, B={len(c)}, V=6890): {stage_ms:.4f} ms with the "
          f"kernel, {stage_plain_ms:.4f} ms with the plain skinning")
    profile_request(
        "POCO-CLIFF", lambda: detect_forward(ctx["model"], smpl, ctx["image"], c, s)
    )
    pc, ps = pare["request"]
    profile_request(
        "POCO-PARE", lambda: detect_forward(pare["model"], smpl, ctx["image"], pc, ps)
    )


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    card, peaks = phase_environment()
    phase_build()
    errs = phase_kernel_check()
    ctx = phase_main_path(args.seed)
    pare = phase_pare(ctx, args.seed)
    flow_launches = phase_flow(ctx, pare, args.seed)
    hmr_launches = phase_hmr(ctx, args.seed)
    launches = ctx["launches"] + pare["launches"] + flow_launches + hmr_launches
    print(f"skinning launches on the main paths: {launches} (cliff {ctx['launches']}, "
          f"pare {pare['launches']}, flow {flow_launches}, hmr {hmr_launches})")
    phase_throughput(ctx, pare, args.reps, card)
    phase_profile(ctx, pare)
    times = phase_kernel_timing(peaks)
    record = {
        "name": "skinning",
        "route": "cuda",
        "source": "poco_tpu_torch/csrc/skinning.cu",
        "replaces": "poco_tpu/ops/pallas_lbs.py:87",
        "launches": launches,
        "max_abs_err": errs["v2"],
        **times,
        "library_ms": None,
    }
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
