#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--reps 20]

Phases, each of which raises (exit code 1) on failure:
  1. environment: torch/CUDA versions, the card's name and power limit;
     TF32 is switched off for matmuls and convolutions;
  2. build every CUDA kernel of the port from `poco_tpu_torch/csrc/`
     (nvcc, in parallel), printing the `-Xptxas -v` report;
  3. kernel check: each kernel against its plain torch version on the
     card at the main path's shapes and at a ragged shape, with timings
     (CUDA events) and the card's bound for the same work;
  4. main path at full width: POCO-CLIFF (HRNet-W48-cls, configs/
     poco_cliff.yaml) with seeded random weights and a V=6890 synthetic
     SMPL answers `detect_forward` requests of 1, 8 and 128 boxes on a
     720x1280 image; every kernel must launch once per request; a 2-box
     request is held against the same weights on the CPU;
  5. crops/s at batch 128, fp32, with the kernel and, in turns, with the
     plain skinning in its place (the yardstick);
  6. a torch.profiler trace of 128-crop requests: device busy and idle
     share, the skinning kernel's share, the top device kernels, and the
     SMPL stage alone with the kernel and with the plain skinning.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Without a CUDA device it exits 1 and
prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from poco_tpu_torch.config import model_config_from_hparams, update_hparams
from poco_tpu_torch.demo.tester import detect_forward
from poco_tpu_torch.models.poco import build_poco_cliff
from poco_tpu_torch.ops import kernels
from poco_tpu_torch.ops.preprocess import preprocess_crops
from poco_tpu_torch.ops.rotation import axis_angle_to_rotmat
from poco_tpu_torch.ops.skinning import skinning, skinning_reference
from poco_tpu_torch.smpl import lbs as lbs_module
from poco_tpu_torch.smpl.assets import synthetic_smpl_model
from poco_tpu_torch.smpl.lbs import smpl_forward
from poco_tpu_torch.utils.weights import calibrate_batchnorm, randomize_batchnorm

REPO = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet: HBM rate and fp32 (non-tensor-core) peak.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12

SKIN_TOL = 1e-4       # kernel vs plain, fp32 sums in another order
HEAD_TOL = 2e-3       # pred_cam / pred_shape / var_pose, card vs CPU
METERS_TOL = 1e-4     # joints3d / vertices, card vs CPU (0.1 mm budget)


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


def phase_environment() -> str:
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
    print(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: matmul.allow_tf32=False cudnn.allow_tf32=False")
    return card


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


def skinning_bound_ms(batch: int, num_verts: int) -> tuple[float, str]:
    """Least time for the work: bytes once each way vs fp32 operations."""
    nbytes = 4 * (num_verts * 24 + batch * 24 * 16 + 2 * batch * num_verts * 3)
    flops = (24 * 12 * 2 + 18) * batch * num_verts
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernel_check() -> dict:
    print("== 3. kernel check")
    record = None
    for batch, num_verts in ((128, 6890), (3, 1001)):
        args = skinning_inputs(batch, num_verts, seed=batch + num_verts)
        out = skinning(*args)
        torch.cuda.synchronize()
        err = float((out - skinning_reference(*args)).abs().max())
        print(f"skinning B={batch} V={num_verts}: max_abs_err {err:.3e} "
              f"(tolerance {SKIN_TOL})")
        check(err <= SKIN_TOL, f"skinning disagrees with its plain version: {err}")
        if record is None:  # the main path's shape
            bound, bound_by = skinning_bound_ms(batch, num_verts)
            record = {
                "name": "skinning",
                "route": "cuda",
                "source": "poco_tpu_torch/csrc/skinning.cu",
                "replaces": "poco_tpu/ops/pallas_lbs.py:87",
                "launches": None,
                "max_abs_err": err,
                "ms": cuda_ms(lambda: skinning(*args), iters=200),
                "plain_ms": cuda_ms(lambda: skinning_reference(*args), iters=50),
                "bound_ms": bound,
                "bound_by": bound_by,
                "library_ms": None,
            }
            print(f"skinning B={batch} V={num_verts}: kernel {record['ms']:.4f} ms, "
                  f"plain {record['plain_ms']:.4f} ms, bound {bound:.4f} ms "
                  f"({bound_by}); no single PyTorch call computes it")
    return record


def random_boxes(rng, n: int, h: int, w: int):
    centers = np.stack(
        [rng.uniform(100, w - 100, n), rng.uniform(100, h - 100, n)], axis=1
    ).astype(np.float32)
    scales = rng.uniform(0.8, 3.0, n).astype(np.float32)
    return centers, scales


def max_point_dist(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.norm(a.cpu() - b.cpu(), dim=-1).max())


def phase_main_path(seed: int) -> dict:
    print("== 4. main path: POCO-CLIFF detect_forward at full width")
    cfg = model_config_from_hparams(update_hparams(str(REPO / "configs/poco_cliff.yaml")))
    print(f"config: {cfg}")
    torch.manual_seed(seed)
    model = build_poco_cliff(device="cuda", **dataclasses.asdict(cfg))
    randomize_batchnorm(model, torch.Generator().manual_seed(seed + 1))
    smpl = synthetic_smpl_model(num_verts=6890, seed=seed, device="cuda")
    rng = np.random.RandomState(seed)
    h, w = 720, 1280
    image = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    centers, scales = random_boxes(rng, 16, h, w)
    with torch.no_grad():
        calib = preprocess_crops(
            torch.from_numpy(image).cuda(), torch.from_numpy(centers).cuda(),
            torch.from_numpy(scales).cuda(),
        )["img"].permute(0, 3, 1, 2)
    calibrate_batchnorm(model.backbone, calib)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {n_params} parameters; SMPL V={smpl.v_template.shape[0]}")

    requests = [random_boxes(rng, n, h, w) for n in (1, 8, 128)]
    skinning.launches = 0
    outputs = [detect_forward(model, smpl, image, c, s) for c, s in requests]
    torch.cuda.synchronize()
    launches = skinning.launches
    print(f"requests {[len(c) for c, _ in requests]}: skinning launches {launches}")
    check(launches == len(requests), "skinning must launch once per request")
    for (c, _), out in zip(requests, outputs):
        n = len(c)
        expect = {
            "pred_pose": (n, 24, 3, 3), "pred_shape": (n, 10), "pred_cam": (n, 3),
            "smpl_vertices": (n, 6890, 3), "smpl_joints3d": (n, 49, 3),
            "smpl_joints2d": (n, 49, 2), "pred_fullimg_cam_t": (n, 3),
            "var_pose": (n, 24),
        }
        for key, shape in expect.items():
            check(tuple(out[key].shape) == shape, f"{key}: {tuple(out[key].shape)}")
            check(bool(torch.isfinite(out[key]).all()), f"{key}: not finite")

    # the same weights on the CPU, for a 2-box request
    cpu_model = build_poco_cliff(device="cpu", **dataclasses.asdict(cfg))
    cpu_model.load_state_dict(model.state_dict())
    c2, s2 = random_boxes(rng, 2, h, w)
    on_card = detect_forward(model, smpl, image, c2, s2)
    on_cpu = detect_forward(cpu_model, smpl.to("cpu"), image, c2, s2)
    for key in ("pred_cam", "pred_shape", "var_pose"):
        err = float((on_card[key].cpu() - on_cpu[key]).abs().max())
        print(f"card vs cpu {key}: max_abs_err {err:.3e} (tolerance {HEAD_TOL})")
        check(err <= HEAD_TOL, f"{key}: card and CPU disagree by {err}")
    for key in ("smpl_joints3d", "smpl_vertices"):
        dist = max_point_dist(on_card[key], on_cpu[key])
        print(f"card vs cpu {key}: max distance {dist:.3e} m (tolerance {METERS_TOL})")
        check(dist <= METERS_TOL, f"{key}: card and CPU disagree by {dist} m")

    return {"launches": launches, "model": model, "smpl": smpl, "image": image,
            "request": requests[-1]}


def timed_requests(run, reps: int) -> list[float]:
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - start)
    return times


def phase_throughput(ctx: dict, reps: int, card: str) -> None:
    """Crops/s at batch 128; the plain skinning swapped into the SMPL stage
    is timed in turns (kernel, plain, plain, kernel) as its yardstick."""
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
        med = statistics.median(ts)
        print(f"throughput fp32, batch {len(c)}, skinning {turn}, {len(ts)} requests: "
              f"median {med * 1e3:.3f} ms (min {min(ts) * 1e3:.3f}, "
              f"max {max(ts) * 1e3:.3f}) = {len(c) / med:.1f} crops/s on {card}")


def phase_profile(ctx: dict) -> None:
    """Where a 128-crop request spends device time (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

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

    n = 3
    detect_forward(ctx["model"], smpl, ctx["image"], c, s)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(n):
            detect_forward(ctx["model"], smpl, ctx["image"], c, s)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - start) * 1e6
    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    if not spans:
        print("device time: not measured (the profiler recorded no device events)")
        return
    busy, end, by_name = 0.0, float("-inf"), {}
    for s0, s1, name in spans:
        busy += max(0.0, s1 - max(s0, end))
        end = max(end, s1)
        by_name[name] = by_name.get(name, 0.0) + (s1 - s0)
    skin_us = sum(t for name, t in by_name.items() if "skin_kernel" in name)
    print(f"device busy {busy / n / 1e3:.3f} ms per request of {wall_us / n / 1e3:.3f} "
          f"ms wall: busy share {busy / wall_us:.4f}, idle share {1 - busy / wall_us:.4f}")
    print(f"skinning kernel {skin_us / n / 1e3:.4f} ms per request = "
          f"{skin_us / busy:.5f} of device time; {len(spans) // n} device ops per request")
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {t / busy:7.4f}  {t / n / 1e3:9.4f} ms  {name[:100]}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    card = phase_environment()
    phase_build()
    record = phase_kernel_check()
    ctx = phase_main_path(args.seed)
    record["launches"] = ctx["launches"]
    phase_throughput(ctx, args.reps, card)
    phase_profile(ctx)
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
