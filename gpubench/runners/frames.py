"""The `frames` traffic: one client in a closed loop, each request one
seeded frame with a set of seeded boxes through the port's
`detect_forward`, the next request dispatched before the previous one's
outputs are fetched (depth 1, as `demo/stream.py:run_stream` does), each
request's outputs copied to host memory as fp32 numpy. `correct`
compares `check_requests` of the window's requests, drawn from the seed,
with the reference's answers on the same frame and boxes."""

from __future__ import annotations

import contextlib
import statistics
import time

import numpy as np
import torch
from torch.profiler import record_function

from bench import compare, port, synth, trace
from reference.poco import POCO as RefPOCO
from reference.preprocess import preprocess_crops as ref_preprocess
from reference.train import smpl_from_arrays

CALIBRATION_CROPS = 16
END_TO_END = ("setup_s", "crops_per_s", "request_p95_ms")
READINGS = ("mesh_mm", "params_rel")
PRECISIONS = ("fp32",)
CELL_KEYS = ("check_requests",)


def check(cell: dict) -> list[str]:
    n = cell["check_requests"]
    return [] if isinstance(n, int) and n >= 1 else [f"check_requests {n!r}"]


def inputs(ctx) -> dict:
    """Frames, boxes, SMPL arrays, the reference SMPL and the reference
    model with its weights, all from the seed."""
    dev, traffic, cfg = ctx.device, ctx.traffic, ctx.config
    gen = synth.generator(ctx.seed, dev)
    frames = synth.frame_pool(gen, dev, traffic)
    boxes = synth.box_sets(gen, dev, traffic)
    arrays = synth.smpl_arrays(gen, dev, cfg["smpl"]["num_verts"], cfg["smpl"]["num_faces"])
    centers, scales = boxes[0]
    with torch.no_grad():
        calib = ref_preprocess(torch.from_numpy(frames[0]).to(dev),
                               torch.from_numpy(centers[:CALIBRATION_CROPS]).to(dev),
                               torch.from_numpy(scales[:CALIBRATION_CROPS]).to(dev))
    ref = synth.reference_model(RefPOCO, synth.ref_config(cfg["model"]), ctx.seed, dev,
                                calib["img"].permute(0, 3, 1, 2))
    return {"frames": frames, "boxes": boxes, "arrays": arrays,
            "ref_smpl": smpl_from_arrays(arrays), "ref": ref}


@torch.no_grad()
def reference_outputs(ref, ref_smpl, frame, centers, scales, keys) -> dict:
    dev = next(ref.parameters()).device
    batch = ref_preprocess(torch.from_numpy(frame).to(dev), torch.from_numpy(centers).to(dev),
                           torch.from_numpy(scales).to(dev))
    out = ref(batch, ref_smpl)
    return {k: out[k].float().cpu().numpy() for k in keys if out.get(k) is not None}


def sample(seed: int, n: int, k: int) -> list[int]:
    """k of the n finished requests, drawn from the seed."""
    return sorted(np.random.default_rng(seed).choice(n, min(k, n), replace=False).tolist())


def run(ctx) -> dict:
    dev, traffic = ctx.device, ctx.traffic
    made = inputs(ctx)
    frames, boxes, ref, ref_smpl = made["frames"], made["boxes"], made["ref"], made["ref_smpl"]
    ctx.mark("inputs and the reference model made")
    model = port.build_model(ctx.config["model"], ref.state_dict(), dev)
    smpl = port.load_smpl(*synth.write_smpl_files(made["arrays"], ctx.tmpdir), dev)
    ctx.mark("the port's model and SMPL loaded")
    ref.to("cpu")   # off the card while the port runs
    keys = port.fetch_keys()
    results = []      # (request, dispatched, done, outputs on the host)
    counter = {"next": 0}
    traced = {"on": False}

    def dispatch():
        i = counter["next"]
        counter["next"] += 1
        frame, (centers, scales) = frames[i % len(frames)], boxes[i % len(boxes)]
        t = time.perf_counter()
        with record_function(trace.REQUEST) if traced["on"] else contextlib.nullcontext():
            out = port.detect_forward(model, smpl, frame, centers, scales)
        return i, t, out

    def finish(pending):
        i, t, out = pending
        host = {k: out[k].float().cpu().numpy() for k in keys if out.get(k) is not None}
        results.append((i, t, time.perf_counter(), host))

    def serve(stop):
        pending = None
        while not stop():
            current = dispatch()
            if pending is not None:
                finish(pending)
            pending = current
        if pending is not None:
            finish(pending)

    # warm-up: the cell's own shape, once
    serve(lambda: counter["next"] >= 1)
    ctx.sync()
    ctx.mark("warm-up request done")
    results.clear()
    setup_s = time.perf_counter() - ctx.t_start
    t0 = time.perf_counter()
    summary = None
    if ctx.trace:
        serve(lambda: len(results) >= 2)   # into the steady state first
        first = counter["next"]
        traced["on"] = True
        with trace.layer_ranges(model):
            summary = trace.profile_stretch(
                lambda: serve(lambda: counter["next"] >= first + ctx.cell["trace_calls"]), dev)
        traced["on"] = False
    after, done_before = time.perf_counter(), len(results)
    serve(lambda: time.perf_counter() - t0 >= ctx.seconds)
    ctx.sync()
    memory_peak = ctx.memory_peak()
    window_s = results[-1][2] - t0
    latencies = [(done - t) * 1e3 for _, t, done, _ in results]
    rows = sum(len(r[3]["pred_cam"]) for r in results)
    failed = sum(not all(np.isfinite(v).all() for v in r[3].values()) for r in results)
    del model, smpl
    ctx.free()

    ctx.mark("window closed, the port freed")
    ref.to(dev)
    picked = sample(ctx.seed, len(results), ctx.cell["check_requests"])
    served, wanted = [], []
    for n in picked:
        i, _, _, host = results[n]
        centers, scales = boxes[i % len(boxes)]
        served.append(host)
        wanted.append(reference_outputs(ref, ref_smpl, frames[i % len(frames)], centers, scales,
                                        keys))
    readings = compare.frames_readings(served, wanted)
    if summary:
        centers, scales = boxes[0]
        summary.update(
            requests=ctx.cell["trace_calls"], rows=ctx.cell["trace_calls"] * traffic["boxes"],
            flops_per_call=trace.count_flops(lambda: reference_outputs(
                ref, ref_smpl, frames[0], centers, scales, keys)),
            skinning_shape=(traffic["boxes"], ctx.config["smpl"]["num_verts"]),
            calls_per_s=(len(results) - done_before) / (results[-1][2] - after))
    return {
        "attempted": counter["next"] - 1,
        "failed": failed,
        "e2e": {
            "setup_s": setup_s,
            "crops_per_s": rows / window_s,
            "request_p95_ms": statistics.quantiles(latencies, n=100, method="inclusive")[94]
            if len(latencies) > 1 else latencies[0],
        },
        "summary": summary,
        "readings": readings,
        "memory_peak_bytes": memory_peak,
        "requests": len(results),
    }


def control(ctx) -> dict:
    """The reference in TF32 (the precision below fp32 with TF32 off) in
    the port's place, against the reference, on `check_requests` requests."""
    made = inputs(ctx)
    keys = compare.MESH_KEYS + compare.PARAM_KEYS
    want, got = [], []
    for i in range(1, ctx.cell["check_requests"] + 1):
        frame = made["frames"][i % len(made["frames"])]
        centers, scales = made["boxes"][i % len(made["boxes"])]
        args = (made["ref"], made["ref_smpl"], frame, centers, scales, keys)
        synth.tf32(False)
        want.append(reference_outputs(*args))
        synth.tf32(True)
        got.append(reference_outputs(*args))
    synth.tf32(False)
    return {"control": compare.frames_readings(got, want)}
