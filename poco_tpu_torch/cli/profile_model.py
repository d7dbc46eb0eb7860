"""A torch.profiler trace of POCO-CLIFF's inference or train step (the
port's counterpart of the repo's `tools/profile_model.py`).

    python -m poco_tpu_torch.cli.profile_model [--mode infer|train] [--batch 128] \\
        [--steps 5] [--out out/poco_trace] [--precision 16|32] [--device cuda|cpu]

POCO-CLIFF at its default config (`models.poco.PocoConfig`: HRNet-W48-cls,
CLIFF head, uncertainty and flow heads) with random weights (torch seed 0)
and a V=6890 synthetic SMPL, on a constant batch of `--batch` crops:
`infer` runs the forward, `train` the train step (`train.step.
make_train_step`: GT mesh, forward, loss, backward, Adam), whose stages
are the `TRAIN_STAGES` ranges in the trace. One step warms up outside the
trace, then `--steps` steps are traced (CPU and, on the card, CUDA
activity) into `<out>/poco_<mode>_b<batch>.json`, a Chrome trace
(chrome://tracing, Perfetto). `--precision 16`, the JAX tool's default,
runs the model in bf16 (`models.poco.compute_precision`: SMPL and the
loss in fp32), the precision `tests/test_torch_precision.py` holds to the
JAX package's bf16 forward and train step (a float32 output within half
of JAX's own bf16-to-fp32 distance plus the fp32 pair's tolerance, a bf16
output within one bf16 step, each loss term and gradient leaf within
twice JAX's distance from float64; the narrow POCO-PARE twin and one loss
term miss these bars, README "Export and serving"); `--precision 32` is
fp32 with TF32 off.
Prints where the trace went.
"""

from __future__ import annotations

import argparse
import os

import torch

from ..device import default_device


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--mode", default="infer", choices=["infer", "train"])
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--out", default=os.path.join("out", "poco_trace"))
    parser.add_argument("--precision", default="16", choices=["16", "32"])
    parser.add_argument("--device", default=default_device(),
                        help="cuda or cpu (default: $POCO_TPU_PLATFORM, else cuda)")
    args = parser.parse_args(argv)

    from ..device import resolve_device
    from ..losses.losses import LossConfig
    from ..models.poco import POCO, PocoConfig, compute_precision, make_dummy_batch
    from ..smpl.assets import synthetic_smpl_model
    from ..train.state import ModuleAdam
    from ..train.step import make_train_step

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = torch.bfloat16 if args.precision == "16" else None
    torch.manual_seed(0)
    model = POCO(PocoConfig()).to(device).eval()
    smpl = synthetic_smpl_model(num_verts=6890, device=device)
    b = args.batch
    batch = make_dummy_batch(model.cfg, b, include_gt=args.mode == "train", device=device)

    if args.mode == "infer":
        @torch.no_grad()
        def run_one():
            with compute_precision(device.type, dtype):
                return model(batch, smpl)["pred_pose"]
    else:
        batch.update(
            pose=torch.zeros((b, 72), device=device),
            betas=torch.zeros((b, 10), device=device),
            has_smpl=torch.ones((b,), device=device),
            has_pose_3d=torch.ones((b,), device=device),
            keypoints=torch.zeros((b, 49, 3), device=device),
        )
        step = make_train_step(model, ModuleAdam(model, lr=1e-4), LossConfig(),
                               autocast_dtype=dtype)

        def run_one():
            return step(batch, smpl)["loss/total_loss"]

    def synchronize():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    run_one()   # warm-up, outside the trace
    synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(args.steps):
            run_one()
        synchronize()   # the device's work inside the trace window
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"poco_{args.mode}_b{b}.json")
    prof.export_chrome_trace(path)
    print(f"trace written to {path} ({args.mode}, batch {b}, {args.steps} steps, "
          f"precision {args.precision})")
    return path


if __name__ == "__main__":
    main()
