"""Export CLI: a POCO checkpoint to a serving artifact (the port's
counterpart of the repo's `tools/export_model.py`, with its flags and
defaults).

    python -m poco_tpu_torch.cli.export --cfg configs/poco_cliff.yaml \\
        [--ckpt <.pt file or a logdir holding one>] --out exported/poco_cliff \\
        [--batch-sizes 1,32] [--dtype bf16|fp32] [--compact] [--uint8-input] \\
        [--platforms cpu,cuda] [--data_parallel N --dp_platform cpu|native] \\
        [--smpl_dir DIR] [--device cuda|cpu]

The artifact (`poco_tpu_torch/runtime/export.py`) holds one
`torch.export` program with a dynamic batch (the weights and SMPL inside)
and `meta.json`; `python -m poco_tpu_torch.cli.serve --artifact <out>`
serves it. `--dtype bf16` (the default, as in the JAX tool) computes as
the JAX package's `POCO(dtype=jnp.bfloat16)` does, with fp32 weights;
`--dtype fp32` is fp32 with TF32 off for cuBLAS and cuDNN. `--platforms`
lists the device types the artifact may serve on (default cpu,cuda:
export on a CPU host, serve on the card). `--data_parallel N` serves each
bucket as N shards on N replicas (every bucket divisible by N); the
export then runs on `--dp_platform`'s device (`cpu`: N replicas on the
CPU, `native`: the first N cards) instead of `--device`, and the artifact
lists that device type only. Without `--ckpt` the weights are random
(torch seed 0): for testing the pipeline only.
"""

from __future__ import annotations

import argparse
import json
import os

import torch
from ..device import default_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cfg", default="configs/poco_cliff.yaml")
    ap.add_argument("--ckpt", default=None,
                    help="torch .pt/.ckpt file, or a run logdir holding one (random "
                         "weights when omitted: pipeline testing only)")
    ap.add_argument("--inf_model", default="best")
    ap.add_argument("--smpl_dir", default="data/smpl")
    ap.add_argument("--out", required=True)
    ap.add_argument("--batch-sizes", default="1,32")
    ap.add_argument("--dtype", default="bf16", choices=["bf16", "fp32"],
                    help="compute precision (weights stay fp32)")
    ap.add_argument("--platforms", default="cpu,cuda",
                    help="device types the artifact may serve on")
    ap.add_argument("--compact", action="store_true",
                    help="fp16 vertex/joint outputs (rendering-grade)")
    ap.add_argument("--uint8-input", action="store_true",
                    help="program takes raw uint8 crops and normalizes on the device "
                         "(4x smaller request uploads)")
    ap.add_argument("--data_parallel", type=int, default=None,
                    help="serve each batch bucket as N shards on N replicas")
    ap.add_argument("--dp_platform", default="cpu", choices=["cpu", "native"],
                    help="device of --data_parallel exports: 'cpu' (N replicas on the CPU) "
                         "or 'native' (the first N cards)")
    ap.add_argument("--device", default=default_device(),
                    help="cuda or cpu (default: $POCO_TPU_PLATFORM, else cuda)")
    return ap


def main(argv=None) -> str:
    args = build_parser().parse_args(argv)

    from ..config import model_config_from_hparams, update_hparams
    from ..device import resolve_device
    from ..models.poco import POCO
    from ..runtime.export import export_poco
    from ..smpl.assets import resolve_smpl_params
    from ..utils.checkpoint import load_checkpoint_into

    if args.data_parallel:
        args.device = "cpu" if args.dp_platform == "cpu" else "cuda"
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    hparams = update_hparams(args.cfg)
    torch.manual_seed(0)
    model = POCO(model_config_from_hparams(hparams)).to(device).eval()
    if args.ckpt:
        load_checkpoint_into(model, args.ckpt, inf_model=args.inf_model)
    else:
        print("WARNING: no --ckpt given; exporting random weights (torch seed 0)")
    smpl = resolve_smpl_params(args.smpl_dir, "neutral", device)

    batch_sizes = tuple(int(b) for b in args.batch_sizes.split(","))
    out = export_poco(
        model, smpl, args.out,
        batch_sizes=batch_sizes,
        compact=args.compact,
        uint8_input=args.uint8_input,
        device=device,
        dtype=args.dtype,
        data_parallel=args.data_parallel,
        platforms=tuple(args.platforms.split(",")),
    )
    with open(os.path.join(out, "meta.json")) as f:
        platforms = json.load(f)["platforms"]
    total = sum(os.path.getsize(os.path.join(out, f)) for f in os.listdir(out))
    print(f"exported {args.cfg} -> {out} ({total / 1e6:.1f} MB, "
          f"buckets {list(batch_sizes)}, {args.dtype}, device {device.type}, platforms "
          f"{','.join(platforms)}, data_parallel {args.data_parallel})", flush=True)
    return out


if __name__ == "__main__":
    main()
