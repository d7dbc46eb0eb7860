"""Export CLI: a POCO checkpoint to a serving artifact (the port's
counterpart of the repo's `tools/export_model.py`).

    python -m poco_tpu_torch.cli.export --cfg configs/poco_cliff.yaml \\
        [--ckpt <.pt file or a logdir holding one>] --out exported/poco_cliff \\
        [--batch-sizes 1,32] [--compact] [--uint8-input] [--smpl_dir DIR] \\
        [--device cuda|cpu]

The artifact (`poco_tpu_torch/runtime/export.py`) holds one
`torch.export` program with a dynamic batch (the weights and SMPL inside)
and `meta.json`; `python -m poco_tpu_torch.cli.serve --artifact <out>`
serves it. It serves on the device type it was exported on. Without
`--ckpt` the weights are random (torch seed 0): for testing the pipeline
only. TF32 is switched off for cuBLAS and cuDNN, as in the port's other
entry points. Not ported, and refused: `--dtype bf16`, `--data_parallel`
and `--platforms` (see ROADMAP.md queue A).
"""

from __future__ import annotations

import argparse
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
    ap.add_argument("--dtype", default="fp32", choices=["bf16", "fp32"],
                    help="fp32 only: bf16 export is not ported (ROADMAP.md queue A item 6)")
    ap.add_argument("--compact", action="store_true",
                    help="fp16 vertex/joint outputs (rendering-grade)")
    ap.add_argument("--uint8-input", action="store_true",
                    help="program takes raw uint8 crops and normalizes on the device "
                         "(4x smaller request uploads)")
    ap.add_argument("--data_parallel", type=int, default=None,
                    help="not ported (ROADMAP.md queue A item 3)")
    ap.add_argument("--platforms", default=None,
                    help="not ported: an artifact serves on its export device")
    ap.add_argument("--device", default=default_device(),
                    help="cuda or cpu (default: $POCO_TPU_PLATFORM, else cuda)")
    return ap


def main(argv=None) -> str:
    args = build_parser().parse_args(argv)

    from ..config import model_config_from_hparams, update_hparams
    from ..device import resolve_device
    from ..models.poco import POCO
    from ..runtime.export import export_poco, not_ported
    from ..smpl.assets import resolve_smpl_params
    from ..utils.checkpoint import load_checkpoint_into

    if args.dtype == "bf16":
        raise not_ported("bf16 export", "item 6, bf16")
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
        data_parallel=args.data_parallel,
        platforms=tuple(args.platforms.split(",")) if args.platforms else None,
    )
    total = sum(os.path.getsize(os.path.join(out, f)) for f in os.listdir(out))
    print(f"exported {args.cfg} -> {out} ({total / 1e6:.1f} MB, "
          f"buckets {list(batch_sizes)}, device {device.type})", flush=True)
    return out


if __name__ == "__main__":
    main()
