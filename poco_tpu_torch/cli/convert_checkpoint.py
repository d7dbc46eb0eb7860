"""Load a reference PyTorch POCO checkpoint into the port's model and audit
its coverage (the port's counterpart of the repo's
`tools/convert_checkpoint.py`).

    python -m poco_tpu_torch.cli.convert_checkpoint --torch_ckpt poco_cliff.pt \\
        --cfg configs/poco_cliff.yaml --out ckpt/poco_cliff [--smpl_dir DIR]

The port's modules carry the reference's names, so a reference checkpoint
(a state_dict, bare or under `model` / `state_dict`, Lightning's `model.`
prefix stripped) loads without renaming; what this tool adds is the
audit that the golden gate (SURVEY.md section 4) rests on. It prints
`loaded N tensors, skipped S` (a tensor whose name the model has at
another shape is skipped) and the reference modules the model does not
have, and raises unless every tensor of the checkpoint loaded and every
parameter and buffer of the model came from it. Then it writes the
weights as a port checkpoint, `<out>.pt`, which `cli.eval`, `cli.demo` and
`cli.train --pretrained` read. Host work only: the model is built on the
CPU. `--smpl_dir` is taken for the JAX tool's command line; the port's
model holds no SMPL weights.
"""

from __future__ import annotations

import argparse

import torch


def checkpoint_coverage(model: torch.nn.Module, state: dict) -> dict:
    """How `state` (a reference-named state_dict) covers `model`: the
    tensors that load (`loaded`), those named like the model's but shaped
    otherwise (`skipped`), the model's tensors it lacks (`missing`), and
    the modules of the checkpoint that the model lacks (`unmatched`,
    each key without its last part, once)."""
    ours = model.state_dict()
    loaded = {k: v for k, v in state.items()
              if k in ours and tuple(v.shape) == tuple(ours[k].shape)}
    unmatched = sorted({k.rsplit(".", 1)[0] for k in state if k not in ours})
    return {
        "loaded": loaded,
        "skipped": sorted(k for k in state if k in ours and k not in loaded),
        "missing": sorted(k for k in ours if k not in state),
        "unmatched": unmatched,
    }


def load_full_coverage(model: torch.nn.Module, path: str, log=print) -> int:
    """Load the reference checkpoint at `path` into `model`, printing the
    audit; raises SystemExit unless the coverage is full. Returns the
    number of tensors loaded."""
    from ..utils.checkpoint import load_torch_checkpoint

    cov = checkpoint_coverage(model, load_torch_checkpoint(path))
    if cov["unmatched"]:
        log(f"unmatched torch modules ({len(cov['unmatched'])}):")
        for name in cov["unmatched"][:50]:
            log(f"   {name}")
    log(f"loaded {len(cov['loaded'])} tensors, skipped {len(cov['skipped'])}")
    faults = {k: cov[k] for k in ("unmatched", "skipped", "missing") if cov[k]}
    if faults:
        raise SystemExit(
            f"{path} does not cover the model: "
            + "; ".join(f"{k} {len(v)}: {v[:10]}" for k, v in faults.items())
        )
    model.load_state_dict(cov["loaded"], strict=True)
    return len(cov["loaded"])


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--torch_ckpt", required=True)
    parser.add_argument("--cfg", default="configs/poco_cliff.yaml")
    parser.add_argument("--out", required=True, help="output checkpoint, without .pt")
    parser.add_argument("--smpl_dir", default=None, help="unused: the model holds no SMPL")
    args = parser.parse_args(argv)

    from ..config import model_config_from_hparams, update_hparams
    from ..models.poco import POCO
    from ..utils.checkpoint import save_checkpoint

    model = POCO(model_config_from_hparams(update_hparams(args.cfg)))
    load_full_coverage(model, args.torch_ckpt)
    path = save_checkpoint(args.out, model)
    print(f"saved port checkpoint to {path}")
    return path


if __name__ == "__main__":
    main()
