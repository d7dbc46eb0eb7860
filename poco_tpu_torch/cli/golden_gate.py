"""The golden gate in one command: load, evaluate, hold to 0.5 mm (the
port's counterpart of the repo's `tools/golden_gate.py`).

    python -m poco_tpu_torch.cli.golden_gate --smpl_dir DIR --torch_ckpt X.pt \\
        --data_dir DIR [--cfg configs/poco_cliff.yaml] [--dataset 3dpw] \\
        [--batch_size 32] [--ref_mpjpe MM | --reference_root DIR] [--budget_mm 0.5] \\
        [--device cuda|cpu]

BASELINE.md's accuracy gate ("3DPW MPJPE within 0.5 mm of the PyTorch
reference on converted weights") needs licence-gated assets: the SMPL
files (SMPL_NEUTRAL / MALE / FEMALE, .pkl or .npz), the reference
checkpoint and the dataset (`<data_dir>/dataset_extras/<dataset>_test.npz`
and its images; `J_regressor_h36m.npy` there is used when present). With
them, this runs the whole gate:

  1. the checkpoint into the port's model, full coverage required
     (`cli.convert_checkpoint`: nothing unmatched, skipped or missing);
  2. the port's `run_eval` over the dataset on `--device`, predictions
     through the neutral SMPL and the GT through the gendered ones, the
     H36M regressor's joints when the regressor is there, else the SMPL
     skeleton's 14 -> MPJPE_port;
  3. the reference side: `--ref_mpjpe` if given; else, with
     `--reference_root` (the reference's source tree, holding `pocolib`),
     the reference's own backbone and head on the CPU over the same
     samples, scored by the same protocol with the port's SMPL and metric
     code -> MPJPE_ref;
  4. |MPJPE_port - MPJPE_ref| <= --budget_mm.

Prints one JSON line either way and exits 0 iff the gate passes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import types

import numpy as np
import torch

from ..device import default_device


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--smpl_dir", required=True)
    parser.add_argument("--torch_ckpt", required=True)
    parser.add_argument("--data_dir", required=True)
    parser.add_argument("--cfg", default="configs/poco_cliff.yaml")
    parser.add_argument("--dataset", default="3dpw")
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--ref_mpjpe", type=float, default=None,
                        help="the reference side's MPJPE in mm, if known")
    parser.add_argument("--reference_root", default=None,
                        help="the reference's source tree (holding pocolib), to run its own "
                             "modules when --ref_mpjpe is not given")
    parser.add_argument("--budget_mm", type=float, default=0.5)
    parser.add_argument("--device", default=default_device(),
                        help="cuda or cpu (default: $POCO_TPU_PLATFORM, else cuda)")
    return parser.parse_args(argv)


def h36m_regressor(data_dir: str, device) -> torch.Tensor | None:
    path = os.path.join(data_dir, "J_regressor_h36m.npy")
    if os.path.exists(path):
        return torch.from_numpy(np.load(path).astype(np.float32)).to(device)
    return None


def _dataset(args):
    from ..config import dataset_npz_path
    from ..data.dataset import PocoDataset

    npz = dataset_npz_path(args.data_dir, args.dataset, is_train=False)
    return PocoDataset(npz, img_dir=args.data_dir, dataset_name=args.dataset, is_train=False)


def eval_port(args, hparams, model, device) -> float:
    """MPJPE (mm) of the port's evaluation on the dataset."""
    from ..eval.runner import run_eval
    from ..smpl.assets import resolve_smpl_params

    result = run_eval(
        model, _dataset(args),
        smpl_neutral=resolve_smpl_params(args.smpl_dir, "neutral", device),
        smpl_male=resolve_smpl_params(args.smpl_dir, "male", device),
        smpl_female=resolve_smpl_params(args.smpl_dir, "female", device),
        batch_size=args.batch_size,
        loss_ver=hparams.POCO.LOSS_VER,
        j_regressor_eval=h36m_regressor(args.data_dir, device),
    )
    return float(result.summary()["mpjpe"])


def reference_modules(root: str, mean_params: str) -> types.SimpleNamespace:
    """The reference's model factories from its source tree, with stand-ins
    for the packages its modules import but these factories do not use
    (yacs, loguru, pytorch_lightning, flatten_dict, torchvision's weight
    download, smplx), and its heads' mean-parameter file set to
    `mean_params`."""
    import importlib

    def stub(name, **attrs):
        mod = types.ModuleType(name)
        for k, v in attrs.items():
            setattr(mod, k, v)
        sys.modules.setdefault(name, mod)
        return sys.modules[name]

    class CfgNode(dict):
        def __getattr__(self, k):
            try:
                return self[k]
            except KeyError:
                raise AttributeError(k)

    def refuse(*_, **__):
        raise RuntimeError("the golden gate builds the reference's modules offline")

    class Quiet:
        def __getattr__(self, _):
            return lambda *a, **kw: None

    stub("yacs", config=stub("yacs.config", CfgNode=CfgNode))
    stub("loguru", logger=Quiet())
    stub("pytorch_lightning")
    stub("flatten_dict", flatten=refuse, unflatten=refuse)
    stub("torchvision", models=stub("torchvision.models", utils=stub(
        "torchvision.models.utils", load_state_dict_from_url=refuse)))
    stub("smplx", SMPL=object, body_models=stub("smplx.body_models", SMPLOutput=dict),
         lbs=stub("smplx.lbs", vertices2joints=refuse))
    if root not in sys.path:
        sys.path.insert(0, root)
    heads = {n: importlib.import_module(f"pocolib.models.head.{n}_head")
             for n in ("cliff", "pare")}
    for mod in heads.values():
        mod.SMPL_MEAN_PARAMS = mean_params
    from pocolib.models.backbone.hrnet import hrnet_w32
    from pocolib.models.backbone.hrnet_cls import hrnet_w48_cls

    return types.SimpleNamespace(hrnet_w32=hrnet_w32, hrnet_w48_cls=hrnet_w48_cls,
                                 cliff_head=heads["cliff"].cliff_head,
                                 pare_head=heads["pare"].pare_head)


def eval_reference(args, hparams) -> float:
    """MPJPE (mm) of the reference's own backbone and head (built from
    `--reference_root`, on the CPU) over the same samples, scored by the
    port's evaluation protocol: predictions through the neutral SMPL, GT
    through the gendered ones, the same 14 joints (the `run_eval` step
    with the reference's outputs in place of the model's)."""
    from ..constants import IMG_NORM_MEAN, IMG_NORM_STD
    from ..eval.runner import make_gendered_eval_step
    from ..smpl.assets import resolve_smpl_params
    from ..smpl.lbs import smpl_forward
    from ..smpl.mean_params import load_mean_params
    from ..utils.checkpoint import load_torch_checkpoint

    # the heads read the mean parameters when they are built; the
    # checkpoint's buffers replace them
    mean_params = os.path.join(tempfile.mkdtemp(), "smpl_mean_params.npz")
    np.savez(mean_params, **dict(zip(("pose", "shape", "cam"), load_mean_params())))
    ref = reference_modules(os.path.abspath(args.reference_root), mean_params)
    sd = load_torch_checkpoint(args.torch_ckpt)
    pare = "pare" in hparams.POCO.BACKBONE
    if pare:
        backbone, head = ref.hrnet_w32(pretrained=False), ref.pare_head(480, "diff_branch",
                                                                        "sigmoid")
    else:
        backbone, head = ref.hrnet_w48_cls(), ref.cliff_head(2048, "diff_branch", "sigmoid")
    for prefix, mod in (("backbone.", backbone), ("head.", head)):
        mod.load_state_dict({k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)},
                            strict=True)
        mod.eval()

    class Reference(torch.nn.Module):
        """The reference's outputs under the keys the eval step reads."""

        def forward(self, batch, smpl):
            img = batch["img"].permute(0, 3, 1, 2)
            feats = backbone(img)
            out = head(feats) if pare else head(feats, {"bbox_info": batch["bbox_info"]})
            pose, shape = out["pred_pose"].float(), out["pred_shape"].float()
            return {"pred_pose": pose, "pred_shape": shape,
                    "smpl_vertices": smpl_forward(smpl, shape, pose).vertices}

    cpu = torch.device("cpu")
    step = make_gendered_eval_step(Reference().eval(), h36m_regressor(args.data_dir, cpu))
    smpls = [resolve_smpl_params(args.smpl_dir, g, cpu) for g in ("neutral", "male", "female")]
    mean = np.asarray(IMG_NORM_MEAN, np.float32)
    std = np.asarray(IMG_NORM_STD, np.float32)
    dataset = _dataset(args)
    errs = []
    for s in range(0, len(dataset), args.batch_size):
        items = [dataset[i] for i in range(s, min(s + args.batch_size, len(dataset)))]
        batch = {k: torch.from_numpy(np.stack([np.asarray(it[k]) for it in items]))
                 for k in ("bbox_info", "pose", "betas")}
        batch["img"] = torch.from_numpy(
            ((np.stack([it["img"] for it in items]) / 255.0 - mean) / std).astype(np.float32))
        batch["gender"] = torch.tensor([int(it.get("gender", -1)) for it in items])
        with torch.no_grad():
            errs.extend(step(batch, *smpls)["mpjpe"].tolist())
    return float(np.mean(errs) * 1000.0)


def main(argv=None) -> dict:
    args = parse_args(argv)
    for path, what in ((args.smpl_dir, "SMPL dir"), (args.torch_ckpt, "torch checkpoint"),
                       (args.data_dir, "data dir")):
        if not os.path.exists(path):
            raise SystemExit(f"{what} not found: {path}")
    if args.ref_mpjpe is None and not args.reference_root:
        raise SystemExit("no reference side: give --ref_mpjpe or --reference_root")

    from ..config import model_config_from_hparams, update_hparams
    from ..device import resolve_device
    from ..models.poco import POCO
    from .convert_checkpoint import load_full_coverage

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hparams = update_hparams(args.cfg)
    torch.manual_seed(0)
    model = POCO(model_config_from_hparams(hparams))
    # 1. full coverage, or no gate
    n = load_full_coverage(model, args.torch_ckpt, log=lambda m: print(m, file=sys.stderr))
    print(f"converted: {n} tensors, 0 skipped", file=sys.stderr)
    # 2. the port
    mpjpe_port = eval_port(args, hparams, model.to(device).eval(), device)
    # 3. the reference
    if args.ref_mpjpe is not None:
        mpjpe_ref = float(args.ref_mpjpe)
    else:
        mpjpe_ref = eval_reference(args, hparams)
    delta = abs(mpjpe_port - mpjpe_ref)
    verdict = {
        "gate": "golden_3dpw_mpjpe",
        "mpjpe_port_mm": round(mpjpe_port, 3),
        "mpjpe_ref_mm": round(mpjpe_ref, 3),
        "delta_mm": round(delta, 3),
        "budget_mm": args.budget_mm,
        "pass": bool(delta <= args.budget_mm),
    }
    print(json.dumps(verdict), flush=True)
    return verdict


if __name__ == "__main__":
    sys.exit(0 if main()["pass"] else 1)
