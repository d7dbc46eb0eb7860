"""The `frames_hmr2` traffic: the `frames` traffic (`runners/frames.py`)
through HMR 2.0. The same client (a closed loop, depth-1 dispatch-ahead,
outputs copied to host memory as fp32 numpy), the same seeded frames,
boxes and SMPL, the same comparison (`compare.frames_readings` of
`check_requests` requests drawn from the seed), with two differences:

- the reference is `reference/hmr2.py` at the configuration's `trunk` and
  `decoder` widths, its weights drawn from the seed at the spread of each
  module's initializer (`seeded_weights`; there is no BN layer to
  calibrate);
- the reference crops at the configuration's `img_res` (256), as the
  port's request does at its model's.

`run` and `control` are frames.py's own, run from a second copy of that
module (`LOOP`) whose `inputs` and `reference_outputs` are this module's.
A traced run's summary also holds `vit_mlp_shape` (tokens a call, width,
hidden) for `vit_mlp_roofline.infer`."""

from __future__ import annotations

import importlib.util
import math
from pathlib import Path

import torch
from torch import nn

from bench import manifest, synth
from reference.hmr2 import HMR2
from reference.preprocess import preprocess_crops as ref_preprocess
from reference.train import smpl_from_arrays

FRAMES = manifest.runner("frames", Path(__file__).resolve().parents[1])
END_TO_END = FRAMES.END_TO_END
READINGS = FRAMES.READINGS
PRECISIONS = FRAMES.PRECISIONS
CELL_KEYS = FRAMES.CELL_KEYS
check = FRAMES.check


def seeded_weights(model: nn.Module, gen: torch.Generator) -> None:
    """Every parameter from one uniform draw on the model's device: each
    leaf U(-b, b) at the spread its module's own initializer gave it (b =
    sqrt(3) times the leaf's root mean square: the published truncated
    normal of std 0.02 draws at std 0.02, a zero bias stays zero), and
    LayerNorm gains U(0.5, 1.5) and shifts U(-0.05, 0.05), as
    `synth.seeded_weights` draws BN's. That function bounds a leaf by its
    largest magnitude, a 5-sigma tail of ViT-H's 6.5 M-entry matrices (2.9
    times the published spread), and leaves LayerNorm gains of either
    sign: a ViT-H drawn so is chaotic on some seeds, where fp32 rounding
    alone moves its features by over 10% through the 32 blocks."""
    params = list(model.parameters())
    norms = {}
    for m in model.modules():
        if isinstance(m, nn.LayerNorm):
            norms[id(m.weight)] = (0.5, 1.0)
            norms[id(m.bias)] = (0.05, 0.0)
    rms = [float(n) / p.numel() ** 0.5 for n, p in
           zip(torch.stack(torch._foreach_norm(params, 2)).tolist(), params)]
    spread = [norms.get(id(p), (3 ** 0.5 * r, 0.0)) for p, r in zip(params, rms)]
    flat = torch.empty(sum(p.numel() for p in params), device=params[0].device)
    flat.uniform_(-1.0, 1.0, generator=gen)
    views = [v.view_as(p) for v, p in zip(flat.split([p.numel() for p in params]), params)]
    torch._foreach_mul_(views, [b for b, _ in spread])
    torch._foreach_add_(views, [c for _, c in spread])
    with torch.no_grad():
        torch._foreach_copy_(params, views)


def reference_model(config: dict, seed: int, device) -> HMR2:
    """The frozen reference HMR 2.0 with the seed's weights."""
    torch.manual_seed(int(seed) % 2**63)   # the initializers' spread (`seeded_weights`)
    with torch.device(device):
        model = HMR2(synth.ref_config(config["model"]), config["trunk"], config["decoder"])
    model.to(device)
    seeded_weights(model, synth.generator(seed + 1, device))
    return model.eval()


def inputs(ctx) -> dict:
    """Frames, boxes and SMPL arrays drawn as the frames runner draws them
    from the seed, the reference SMPL and the reference model."""
    dev, traffic, cfg = ctx.device, ctx.traffic, ctx.config
    gen = synth.generator(ctx.seed, dev)
    frames = synth.frame_pool(gen, dev, traffic)
    boxes = synth.box_sets(gen, dev, traffic)
    arrays = synth.smpl_arrays(gen, dev, cfg["smpl"]["num_verts"], cfg["smpl"]["num_faces"])
    return {"frames": frames, "boxes": boxes, "arrays": arrays,
            "ref_smpl": smpl_from_arrays(arrays), "ref": reference_model(cfg, ctx.seed, dev)}


@torch.no_grad()
def reference_outputs(ref, ref_smpl, frame, centers, scales, keys) -> dict:
    dev = next(ref.parameters()).device
    batch = ref_preprocess(torch.from_numpy(frame).to(dev), torch.from_numpy(centers).to(dev),
                           torch.from_numpy(scales).to(dev), out_res=ref.cfg.img_res)
    out = ref(batch, ref_smpl)
    return {k: out[k].float().cpu().numpy() for k in keys if out.get(k) is not None}


def _loop():
    spec = importlib.util.spec_from_file_location("gpubench_runner_frames_of_hmr2",
                                                  FRAMES.__file__)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.inputs, module.reference_outputs = inputs, reference_outputs
    return module


LOOP = _loop()


def mlp_shape(config: dict, boxes: int) -> tuple[int, int, int]:
    """(tokens a call, width, hidden) of one block's MLP at `boxes` crops."""
    trunk = config["trunk"]
    p = trunk["patch_size"]
    grid = [(s + 4 - p) // p + 1 for s in trunk["img_size"]]   # the patch conv, padding 2
    return boxes * math.prod(grid), trunk["embed_dim"], trunk["mlp_ratio"] * trunk["embed_dim"]


def run(ctx) -> dict:
    out = LOOP.run(ctx)
    if out["summary"]:
        out["summary"]["vit_mlp_shape"] = mlp_shape(ctx.config, ctx.traffic["boxes"])
    return out


def control(ctx) -> dict:
    """The reference in TF32 in the port's place, as `frames.control`."""
    return LOOP.control(ctx)
