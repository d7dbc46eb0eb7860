"""Where the loss-on train step of the PyTorch port and the JAX package part
on the CPU, against the port's own float64 step.

    JAX_PLATFORMS=cpu python tools/step_precision.py [--no-mkldnn]

The narrow POCO-PARE twin of tests/test_torch_model.py (V=6890 SMPL, B=2),
configs/poco_pare.yaml with the render and/or part-segmentation loss on,
set up as tests/test_torch_train_render.py sets it up: all-keep dropout,
the ReLU branches of the port's float64 forward on both sides, JAX's step
on the port's GT part labels. For each loss setting it prints

  * the render and segmentation terms: the port (fp32), JAX (fp32), the
    port in float64, and the port's relative distance from JAX and from
    its float64 value;
  * the gradient leaves furthest from JAX's at the test's bar (1e-3
    relative + 1e-5 sqrt(n), L2): the distance over the bar, and the
    distances of the port's and JAX's gradients from the port's float64;

then, with the render loss on, each forward output's largest distance
from the port's float64 forward (port fp32, JAX fp32), and the soft
rasterizer's own vertex gradient of `render_losses` (fp32 of each package
against float64). `--no-mkldnn` runs the port's CPU convolutions without
oneDNN. Needs JAX, flax and torch; it runs where the tests run.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

import poco_tpu.train.step as jax_step_module  # noqa: E402
from poco_tpu.ops import soft_raster as jax_raster  # noqa: E402
from poco_tpu_torch.ops import soft_raster  # noqa: E402
from tests.test_torch_model import PARE_YAML, narrow_models  # noqa: E402
from tests.test_torch_render_loss import _meshes  # noqa: E402
from tests.test_torch_train import (  # noqa: E402
    GRAD_ATOL,
    GRAD_RTOL,
    LR,
    ModuleAdam,
    ReluMasks,
    _all_keep,
    _float64_grads,
    _j,
    _jax_relu_replay,
    _shared_part_labels,
    _t,
    _train_batch,
    create_train_state,
    jax_loss_config,
    jax_make_train_step,
    jax_update_hparams,
    jax_variables,
    loss_config_from_hparams,
    make_fused_optimizer,
    make_train_step,
    prepare_gt,
    state_dict_from_jax,
    update_hparams,
)

SETTINGS = {
    "render + segmentation": "  USE_SMPL_RENDER_LOSS: true\n  USE_SMPL_SEGM_LOSS: true\n",
    "render": "  USE_SMPL_RENDER_LOSS: true\n",
    "segmentation": "  USE_SMPL_SEGM_LOSS: true\n",
}
TERMS = ("loss/loss_smpl_render", "loss/loss_smpl_segm")


def _yaml(tmp: str, flags: str) -> str:
    path = os.path.join(tmp, "poco_pare_losses.yaml")
    with open(path, "w") as f:
        f.write(PARE_YAML.read_text() + "TRAINING:\n" + flags)
    return path


def step_readings(name: str, yaml: str, leaves: int = 5) -> None:
    with pytest.MonkeyPatch.context() as mp:
        twin = narrow_models(mp, "pare")
        model, jax_model = twin["model"], twin["jax_model"]
        _all_keep(mp)
        loss_cfg = loss_config_from_hparams(update_hparams(yaml))
        batch = _train_batch(7)
        masks = ReluMasks()
        grads64, terms64 = _float64_grads(model, _t(batch), twin["smpl"], loss_cfg, masks)
        _jax_relu_replay(mp, masks)
        if loss_cfg.use_smpl_segm_loss:
            _shared_part_labels(mp, _t(batch), twin["smpl"], loss_cfg)
        variables = jax.tree.map(np.array, jax_variables(model))
        jax_state = create_train_state(jax_model, variables, make_fused_optimizer(lr=LR))
        step = jax_make_train_step(jax_model, jax_loss_config(jax_update_hparams(yaml)),
                                   donate=False)
        new_state, jax_metrics = jax.block_until_ready(
            step(jax_state, _j(batch), twin["jax_smpl"], jax.random.PRNGKey(0)))
        with masks.replay():
            metrics = make_train_step(model, ModuleAdam(model, lr=LR), loss_cfg)(
                _t(batch), twin["smpl"])

    print(f"== {name}")
    for key in TERMS:
        if key in jax_metrics:
            got, want, f64 = float(metrics[key]), float(jax_metrics[key]), terms64[key]
            print(f"{key}: port {got!r}, JAX {want!r}, port float64 {f64!r}; port from JAX "
                  f"{(got - want) / want:.3e}, from its float64 {(got - f64) / f64:.3e}")
    grads = {}
    for group, sub in new_state.opt_state["groups"].items():
        _, unravel = ravel_pytree(jax_state.params[group])
        grads[group] = unravel(sub["m"] / 0.1)   # the fused Adam's first moment
    rows = []
    for key, ref in state_dict_from_jax({"params": jax.tree.map(np.asarray, grads)}).items():
        got, ref = model.get_parameter(key).grad.double(), ref.double()
        bar = GRAD_RTOL * float(ref.norm()) + GRAD_ATOL * ref.numel() ** 0.5
        err = float((got - ref).norm())
        rows.append((err / bar, key, err, bar, float((got - grads64[key]).norm()),
                     float((ref - grads64[key]).norm())))
    for ratio, key, err, bar, port64, jax64 in sorted(rows, reverse=True)[:leaves]:
        print(f"  {key}: {ratio:.3f} of the bar (port from JAX {err:.3e}, bar {bar:.3e}; "
              f"from the port's float64: port {port64:.3e}, JAX {jax64:.3e})")


def forward_readings(yaml: str) -> None:
    """Each forward output's largest distance from the port's float64
    forward, the ReLU branches of that forward on every side."""
    with pytest.MonkeyPatch.context() as mp:
        twin = narrow_models(mp, "pare")
        model, smpl = twin["model"], twin["smpl"]
        _all_keep(mp)
        batch = _train_batch(7)
        masks = ReluMasks()
        model64 = copy.deepcopy(model).double().train()
        smpl64 = dataclasses.replace(smpl, **{
            f.name: getattr(smpl, f.name).double() for f in dataclasses.fields(smpl)
            if torch.is_tensor(getattr(smpl, f.name)) and getattr(smpl, f.name).is_floating_point()
        })
        batch64 = {k: v.double() if v.is_floating_point() else v for k, v in _t(batch).items()}
        gt64 = prepare_gt(batch64, smpl64)
        with masks.record(), torch.no_grad():
            out64 = model64(dict(batch64, gt_pose_rotmat=gt64["gt_pose_rotmat"]), smpl64)
        gt32 = prepare_gt(_t(batch), smpl)
        with masks.replay(), torch.no_grad():
            out32 = copy.deepcopy(model).train()(
                dict(_t(batch), gt_pose_rotmat=gt32["gt_pose_rotmat"]), smpl)
        _jax_relu_replay(mp, masks)
        jgt = jax_step_module.prepare_gt(_j(batch), twin["jax_smpl"])
        jax_out, _ = twin["jax_model"].apply(
            jax.tree.map(np.array, jax_variables(model)),
            dict(_j(batch), gt_pose_rotmat=jgt["gt_pose_rotmat"]), twin["jax_smpl"],
            train=True, rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
    print("== forward outputs, largest distance from the port's float64 forward")
    for key in sorted(out64):
        if not torch.is_tensor(out64[key]) or jax_out.get(key) is None:
            continue
        ref = out64[key].numpy()
        port, other = out32[key].double().numpy(), np.asarray(jax_out[key], np.float64)
        if port.shape == ref.shape == other.shape:
            print(f"  {key}: port {np.abs(port - ref).max():.3e}, JAX {np.abs(other - ref).max():.3e}"
                  f" (largest |value| {np.abs(ref).max():.3e})")


def rasterizer_readings() -> None:
    """`render_losses`' vertex gradient on two V=6890 meshes, fp32 of each
    package against the port's float64, relative L2."""
    verts, cams, _ = _meshes(6890, seed=1)
    gt = verts[::-1].copy()

    def port(dtype):
        v = torch.from_numpy(verts.astype(dtype)).requires_grad_()
        soft_raster.render_losses(v, torch.from_numpy(gt.astype(dtype)),
                                  torch.from_numpy(cams.astype(dtype))).backward()
        return v.grad.double().numpy()

    def other(dtype):
        return np.asarray(jax.grad(lambda v: jax_raster.render_losses(
            v, jnp.asarray(gt.astype(dtype)), jnp.asarray(cams.astype(dtype))))(
                jnp.asarray(verts.astype(dtype))), np.float64)

    ref = port(np.float64)
    with jax.enable_x64(True):
        jax64 = other(np.float64)
    port32, jax32 = port(np.float32), other(np.float32)
    norm = np.linalg.norm(ref)
    print("== render_losses' vertex gradient, relative L2: port fp32 from float64 "
          f"{np.linalg.norm(port32 - ref) / norm:.3e}, JAX fp32 "
          f"{np.linalg.norm(jax32 - ref) / norm:.3e}, port from JAX "
          f"{np.linalg.norm(port32 - jax32) / norm:.3e}; float64 port from JAX "
          f"{np.linalg.norm(ref - jax64) / norm:.3e}")


def main() -> None:
    import tempfile

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--no-mkldnn", action="store_true",
                        help="the port's CPU convolutions without oneDNN")
    args = parser.parse_args()

    torch.set_num_threads(1)
    if args.no_mkldnn:
        torch.backends.mkldnn.enabled = False
    print(f"torch {torch.__version__}, jax {jax.__version__}, oneDNN "
          f"{'off' if args.no_mkldnn else 'on'}")
    with tempfile.TemporaryDirectory() as tmp:
        for name, flags in SETTINGS.items():
            step_readings(name, _yaml(tmp, flags))
        forward_readings(_yaml(tmp, SETTINGS["render"]))
    rasterizer_readings()


if __name__ == "__main__":
    main()
