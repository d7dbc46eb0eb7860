"""PyTorch port vs JAX package: the training path.

The same seeded numpy inputs through each module of training on both
sides, with the tolerance stated at each check:

  * every term of `poco_loss`, over every `loss_ver`, `sigma1_nll`, the
    2-D-sigma fallthrough, excluded parts, `keypoint2d_noncrop` on and
    off, a batch with no SMPL rows, GT-conditioned rows and
    `hmr_loss_config`: rtol 1e-5, atol 1e-6;
  * the optimizer (`ModuleAdam` against `make_fused_optimizer`) over 5
    steps with module LRs, a frozen module, clipping and weight decay:
    atol 2e-6, rtol 1e-5 (the bar of tests/test_trainer.py:163-166);
  * `prepare_gt`: atol 1e-6; `make_eval_step`: 1e-4 m;
  * one train step on the narrow POCO-CLIFF twin
    (`test_torch_model.narrow_models`) and on `tiny-cliff`, dropout
    all-keep on both sides (flax draws its mask through
    `jax.random.bernoulli`, the port through
    `models.layers.dropout_keep_mask`; both are patched) and the ReLU
    branches of the port's float64 forward on both (`train.checks.
    ReluMasks`), at batch 2: the loss (rtol 1e-5), each gradient leaf
    through `state_dict_from_jax` (atol 1e-5 + rtol 1e-3, elementwise on
    tiny-cliff, in L2 form on the narrow twin), the BN running statistics after the step (atol 1e-6 + rtol
    1e-5 on tiny-cliff; atol 1e-5 + rtol 1e-4 on the narrow twin, whose
    deep layers carry its fp32 forward noise: both far below the 1% that separates
    flax's biased variance, which the port's BN follows, from torch's
    unbiased one at n = 98), and
    the parameters after the step where both gradients exceed 1e-6 with
    one sign (atol 2e-6; Adam's first step is lr * g / |g|, so where a
    gradient is fp32 noise its sign is arbitrary). JAX's gradients are read from its optimizer state after
    the step: the fused Adam's first moment is (1 - b1) g.
"""

import copy
import dataclasses

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import poco_tpu.losses.losses as jax_losses
import poco_tpu.models.poco as jax_poco
import poco_tpu.ops.soft_raster as jax_soft_raster
from poco_tpu.config import loss_config_from_hparams as jax_loss_config
from poco_tpu.config import model_config_from_hparams as jax_model_config
from poco_tpu.config import update_hparams as jax_update_hparams
from poco_tpu.ops.rotation import axis_angle_to_rotmat as jax_aa_to_rotmat
from poco_tpu.smpl.assets import synthetic_smpl_model as jax_synthetic_smpl
from poco_tpu.train.state import create_train_state, make_fused_optimizer
from poco_tpu.train.step import make_train_step as jax_make_train_step
from poco_tpu.train.step import prepare_gt as jax_prepare_gt

import poco_tpu_torch.losses.losses as losses
import poco_tpu_torch.models.poco as port_poco
from poco_tpu_torch.config import (
    loss_config_from_hparams,
    model_config_from_hparams,
    parse_freeze_params,
    parse_module_lr,
    update_hparams,
)
from poco_tpu_torch.models import layers
from poco_tpu_torch.smpl.assets import synthetic_smpl_model
from poco_tpu_torch.train.checks import ReluMasks
from poco_tpu_torch.train.state import ModuleAdam, check_finite, count_params
from poco_tpu_torch.train.step import (
    add_pred_render,
    make_train_step,
    prepare_gt,
    render_targets,
)
from poco_tpu_torch.utils.weights import (
    calibrate_batchnorm,
    randomize_batchnorm,
    state_dict_from_jax,
)

from .test_torch_model import CLIFF_YAML, REPO, jax_variables, narrow_models

LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-6
OPT_ATOL, OPT_RTOL = 2e-6, 1e-5
GT_ATOL = 1e-6
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-3
# BN running statistics: the narrow twin's deep layers carry its fp32
# forward noise (see test_train_step_matches_jax)
BN_TOL = {"tiny_cliff": (1e-6, 1e-5), "narrow_cliff": (1e-5, 1e-4)}  # atol, rtol
STEP_ATOL, STEP_GRAD_FLOOR = 2e-6, 1e-6
LR = 1e-4
TINY_YAML = REPO / "configs" / "tiny_smoke.yaml"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module (see
    tests/test_torch_eval.py: the fast tier's six workers share the
    host). Restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


# --------------------------------------------------------------------------
# config bridges
# --------------------------------------------------------------------------

def test_loss_config_and_module_specs_match_jax():
    from poco_tpu.config import parse_freeze_params as jax_freeze
    from poco_tpu.config import parse_module_lr as jax_module_lr

    for yaml in (CLIFF_YAML, TINY_YAML, REPO / "configs" / "spin_hmr.yaml"):
        port = dataclasses.asdict(loss_config_from_hparams(update_hparams(str(yaml))))
        ref = dataclasses.asdict(jax_loss_config(jax_update_hparams(str(yaml))))
        assert port == ref, yaml
    rename = {"backbone_net": "backbone"}
    spec = "0.1_0.5_1.0_2.0"
    assert parse_module_lr(spec) == {rename.get(k, k): v for k, v in jax_module_lr(spec).items()}
    spec = "0-backbone-head,3-flow_head,5-backbone_net-uncert_head"
    assert parse_freeze_params(spec) == {
        e: [rename.get(m, m) for m in mods] for e, mods in jax_freeze(spec).items()
    }


def test_grid_search_matches_jax(tmp_path):
    from poco_tpu.config import get_grid_search_configs as jax_grid
    from poco_tpu.config import run_grid_search_experiments as jax_run

    from poco_tpu_torch.config import get_grid_search_configs, run_grid_search_experiments

    cfg = {"METHOD": "poco", "OPTIMIZER": {"LR": [1e-4, 3e-4]},
           "DATASET": {"BATCH_SIZE": [8, 16, 32]}, "POCO": {"BACKBONE": "tiny-cliff"}}
    assert get_grid_search_configs(cfg) == jax_grid(cfg)
    yaml_path = tmp_path / "grid.yaml"
    import yaml

    yaml_path.write_text(yaml.safe_dump(cfg))
    port = run_grid_search_experiments(str(yaml_path), 4, logdir=str(tmp_path / "a"))
    ref = jax_run(str(yaml_path), 4, logdir=str(tmp_path / "b"))
    assert port.EXP_ID == ref.EXP_ID
    assert port.OPTIMIZER.LR == ref.OPTIMIZER.LR
    assert port.DATASET.BATCH_SIZE == ref.DATASET.BATCH_SIZE
    assert (tmp_path / "a" / "config_to_run.yaml").read_text() == (
        tmp_path / "b" / "config_to_run.yaml").read_text()


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------

def _loss_inputs(seed, sigma="2d", no_smpl=False, cond=True, parts=24, hmr=False):
    rng = np.random.RandomState(seed)
    b, v = 4, 50
    rot = np.asarray(jax_aa_to_rotmat(jnp.asarray(0.4 * rng.randn(b * 24, 3), jnp.float32)))
    pred = {
        "pred_pose": rot.reshape(b, 24, 3, 3),
        "pred_shape": rng.randn(b, 10).astype(np.float32),
        "pred_cam": np.stack([rng.uniform(0.5, 1.2, b), 0.1 * rng.randn(b), 0.1 * rng.randn(b)],
                             1).astype(np.float32),
        "smpl_joints2d": rng.uniform(100, 700, (b, 49, 2)).astype(np.float32),
        "smpl_joints3d": rng.randn(b, 49, 3).astype(np.float32),
        "smpl_vertices": rng.randn(b, v, 3).astype(np.float32),
    }
    if not hmr:
        shape = {"2d": (b, parts), "9d": (b, parts, 3, 3)}[sigma]
        pred["var_pose"] = rng.uniform(0.05, 0.95, shape).astype(np.float32)
        if sigma == "2d":  # the flow's term pairs a (B, P) log_phi with a (B, P) sigma
            pred["log_phi"] = rng.randn(b, parts).astype(np.float32)
    kp = rng.uniform(-1, 1, (b, 49, 3)).astype(np.float32)
    kp[..., 2] = rng.rand(b, 49) > 0.3
    kp_full = np.concatenate([rng.uniform(100, 700, (b, 49, 2)), rng.rand(b, 49, 1)],
                             -1).astype(np.float32)
    gt = {
        "pose": (0.3 * rng.randn(b, 72)).astype(np.float32),
        "betas": rng.randn(b, 10).astype(np.float32),
        "pose_3d": np.concatenate([rng.randn(b, 24, 3), rng.rand(b, 24, 1)], -1).astype(np.float32),
        "vertices": rng.randn(b, v, 3).astype(np.float32),
        "has_smpl": (np.zeros(b) if no_smpl else np.asarray([1, 1, 0, 1])).astype(np.float32),
        "has_pose_3d": np.asarray([1, 0, 1, 1], np.float32),
        "keypoints": kp,
        "keypoints_fullimg": kp_full,
        "orig_shape": np.tile(np.asarray([[720.0, 1280.0]], np.float32), (b, 1)),
        "scale": rng.uniform(1, 3, b).astype(np.float32),
    }
    if cond:
        gt["gt_pose_cond_mask"] = np.asarray([True, False, True, False])
    return pred, gt


# id -> (LossConfig overrides, input options)
LOSS_CASES = {
    "gaus_2d_fallthrough": ({}, {}),
    "gaus_2d_sigma1_nll": ({"sigma1_nll": True}, {}),
    "gaus_9d": ({}, {"sigma": "9d"}),
    "res_9d": ({"loss_ver": "norm_flow_res"}, {"sigma": "9d"}),
    "res_2d_sigma1_nll": ({"loss_ver": "norm_flow_res", "sigma1_nll": True}, {}),
    "res_excluded_parts": ({"loss_ver": "norm_flow_res", "sigma1_nll": True}, {"parts": 20}),
    "gaus_excluded_parts": ({"sigma1_nll": True}, {"sigma": "9d", "parts": 22}),
    "norm_flow": ({"loss_ver": "norm_flow", "sigma1_nll": True}, {}),
    "unknown_ver_zero_pose": ({"loss_ver": "norm_flow_res_gauss", "sigma1_nll": True}, {}),
    "noncrop": ({"keypoint2d_noncrop": True, "shape_loss_weight": 1.0}, {}),
    "no_smpl_rows": ({}, {"no_smpl": True}),
    "no_gt_cond": ({"sigma1_nll": True}, {"cond": False}),
    "weights": ({"pose_uncert_weight": 0.01, "beta_uncert_weight": 2.0, "nf_loss_weight": 0.1,
                 "openpose_train_weight": 0.5, "loss_weight": 30.0}, {"sigma": "9d"}),
    "hmr": ("hmr", {"hmr": True, "cond": False}),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_poco_loss_terms_match_jax(case):
    overrides, opts = LOSS_CASES[case]
    if overrides == "hmr":
        cfg, jcfg = losses.hmr_loss_config(), jax_losses.hmr_loss_config()
    else:
        cfg, jcfg = losses.LossConfig(**overrides), jax_losses.LossConfig(**overrides)
    assert cfg.effective_pose_weight == jcfg.effective_pose_weight
    pred, gt = _loss_inputs(sorted(LOSS_CASES).index(case), **opts)
    total, terms = losses.poco_loss(_t(pred), _t(gt), cfg)
    jtotal, jterms = jax_losses.poco_loss(_j(pred), _j(gt), jcfg)
    assert set(terms) == set(jterms)
    for key in jterms:
        np.testing.assert_allclose(terms[key].numpy(), np.asarray(jterms[key]),
                                   rtol=LOSS_RTOL, atol=LOSS_ATOL, err_msg=key)
    assert bool(torch.isfinite(total))
    if opts.get("no_smpl"):
        assert float(terms["loss/loss_regr_pose"]) == 0.0
        assert float(terms["loss/loss_regr_betas"]) == 0.0


def test_masked_mean_of_no_rows_is_zero():
    assert float(losses.masked_mean(torch.ones(4, 3), torch.zeros(4))) == 0.0
    x = torch.tensor([[1.0], [3.0], [5.0], [7.0]])
    assert float(losses.masked_mean(x, torch.tensor([1.0, 0.0, 1.0, 0.0]))) == 3.0


# --------------------------------------------------------------------------
# optimizer
# --------------------------------------------------------------------------

class _Groups(torch.nn.Module):
    """Four top-level modules of a few parameters each, as POCO's."""

    def __init__(self, tree):
        super().__init__()
        for name, leaves in tree.items():
            module = torch.nn.Module()
            for leaf, value in leaves.items():
                module.register_parameter(leaf, torch.nn.Parameter(torch.from_numpy(value.copy())))
            setattr(self, {"backbone_net": "backbone"}.get(name, name), module)


OPT_CASES = {
    "plain": {},
    "module_lr": {"module_lr": {"backbone_net": 0.1, "head": 0.5}},
    "frozen": {"frozen_modules": ("flow_head",)},
    "clip": {"grad_clip": 0.05},
    "weight_decay": {"weight_decay": 1e-2},
    "all": {"module_lr": {"backbone_net": 0.1, "uncert_head": 2.0},
            "frozen_modules": ("head",), "grad_clip": 1.0, "weight_decay": 1e-3},
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimizer_matches_fused_jax(case):
    kwargs = OPT_CASES[case]
    rng = np.random.RandomState(sorted(OPT_CASES).index(case))
    tree = {
        name: {f"w{i}": rng.randn(*shape).astype(np.float32)
               for i, shape in enumerate([(3, 4), (5,), (2, 2, 3)])}
        for name in ("backbone_net", "head", "uncert_head", "flow_head")
    }
    port_kwargs = dict(kwargs)
    rename = {"backbone_net": "backbone"}
    port_kwargs["module_lr"] = {rename.get(k, k): v for k, v in kwargs.get("module_lr", {}).items()}
    port_kwargs["frozen_modules"] = tuple(rename.get(k, k) for k in kwargs.get("frozen_modules", ()))
    model = _Groups(tree)
    opt = ModuleAdam(model, lr=1e-2, **port_kwargs)
    tx = make_fused_optimizer(lr=1e-2, **kwargs)
    params = jax.tree.map(jnp.asarray, tree)
    state = tx.init(params)
    for step in range(5):
        grads = jax.tree.map(lambda p: (0.1 * rng.randn(*p.shape)).astype(np.float32), tree)
        for name, leaves in grads.items():
            module = getattr(model, rename.get(name, name))
            for leaf, g in leaves.items():
                getattr(module, leaf).grad = torch.from_numpy(g.copy())
        norm = opt.step()
        updates, state = tx.update(jax.tree.map(jnp.asarray, grads), state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        jnorm = jnp.sqrt(sum(jnp.sum(g ** 2) for g in jax.tree.leaves(grads)))
        np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
        for name, leaves in params.items():
            module = getattr(model, rename.get(name, name))
            for leaf, value in leaves.items():
                np.testing.assert_allclose(
                    getattr(module, leaf).detach().numpy(), np.asarray(value),
                    atol=OPT_ATOL, rtol=OPT_RTOL, err_msg=f"{case} step {step} {name}/{leaf}",
                )


def test_lr_scale_halves_the_update_in_place():
    """The plateau scheduler's scale: the same optimizer object, every
    group's LR halved, the moments kept."""
    tree = {"head": {"w": np.ones((3,), np.float32)}, "backbone_net": {"w": np.ones(2, np.float32)}}
    model = _Groups(tree)
    opt = ModuleAdam(model, lr=1e-2, module_lr={"backbone": 0.1})
    model.head.w.grad = torch.ones(3)
    model.backbone.w.grad = torch.ones(2)
    opt.step()
    state_before = {k: v["exp_avg"].clone() for k, v in opt.optimizer.state.items()}
    opt.set_lr_scale(0.5)
    assert {g["name"]: g["lr"] for g in opt.groups} == pytest.approx(
        {"backbone": 0.5e-2 * 0.1, "head": 0.5e-2})
    for p, s in opt.optimizer.state.items():
        assert torch.equal(s["exp_avg"], state_before[p])


def test_count_params_and_check_finite():
    tree = {"head": {"w": np.ones((3, 4), np.float32)}, "flow_head": {"w": np.ones(5, np.float32)}}
    counts = count_params(_Groups(tree))
    assert counts == {"head": 12, "flow_head": 5, "total": 17}
    check_finite({"a": torch.ones(3), "b": {"c": np.zeros(2)}})
    with pytest.raises(FloatingPointError, match="b/c"):
        check_finite({"a": torch.ones(3), "b": {"c": np.asarray([0.0, np.nan])}})


# --------------------------------------------------------------------------
# prepare_gt and one train step
# --------------------------------------------------------------------------

def _train_batch(seed, b=2):
    rng = np.random.RandomState(seed)
    center = rng.uniform(300, 900, (b, 2)).astype(np.float32)
    scale = rng.uniform(1.5, 3.0, b).astype(np.float32)
    orig = np.tile(np.asarray([[720.0, 1280.0]], np.float32), (b, 1))
    focal = np.full(b, float(np.hypot(720, 1280)), np.float32)
    kp_full = np.concatenate(
        [center[:, None] + 60 * rng.randn(b, 49, 2), np.ones((b, 49, 1))], -1
    ).astype(np.float32)
    return {
        "img": rng.randn(b, 224, 224, 3).astype(np.float32),
        "bbox_info": np.stack([(center[:, 0] - 640) / focal * 2.8,
                               (center[:, 1] - 360) / focal * 2.8,
                               (scale * 200 - 0.24 * focal) / (0.06 * focal)], 1).astype(np.float32),
        "focal_length": focal, "scale": scale, "center": center, "orig_shape": orig,
        "pose": rng.uniform(-0.3, 0.3, (b, 72)).astype(np.float32),
        "betas": rng.uniform(-0.5, 0.5, (b, 10)).astype(np.float32),
        "has_smpl": np.ones(b, np.float32),
        "has_pose_3d": np.asarray([1.0, 0.0] * b, np.float32)[:b],
        "pose_3d": np.concatenate([0.3 * rng.randn(b, 24, 3), np.ones((b, 24, 1))],
                                  -1).astype(np.float32),
        "keypoints": rng.uniform(-1, 1, (b, 49, 3)).astype(np.float32),
        "keypoints_fullimg": kp_full,
        "gt_pose_cond_mask": np.asarray([True, False] * b)[:b],
    }


@pytest.mark.parametrize("synthesize", [False, True])
def test_prepare_gt_matches_jax(synthesize):
    batch = _train_batch(1, b=3)
    if synthesize:  # no 3D joints or crop keypoints: both are made from the GT joints
        del batch["pose_3d"], batch["keypoints"]
    port = prepare_gt(_t(batch), synthetic_smpl_model(num_verts=6890, device="cpu"))
    ref = jax_prepare_gt(_j(batch), jax_synthetic_smpl(num_verts=6890))
    assert set(port) == set(ref)
    for key in ("gt_pose_rotmat", "vertices", "model_joints", "pose_3d", "keypoints"):
        np.testing.assert_allclose(port[key].numpy(), np.asarray(ref[key]), atol=GT_ATOL,
                                   rtol=0, err_msg=key)


def _tiny_models(mp, seed=0):
    """The tiny-cliff pair of configs/tiny_smoke.yaml, built as
    `narrow_models` builds its twins."""
    cfg = model_config_from_hparams(update_hparams(str(TINY_YAML)))
    torch.manual_seed(seed)
    model = port_poco.POCO(cfg)
    randomize_batchnorm(model, torch.Generator().manual_seed(seed + 1))
    calibrate_batchnorm(
        model.backbone, torch.randn(4, 3, 224, 224, generator=torch.Generator().manual_seed(seed + 2))
    )
    return {
        "model": model,
        "jax_model": jax_poco.POCO(cfg=jax_model_config(jax_update_hparams(str(TINY_YAML)))),
        "smpl": synthetic_smpl_model(num_verts=6890, device="cpu"),
        "jax_smpl": jax_synthetic_smpl(num_verts=6890),
    }


def test_eval_step_matches_jax(monkeypatch):
    """`make_eval_step` (the validation step of the JAX package's
    trainer) on tiny-cliff, with and without an eval regressor: per-sample
    mpjpe, pa_mpjpe, v2v within 1e-4 m and the mean sigma within 2e-3, the
    head-output budget of tests/test_torch_model.py."""
    from poco_tpu.train.step import make_eval_step as jax_make_eval_step

    from poco_tpu_torch.train.step import make_eval_step

    twin = _tiny_models(monkeypatch)
    rng = np.random.RandomState(5)
    batch = {k: v for k, v in _train_batch(9, b=3).items()
             if k in ("img", "bbox_info", "focal_length", "scale", "center", "orig_shape")}
    batch["gt_vertices"] = (0.3 * rng.randn(3, 6890, 3)).astype(np.float32)
    batch["gt_joints3d"] = (0.3 * rng.randn(3, 24, 3)).astype(np.float32)
    reg = rng.rand(17, 6890).astype(np.float32)  # the H36M 17-joint regressor
    reg /= reg.sum(1, keepdims=True)
    variables = jax_variables(twin["model"])
    for regressor in (None, reg):
        port = make_eval_step(twin["model"], None if regressor is None else torch.from_numpy(regressor))(
            _t(batch), twin["smpl"])
        ref = jax_make_eval_step(twin["jax_model"], None if regressor is None else jnp.asarray(regressor))(
            variables, _j(batch), twin["jax_smpl"])
        assert set(port) == set(ref) == {"mpjpe", "pa_mpjpe", "v2v", "uncert"}
        for key, atol in (("mpjpe", 1e-4), ("pa_mpjpe", 1e-4), ("v2v", 1e-4), ("uncert", 2e-3)):
            np.testing.assert_allclose(port[key].numpy(), np.asarray(ref[key]), atol=atol, rtol=0,
                                       err_msg=key)


def _all_keep(monkeypatch):
    monkeypatch.setattr(
        jax.random, "bernoulli", lambda key, p=0.5, shape=None: jnp.ones(shape, bool)
    )
    monkeypatch.setattr(layers, "dropout_keep_mask", lambda x, keep: torch.ones_like(x, dtype=torch.bool))


def _float64_grads(model, batch, smpl, loss_cfg, masks):
    """The port's gradients and loss terms of the same loss, in float64 on
    the CPU; its ReLU masks are recorded into `masks`."""
    model64 = copy.deepcopy(model).double().train()
    smpl64 = dataclasses.replace(smpl, **{
        f.name: getattr(smpl, f.name).double() for f in dataclasses.fields(smpl)
        if torch.is_tensor(getattr(smpl, f.name)) and getattr(smpl, f.name).is_floating_point()
    })
    batch64 = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
    gt = prepare_gt(batch64, smpl64)
    gt.update(render_targets(batch64, gt, smpl64, loss_cfg))
    with masks.record():
        out = model64(dict(batch64, gt_pose_rotmat=gt["gt_pose_rotmat"]), smpl64)
    loss, terms = losses.poco_loss(add_pred_render(out, gt), gt, loss_cfg)
    loss.backward()
    return ({k: p.grad for k, p in model64.named_parameters()},
            {k: float(v.detach()) for k, v in terms.items()})


def _shared_part_labels(monkeypatch, batch, smpl, loss_cfg):
    """JAX's step takes the port's GT part labels (`render_targets` on the
    same batch, as the port's step makes them): each package takes its own
    argmax of its soft part probabilities, which can flip on a pixel where
    two parts tie to fp32 rounding, and a flipped label moves the
    segmentation loss's gradient by more than the bar."""
    labels = render_targets(batch, prepare_gt(batch, smpl), smpl, loss_cfg)["gt_segm_mask"]
    onehot = jax.nn.one_hot(labels.numpy(), smpl.lbs_weights.shape[-1] + 1)
    monkeypatch.setattr(jax_soft_raster, "soft_part_probs", lambda *args, **kwargs: onehot)


def _jax_relu_replay(monkeypatch, masks):
    """flax's `nn.relu` as x * mask with the port's recorded masks, NCHW
    ones in the JAX package's NHWC, in call order (the JAX step traces its
    forward once): `ReluMasks.replay` on the JAX side."""
    calls = iter(masks.masks)

    def replaying(x):
        mask = next(calls).numpy()
        if mask.ndim == 4:
            mask = mask.transpose(0, 2, 3, 1)
        assert mask.shape == x.shape, (mask.shape, x.shape)
        return x * jnp.asarray(mask, x.dtype)

    monkeypatch.setattr(flax.linen, "relu", replaying)


def _leaf_close(got, ref, atol, rtol):
    """The L2 form of atol + rtol over a gradient leaf:
    |got - ref| <= rtol |ref| + atol sqrt(n)."""
    err = float((got.double() - ref.double()).norm())
    return err <= rtol * float(ref.double().norm()) + atol * ref.numel() ** 0.5, err


@pytest.mark.parametrize("kind", ["narrow_cliff", "tiny_cliff"])
def test_train_step_matches_jax(monkeypatch, kind):
    """One train step of the port against `make_train_step` of the JAX
    package on the same weights and batch (B=2), both with all-keep
    dropout, POCO-CLIFF's loss settings (configs/poco_cliff.yaml:
    full-image 2D keypoints, shape loss, flow term).

    Both sides take the ReLU branches of the port's float64 forward
    (`train.checks.ReluMasks`; see its docstring): in train mode at batch 2
    the narrow HRNet twin's fp32 activations carry about 1e-4 of rounding
    at its last layers, which puts a few of its 21 M ReLU units on the
    other side of 0 in any two fp32 runs, and each such flip moves the
    backbone's gradients by whole units (3-16% in relative L2 without the
    masks, 3e-4 at most with them). Every gradient leaf of tiny-cliff is
    then held to atol 1e-5 + rtol 1e-3 elementwise, and every leaf of the
    narrow twin to the L2 form of the same bar (its largest elements sit
    at 3e-4 relative, so a few elements of 1e7 miss the elementwise rtol):
    |port - JAX| <= 1e-3 |JAX| + 1e-5 sqrt(n). The parameters after the
    step are compared where both gradients exceed 1e-6 with the same
    sign: Adam's first step is lr x g / (|g| + eps), so an element whose
    gradient is below its leaf's rounding (a few in 1e5 of the narrow
    twin's) moves by anything in [-lr, lr] on either side."""
    twin = narrow_models(monkeypatch, "cliff") if kind == "narrow_cliff" else _tiny_models(monkeypatch)
    check_train_step_against_jax(monkeypatch, twin, CLIFF_YAML, narrow=kind == "narrow_cliff")


def check_train_step_against_jax(monkeypatch, twin: dict, yaml, narrow: bool,
                                 expect_terms: tuple[str, ...] = (),
                                 fp32_floor: float = 0.0) -> None:
    """One train step of `twin["model"]` against JAX's `make_train_step`
    on `twin["jax_model"]`, with the loss settings of `yaml`, at the bars
    of `test_train_step_matches_jax` (each gradient leaf in L2 form on a
    narrow twin, elementwise otherwise); `expect_terms` must be among the
    loss terms. With the part-segmentation loss on, both steps take the
    port's GT part labels (`_shared_part_labels`).

    With `fp32_floor`, a loss term or a narrow twin's gradient leaf that
    misses its bar passes if it is within that multiple of the port's own
    fp32 distance from its float64 value: the port and JAX may then differ
    by no more than fp32 rounding moves the port. A fault of the port's
    arithmetic is in its float64 value too, and fails."""
    kind = "narrow_cliff" if narrow else "tiny_cliff"
    model, jax_model = twin["model"], twin["jax_model"]
    _all_keep(monkeypatch)
    loss_cfg = loss_config_from_hparams(update_hparams(str(yaml)))
    batch = _train_batch(7)
    masks = ReluMasks()
    f64_grads, f64_terms = _float64_grads(model, _t(batch), twin["smpl"], loss_cfg, masks)
    _jax_relu_replay(monkeypatch, masks)
    if loss_cfg.use_smpl_segm_loss:
        _shared_part_labels(monkeypatch, _t(batch), twin["smpl"], loss_cfg)

    # copies: the port's step below updates the weights in place, and
    # JAX's CPU arrays may share memory with numpy arrays, so JAX works on
    # its own buffers and is done before the port starts
    variables = jax.tree.map(np.array, jax_variables(model))
    jax_state = create_train_state(jax_model, variables, make_fused_optimizer(lr=LR))
    jax_step = jax_make_train_step(
        jax_model, jax_loss_config(jax_update_hparams(str(yaml))), donate=False
    )
    new_state, jax_metrics = jax.block_until_ready(
        jax_step(jax_state, _j(batch), twin["jax_smpl"], jax.random.PRNGKey(0))
    )

    optimizer = ModuleAdam(model, lr=LR)
    with masks.replay():
        metrics = make_train_step(model, optimizer, loss_cfg)(_t(batch), twin["smpl"])

    np.testing.assert_allclose(float(metrics["loss/total_loss"]),
                               float(jax_metrics["loss/total_loss"]), rtol=LOSS_RTOL)
    assert {k for k in metrics if not k.startswith("_")} == {
        k for k in jax_metrics if not k.startswith("_")}
    assert set(expect_terms) <= set(metrics)
    for key in jax_metrics:
        if key.startswith("loss/"):
            got, want = float(metrics[key]), float(jax_metrics[key])
            floor = fp32_floor * abs(got - f64_terms[key])
            if abs(got - want) > floor:
                np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=LOSS_ATOL,
                                           err_msg=key)

    # JAX's gradients: the fused Adam's first moment after one step
    grads = {}
    for group, sub in new_state.opt_state["groups"].items():
        _, unravel = ravel_pytree(jax_state.params[group])
        grads[group] = unravel(sub["m"] / 0.1)
    jax_grads = state_dict_from_jax({"params": jax.tree.map(np.asarray, grads)})
    port_grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(port_grads) == set(jax_grads)
    for key, ref in jax_grads.items():
        got = port_grads[key]
        if kind == "narrow_cliff":
            ok, err = _leaf_close(got, ref, GRAD_ATOL, GRAD_RTOL)
            floor = fp32_floor * float((got.double() - f64_grads[key]).norm())
            assert ok or err <= floor, (key, err, float(ref.norm()), floor)
        else:
            np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=GRAD_ATOL,
                                       rtol=GRAD_RTOL, err_msg=key)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(jax_metrics["grad_norm"]),
                               rtol=GRAD_RTOL)

    state = model.state_dict()
    stats = state_dict_from_jax({"batch_stats": jax.tree.map(np.asarray, new_state.batch_stats)})
    for key, ref in stats.items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(state[key].numpy(), ref.numpy(), atol=BN_TOL[kind][0],
                                       rtol=BN_TOL[kind][1], err_msg=key)

    new_params = state_dict_from_jax({"params": jax.tree.map(np.asarray, new_state.params)})
    for key, ref in new_params.items():
        moved = (jax_grads[key].abs() > STEP_GRAD_FLOOR) & (
            port_grads[key].abs() > STEP_GRAD_FLOOR) & (
            torch.sign(jax_grads[key]) == torch.sign(port_grads[key]))
        np.testing.assert_allclose(state[key][moved].numpy(), ref[moved].numpy(),
                                   atol=STEP_ATOL, rtol=0, err_msg=key)
