"""PyTorch port vs JAX package: heads, the POCO-CLIFF slice, the weight
bridge, the config, and the port's independence from JAX.

The slice test runs the narrow model (HRNet-cls at width 8, every other
module at full width: CLIFF head over 2048 features, V=6890 SMPL) from a
uint8 image through `detect_forward`, and the JAX `preprocess_crops` +
`POCO.apply` on the same weights, carried by `convert_state_dict`. JAX
compiles that program once per file (module-scoped fixture).

`narrow_models` builds the narrow twin pairs (CLIFF, PARE, HMR) that the
other `test_torch_*` files share.
"""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import poco_tpu.models.poco as jax_poco
from poco_tpu.config import model_config_from_hparams as jax_model_config
from poco_tpu.config import update_hparams as jax_update_hparams
from poco_tpu.models.backbones.common import Bottleneck as JaxBottleneck
from poco_tpu.models.backbones.hrnet import HRNet as JaxHRNet
from poco_tpu.models.backbones.resnet import ResNet as JaxResNet
from poco_tpu.models.heads.cliff import CliffHead as JaxCliffHead
from poco_tpu.models.heads.poco_uncert import PocoUncertHead as JaxPocoUncertHead
from poco_tpu.ops.preprocess import preprocess_crops as jax_preprocess_crops
from poco_tpu.smpl.assets import synthetic_smpl_model as jax_synthetic_smpl
from poco_tpu.utils.checkpoint_convert import convert_state_dict

import poco_tpu_torch.models.poco as port_poco
from poco_tpu_torch.config import model_config_from_hparams, update_hparams
from poco_tpu_torch.demo.tester import detect_forward
from poco_tpu_torch.models.backbones.common import Bottleneck
from poco_tpu_torch.models.backbones.hrnet import HRNet
from poco_tpu_torch.models.backbones.resnet import ResNet
from poco_tpu_torch.models.heads.cliff import CliffHead
from poco_tpu_torch.models.heads.poco_uncert import PocoUncertHead
from poco_tpu_torch.smpl.assets import synthetic_smpl_model
from poco_tpu_torch.utils.weights import (
    calibrate_batchnorm,
    randomize_batchnorm,
    state_dict_from_jax,
)

REPO = Path(__file__).resolve().parents[1]
CLIFF_YAML = REPO / "configs" / "poco_cliff.yaml"
PARE_YAML = REPO / "configs" / "poco_pare.yaml"
HMR_YAML = REPO / "configs" / "spin_hmr.yaml"
WIDTH = 8

# Narrow twins of the three shipped models: the backbone cut (HRNet at
# width 8, ResNet-50's Bottleneck stages at depth 1), every other module
# at full width. kind -> (config, backbone name, port, JAX backbone).
NARROW = {
    "cliff": (
        CLIFF_YAML, "hrnet_w48_cls",
        lambda: HRNet(width=WIDTH),
        lambda dtype=jnp.float32: JaxHRNet(variant="cls", width=WIDTH, dtype=dtype),
    ),
    "pare": (
        PARE_YAML, "hrnet_w32",
        lambda: HRNet(width=WIDTH, variant="pose"),
        lambda dtype=jnp.float32: JaxHRNet(variant="pose", width=WIDTH, dtype=dtype),
    ),
    "hmr": (
        HMR_YAML, "resnet50",
        lambda: ResNet(Bottleneck, (1, 1, 1, 1)),
        lambda dtype=jnp.float32: JaxResNet(JaxBottleneck, (1, 1, 1, 1), dtype=dtype),
    ),
}


def narrow_models(mp, kind: str, seed: int = 0) -> dict:
    """The narrow port model of `kind` on the CPU (seeded weights, BN
    randomized and calibrated on one batch), its JAX twin (which takes the
    port's weights through `convert_state_dict`) and both SMPLs (V=6890).
    `mp` patches both backbone registries for as long as it is active."""
    yaml, name, port_backbone, jax_backbone = NARROW[kind]
    mp.setitem(port_poco.BACKBONES, name, port_backbone)
    mp.setitem(jax_poco.BACKBONES, name, jax_backbone)
    cfg = model_config_from_hparams(update_hparams(str(yaml)))
    torch.manual_seed(seed)
    model = port_poco.build_poco_cliff(device="cpu", **dataclasses.asdict(cfg))
    randomize_batchnorm(model, torch.Generator().manual_seed(seed + 1))
    crops = torch.randn(4, 3, 224, 224, generator=torch.Generator().manual_seed(seed + 2))
    calibrate_batchnorm(model.backbone, crops)
    if kind == "pare":  # the PARE head has BN layers of its own
        with torch.no_grad():
            calibrate_batchnorm(model.head, model.backbone(crops))
    return {
        "model": model,
        "jax_model": jax_poco.POCO(cfg=jax_model_config(jax_update_hparams(str(yaml)))),
        "smpl": synthetic_smpl_model(num_verts=6890, device="cpu"),
        "jax_smpl": jax_synthetic_smpl(num_verts=6890),
    }


def jax_variables(model: torch.nn.Module) -> dict:
    """The port model's weights as a JAX variable tree."""
    conv = convert_state_dict(model.state_dict(), head_type=model.cfg.head_name)
    assert conv["unmatched"] == []
    return {k: conv[k] for k in ("params", "batch_stats", "buffers")}


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _strip(state, prefix):
    return {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}


def _assert_outputs_close(port, ref, tolerances):
    for key, atol in tolerances.items():
        np.testing.assert_allclose(
            port[key].numpy(), np.asarray(ref[key]), atol=atol, rtol=0, err_msg=key
        )


# --------------------------------------------------------------------------
# config
# --------------------------------------------------------------------------

def test_config_matches_jax():
    port_cfg = model_config_from_hparams(update_hparams(str(CLIFF_YAML)))
    jax_cfg = jax_model_config(jax_update_hparams(str(CLIFF_YAML)))
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(jax_cfg)
    assert port_cfg == port_poco.PocoConfig()  # the yaml is the default model


def test_config_refuses_unknown_keys():
    from poco_tpu_torch.config import update_hparams_from_dict

    with pytest.raises(KeyError, match="BACKBONEE"):
        update_hparams_from_dict({"POCO": {"BACKBONEE": "x"}})


# --------------------------------------------------------------------------
# heads on JAX-initialized weights, carried by state_dict_from_jax
# --------------------------------------------------------------------------

def test_cliff_head_on_jax_weights():
    rng = np.random.RandomState(0)
    feats = rng.rand(3, 2048).astype(np.float32)
    bbox = rng.randn(3, 3).astype(np.float32)
    jhead = JaxCliffHead(num_input_features=2048)
    variables = jhead.init(jax.random.PRNGKey(0), jnp.asarray(feats), jnp.asarray(bbox))
    state = state_dict_from_jax(
        {"params": {"head": variables["params"]}, "buffers": {"head": variables["buffers"]}}
    )
    head = CliffHead(2048).eval()
    head.load_state_dict(_strip(state, "head."), strict=True)
    with torch.no_grad():
        port = head(torch.from_numpy(feats), torch.from_numpy(bbox))
    ref = jhead.apply(variables, jnp.asarray(feats), jnp.asarray(bbox))
    assert set(port) == set(ref)
    _assert_outputs_close(port, ref, {k: 1e-5 for k in ref if k != "body_feat2"})
    _assert_outputs_close(port, ref, {"body_feat2": 1e-4})  # 2048-term sums


@pytest.mark.parametrize("with_gt", [False, True])
def test_uncert_head_on_jax_weights(with_gt):
    rng = np.random.RandomState(1)
    feats = rng.rand(3, 2048).astype(np.float32)
    pose = rng.randn(3, 24, 3, 3).astype(np.float32)
    gt = rng.randn(3, 24, 3, 3).astype(np.float32)
    mask = np.asarray([True, False, True])
    jhead = JaxPocoUncertHead(num_input_channels=2048)
    variables = jhead.init(jax.random.PRNGKey(1), jnp.asarray(feats), jnp.asarray(pose))
    state = state_dict_from_jax({"params": {"uncert_head": variables["params"]}})
    head = PocoUncertHead(2048).eval()
    head.load_state_dict(_strip(state, "uncert_head."), strict=True)
    kwargs_t, kwargs_j = {}, {}
    if with_gt:
        kwargs_t = dict(gt_pose_rotmat=torch.from_numpy(gt), gt_pose_cond_mask=torch.from_numpy(mask))
        kwargs_j = dict(gt_pose_rotmat=jnp.asarray(gt), gt_pose_cond_mask=jnp.asarray(mask))
    with torch.no_grad():
        port = head(torch.from_numpy(feats), torch.from_numpy(pose), **kwargs_t)
    ref = jhead.apply(variables, jnp.asarray(feats), jnp.asarray(pose), **kwargs_j)
    assert port["var_pose"].shape == (3, 24)
    _assert_outputs_close(port, ref, {"var_pose": 1e-5})


@pytest.mark.parametrize("mode,neurons,kwargs", [
    ("feat", (256, 64), dict(activation_type="softplus")),
    ("feat-pose", (512,), dict(loss_ver="norm_flow_res_gaus", sigma_dim=9)),
    ("feat-pose-net", (216,), dict(use_dropout=False, exclude_uncert_idx=(0, 3))),
])
def test_uncert_head_refuses_unported_modes(mode, neurons, kwargs):
    """Every input mode is ported, its fc stack carried from JAX: feat (2
    hidden layers), feat-pose (POCO-PARE's 3072 + 216 -> 512 -> 24, here
    with sigma_dim 9) and feat-pose-net; a mode the JAX head does not
    know is refused."""
    with pytest.raises(ValueError, match="uncert_inp_type"):
        PocoUncertHead(3072, uncert_inp_type="pose-feat")
    rng = np.random.RandomState(2)
    feats = rng.rand(3, 3072).astype(np.float32)
    pose = rng.randn(3, 24, 3, 3).astype(np.float32)
    jhead = JaxPocoUncertHead(
        num_input_channels=3072, num_neurons=neurons, uncert_inp_type=mode, **kwargs
    )
    variables = jhead.init(jax.random.PRNGKey(2), jnp.asarray(feats), jnp.asarray(pose))
    state = state_dict_from_jax({"params": {"uncert_head": variables["params"]}})
    head = PocoUncertHead(3072, num_neurons=neurons, uncert_inp_type=mode, **kwargs).eval()
    head.load_state_dict(_strip(state, "uncert_head."), strict=True)
    with torch.no_grad():
        port = head(torch.from_numpy(feats), torch.from_numpy(pose))
    ref = jhead.apply(variables, jnp.asarray(feats), jnp.asarray(pose))
    assert port["var_pose"].shape == ref["var_pose"].shape
    _assert_outputs_close(port, ref, {"var_pose": 1e-5})


# --------------------------------------------------------------------------
# the narrow POCO-CLIFF slice, end to end
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def narrow():
    """The narrow POCO-CLIFF pair (`narrow_models`) and the JAX request
    program, compiled once for the file."""
    with pytest.MonkeyPatch.context() as mp:
        pair = narrow_models(mp, "cliff")
        yield pair | {"jax_request": _jax_request(pair["jax_model"])}


def _jax_request(jax_model):
    """The JAX package's request: `preprocess_crops` + `POCO.apply`, jitted."""
    return jax.jit(lambda v, im, hw, c, s, sm: jax_model.apply(
        v, jax_preprocess_crops(im, c, s, true_hw=hw), sm, train=False))


def _request(seed):
    rng = np.random.RandomState(seed)
    image = np.zeros((256, 320, 3), np.uint8)  # bottom rows are padding
    image[:240] = rng.randint(0, 256, (240, 320, 3))
    centers = np.asarray([[160, 120], [40, 200], [300, 30]], np.float32)
    scales = np.asarray([1.1, 0.5, 0.8], np.float32)
    return image, centers, scales, np.asarray([240.0, 320.0], np.float32)


# Per-key tolerances of the slice. Head outputs 2e-3 and positions 1e-4 m
# are the budgets of tests/test_fullwidth_parity.py; the pooled features
# take 5e-3 (O(1) values after ~70 BN-calibrated conv layers whose sums
# XLA and oneDNN order differently); pixels 1e-2 px at ~1e3 px.
SLICE_TOLERANCES = {
    "pred_pose": 2e-3, "pred_pose_6d": 2e-3, "pred_cam": 2e-3,
    "pred_shape": 2e-3, "var_pose": 2e-3, "body_feat2": 2e-3,
    "uncert_feat": 5e-3, "pred_cam_t": 2e-3, "pred_fullimg_cam_t": 2e-3,
    "smpl_vertices": 1e-4, "smpl_joints3d": 1e-4, "smpl_joints2d": 1e-2,
}

# A request's second box made non-finite: (centre, scale) of that row.
NON_FINITE_BOXES = {
    "nan_center": ((np.nan, np.nan), 0.5),
    "inf_scale": ((40.0, 200.0), np.inf),
}


def _check_slice(model, jax_model, smpl, jax_smpl, jax_request=None, bad=None):
    """With `bad` (a key of NON_FINITE_BOXES) the request's second box is
    non-finite: both sides must answer, with NaN in the same places of
    every output (the JAX model keeps a box's NaN in its own row), and
    every other value within SLICE_TOLERANCES."""
    image, centers, scales, true_hw = _request(3)
    if bad is not None:
        centers[1], scales[1] = NON_FINITE_BOXES[bad]
    port = detect_forward(model, smpl, image, centers, scales, true_hw)
    variables = jax_variables(model)
    fwd = jax_request or _jax_request(jax_model)
    ref = fwd(variables, jnp.asarray(image), jnp.asarray(true_hw), jnp.asarray(centers),
              jnp.asarray(scales), jax_smpl)
    assert set(port) == set(ref)
    assert port["log_phi"] is None and ref["log_phi"] is None
    assert set(SLICE_TOLERANCES) == {k for k in port if k != "log_phi"}
    for key in SLICE_TOLERANCES:
        nan_rows = np.isnan(np.asarray(ref[key])).reshape(len(centers), -1).any(axis=1)
        assert list(nan_rows) == [bad is not None and i == 1 for i in range(3)], key
        np.testing.assert_array_equal(np.isnan(port[key].numpy()), np.isnan(np.asarray(ref[key])),
                                      err_msg=key)
    _assert_outputs_close(port, ref, SLICE_TOLERANCES)


@pytest.mark.parametrize("bad", [None, *NON_FINITE_BOXES])
def test_slice_detect_forward_matches_jax(narrow, bad):
    _check_slice(narrow["model"], narrow["jax_model"], narrow["smpl"], narrow["jax_smpl"],
                 narrow["jax_request"], bad)


@pytest.mark.slow
def test_slice_fullwidth_matches_jax():
    """The same check on HRNet-W48-cls at full width (JAX compiles the
    full model on the CPU: minutes)."""
    torch.manual_seed(10)
    model = port_poco.build_poco_cliff(device="cpu")
    randomize_batchnorm(model, torch.Generator().manual_seed(11))
    calibrate_batchnorm(
        model.backbone,
        torch.randn(4, 3, 224, 224, generator=torch.Generator().manual_seed(12)),
    )
    _check_slice(
        model, jax_poco.build_poco_cliff(),
        synthetic_smpl_model(num_verts=6890, device="cpu"),
        jax_synthetic_smpl(num_verts=6890),
    )


@pytest.mark.parametrize("kind", sorted(NARROW))
def test_bridge_round_trip(kind):
    """port state_dict -> `convert_state_dict` -> exactly the tree of the
    JAX model initialized with a GT pose (flow head included) ->
    `state_dict_from_jax` -> the same state_dict, which loads strictly."""
    with pytest.MonkeyPatch.context() as mp:
        pair = narrow_models(mp, kind)
        model = pair["model"]
        state = model.state_dict()
        conv = convert_state_dict(state, head_type=kind)
        assert conv["unmatched"] == []

        batch = jax_poco.make_dummy_batch(model.cfg, 1, include_gt=True)
        shapes = jax.eval_shape(
            lambda: pair["jax_model"].init(jax.random.PRNGKey(0), batch, pair["jax_smpl"])
        )
        assert ("flow_head" in shapes["params"]) == model.cfg.has_flow_head
        for col in ("params", "batch_stats", "buffers"):
            expect = {k: tuple(v.shape) for k, v in _flat(shapes[col]).items()}
            got = {k: tuple(np.shape(v)) for k, v in _flat(conv[col]).items()}
            assert got == expect, col

        back = state_dict_from_jax(conv)
        assert set(back) == set(state)
        for key, value in state.items():
            if not key.endswith("num_batches_tracked"):
                torch.testing.assert_close(back[key], value, rtol=0, atol=0)
        fresh = port_poco.POCO(model.cfg)
        fresh.load_state_dict(back, strict=True)


def test_state_dict_from_jax_leaves_flow_head_and_refuses_strangers():
    """The flow head's leaves are carried; a leaf with no place raises."""
    tree = {"params": {
        "head": {"fc1": {"kernel": np.zeros((5, 4), np.float32)}},
        "flow_head": {
            "cond_layer": {"kernel": np.zeros((2, 3), np.float32)},
            "flow": {"t1": {"fc2": {"bias": np.arange(9, dtype=np.float32)}}},
        },
    }}
    state = state_dict_from_jax(tree)
    assert state["head.fc1.weight"].shape == (4, 5)
    assert state["flow_head.cond_layer.weight"].shape == (3, 2)
    np.testing.assert_array_equal(state["flow_head.flow.t.1.4.bias"], np.arange(9))
    assert len(state) == 3
    tree["params"]["mystery"] = {"w": np.zeros(1, np.float32)}
    with pytest.raises(KeyError, match="mystery"):
        state_dict_from_jax(tree)
    del tree["params"]["mystery"]
    tree["params"]["flow_head"]["flow"]["u0"] = {"fc0": {"bias": np.zeros(1, np.float32)}}
    with pytest.raises(KeyError, match="u0"):
        state_dict_from_jax(tree)


def test_port_builds_every_backbone_of_the_jax_registry_but_tiny():
    """Every backbone of the JAX registry, the tiny ones included since
    they came with training, at the JAX package's output width; beside
    them the port alone has HMR 2.0's ViT-H (`vit_h`, 1280 wide)."""
    from poco_tpu.models.backbones.resnet import BACKBONE_INFO

    assert set(port_poco.BACKBONES) == set(jax_poco.BACKBONES) | {"vit_h"}
    for name, factory in port_poco.BACKBONES.items():
        with torch.device("meta"):
            net = factory()
        width = 1280 if name == "vit_h" else BACKBONE_INFO[name]["n_output_channels"]
        assert net.out_channels == width, name


def test_model_refuses_unported_paths():
    with pytest.raises(NotImplementedError, match="not in the registry"):
        port_poco.POCO(port_poco.PocoConfig(backbone="tinier-cliff"))
    with pytest.raises(NotImplementedError, match="head 'spin'"):
        port_poco.POCO(port_poco.PocoConfig(backbone="resnet18-spin"))


# --------------------------------------------------------------------------
# entry points and package independence
# --------------------------------------------------------------------------

def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_poco.build_poco_cliff()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthetic_smpl_model(num_verts=32)
    from poco_tpu_torch.cli import train as train_cli
    from poco_tpu_torch.train.trainer import Trainer

    hparams = update_hparams(str(REPO / "configs" / "tiny_smoke.yaml"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(hparams, synthetic_smpl_model(num_verts=32, device="cpu"), lambda e: None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--cfg", str(REPO / "configs" / "tiny_smoke.yaml")])


FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "poco_tpu"}


def _port_sources():
    return sorted((REPO / "poco_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "ablate_skinning_backward.py"
    ]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: p.name)
def test_port_source_imports_nothing_of_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import poco_tpu_torch, chip_smoke, ablate_skinning_backward\n"
        "for m in pkgutil.walk_packages(poco_tpu_torch.__path__, 'poco_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {sorted(FORBIDDEN)!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
