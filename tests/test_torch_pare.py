"""PyTorch port vs JAX package: PARE's layers, the PARE head in every
heatmap mode and option, the HRNet pose variant, and the POCO-PARE slice.

Inputs are made from a seed with numpy and go through both packages;
head weights are JAX-initialized, perturbed (so that zero-initialized
paths such as the non-local blocks' residuals do work) and carried to the
port by `state_dict_from_jax`. The slice test runs the narrow POCO-PARE
(HRNet-W32 topology at width 8; the PARE head, feat-pose uncertainty and
3-layer flow at full width; V=6890 SMPL) through `detect_forward` and the
JAX `preprocess_crops` + `POCO.apply` on the same weights.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import poco_tpu.models.layers as jax_layers
import poco_tpu.models.poco as jax_poco
from poco_tpu.config import model_config_from_hparams as jax_model_config
from poco_tpu.config import update_hparams as jax_update_hparams
from poco_tpu.models.backbones.common import resize_bilinear_align_corners as jax_resize
from poco_tpu.models.backbones.hrnet import HRNet as JaxHRNet
from poco_tpu.models.heads.pare import PareHead as JaxPareHead
from poco_tpu.models.heads.pare import coord_maps as jax_coord_maps
from poco_tpu.ops.preprocess import preprocess_crops as jax_preprocess_crops
from poco_tpu.smpl.assets import synthetic_smpl_model as jax_synthetic_smpl

import poco_tpu_torch.models.layers as layers
import poco_tpu_torch.models.poco as port_poco
from poco_tpu_torch.config import model_config_from_hparams, update_hparams
from poco_tpu_torch.demo.tester import detect_forward
from poco_tpu_torch.models.backbones.common import resize_bilinear_align_corners
from poco_tpu_torch.models.backbones.hrnet import HRNet
from poco_tpu_torch.models.heads.pare import PareHead, coord_maps
from poco_tpu_torch.smpl.assets import synthetic_smpl_model
from poco_tpu_torch.utils.weights import (
    calibrate_batchnorm,
    randomize_batchnorm,
    state_dict_from_jax,
)

from .test_torch_model import (
    PARE_YAML,
    SLICE_TOLERANCES,
    _assert_outputs_close,
    _request,
    _strip,
    jax_variables,
    narrow_models,
)


def perturbed(variables: dict, seed: int) -> dict:
    """JAX variables with every leaf moved off its initial value: params
    by noise of 0.1 of their scale (0.02 for zero-initialized leaves), BN
    means by 0.1 noise and variances drawn from [0.5, 1.5]."""
    rng = np.random.RandomState(seed)

    def walk(tree, col):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, col)
                continue
            v = np.asarray(v, np.float32)
            if col == "batch_stats":
                v = rng.uniform(0.5, 1.5, v.shape) if k == "var" else 0.1 * rng.randn(*v.shape)
            elif col == "params":
                scale = max(float(np.abs(v).mean()), 0.2)
                v = v + 0.1 * scale * rng.randn(*v.shape)
            out[k] = np.asarray(v, np.float32)
        return out

    return {col: walk(tree, col) for col, tree in variables.items()}


def _t(x):
    return torch.from_numpy(np.array(x))


# --------------------------------------------------------------------------
# models/layers.py and the small helpers, against JAX
# --------------------------------------------------------------------------

def test_per_position_conv_on_jax_weights():
    rng = np.random.RandomState(0)
    x = rng.randn(3, 16, 24, 1).astype(np.float32)
    mod = jax_layers.PerPositionConv1x1(6, (24, 1), use_bias=True)
    variables = perturbed(mod.init(jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    port = layers.PerPositionConv1x1(16, 6, (24, 1), bias=True)
    state = state_dict_from_jax({"params": {"head": {"pose_mlp": variables["params"]}}})
    port.load_state_dict(_strip(state, "head.pose_mlp."), strict=True)
    assert port.weight.shape == (1, 6, 16, 24, 1, 1)  # the reference layout
    with torch.no_grad():
        out = port(_t(x))
    np.testing.assert_allclose(
        out.numpy(), np.asarray(mod.apply(variables, jnp.asarray(x))), atol=1e-5
    )


@pytest.mark.parametrize("act", ["softmax", "sigmoid", "none"])
@pytest.mark.parametrize("use_scale", [False, True])
def test_keypoint_attention_matches_jax(act, use_scale):
    rng = np.random.RandomState(1)
    feats = rng.randn(2, 12, 7, 9).astype(np.float32)
    hm = 3.0 * rng.randn(2, 5, 7, 9).astype(np.float32)
    out = layers.keypoint_attention(_t(feats), _t(hm), act=act, use_scale=use_scale)
    ref = jax_layers.keypoint_attention(jnp.asarray(feats), jnp.asarray(hm), act, use_scale)
    assert out.shape == (2, 12, 5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("temperature,normalize", [(1.0, True), (2.5, False)])
def test_softargmax_matches_jax(temperature, normalize):
    rng = np.random.RandomState(2)
    hm = 4.0 * rng.randn(2, 5, 8, 11).astype(np.float32)
    kp, norm = layers.softargmax2d(_t(hm), temperature, normalize)
    jkp, jnorm = jax_layers.softargmax2d(jnp.asarray(hm), temperature, normalize)
    np.testing.assert_allclose(kp.numpy(), np.asarray(jkp), atol=1e-5)
    np.testing.assert_allclose(norm.numpy(), np.asarray(jnorm), atol=1e-6)
    kp1, norm1 = layers.softargmax1d(_t(hm[:, :, 0]), temperature, normalize)
    jkp1, jnorm1 = jax_layers.softargmax1d(jnp.asarray(hm[:, :, 0]), temperature, normalize)
    np.testing.assert_allclose(kp1.numpy(), np.asarray(jkp1), atol=1e-5)
    np.testing.assert_allclose(norm1.numpy(), np.asarray(jnorm1), atol=1e-6)


@pytest.mark.parametrize("normalize", [True, False])
def test_heatmap_preds_match_jax(normalize):
    """First maximum on ties, (0, 0) where the maximum is not positive."""
    rng = np.random.RandomState(3)
    hm = rng.randn(2, 6, 5, 7).astype(np.float32)
    hm[0, 0] = -1.0 - np.abs(hm[0, 0])        # every value negative
    hm[0, 1] = 0.0                             # a flat zero map
    hm[1, 2] = np.round(hm[1, 2])              # integer ties
    hm[1, 2, 1, 3] = hm[1, 2, 4, 0] = 9.0      # two equal maxima
    kp, conf = layers.get_heatmap_preds(_t(hm), normalize)
    jkp, jconf = jax_layers.get_heatmap_preds(jnp.asarray(hm), normalize)
    np.testing.assert_array_equal(kp.numpy(), np.asarray(jkp))
    np.testing.assert_array_equal(conf.numpy(), np.asarray(jconf))


def test_grid_sample_matches_jax():
    rng = np.random.RandomState(4)
    feats = rng.randn(2, 3, 7, 9).astype(np.float32)
    uv = rng.uniform(-1.2, 1.2, (2, 11, 2)).astype(np.float32)
    out = layers.grid_sample_bilinear(_t(feats), _t(uv))
    ref = jax_layers.grid_sample_bilinear(jnp.asarray(feats), jnp.asarray(uv))
    assert out.shape == (2, 3, 11)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("out_hw", [(14, 14), (28, 20), (3, 1)])
def test_resize_bilinear_align_corners_matches_jax(out_hw):
    rng = np.random.RandomState(5)
    x = rng.randn(2, 4, 7, 5).astype(np.float32)
    out = resize_bilinear_align_corners(_t(x), *out_hw)
    ref = jax_resize(jnp.asarray(x.transpose(0, 2, 3, 1)), *out_hw)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(ref).transpose(0, 3, 1, 2), atol=1e-5
    )


def test_coord_maps_match_jax():
    np.testing.assert_array_equal(
        coord_maps(9).numpy(), np.asarray(jax_coord_maps(9)).transpose(0, 3, 1, 2)
    )


# --------------------------------------------------------------------------
# PareHead on JAX weights: every heatmap mode, every option
# --------------------------------------------------------------------------

HEAD_IN, HEAD_HW = 32, 28

HEAD_OPTIONS = {
    "part_segm": {},
    "hm": dict(use_heatmaps="hm"),
    "hm_soft": dict(use_heatmaps="hm_soft"),
    "part_segm_pool": dict(use_heatmaps="part_segm_pool"),
    "attention": dict(use_heatmaps="attention"),
    "hm_grid_sample": dict(use_heatmaps="hm", use_keypoint_attention=False),
    "hm_soft_grid_sample": dict(use_heatmaps="hm_soft", use_keypoint_attention=False),
    "part_segm_pool_grid_sample": dict(
        use_heatmaps="part_segm_pool", use_keypoint_attention=False
    ),
    "sigmoid_scaled_attention": dict(
        keypoint_attention_act="sigmoid", use_scale_keypoint_attention=True
    ),
    "same_branch_v1": dict(uncert_layer="same_branch_v1", uncert_act="softplus"),
    "diff_branch_lc2d": dict(uncert_layer="diff_branch_lc2d"),
    "position_encodings": dict(use_position_encodings=True),
    "final_conv_3": dict(final_conv_kernel=3),
    "mean_camshape_and_pose": dict(use_mean_camshape=True, use_mean_pose=True),
    "keypoint_features_for_smpl": dict(use_keypoint_features_for_smpl=True),
    "hmr_regression": dict(use_hmr_regression=True),
    "iterative_regression": dict(iterative_regression=True),
    "iterative_residual_all_pose": dict(
        iterative_regression=True, iter_residual=True, num_iterations=2,
        pose_input_type="feats.all_pose.shape.cam",
        shape_input_type="feats.all_pose.shape.cam",
    ),
    "coattention": dict(use_coattention=True, use_keypoint_features_for_smpl=True),
    "coattention_double_3": dict(
        use_coattention=True, coattention_conv="double_3", num_coattention_iter=2
    ),
    "coattention_single_1": dict(use_coattention=True, coattention_conv="single_1"),
    "branch_nonlocal": dict(use_branch_nonlocal=True),
    "final_nonlocal": dict(use_final_nonlocal=True, uncert_layer="same_branch_v1"),
    "branch_iteration": dict(num_branch_iteration=2),
    "soft_attention": dict(use_soft_attention=True, use_heatmaps="hm_soft"),
}

# fp32 sums of up to 9 x 128 terms (and 28^2-term attention pools) taken
# in another order by XLA and oneDNN
HEAD_ATOL, HEAD_RTOL = 2e-4, 1e-4


@pytest.mark.parametrize("option", sorted(HEAD_OPTIONS))
def test_pare_head_on_jax_weights(option):
    kwargs = HEAD_OPTIONS[option]
    rng = np.random.RandomState(6)
    feats = rng.randn(2, HEAD_HW, HEAD_HW, HEAD_IN).astype(np.float32)
    jhead = JaxPareHead(num_input_features=HEAD_IN, **kwargs)
    variables = perturbed(jhead.init(jax.random.PRNGKey(6), jnp.asarray(feats)), 7)
    state = state_dict_from_jax({
        "params": {"head": variables["params"]},
        "batch_stats": {"head": variables.get("batch_stats", {})},
        "buffers": {"head": variables["buffers"]},
    })
    head = PareHead(num_input_features=HEAD_IN, **kwargs).eval()
    head.load_state_dict(_strip(state, "head."), strict=True)
    with torch.no_grad():
        port = head(_t(feats.transpose(0, 3, 1, 2)))
    ref = jhead.apply(variables, jnp.asarray(feats))
    assert set(port) == set(ref)
    for key in ref:
        assert port[key].shape == ref[key].shape, key
        np.testing.assert_allclose(
            port[key].numpy(), np.asarray(ref[key]), atol=HEAD_ATOL, rtol=HEAD_RTOL,
            err_msg=key,
        )


def test_pare_head_output_channels():
    assert PareHead().get_output_channels() == 24 * 128
    assert PareHead(uncert_layer="diff_branch_lc2d").get_output_channels() == 128


# --------------------------------------------------------------------------
# HRNet pose variant at width 8
# --------------------------------------------------------------------------

@pytest.mark.parametrize("use_conv,downsample", [
    (True, False), (False, False), (True, True), (False, True),
])
def test_hrnet_pose_variant_on_jax_weights(use_conv, downsample):
    """The pose merge (bilinear + conv chains, or interpolation; on the
    highest or lowest resolution) at width 8 on a 64 px input."""
    rng = np.random.RandomState(8)
    x = rng.randn(2, 64, 64, 3).astype(np.float32)
    jnet = JaxHRNet(variant="pose", width=8, use_conv=use_conv, downsample=downsample)
    variables = perturbed(jnet.init(jax.random.PRNGKey(8), jnp.asarray(x)), 9)
    state = state_dict_from_jax({
        "params": {"backbone_net": variables["params"]},
        "batch_stats": {"backbone_net": variables["batch_stats"]},
    })
    net = HRNet(width=8, variant="pose", use_conv=use_conv, downsample=downsample).eval()
    net.load_state_dict(_strip(state, "backbone."), strict=True)
    with torch.no_grad():
        out = net(_t(x.transpose(0, 3, 1, 2)))
    ref = np.asarray(jnet.apply(variables, jnp.asarray(x))).transpose(0, 3, 1, 2)
    side = 2 if downsample else 16
    assert out.shape == (2, 120, side, side) == ref.shape
    assert net.out_channels == 120
    # the perturbed BN statistics leave activations of O(1e3): fp32 sums
    # in another order agree to ~1e-6 of the largest value
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5 * np.abs(ref).max(), rtol=0)


def test_pose_backbones_at_full_width_have_the_reference_names():
    net = port_poco.BACKBONES["hrnet_w32"]()
    assert net.out_channels == 480
    names = dict(net.named_modules())
    assert isinstance(names["upsample_stage_4.9"], torch.nn.Conv2d)
    assert isinstance(names["upsample_stage_4.10"], torch.nn.BatchNorm2d)
    assert "final_layer" not in names and "incre_modules" not in names
    assert port_poco.BACKBONES["hrnet_w48"]().out_channels == 720
    assert port_poco.BACKBONES["hrnet_w64"]().out_channels == 960


# --------------------------------------------------------------------------
# the narrow POCO-PARE slice, end to end
# --------------------------------------------------------------------------

# SLICE_TOLERANCES for the keys PARE gives, and the segmentation logits
# (56x56x25, O(1) values after two BN-calibrated 3x3 convs over 120
# channels)
PARE_TOLERANCES = {
    **{k: v for k, v in SLICE_TOLERANCES.items()
       if k not in ("body_feat2", "pred_fullimg_cam_t")},
    "pred_segm_mask": 2e-3,
}
# Held against the port's float64 forward instead of directly (the JAX
# package's own PARE parity gate, tests/test_fullwidth_parity.py:105-134):
# the random part attention and 6D decoder carry fp32 reassociation noise
# to the vertices, where the port's fp32 forward alone sits 0.9-1.6e-4 m
# from its fp64 forward, and the random camera scale (~1e-2) puts
# t_z = 2 f / (224 s) near 1e3, where fp32 rounding alone is ~1e-3. So
# two fp32 forwards cannot agree within the budget. The JAX result must
# lie within max(budget, 3 x the port's own fp32 noise) of the fp64 truth;
# vertices also within the 0.5 mm golden-gate budget.
NOISE_GATED = {"smpl_vertices": 5e-4, "pred_cam_t": None}


def _fp64_forward(model, smpl, batch) -> dict:
    """The port model in float64 on the same (float32) crops."""
    model64 = copy.deepcopy(model).double()
    smpl64 = dataclasses.replace(smpl, **{
        f.name: getattr(smpl, f.name).double() for f in dataclasses.fields(smpl)
        if torch.is_tensor(getattr(smpl, f.name))
        and getattr(smpl, f.name).is_floating_point()
    })
    with torch.no_grad():
        return model64({k: v.double() for k, v in batch.items()}, smpl64)


@pytest.fixture(scope="module")
def pare():
    with pytest.MonkeyPatch.context() as mp:
        yield narrow_models(mp, "pare")


def test_pare_config_matches_jax():
    port_cfg = model_config_from_hparams(update_hparams(str(PARE_YAML)))
    jax_cfg = jax_model_config(jax_update_hparams(str(PARE_YAML)))
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(jax_cfg)
    assert port_cfg == port_poco.build_poco_pare(device="cpu").cfg
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(jax_poco.build_poco_pare().cfg)


def _check_pare_slice(model, jax_model, smpl, jax_smpl):
    """As the CLIFF slice, with NOISE_GATED keys against fp64, and JAX
    makes the crops outside `jit`: fused by XLA, the crop's bilinear
    weights round differently (up to 1.5e-4 in a normalized pixel), an
    input change the random part attention carries past the budgets.
    Unfused, JAX's crops equal the port's exactly."""
    image, centers, scales, true_hw = _request(3)
    port = detect_forward(model, smpl, image, centers, scales, true_hw)
    batch = jax_preprocess_crops(
        jnp.asarray(image), jnp.asarray(centers), jnp.asarray(scales),
        true_hw=jnp.asarray(true_hw),
    )
    fwd = jax.jit(lambda v, b, sm: jax_model.apply(v, b, sm, train=False))
    ref = fwd(jax_variables(model), batch, jax_smpl)
    assert set(port) == set(ref)
    assert port["log_phi"] is None and ref["log_phi"] is None
    assert set(PARE_TOLERANCES) == {k for k in port if k != "log_phi"}
    assert port["uncert_feat"].shape == (3, 24 * 128)
    assert port["pred_segm_mask"].shape == (3, 25, 56, 56)
    _assert_outputs_close(
        port, ref, {k: v for k, v in PARE_TOLERANCES.items() if k not in NOISE_GATED}
    )
    truth = _fp64_forward(model, smpl, {k: _t(np.asarray(v)) for k, v in batch.items()})
    for key, cap in NOISE_GATED.items():
        noise = float((port[key].double() - truth[key]).abs().max())
        err = float((_t(np.asarray(ref[key])).double() - truth[key]).abs().max())
        assert err <= max(PARE_TOLERANCES[key], 3.0 * noise), (key, err, noise)
        assert cap is None or err <= cap, (key, err)


def test_pare_slice_detect_forward_matches_jax(pare):
    _check_pare_slice(pare["model"], pare["jax_model"], pare["smpl"], pare["jax_smpl"])


@pytest.mark.slow
def test_pare_slice_fullwidth_matches_jax():
    """The same check on HRNet-W32 at full width (JAX compiles the full
    model on the CPU: minutes)."""
    torch.manual_seed(20)
    model = port_poco.build_poco_pare(device="cpu")
    randomize_batchnorm(model, torch.Generator().manual_seed(21))
    crops = torch.randn(4, 3, 224, 224, generator=torch.Generator().manual_seed(22))
    calibrate_batchnorm(model.backbone, crops)
    with torch.no_grad():
        calibrate_batchnorm(model.head, model.backbone(crops))
    _check_pare_slice(
        model, jax_poco.build_poco_pare(),
        synthetic_smpl_model(num_verts=6890, device="cpu"),
        jax_synthetic_smpl(num_verts=6890),
    )
