"""PyTorch port vs JAX package: the ResNet trunks, the HMR head, and the
HMR/SPIN baseline (configs/spin_hmr.yaml) end to end.

The trunks run at reduced depth (one block a stage) on a 64 px input,
JAX-initialized and perturbed, carried by `state_dict_from_jax`. The end
to end test runs the narrow HMR (ResNet-50's Bottleneck stages at depth
1, the HMR head at full width, V=6890 SMPL) through `detect_forward` and
the JAX `preprocess_crops` + `POCO.apply` on the same weights.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import poco_tpu.models.poco as jax_poco
from poco_tpu.config import model_config_from_hparams as jax_model_config
from poco_tpu.config import update_hparams as jax_update_hparams
from poco_tpu.models.backbones import common as jax_common
from poco_tpu.models.backbones.resnet import ResNet as JaxResNet
from poco_tpu.models.heads.hmr import HmrHead as JaxHmrHead
from poco_tpu.ops.preprocess import preprocess_crops as jax_preprocess_crops

import poco_tpu_torch.models.poco as port_poco
from poco_tpu_torch.config import model_config_from_hparams, update_hparams
from poco_tpu_torch.demo.tester import detect_forward
from poco_tpu_torch.models.backbones import common
from poco_tpu_torch.models.backbones.resnet import ResNet
from poco_tpu_torch.models.heads.hmr import HmrHead
from poco_tpu_torch.utils.weights import state_dict_from_jax

from .test_torch_model import (
    HMR_YAML,
    SLICE_TOLERANCES,
    _assert_outputs_close,
    _request,
    _strip,
    jax_variables,
    narrow_models,
)
from .test_torch_pare import _t, perturbed


TRUNKS = {
    "basic": ("BasicBlock", {}),
    "bottleneck": ("Bottleneck", {}),
    "grouped": ("Bottleneck", dict(groups=32, base_width=4)),
    "wide": ("Bottleneck", dict(base_width=128)),
}


@pytest.mark.parametrize("name", sorted(TRUNKS))
def test_resnet_trunk_on_jax_weights(name):
    block, kwargs = TRUNKS[name]
    rng = np.random.RandomState(0)
    x = rng.randn(2, 64, 64, 3).astype(np.float32)
    jnet = JaxResNet(getattr(jax_common, block), (1, 1, 1, 1), **kwargs)
    variables = perturbed(jnet.init(jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    state = state_dict_from_jax({
        "params": {"backbone_net": variables["params"]},
        "batch_stats": {"backbone_net": variables["batch_stats"]},
    })
    net = ResNet(getattr(common, block), (1, 1, 1, 1), **kwargs).eval()
    net.load_state_dict(_strip(state, "backbone."), strict=True)
    with torch.no_grad():
        out = net(_t(x.transpose(0, 3, 1, 2)))
    ref = np.asarray(jnet.apply(variables, jnp.asarray(x))).transpose(0, 3, 1, 2)
    assert out.shape == ref.shape == (2, net.out_channels, 2, 2)
    # perturbed BN statistics leave large activations: fp32 sums in
    # another order agree to ~1e-6 of the largest value
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5 * np.abs(ref).max(), rtol=0)


def test_resnet_factories_have_torchvision_names_and_widths():
    assert port_poco.BACKBONES["resnet18"]().out_channels == 512
    net = port_poco.BACKBONES["resnet50"]()
    assert net.out_channels == 2048
    names = dict(net.named_modules())
    assert isinstance(names["maxpool"], torch.nn.MaxPool2d)
    assert isinstance(names["layer3.5.conv3"], torch.nn.Conv2d)
    assert isinstance(names["layer2.0.downsample.1"], torch.nn.BatchNorm2d)
    assert names["layer1.0.conv2"].groups == 1
    assert port_poco.BACKBONES["resnext50_32x4d"]().layer1[0].conv2.groups == 32
    assert port_poco.BACKBONES["wide_resnet50_2"]().layer1[0].conv2.out_channels == 128
    with torch.no_grad():
        feats = port_poco.BACKBONES["resnet18"]().eval()(torch.zeros(1, 3, 224, 224))
    assert feats.shape == (1, 512, 7, 7)


def test_hmr_head_on_jax_weights():
    rng = np.random.RandomState(2)
    feats = rng.rand(3, 7, 7, 512).astype(np.float32)
    jhead = JaxHmrHead(num_input_features=512)
    variables = perturbed(jhead.init(jax.random.PRNGKey(2), jnp.asarray(feats)), 3)
    state = state_dict_from_jax(
        {"params": {"head": variables["params"]}, "buffers": {"head": variables["buffers"]}}
    )
    head = HmrHead(512).eval()
    head.load_state_dict(_strip(state, "head."), strict=True)
    with torch.no_grad():
        port = head(_t(feats.transpose(0, 3, 1, 2)))
    ref = jhead.apply(variables, jnp.asarray(feats))
    assert set(port) == set(ref)
    _assert_outputs_close(port, ref, {k: 1e-4 for k in ref})


def test_hmr_config_matches_jax():
    port_cfg = model_config_from_hparams(update_hparams(str(HMR_YAML)))
    jax_cfg = jax_model_config(jax_update_hparams(str(HMR_YAML)))
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(jax_cfg)
    assert port_cfg == port_poco.build_hmr(device="cpu").cfg
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(jax_poco.build_hmr().cfg)


# The head and position budgets of the slices (SLICE_TOLERANCES) for the
# keys HMR gives; no uncertainty or flow head
HMR_TOLERANCES = {
    k: SLICE_TOLERANCES[k] for k in (
        "pred_pose", "pred_pose_6d", "pred_cam", "pred_shape", "uncert_feat",
        "pred_cam_t", "smpl_vertices", "smpl_joints3d", "smpl_joints2d",
    )
}


def test_hmr_detect_forward_matches_jax():
    image, centers, scales, true_hw = _request(3)
    with pytest.MonkeyPatch.context() as mp:
        pair = narrow_models(mp, "hmr")
        model = pair["model"]
        port = detect_forward(model, pair["smpl"], image, centers, scales, true_hw)
        fwd = jax.jit(lambda v, im, hw, c, s, sm: pair["jax_model"].apply(
            v, jax_preprocess_crops(im, c, s, true_hw=hw), sm, train=False))
        ref = fwd(jax_variables(model), jnp.asarray(image), jnp.asarray(true_hw),
                  jnp.asarray(centers), jnp.asarray(scales), pair["jax_smpl"])
    assert set(port) == set(ref)
    assert port["log_phi"] is None and "var_pose" not in port
    assert set(HMR_TOLERANCES) == {k for k in port if k != "log_phi"}
    assert port["uncert_feat"].shape == (3, 2048)
    _assert_outputs_close(port, ref, HMR_TOLERANCES)
