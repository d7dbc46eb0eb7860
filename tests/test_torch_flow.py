"""PyTorch port vs JAX package: the RealNVP flow head.

The coupling-mask builders, `RealNVP` (invertibility, `log_prob`, seeded
sampling), `FlowHead.log_phi` over the options of the JAX head, and the
POCO forward with a GT pose (`log_phi`) for the narrow POCO-CLIFF and
POCO-PARE. Flow weights are JAX-initialized and perturbed, then carried
to the port by `state_dict_from_jax`; inputs are made with numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import poco_tpu.models.heads.flow as jax_flow
from poco_tpu.ops.preprocess import preprocess_crops as jax_preprocess_crops

import poco_tpu_torch.models.heads.flow as flow
from poco_tpu_torch.ops.preprocess import preprocess_crops
from poco_tpu_torch.ops.rotation import axis_angle_to_rotmat
from poco_tpu_torch.utils.weights import state_dict_from_jax

from .test_torch_model import _request, _strip, jax_variables, narrow_models
from .test_torch_pare import _t, perturbed

# log_phi sums 9 (or 24) log-densities through 2 x 3 coupling layers:
# fp32 rounding of O(10) values, in the units the JAX package's own
# parity tests use for log_phi (atol plus a relative term)
LOG_PHI_ATOL, LOG_PHI_RTOL = 2e-3, 1e-4


def _rotations(rng, batch: int, scale: float) -> np.ndarray:
    """(batch, 24, 3, 3) rotations from seeded axis-angles."""
    aa = torch.from_numpy((scale * rng.randn(batch, 24, 3)).astype(np.float32))
    return axis_angle_to_rotmat(aa).numpy()


@pytest.mark.parametrize("kind", sorted(flow.MASK_BUILDERS))
@pytest.mark.parametrize("num_rv,num_layers", [(9, 1), (9, 3), (24, 2), (5, 1)])
def test_mask_builders_match_jax(kind, num_rv, num_layers):
    ours = flow.MASK_BUILDERS[kind](num_rv, num_layers)
    ref = jax_flow.MASK_BUILDERS[kind](num_rv, num_layers)
    assert ours.shape == (2 * num_layers, num_rv)
    np.testing.assert_array_equal(ours, ref)


def _realnvp_pair(num_rv, layers, mask_type, context, seed):
    """A JAX RealNVP with perturbed weights and the port's on the same."""
    rng = np.random.RandomState(seed)
    x = np.abs(rng.randn(7, num_rv)).astype(np.float32)
    cond = rng.randn(7, context).astype(np.float32) if context else None
    jnvp = jax_flow.RealNVP(num_rv=num_rv, num_coupling_layers=layers, mask_type=mask_type)
    variables = jnvp.init(
        jax.random.PRNGKey(seed), jnp.asarray(x), None if cond is None else jnp.asarray(cond)
    )
    variables = perturbed(variables, seed + 1)
    state = state_dict_from_jax({"params": {"flow_head": {"flow": variables["params"]}}})
    nvp = flow.RealNVP(num_rv, layers, mask_type=mask_type, context_dim=context)
    nvp.load_state_dict(_strip(state, "flow_head.flow."), strict=True)
    return jnvp, variables, nvp, x, cond


@pytest.mark.parametrize("num_rv,layers,mask_type,context", [
    (9, 3, "alter", 16), (9, 1, "new", 0), (24, 2, "old", 8),
])
def test_realnvp_matches_jax_and_inverts(num_rv, layers, mask_type, context):
    jnvp, variables, nvp, x, cond = _realnvp_pair(num_rv, layers, mask_type, context, 3)
    assert "mask" not in nvp.state_dict()  # rebuilt from the config
    jc = None if cond is None else jnp.asarray(cond)
    tc = None if cond is None else _t(cond)
    with torch.no_grad():
        z, log_det = nvp.backward_p(_t(x), tc)
        lp = nvp.log_prob(_t(x), tc)
        x_back = nvp.forward_p(z, tc)
        fwd = nvp.forward_p(_t(x), tc)
    jz, jlog_det = jnvp.apply(variables, jnp.asarray(x), jc, method="backward_p")
    jlp = jnvp.apply(variables, jnp.asarray(x), jc)
    jfwd = jnvp.apply(variables, jnp.asarray(x), jc, method="forward_p")
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(log_det.numpy(), np.asarray(jlog_det), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(fwd.numpy(), np.asarray(jfwd), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(x_back.numpy(), x, atol=1e-5)   # data -> latent -> data


def test_realnvp_samples_from_an_explicit_generator():
    _, _, nvp, _, cond = _realnvp_pair(9, 3, "alter", 16, 4)
    with torch.no_grad():
        a = nvp.sample(7, torch.Generator().manual_seed(5), _t(cond))
        b = nvp.sample(7, torch.Generator().manual_seed(5), _t(cond))
        z = torch.randn((7, 9), generator=torch.Generator().manual_seed(5))
        latent, _ = nvp.backward_p(a, _t(cond))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(a, nvp.forward_p(z, _t(cond)), rtol=0, atol=0)
    torch.testing.assert_close(latent, z, rtol=0, atol=1e-5)


FLOW_HEADS = {
    "rv9": dict(num_nf_rv=9),
    "rv9_exclude": dict(num_nf_rv=9, exclude_uncert_idx=(0, 5)),
    "rv9_mask_params": dict(num_nf_rv=9, mask_params_id=(1, 3), num_flow_layers=3),
    "rv9_unconditioned_new": dict(num_nf_rv=9, cond_nflow=False, nflow_mask_type="new"),
    "rv24": dict(num_nf_rv=24, num_flow_layers=2),
    "rv24_mask_params_old": dict(num_nf_rv=24, mask_params_id=(1, 3), nflow_mask_type="old"),
}


@pytest.mark.parametrize("sigma", ["per_joint", "per_entry", "none"])
@pytest.mark.parametrize("name", sorted(FLOW_HEADS))
def test_flow_head_log_phi_matches_jax(name, sigma):
    kwargs = FLOW_HEADS[name]
    parts = 24 - len(kwargs.get("exclude_uncert_idx", ()))
    rng = np.random.RandomState(6)
    batch = 4
    feat = rng.randn(batch, 96).astype(np.float32)
    pred = _rotations(rng, batch, 0.4)
    gt = _rotations(rng, batch, 0.4)
    var = {
        "per_joint": rng.uniform(0.2, 0.9, (batch, parts)),
        "per_entry": rng.uniform(0.2, 0.9, (batch, parts, 3, 3)),
        "none": None,
    }[sigma]
    var = None if var is None else var.astype(np.float32)
    jhead = jax_flow.FlowHead(context_dim=32, **kwargs)
    args = [jnp.asarray(a) for a in (feat, pred, gt)] + [None if var is None else jnp.asarray(var)]
    variables = perturbed(jhead.init(jax.random.PRNGKey(6), *args), 7)
    state = state_dict_from_jax({"params": {"flow_head": variables["params"]}})
    head = flow.FlowHead(num_input_features=96, context_dim=32, **kwargs)
    head.load_state_dict(_strip(state, "flow_head."), strict=True)
    with torch.no_grad():
        log_phi = head(_t(feat), _t(pred), _t(gt), None if var is None else _t(var))
    ref = np.asarray(jhead.apply(variables, *args))
    assert log_phi.shape == ref.shape
    # 9 random variables: one log-density a part; 24: one over all joints
    assert ref.shape == (batch, parts if kwargs["num_nf_rv"] == 9 else 1)
    np.testing.assert_allclose(
        log_phi.numpy(), ref, atol=LOG_PHI_ATOL, rtol=LOG_PHI_RTOL
    )
    if "mask_params_id" in kwargs and ref.shape[1] == 24:
        assert not log_phi[:, list(kwargs["mask_params_id"])].any()


# --------------------------------------------------------------------------
# POCO forward with a GT pose: log_phi of the narrow CLIFF and PARE models
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["cliff", "pare"])
def test_poco_forward_with_gt_pose_matches_jax(kind):
    """`model(batch, smpl)` with a GT pose and a GT_POSE_COND mask gives
    the JAX model's `log_phi` (and, for CLIFF, the GT-conditioned
    `var_pose`); the crops are made once and fed to both."""
    image, centers, scales, true_hw = _request(3)
    rng = np.random.RandomState(8)
    gt = _rotations(rng, 3, 0.3)
    mask = np.asarray([True, False, True])
    with pytest.MonkeyPatch.context() as mp:
        pair = narrow_models(mp, kind)
        model = pair["model"]
        batch = preprocess_crops(
            _t(image), _t(centers), _t(scales), true_hw=_t(true_hw)
        )
        batch.update(gt_pose_rotmat=_t(gt), gt_pose_cond_mask=_t(mask))
        with torch.no_grad():
            port = model(batch, pair["smpl"])
        jbatch = jax_preprocess_crops(
            jnp.asarray(image), jnp.asarray(centers), jnp.asarray(scales),
            true_hw=jnp.asarray(true_hw),
        )
        jbatch.update(gt_pose_rotmat=jnp.asarray(gt), gt_pose_cond_mask=jnp.asarray(mask))
        ref = jax.jit(lambda v, b, sm: pair["jax_model"].apply(v, b, sm, train=False))(
            jax_variables(model), jbatch, pair["jax_smpl"]
        )
    assert set(port) == set(ref)
    assert port["log_phi"].shape == ref["log_phi"].shape == (3, 24)
    assert bool(torch.isfinite(port["log_phi"]).all())
    np.testing.assert_allclose(
        port["log_phi"].numpy(), np.asarray(ref["log_phi"]),
        atol=LOG_PHI_ATOL, rtol=LOG_PHI_RTOL,
    )
    np.testing.assert_allclose(
        port["var_pose"].numpy(), np.asarray(ref["var_pose"]), atol=2e-3, rtol=0
    )
