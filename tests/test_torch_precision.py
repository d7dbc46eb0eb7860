"""The port's bf16 compute against the JAX package's: the forward, the
artifact and the `TRAINING.PRECISION: 16` train step.

The JAX package computes in bf16 with fp32 parameters as
`POCO(dtype=jnp.bfloat16)`; the port with `models.poco.compute_precision`
(a bf16 autocast, SMPL in fp32). The reference is JAX's bf16 program
compiled with XLA's excess precision off (STRICT_BF16), so that each of
its ops rounds its output to bf16 as the port's ops do; JAX's default
program fuses and skips some of those roundings. On the same weights
(carried through the bridge) and the same seeded crops, made with numpy:

  * every output has JAX's dtype (`uncert_feat`, `body_feat2` and
    `var_pose` bf16, the SMPL and camera outputs float32), and so has
    every convolution, dense, batch-norm and per-position layer's output
    (counted by kind and dtype on both sides);
  * a float32 output lies within half of JAX's own distance from bf16 to
    fp32 on that output, plus the fp32 pair's tolerance of the file that
    holds the fp32 pair (`SLICE_TOLERANCES`, `PARE_TOLERANCES`,
    `HMR_TOLERANCES`), both as the largest absolute difference;
  * a bf16 output lies within one bf16 step of JAX's (rtol 2^-7,
    atol 2^-8), compared as float32;
  * the port's bf16 output differs from its fp32 output (an autocast that
    does nothing fails).

Tiny-cliff (V=96) and the narrow HMR twin meet these bars. The narrow
POCO-PARE twin (`tests/test_torch_model.narrow_models`, V=6890) does not,
and neither do JAX's two programs against each other there (see
`test_bf16_forward_narrow_twin_matches_jax`): a PARE output that misses
them is held within SPREAD_FACTOR x the distance between JAX's default and
strict bf16 programs. The bf16 artifact (tiny, buckets (2, 4), float and
uint8 input) is held to JAX's bf16 artifact (`platforms=("cpu",)`) by the
same bars, and to the port's eager bf16 forward as the fp32 artifact is,
exactly; `cli.export` exports it by default. One PRECISION 16 train step
of the narrow POCO-CLIFF twin is held to JAX's strict bf16 step, set up as
`tests/test_torch_train.py` sets up the fp32 one (all-keep dropout, the
ReLU branches of the port's float64 forward on both sides): each loss
term, each gradient leaf, each module's gradient and the whole gradient
within twice JAX's own distance from the float64 value.
"""

from collections import Counter

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import poco_tpu.models.poco as jax_poco
from poco_tpu.models.layers import PerPositionConv1x1 as JaxPerPositionConv1x1
from poco_tpu.config import loss_config_from_hparams as jax_loss_config
from poco_tpu.config import update_hparams as jax_update_hparams
from poco_tpu.runtime.export import export_poco as jax_export_poco
from poco_tpu.runtime.export import load_exported as jax_load_exported
from poco_tpu.train.state import create_train_state, make_fused_optimizer
from poco_tpu.train.step import make_train_step as jax_make_train_step

from poco_tpu_torch.cli import export as export_cli
from poco_tpu_torch.config import loss_config_from_hparams, update_hparams
from poco_tpu_torch.models.layers import PerPositionConv1x1
from poco_tpu_torch.models.poco import compute_precision
from poco_tpu_torch.ops.preprocess import normalize_image
from poco_tpu_torch.runtime.export import ServedPoco, export_poco, load_exported
from poco_tpu_torch.train.checks import ReluMasks
from poco_tpu_torch.train.state import ModuleAdam
from poco_tpu_torch.train.step import make_train_step
from poco_tpu_torch.utils.weights import state_dict_from_jax

from .test_torch_export import BUCKETS, TINY_YAML, padded, seeded_batch, tiny_pair
from .test_torch_hmr import HMR_TOLERANCES
from .test_torch_model import CLIFF_YAML, SLICE_TOLERANCES, jax_variables, narrow_models
from .test_torch_pare import PARE_TOLERANCES
from .test_torch_train import (
    LR,
    _all_keep,
    _float64_grads,
    _j,
    _jax_relu_replay,
    _t,
    _train_batch,
)

BF16_RTOL, BF16_ATOL = 2.0 ** -7, 2.0 ** -8   # one bf16 step
DISTANCE_SHARE = 0.5      # of JAX's own bf16-to-fp32 distance, on a float32 output
STEP_FACTOR = 2.0         # of JAX's own bf16-to-float64 distance: loss terms and gradients
SPREAD_FACTOR = 2.0       # of JAX's default-to-strict bf16 distance (the narrow PARE twin)
# The one item of the PRECISION 16 step that misses STEP_FACTOR, and its own factor: a
# scalar whose bf16 value is one draw of the rounding noise. The port's own draw of
# `loss/loss_regr_pose` lies 1.2e-7 to 6.5e-6 from float64 as torch runs on 1 to 8
# threads (oneDNN blocks the sums by thread), JAX's strict one 2.2e-6; at this module's
# one thread the port is 2.01 x JAX's distance from JAX (CHANGES.md).
STEP_MISSES = {"loss/loss_regr_pose": 3.0}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module (see tests/test_torch_eval.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _request(n: int, seed: int) -> dict[str, np.ndarray]:
    """`n` seeded uint8 crops, normalized on the host, with CLIFF conditioning."""
    batch = seeded_batch(n, seed, uint8=True)
    batch["img"] = normalize_image(torch.from_numpy(batch["img"]).float()).numpy()
    return batch


# the layers whose outputs `_port` and `_jax` count by (kind, dtype), on each side
JAX_LAYERS = {flax.linen.Conv: "conv", flax.linen.ConvTranspose: "deconv",
              flax.linen.Dense: "dense", flax.linen.BatchNorm: "bn",
              JaxPerPositionConv1x1: "per-position"}
PORT_LAYERS = {torch.nn.Conv2d: "conv", torch.nn.ConvTranspose2d: "deconv",
               torch.nn.Linear: "dense", torch.nn.modules.batchnorm._BatchNorm: "bn",
               PerPositionConv1x1: "per-position"}


def _kind(module, layers: dict) -> str | None:
    return next((name for cls, name in layers.items() if isinstance(module, cls)), None)


def _port(model, smpl, batch, dtype, layers: Counter | None = None) -> dict[str, torch.Tensor]:
    """The port's forward; with `layers`, counts its layers' outputs by
    (kind, dtype)."""
    tb = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}

    def count(module, args, out):
        layers[(_kind(module, PORT_LAYERS), str(out.dtype).replace("torch.", ""))] += 1

    hooks = [m.register_forward_hook(count) for m in model.modules()
             if layers is not None and _kind(m, PORT_LAYERS)]
    try:
        with torch.inference_mode(), compute_precision("cpu", dtype):
            out = model(tb, smpl)
    finally:
        for hook in hooks:
            hook.remove()
    return {k: v for k, v in out.items() if v is not None}


# XLA may skip a bf16 rounding inside a fused computation ("excess precision", on by
# default); with it off, every op of JAX's bf16 program rounds its output to bf16, as eager
# JAX and the port do (tiny-cliff's vertices: strict and eager JAX 1.8e-7 m apart, the port
# 2.4e-7 m from strict JAX, the default program 1.5e-4 m)
STRICT_BF16 = {"xla_allow_excess_precision": False}


def _compiled(fn, *args, strict: bool):
    """`jax.jit(fn)` compiled for `args`, with STRICT_BF16 where `strict`."""
    lowered = (fn if hasattr(fn, "lower") else jax.jit(fn)).lower(*args)
    return lowered.compile(compiler_options=STRICT_BF16 if strict else None)


def _jax(jax_model, variables, jax_smpl, batch, strict: bool = False,
         layers: Counter | None = None) -> dict:
    """JAX's forward, jitted; with `strict`, compiled with STRICT_BF16.
    With `layers`, counts its layers' outputs by (kind, dtype)."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    kinds = {}

    def capture(module, method) -> bool:
        kind = _kind(module, JAX_LAYERS) if method == "__call__" else None
        if kind:
            kinds[module.path] = kind
        return kind is not None

    def forward(v, b, sm):
        if layers is None:
            return jax_model.apply(v, b, sm, train=False), {}
        return jax_model.apply(v, b, sm, train=False, capture_intermediates=capture,
                               mutable=["intermediates"])

    out, state = _compiled(forward, variables, jb, jax_smpl, strict=strict)(variables, jb, jax_smpl)
    if layers is not None:
        def walk(tree, path):
            for key, value in tree.items():
                if key == "__call__":
                    layers.update((kinds[path], str(v.dtype)) for v in value)
                else:
                    walk(value, path + (key,))
        walk(flax.core.unfreeze(state["intermediates"]), ())
    return {k: np.asarray(v) for k, v in out.items() if v is not None}


def _name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def assert_bf16_close(port: dict, jax16: dict, jax32: dict, tolerances: dict,
                      spread: dict | None = None) -> dict:
    """The bars of the module docstring. With `spread` (the distance of
    JAX's default bf16 outputs from its strict ones), a key that misses
    them passes within SPREAD_FACTOR x that distance + the key's
    tolerance. Returns each key's difference beside its bar and verdict."""
    assert sorted(port) == sorted(jax16) == sorted(tolerances)
    readings = {}
    for key, tol in tolerances.items():
        got = port[key].float().numpy()
        want = np.asarray(jax16[key]).astype(np.float32)
        assert _name(port[key].dtype) == np.asarray(jax16[key]).dtype.name, key
        own = float(np.abs(want - np.asarray(jax32[key], np.float32)).max())
        err = float(np.abs(got - want).max())
        if port[key].dtype == torch.bfloat16:
            close = np.allclose(got, want, rtol=BF16_RTOL, atol=BF16_ATOL)
            readings[key] = (err, "bf16 step", close)
        else:
            close = err <= DISTANCE_SHARE * own + tol
            readings[key] = (err, DISTANCE_SHARE * own + tol, close)
        if not close and spread is not None:
            close = err <= SPREAD_FACTOR * spread[key] + tol
            readings[key] += ("spread", err / spread[key])
        assert close, (key, readings[key], own)
    return readings


def _check_forward(model, jax_model, variables, smpl, jax_smpl, tolerances,
                   spread: bool = False, seed=3) -> None:
    """The module docstring's bars on 3 crops, against JAX's strict bf16
    forward; the layers' output dtypes counted on both sides must agree.
    With `spread`, `assert_bf16_close`'s second bar (see
    `test_bf16_forward_narrow_twin_matches_jax`)."""
    jax16_model = jax_poco.POCO(cfg=jax_model.cfg, dtype=jnp.bfloat16)
    batch = _request(3, seed)
    port_layers, jax_layers = Counter(), Counter()
    port16 = _port(model, smpl, batch, torch.bfloat16, port_layers)
    port32 = {k: v.numpy() for k, v in _port(model, smpl, batch, None).items()}
    jax16 = _jax(jax16_model, variables, jax_smpl, batch, strict=True, layers=jax_layers)
    jax32 = _jax(jax_model, variables, jax_smpl, batch)
    assert port_layers == jax_layers and port_layers[("conv", "bfloat16")] > 0, (
        sorted(port_layers.items()), sorted(jax_layers.items()))
    distance = None
    if spread:
        fused = _jax(jax16_model, variables, jax_smpl, batch)
        distance = {k: float(np.abs(fused[k].astype(np.float32) - jax16[k].astype(np.float32)).max())
                    for k in jax16}
    readings = assert_bf16_close(port16, jax16, jax32, tolerances, distance)
    print(f"bf16 forward of {jax_model.cfg.backbone}, layers {sorted(port_layers.items())}: "
          f"{readings}")
    for key in ("uncert_feat", "pred_pose", "smpl_vertices"):
        assert not np.array_equal(port16[key].float().numpy(), port32[key]), key
    assert port16["smpl_vertices"].dtype == torch.float32


# --------------------------------------------------------------------------
# the forward
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    return tiny_pair()


def test_bf16_forward_tiny_matches_jax(tiny):
    _check_forward(tiny["model"], tiny["jax_model"], tiny["variables"], tiny["smpl"],
                   tiny["jax_smpl"], SLICE_TOLERANCES)


@pytest.mark.parametrize("kind", ["pare", "hmr"])
def test_bf16_forward_narrow_twin_matches_jax(kind):
    """The narrow HMR twin meets the module docstring's bars against JAX's
    strict bf16 forward. The narrow PARE twin does not, and JAX does not
    meet them against itself there: its default bf16 program lies 0.37 m
    from its strict one on the vertices (eager JAX 0.42 m), where the bar
    is 0.15 m. The random part attention turns a rounding made in another
    order into other parts, so two correct bf16 forwards of that net
    differ by about JAX's own bf16-to-fp32 distance; the first
    convolution already differs in the last bit (oneDNN and XLA sum in
    other orders). A PARE output that misses the bars is held within
    SPREAD_FACTOR x the distance of JAX's two programs on it, and every
    layer's output dtype to JAX's (`_check_forward`): a submodule kept in
    fp32 shows there, where the outputs cannot show it."""
    tolerances = {"pare": PARE_TOLERANCES, "hmr": HMR_TOLERANCES}[kind]
    with pytest.MonkeyPatch.context() as mp:
        pair = narrow_models(mp, kind)
        _check_forward(pair["model"], pair["jax_model"], jax_variables(pair["model"]),
                       pair["smpl"], pair["jax_smpl"], tolerances, spread=kind == "pare")


def test_compute_precision_refuses_other_dtypes():
    with pytest.raises(ValueError, match="fp32 .None. or bf16"):
        compute_precision("cpu", torch.float16)


# --------------------------------------------------------------------------
# the bf16 artifact
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bf16_artifacts(tiny, tmp_path_factory):
    """JAX's and the port's bf16 tiny artifacts, buckets (2, 4), by input
    kind: {"float": (jax, port), "uint8": (jax, port)}."""
    root = tmp_path_factory.mktemp("exported_bf16")
    jax16_model = jax_poco.POCO(cfg=tiny["jax_model"].cfg, dtype=jnp.bfloat16)
    out = {}
    for kind in ("float", "uint8"):
        jax_out, port_out = str(root / f"jax_{kind}"), str(root / f"port_{kind}")
        jax_export_poco(jax16_model, tiny["variables"], tiny["jax_smpl"], jax_out,
                        batch_sizes=BUCKETS, platforms=("cpu",), uint8_input=kind == "uint8")
        export_poco(tiny["model"], tiny["smpl"], port_out, batch_sizes=BUCKETS,
                    uint8_input=kind == "uint8", device="cpu", dtype="bf16")
        out[kind] = (jax_out, port_out)
    return out


@pytest.mark.parametrize("kind", ["float", "uint8"])
@pytest.mark.parametrize("n", [1, 3])
def test_bf16_artifact_matches_jax_bf16_artifact(tiny, bf16_artifacts, kind, n):
    """1 pads into the 2-bucket, 3 into the 4-bucket; a float artifact
    gets the crops normalized on the host, as the server sends them
    (`prepare_request_batch`). JAX's own distance is its bf16 artifact's
    from its fp32 forward on the same rows."""
    jax_out, port_out = bf16_artifacts[kind]
    batch = seeded_batch(n, seed=20 + n, uint8=True)
    host = dict(batch, img=normalize_image(torch.from_numpy(batch["img"]).float()).numpy())
    if kind == "float":
        batch = host
    got = load_exported(port_out, device="cpu").predict(batch)
    want = jax_load_exported(jax_out).predict(batch)
    jax32 = _jax(tiny["jax_model"], tiny["variables"], tiny["jax_smpl"], host)
    # numpy has no bfloat16: the port's bf16 outputs arrive as float32
    bf16_keys = {k for k, v in want.items() if v.dtype.name == "bfloat16"}
    assert bf16_keys == {"uncert_feat", "body_feat2", "var_pose"}
    assert all(got[k].dtype == np.float32 for k in got)
    port = {k: torch.from_numpy(v).to(torch.bfloat16 if k in bf16_keys else torch.float32)
            for k, v in got.items()}
    assert all(torch.equal(port[k].float(), torch.from_numpy(got[k])) for k in bf16_keys)
    print(f"bf16 artifact, {kind}, {n} crops: "
          f"{assert_bf16_close(port, want, jax32, SLICE_TOLERANCES)}")


@pytest.mark.parametrize("kind", ["float", "uint8"])
def test_bf16_artifact_equals_eager_bf16_forward(tiny, bf16_artifacts, kind):
    """At a bucket's size, and padded, the bf16 program gives exactly the
    eager bf16 forward's outputs (as float32), as the fp32 artifact gives
    the fp32 forward's; meta records the compute dtype."""
    loaded = load_exported(bf16_artifacts[kind][1], device="cpu")
    assert loaded.meta["compute_dtype"] == "bfloat16"
    for n in (2, 3):
        batch = seeded_batch(n, seed=30 + n, uint8=kind == "uint8")
        got = loaded.predict(batch)
        host = padded(batch, 4) if n == 3 else batch
        host = dict(host)
        if kind == "uint8":
            host["img"] = normalize_image(torch.from_numpy(host["img"]).float()).numpy()
        want = {k: v.float().numpy()[:n] for k, v in
                _port(tiny["model"], tiny["smpl"], host, torch.bfloat16).items()}
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_bf16_program_skins_in_fp32(tiny):
    """The skinning custom op of a bf16 program takes fp32 inputs: SMPL
    runs outside the bf16 region, so the kernel's fp32 contract holds."""
    served = ServedPoco(tiny["model"], tiny["smpl"], compact=False, uint8_input=True,
                        dtype="bf16")
    example = {k: torch.from_numpy(v) for k, v in seeded_batch(2, 5, uint8=True).items()}
    with torch.no_grad():
        program = torch.export.export(served, (example,), strict=False)
    calls = [
        node for module in program.graph_module.modules()
        if isinstance(module, torch.fx.GraphModule)
        for node in module.graph.nodes if str(node.target) == "poco_tpu_torch.skinning.default"
    ]
    assert len(calls) == 1
    dtypes = [arg.meta["val"].dtype for arg in calls[0].args]
    assert dtypes == [torch.float32] * 3


def test_bf16_export_cli(tmp_path):
    """`cli.export` defaults to bf16, as the JAX tool does."""
    out = str(tmp_path / "artifact")
    assert export_cli.build_parser().parse_args(["--out", out]).dtype == "bf16"
    export_cli.main(["--cfg", TINY_YAML, "--out", out, "--batch-sizes", "2",
                     "--smpl_dir", str(tmp_path / "no_smpl"), "--device", "cpu"])
    loaded = load_exported(out, device="cpu")
    assert loaded.meta["compute_dtype"] == "bfloat16"
    got = loaded.predict(seeded_batch(2, 6, uint8=False))
    assert got["var_pose"].dtype == np.float32 and np.isfinite(got["pred_pose"]).all()


# --------------------------------------------------------------------------
# TRAINING.PRECISION: 16
# --------------------------------------------------------------------------

def test_precision16_train_step_matches_jax_bf16_step(monkeypatch):
    """One bf16 train step of the narrow POCO-CLIFF twin (batch 2,
    configs/poco_cliff.yaml's loss) against `make_train_step` of JAX's
    `POCO(dtype=jnp.bfloat16)` on the same weights, compiled with
    STRICT_BF16 (every op rounds to bf16, as the port's do), measured
    against the float64 value of the same step (the port's float64
    forward and backward on the same ReLU branches): each loss term, each
    gradient leaf (in L2), each top-level module's gradient and the whole
    gradient within STEP_FACTOR x JAX's own distance from float64 (the
    item in STEP_MISSES within its own factor, see there). JAX's
    default program fuses and skips bf16 roundings, so it lies nearer
    float64 than either op-by-op program (see CHANGES.md). JAX's
    gradients are its fused Adam's first moment / (1 - b1)."""
    from jax.flatten_util import ravel_pytree

    twin = narrow_models(monkeypatch, "cliff")
    model = twin["model"]
    jax16_model = jax_poco.POCO(cfg=twin["jax_model"].cfg, dtype=jnp.bfloat16)
    _all_keep(monkeypatch)
    loss_cfg = loss_config_from_hparams(update_hparams(str(CLIFF_YAML)))
    batch = _train_batch(7)
    masks = ReluMasks()
    f64_grads, f64_terms = _float64_grads(model, _t(batch), twin["smpl"], loss_cfg, masks)
    _jax_relu_replay(monkeypatch, masks)

    variables = jax.tree.map(np.array, jax_variables(model))
    jax_state = create_train_state(jax16_model, variables, make_fused_optimizer(lr=LR))
    jax_step = jax_make_train_step(jax16_model, jax_loss_config(jax_update_hparams(str(CLIFF_YAML))),
                                   donate=False)
    args = (jax_state, _j(batch), twin["jax_smpl"], jax.random.PRNGKey(0))
    new_state, jax_metrics = jax.block_until_ready(_compiled(jax_step, *args, strict=True)(*args))

    optimizer = ModuleAdam(model, lr=LR)
    with masks.replay():
        metrics = make_train_step(model, optimizer, loss_cfg, autocast_dtype=torch.bfloat16)(
            _t(batch), twin["smpl"])

    terms = [k for k in jax_metrics if k.startswith("loss/")]
    assert terms and {k for k in metrics if not k.startswith("_")} == {
        k for k in jax_metrics if not k.startswith("_")}
    readings = {}   # |port - JAX| / |JAX - float64|
    for key in terms:
        got, want = float(metrics[key]), float(jax_metrics[key])
        readings[key] = abs(got - want) / abs(want - f64_terms[key])

    grads = {}
    for group, sub in new_state.opt_state["groups"].items():
        _, unravel = ravel_pytree(jax_state.params[group])
        grads[group] = unravel(sub["m"] / 0.1)
    jax_grads = state_dict_from_jax({"params": jax.tree.map(np.asarray, grads)})
    port_grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(port_grads) == set(jax_grads)

    def ratio(keys) -> float:
        def flat(tree):
            return torch.cat([tree[k].double().flatten() for k in keys])
        return float((flat(port_grads) - flat(jax_grads)).norm()
                     / (flat(jax_grads) - flat(f64_grads)).norm())

    for group in ("backbone.", "head.", "uncert_head.", "flow_head.", ""):
        readings[group or "gradient"] = ratio([k for k in jax_grads if k.startswith(group)])
    for key in jax_grads:
        readings[key] = ratio([key])
    worst = sorted(readings.items(), key=lambda kv: -kv[1])
    groups = ("backbone.", "head.", "uncert_head.", "flow_head.", "gradient")
    print("PRECISION 16 step, |port - JAX| / |JAX - float64|, worst:", worst[:8],
          "terms:", {k: readings[k] for k in terms}, "modules:", {k: readings[k] for k in groups})
    missed = [kv for kv in worst if kv[1] > STEP_MISSES.get(kv[0], STEP_FACTOR)]
    assert not missed, missed
