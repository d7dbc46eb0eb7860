"""The port's export runtime (`poco_tpu_torch/runtime/export.py`), case
by case as tests/test_export.py holds the JAX one, and the skinning
custom ops that exported programs call.

A tiny-backbone POCO (`tiny-cliff`, a V=96 synthetic SMPL) is built in
JAX and carried to the port through `state_dict_from_jax`; both packages
export it with buckets (2, 4) and raw uint8 input. On the same seeded
crops, made with numpy, the port's artifact on the CPU agrees with the
JAX artifact within `tests/test_torch_model.py:SLICE_TOLERANCES` at 1,
3 (padding) and 9 (chunking) crops, and with the port's eager
`model(batch, smpl)` exactly (on the padded batch where it pads). The
narrow POCO-PARE and HMR twins export too. The exported graph calls the
`poco_tpu_torch::skinning` op, not the plain einsums, and
`torch.library.opcheck` holds both ops' registrations. What is not
ported is refused. `cli.export` writes an artifact that `cli.serve`
serves, in-process.
"""

import io
import json
import shutil
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import poco_tpu.models.poco as jax_poco
from poco_tpu.runtime.export import export_poco as jax_export_poco
from poco_tpu.runtime.export import load_exported as jax_load_exported
from poco_tpu.smpl.assets import synthetic_smpl_model as jax_synthetic_smpl
from poco_tpu_torch.cli import export as export_cli
from poco_tpu_torch.cli import serve as serve_cli
from poco_tpu_torch.models.poco import POCO, PocoConfig, make_dummy_batch
from poco_tpu_torch.ops.preprocess import normalize_image
from poco_tpu_torch.ops.skinning import skinning
from poco_tpu_torch.runtime.export import (
    PROGRAM_NAME,
    ExportedPoco,
    ServedPoco,
    export_poco,
    load_exported,
)
from poco_tpu_torch.smpl.assets import synthetic_smpl_model
from poco_tpu_torch.utils.weights import state_dict_from_jax
from .test_torch_model import SLICE_TOLERANCES, narrow_models

TINY_YAML = str(Path(__file__).resolve().parents[1] / "configs" / "tiny_smoke.yaml")
TINY = dict(backbone="tiny-cliff", num_neurons=(64,), context_dim=64)
BUCKETS = (2, 4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module (see tests/test_torch_eval.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny_pair() -> dict:
    """The JAX tiny-cliff POCO with its initial variables, and the port's
    twin carrying the same weights, with both SMPLs (V=96)."""
    jax_model = jax_poco.POCO(cfg=jax_poco.PocoConfig(**TINY))
    jax_smpl = jax_synthetic_smpl(num_verts=96)
    variables = jax_poco.init_poco(jax_model, jax.random.PRNGKey(0), jax_smpl)
    model = POCO(PocoConfig(**TINY)).eval()
    model.load_state_dict(
        state_dict_from_jax(jax.tree.map(np.asarray, dict(variables))), strict=True
    )
    return {"jax_model": jax_model, "variables": variables, "jax_smpl": jax_smpl,
            "model": model, "smpl": synthetic_smpl_model(num_verts=96, device="cpu")}


@pytest.fixture(scope="module")
def tiny():
    return tiny_pair()


@pytest.fixture(scope="module")
def artifact(tiny, tmp_path_factory):
    """The port's float-input tiny artifact, buckets (2, 4), on the CPU."""
    out = str(tmp_path_factory.mktemp("exported") / "tiny_cliff")
    export_poco(tiny["model"], tiny["smpl"], out, batch_sizes=BUCKETS, device="cpu")
    return out


@pytest.fixture(scope="module")
def u8_artifacts(tiny, tmp_path_factory):
    """The JAX and the port's uint8-input tiny artifacts, buckets (2, 4)."""
    root = tmp_path_factory.mktemp("exported_u8")
    jax_out, port_out = str(root / "jax"), str(root / "port")
    jax_export_poco(tiny["jax_model"], tiny["variables"], tiny["jax_smpl"], jax_out,
                    batch_sizes=BUCKETS, platforms=("cpu",), uint8_input=True)
    export_poco(tiny["model"], tiny["smpl"], port_out, batch_sizes=BUCKETS,
                uint8_input=True, device="cpu")
    return jax_out, port_out


def seeded_batch(n: int, seed: int, uint8: bool) -> dict[str, np.ndarray]:
    """A request batch of `n` crops with CLIFF conditioning, from numpy."""
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (n, 224, 224, 3)).astype(np.uint8)
    return {
        "img": img if uint8 else rng.randn(n, 224, 224, 3).astype(np.float32),
        "bbox_info": (0.3 * rng.randn(n, 3)).astype(np.float32),
        "focal_length": rng.uniform(800, 1600, n).astype(np.float32),
        "scale": rng.uniform(0.5, 2.0, n).astype(np.float32),
        "center": rng.uniform(200, 800, (n, 2)).astype(np.float32),
        "orig_shape": np.tile(np.asarray([[1080.0, 1920.0]], np.float32), (n, 1)),
    }


def eager(model, smpl, batch: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """`model(batch, smpl)` on the CPU, uint8 crops normalized as the
    uint8-input program does."""
    tb = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
    if tb["img"].dtype == torch.uint8:
        tb["img"] = normalize_image(tb["img"].float())
    with torch.inference_mode():
        out = model(tb, smpl)
    return {k: v.numpy() for k, v in out.items() if v is not None}


def padded(batch: dict[str, np.ndarray], bucket: int) -> dict[str, np.ndarray]:
    """`batch` padded to `bucket` rows with its last row, as predict pads."""
    m = len(batch["img"])
    return {k: np.concatenate([v, np.repeat(v[-1:], bucket - m, axis=0)]) for k, v in batch.items()}


def assert_equal(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


class TestExportRoundtrip:
    def test_meta_and_files(self, artifact):
        with open(f"{artifact}/meta.json") as f:
            meta = json.load(f)
        assert meta["batch_sizes"] == [2, 4]
        assert meta["model_cfg"]["backbone"] == "tiny-cliff"
        assert meta["batch_keys"] == sorted(make_dummy_batch(
            PocoConfig(**TINY), 1, include_gt=False, device="cpu"))
        assert meta["output_keys"] == sorted(SLICE_TOLERANCES)
        assert meta["device"] == "cpu" and meta["torch_version"] == torch.__version__
        assert meta["smpl_static"]["parents"][0] == -1
        assert (not meta["compact"]) and (not meta["uint8_input"])
        assert np.fromfile(f"{artifact}/{PROGRAM_NAME}", np.uint8).size > 0

    @pytest.mark.parametrize("n", BUCKETS)
    def test_matches_model_forward(self, tiny, artifact, n):
        """At a bucket's size nothing pads: the program gives exactly the
        eager forward's outputs."""
        batch = seeded_batch(n, seed=n, uint8=False)
        got = load_exported(artifact, device="cpu").predict(batch)
        assert_equal(got, eager(tiny["model"], tiny["smpl"], batch))

    def test_padding_and_chunking(self, tiny, artifact):
        """n=3 pads into the 4-bucket; n=7 chunks 4+3: each chunk equals
        the eager forward of its padded rows, and padding never leaks."""
        loaded = load_exported(artifact, device="cpu")
        batch = seeded_batch(7, seed=1, uint8=False)
        out = loaded.predict(batch)
        head = eager(tiny["model"], tiny["smpl"], {k: v[:4] for k, v in batch.items()})
        tail = eager(tiny["model"], tiny["smpl"], padded({k: v[4:] for k, v in batch.items()}, 4))
        assert_equal(out, {k: np.concatenate([head[k], tail[k][:3]]) for k in head})
        three = loaded.predict({k: v[4:] for k, v in batch.items()})
        assert_equal(three, {k: v[:3] for k, v in tail.items()})

    def test_uint8_input_matches_host_normalize(self, tiny, artifact, u8_artifacts):
        """A uint8_input artifact (normalize on the device) reproduces the
        float artifact fed host-normalized crops; float input to a uint8
        artifact is rejected (it cannot be recovered into uint8)."""
        loaded = load_exported(u8_artifacts[1], device="cpu")
        assert loaded.uint8_input
        batch = seeded_batch(2, seed=2, uint8=True)
        got = loaded.predict(batch)
        batch_f = dict(batch)
        batch_f["img"] = normalize_image(torch.from_numpy(batch["img"]).float()).numpy()
        assert_equal(got, load_exported(artifact, device="cpu").predict(batch_f))
        with pytest.raises(ValueError, match="uint8"):
            loaded.predict(batch_f)

    def test_buckets_for_and_warm_tracking(self, artifact):
        """is_warm drives the serving loop's flush-before-cold-dispatch rule."""
        loaded = load_exported(artifact, device="cpu")
        assert loaded.buckets_for(1) == [2]
        assert loaded.buckets_for(3) == [4]
        assert loaded.buckets_for(4) == [4]
        assert loaded.buckets_for(5) == [4, 2]
        assert loaded.buckets_for(9) == [4, 4, 2]
        assert not loaded.is_warm(1)
        batch = {
            k: np.zeros((1,) + loaded._key_shape(k), loaded._key_dtype(k))
            for k in loaded.batch_keys
        }
        loaded.predict(batch)       # runs bucket 2
        assert loaded.is_warm(1) and loaded.is_warm(2)
        assert not loaded.is_warm(3)  # bucket 4 still cold
        loaded.warmup()
        assert loaded.is_warm(9)
        assert sorted(loaded.warmup_seconds) == [2, 4]
        assert loaded.load_seconds > 0

    def test_missing_key_raises(self, artifact):
        loaded = load_exported(artifact, device="cpu")
        with pytest.raises(KeyError):
            loaded.predict({"img": np.zeros((1, 224, 224, 3), np.float32)})

    @pytest.mark.parametrize("n", [1, 3, 9])
    def test_matches_jax_artifact(self, u8_artifacts, n):
        """The port's artifact against the JAX artifact of the same
        weights, on the same uint8 crops: 1 pads into the 2-bucket, 3
        into the 4-bucket, 9 chunks 4+4+1."""
        jax_out, port_out = u8_artifacts
        batch = seeded_batch(n, seed=10 + n, uint8=True)
        want = jax_load_exported(jax_out).predict(batch)
        got = load_exported(port_out, device="cpu").predict(batch)
        assert sorted(got) == sorted(want) == sorted(SLICE_TOLERANCES)
        for key, atol in SLICE_TOLERANCES.items():
            assert got[key].shape[0] == n
            np.testing.assert_allclose(got[key], want[key], atol=atol, rtol=0, err_msg=key)

    def test_compact_casts_vertices_within_a_millimetre(self, tiny, artifact, tmp_path):
        """compact=True leaves the vertices and joints as fp16, within
        1 mm of the fp32 artifact's; every other output is unchanged."""
        out = str(tmp_path / "compact")
        export_poco(tiny["model"], tiny["smpl"], out, batch_sizes=BUCKETS, compact=True,
                    device="cpu")
        batch = seeded_batch(3, seed=4, uint8=False)
        got = load_exported(out, device="cpu").predict(batch)
        want = load_exported(artifact, device="cpu").predict(batch)
        for key in want:
            if key in ("smpl_vertices", "smpl_joints3d", "smpl_joints2d"):
                assert got[key].dtype == np.float16
            else:
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        np.testing.assert_allclose(got["smpl_vertices"].astype(np.float32),
                                   want["smpl_vertices"], atol=1e-3, rtol=0)


@pytest.mark.parametrize("kind", ["pare", "hmr"])
def test_every_model_exports(kind, tmp_path):
    """The narrow POCO-PARE and HMR twins (V=6890) export and reproduce
    their eager forward exactly at a bucket's size."""
    with pytest.MonkeyPatch.context() as mp:
        pair = narrow_models(mp, kind)
        out = str(tmp_path / kind)
        export_poco(pair["model"], pair["smpl"], out, batch_sizes=(1, 2), device="cpu")
        loaded = load_exported(out, device="cpu")
        batch = seeded_batch(2, seed=5, uint8=False)
        got = loaded.predict(batch)
        assert_equal(got, eager(pair["model"], pair["smpl"], batch))
        assert sorted(got) == loaded.meta["output_keys"]


def _graph_targets(program) -> list[str]:
    return [
        str(node.target)
        for module in program.graph_module.modules() if isinstance(module, torch.fx.GraphModule)
        for node in module.graph.nodes if node.op == "call_function"
    ]


def test_exported_graph_calls_the_skinning_op(tiny):
    """The program keeps a call to `poco_tpu_torch::skinning` (which
    launches the kernel where the program runs on the card) instead of
    inlining the plain version, and the wrapper's counter does not move
    while tracing."""
    served = ServedPoco(tiny["model"], tiny["smpl"], compact=False, uint8_input=False)
    example = make_dummy_batch(tiny["model"].cfg, 2, include_gt=False, device="cpu")
    before = skinning.launches
    with torch.no_grad():
        program = torch.export.export(served, (example,), strict=False)
    targets = _graph_targets(program)
    assert targets.count("poco_tpu_torch.skinning.default") == 1
    assert skinning.launches == before
    # the plain version's blend, "vj,bjk->bvk", is not in the graph
    einsums = [
        node.args[0]
        for module in program.graph_module.modules() if isinstance(module, torch.fx.GraphModule)
        for node in module.graph.nodes if str(node.target) == "aten.einsum.default"
    ]
    assert "vj,bjk->bvk" not in einsums


def _skinning_args(seed: int, requires_grad: bool):
    rng = np.random.RandomState(seed)
    w = rng.rand(40, 24).astype(np.float32) ** 4
    w /= w.sum(axis=1, keepdims=True)
    tfms = rng.randn(3, 24, 4, 4).astype(np.float32)
    vp = rng.randn(3, 40, 3).astype(np.float32)
    w, tfms, vp = (torch.from_numpy(a) for a in (w, tfms, vp))
    return w, tfms.requires_grad_(requires_grad), vp.requires_grad_(requires_grad)


def test_opcheck_skinning():
    torch.library.opcheck(torch.ops.poco_tpu_torch.skinning, _skinning_args(0, True))
    torch.library.opcheck(torch.ops.poco_tpu_torch.skinning, _skinning_args(1, False))


def test_opcheck_skinning_backward():
    w, tfms, vp = _skinning_args(2, False)
    g = torch.from_numpy(np.random.RandomState(3).randn(3, 40, 3).astype(np.float32))
    torch.library.opcheck(torch.ops.poco_tpu_torch.skinning_backward, (w, tfms, vp, g))


def test_op_gradients_equal_the_plain_versions():
    """Autograd through the op (its registered backward, the
    `skinning_backward` op) gives the gradients of torch autograd through
    `skinning_reference`, to fp32 rounding (atol 1e-6)."""
    from poco_tpu_torch.ops.skinning import skinning_reference

    w, tfms, vp = _skinning_args(4, True)
    g = torch.from_numpy(np.random.RandomState(5).randn(3, 40, 3).astype(np.float32))
    got = torch.autograd.grad(torch.ops.poco_tpu_torch.skinning(w, tfms, vp), (tfms, vp), g)
    want = torch.autograd.grad(skinning_reference(w, tfms, vp), (tfms, vp), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


# --------------------------------------------------------------------------
# what is not ported, and the device rules
# --------------------------------------------------------------------------

def test_data_parallel_export_is_refused(tiny, tmp_path):
    with pytest.raises(NotImplementedError, match="queue A, item 3"):
        export_poco(tiny["model"], tiny["smpl"], str(tmp_path / "dp"), batch_sizes=(8,),
                    data_parallel=8, device="cpu")


def test_bf16_export_is_refused(tiny, tmp_path):
    model = POCO(PocoConfig(**TINY)).eval().to(torch.bfloat16)
    with pytest.raises(NotImplementedError, match="item 6"):
        export_poco(model, tiny["smpl"], str(tmp_path / "bf16"), device="cpu")
    with pytest.raises(NotImplementedError, match="item 6"):
        export_cli.main(["--cfg", TINY_YAML, "--out", str(tmp_path / "cli"),
                         "--dtype", "bf16", "--device", "cpu"])


def test_cross_platform_export_is_refused(tiny, tmp_path):
    with pytest.raises(NotImplementedError, match="another platform"):
        export_poco(tiny["model"], tiny["smpl"], str(tmp_path / "x"), platforms=("cpu", "cuda"),
                    device="cpu")


def test_artifact_of_another_device_type_is_refused(artifact, tmp_path):
    """A program holds its export device's tensors: an artifact recorded
    as exported on the card is refused on the CPU, before its program is
    read, and no CPU artifact is taken where the card is asked for."""
    moved = tmp_path / "from_the_card"
    shutil.copytree(artifact, moved)
    meta = json.loads((moved / "meta.json").read_text())
    meta["device"] = "cuda"
    (moved / "meta.json").write_text(json.dumps(meta))
    (moved / PROGRAM_NAME).unlink()
    with pytest.raises(ValueError, match="exported on cuda"):
        ExportedPoco(str(moved), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ExportedPoco(artifact)


def test_jax_artifact_is_refused(u8_artifacts):
    """The JAX package's artifact (StableHLO programs, no device in its
    meta.json) is not taken for a port artifact."""
    with pytest.raises(ValueError, match="not an artifact of this runtime"):
        ExportedPoco(u8_artifacts[0], device="cpu")


def test_export_asks_for_the_card_by_default(tiny, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this case is about a host without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_poco(tiny["model"], tiny["smpl"], str(tmp_path / "x"))


def test_model_off_the_export_device_is_refused(tiny, tmp_path):
    with pytest.raises(ValueError, match="must lie on meta"):
        export_poco(tiny["model"], tiny["smpl"], str(tmp_path / "x"), device="meta")


# --------------------------------------------------------------------------
# the CLIs
# --------------------------------------------------------------------------

def test_export_cli_defaults_resolve():
    """The CLI's default --cfg must exist and parse into a model config."""
    from poco_tpu_torch.config import model_config_from_hparams, update_hparams

    args = export_cli.build_parser().parse_args(["--out", "/tmp/unused"])
    assert model_config_from_hparams(update_hparams(args.cfg)).backbone
    assert args.device == "cuda" and args.dtype == "fp32"


def test_export_cli_then_serve_cli(tmp_path, capsys):
    """`cli.export` of configs/tiny_smoke.yaml on the CPU (random weights,
    the synthetic SMPL), then the server of `cli.serve` on it, in-process:
    one 2-crop request over HTTP."""
    out = str(tmp_path / "artifact")
    export_cli.main(["--cfg", TINY_YAML, "--out", out, "--batch-sizes", "2",
                     "--uint8-input", "--smpl_dir", str(tmp_path / "no_smpl"),
                     "--device", "cpu"])
    assert f"exported {TINY_YAML}" in capsys.readouterr().out
    args = serve_cli.build_parser().parse_args(
        ["--artifact", out, "--host", "127.0.0.1", "--port", "0", "--device", "cpu"])
    server = serve_cli.make_server(args).start(warmup=True)
    try:
        buf = io.BytesIO()
        np.savez(buf, img=np.zeros((2, 224, 224, 3), np.uint8))
        req = urllib.request.Request(f"http://127.0.0.1:{server.port}/predict",
                                     data=buf.getvalue(), method="POST")
        got = np.load(io.BytesIO(urllib.request.urlopen(req, timeout=120).read()))
        assert got["pred_pose"].shape == (2, 24, 3, 3)
        assert got["smpl_vertices"].shape[0] == 2 and got["smpl_vertices"].shape[-1] == 3
    finally:
        server.stop()
