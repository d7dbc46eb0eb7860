"""PyTorch port vs JAX package: the dataset, its loader, checkpoints and
the evaluation CLI.

The port's `PocoDataset` and `DataLoader` against JAX's on the repo's
smoke set (`data/dataset_extras/smoke_test.npz`, 16 JPEGs), the JAX
package on its native path (`POCO_TPU_NATIVE_LOADER=1`): its `get_batch`
decodes and warps with the same C++ code as the port's loader, so every
key and value is equal, the crops bit-equal, the batch order the same.
Against JAX's per-item path, which warps with cv2, the crops are held to
JAX's own bar for its native warp against cv2 (tests/test_native_loader.py
:108-116: atol 1.5 in the interior) and every other key stays exact. With
OpenCV hidden the port reads, crops and augments items.
`python -m poco_tpu_torch.cli.eval` runs in process on the
CPU with a `.pt` saved from a seeded narrow port model, against
`run_eval` and against the repo's `eval.py` on the same file.
"""

import json
import os
import runpy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import poco_tpu.models.poco as jax_poco
from poco_tpu.config import dataset_npz_path as jax_dataset_npz_path
from poco_tpu.data.dataset import DataLoader as JaxDataLoader
from poco_tpu.data.dataset import PocoDataset as JaxPocoDataset
from poco_tpu.utils.checkpoint_convert import load_torch_checkpoint as jax_load_torch_checkpoint

import poco_tpu_torch.models.poco as port_poco
from poco_tpu_torch.cli import eval as cli_eval
from poco_tpu_torch.config import dataset_npz_path
from poco_tpu_torch.data import transforms
from poco_tpu_torch.data.dataset import DataLoader, PocoDataset
from poco_tpu_torch.eval.runner import pw3d_split_report, run_eval
from poco_tpu_torch.smpl.assets import resolve_smpl_params
from poco_tpu_torch.utils.checkpoint import (
    get_model_path,
    load_checkpoint_into,
    load_torch_checkpoint,
)

from .test_torch_model import CLIFF_YAML, NARROW, narrow_models

REPO = Path(__file__).resolve().parents[1]
DATA = REPO / "data"
SMOKE_NPZ = DATA / "dataset_extras" / "smoke_test.npz"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module: under the fast tier's
    six workers on a shared host the default team (a thread a core)
    spends the many small ops of the SMPL chain waiting in its barriers,
    over ten times slower than one thread. Restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CV2_WARP_ATOL = 1.5  # JAX's native warp against its cv2 warp, interior (test_native_loader.py:116)


@pytest.fixture
def native_path(monkeypatch):
    """The JAX package on its native decoder and whole-batch warp."""
    monkeypatch.setenv("POCO_TPU_NATIVE_LOADER", "1")


def _assert_items_equal(port: dict, ref: dict, cv2_warp: bool = False) -> None:
    """Every key equal; with `cv2_warp` (`ref` cropped by cv2), the crop at
    CV2_WARP_ATOL in its interior."""
    assert list(port) == list(ref)
    for key, value in ref.items():
        if isinstance(value, (str, list)):
            assert port[key] == value, key
        else:
            assert np.asarray(port[key]).dtype == np.asarray(value).dtype, key
            if key == "img" and cv2_warp:
                np.testing.assert_allclose(port[key][..., 2:-2, 2:-2, :], value[..., 2:-2, 2:-2, :],
                                           atol=CV2_WARP_ATOL, rtol=0, err_msg=key)
            else:
                np.testing.assert_array_equal(port[key], value, err_msg=key)


def _rows(batch: dict) -> list[dict]:
    """A collated batch back into its items."""
    n = len(batch["imgname"])
    return [{k: v[j] for k, v in batch.items()} for j in range(n)]


# --------------------------------------------------------------------------
# dataset and loader
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["eval", "test_rot_scale", "train"])
def test_dataset_items_equal_jax(native_path, mode):
    """Every item of the smoke set, key for key: at eval, with TEST_ROT /
    TEST_SCALE (rotated crop, rotated global orient), and with training
    augmentation from the same seed. The port's items (one at a time)
    equal the rows of JAX's native `get_batch`, crops bit-equal; against
    JAX's per-item items (cv2's warp) the crops are within CV2_WARP_ATOL."""
    kwargs = {"is_train": mode == "train", "seed": 3}
    if mode == "test_rot_scale":
        kwargs["options"] = {"TEST_ROT": 20.0, "TEST_SCALE": 1.2}
    port = PocoDataset(str(SMOKE_NPZ), img_dir=str(DATA), **kwargs)
    ref = JaxPocoDataset(str(SMOKE_NPZ), img_dir=str(DATA), **kwargs)
    ref_items = JaxPocoDataset(str(SMOKE_NPZ), img_dir=str(DATA), **kwargs)
    assert len(port) == len(ref) == 16
    np.testing.assert_array_equal(port.gender, ref.gender)
    ref_rows = _rows(ref.get_batch(range(len(ref))))
    rotated = 0
    for i in range(len(ref)):
        item = port[i]
        _assert_items_equal(item, ref_rows[i])
        _assert_items_equal(item, ref_items[i], cv2_warp=True)
        rotated += float(item["rot_angle"]) != 0.0
    assert item["img"].shape == (224, 224, 3) and item["img"].dtype == np.float32
    if mode == "test_rot_scale":
        assert rotated == 16
        np.testing.assert_allclose(item["scale"], 1.2 * 0.9, rtol=1e-6)


def test_dataset_confident_frames_and_genders_equal_jax(native_path, tmp_path):
    """A `var` field keeps the frames whose root uncertainty is below
    UNCERT_THRESHOLD; genders map m -> 0, f -> 1, anything else -> -1;
    `num_images` draws the same subset."""
    data = dict(np.load(SMOKE_NPZ))
    rng = np.random.RandomState(4)
    data["var"] = rng.uniform(0.0, 0.6, (16, 24)).astype(np.float32)
    data["gender"] = np.array(["m", "f", "n", "x"] * 4)
    path = tmp_path / "smoke_var.npz"
    np.savez(path, **data)
    for kwargs in ({}, {"num_images": 5}):
        port = PocoDataset(str(path), img_dir=str(DATA), is_train=False, **kwargs)
        ref = JaxPocoDataset(str(path), img_dir=str(DATA), is_train=False, **kwargs)
        assert len(port) == len(ref) and len(port) < 16
        np.testing.assert_array_equal(port.imgname, ref.imgname)
        np.testing.assert_array_equal(port.gender, ref.gender)
        last = len(ref) - 1
        _assert_items_equal(port[last], _rows(ref.get_batch([last]))[0])
        _assert_items_equal(port[last], ref[last], cv2_warp=True)
    assert set(PocoDataset(str(path), img_dir=str(DATA)).gender) == {-1, 0, 1}


@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, True), (True, False)])
def test_loader_batches_equal_jax(native_path, shuffle, drop_last):
    """The same batches in the same order as JAX's loader (batch 5 of 16:
    a short last batch unless dropped)."""
    port = DataLoader(PocoDataset(str(SMOKE_NPZ), img_dir=str(DATA), is_train=False),
                      batch_size=5, shuffle=shuffle, drop_last=drop_last, seed=1)
    ref = JaxDataLoader(JaxPocoDataset(str(SMOKE_NPZ), img_dir=str(DATA), is_train=False),
                        batch_size=5, shuffle=shuffle, drop_last=drop_last, seed=1)
    port_batches, ref_batches = list(port), list(ref)
    assert len(port) == len(ref) == len(port_batches) == len(ref_batches) == 3 + (not drop_last)
    for b, r in zip(port_batches, ref_batches):
        _assert_items_equal(b, r)


def test_loader_stops_early_and_raises_what_the_dataset_raises():
    class Broken:
        def __len__(self):
            return 6

        def __getitem__(self, i):
            if i == 4:
                raise FileNotFoundError(f"item {i}")
            return {"x": np.float32(i), "name": str(i)}

    loader = DataLoader(Broken(), batch_size=2, shuffle=False, prefetch=1)
    first = next(iter(loader))  # a consumer that stops early
    np.testing.assert_array_equal(first["x"], [0.0, 1.0])
    assert first["name"] == ["0", "1"]
    with pytest.raises(FileNotFoundError, match="item 4"):
        list(loader)


@pytest.mark.parametrize("name,is_train", [
    ("3dpw", False), ("smoke", False), ("smoke", True), ("h36m", True), ("nowhere", False),
])
def test_dataset_npz_path_equals_jax(name, is_train):
    assert dataset_npz_path(str(DATA), name, is_train) == jax_dataset_npz_path(
        str(DATA), name, is_train
    )


def test_data_without_opencv_raises_import_error(monkeypatch):
    """The opposite of what the name says since the port has its own
    loader: with cv2 hidden, the dataset reads, crops and augments items
    (rotated, flipped, channel noise) and whole batches, equal to what it
    gives with cv2 importable."""
    kwargs = {"img_dir": str(DATA), "is_train": True, "seed": 11,
              "options": {"ROT_FACTOR": 60.0}}
    with_cv2 = PocoDataset(str(SMOKE_NPZ), **kwargs)
    expect = [with_cv2[i] for i in range(4)]
    monkeypatch.setitem(sys.modules, "cv2", None)
    port = PocoDataset(str(SMOKE_NPZ), **kwargs)
    items = [port[i] for i in range(4)]
    for item, ref in zip(items, expect):
        _assert_items_equal(item, ref)
    assert any(it["rot_angle"] != 0 for it in items) and any(it["is_flipped"] for it in items)
    assert all(it["img"].shape == (224, 224, 3) and it["img"].max() > 0 for it in items)
    again = PocoDataset(str(SMOKE_NPZ), **kwargs)
    _assert_items_equal(_rows(again.get_batch(range(4)))[3], items[3])
    aug = transforms.AugmentParams(flip=True)
    pose = np.arange(72, dtype=np.float32)
    np.testing.assert_array_equal(transforms.process_pose(pose, aug),
                                  transforms.flip_pose(pose.copy()))


def test_importing_the_port_loads_neither_jax_nor_cv2():
    code = (
        "import importlib, pkgutil, sys\n"
        "import poco_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(poco_tpu_torch.__path__, 'poco_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'orbax', 'poco_tpu', 'cv2'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------

def _small_model():
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4))


@pytest.mark.parametrize("wrap", ["plain", "model", "state_dict", "lightning"])
def test_load_torch_checkpoint_unwraps_as_jax(tmp_path, wrap):
    state = _small_model().state_dict()
    payload = {
        "plain": state,
        "model": {"model": state, "step": 3},
        "state_dict": {"state_dict": state},
        "lightning": {"state_dict": {f"model.{k}": v for k, v in state.items()}},
    }[wrap]
    path = tmp_path / "ckpt.pt"
    torch.save(payload, path)
    port, ref = load_torch_checkpoint(str(path)), jax_load_torch_checkpoint(str(path))
    assert list(port) == list(ref) == list(state)
    for key in state:
        torch.testing.assert_close(port[key], state[key], rtol=0, atol=0)
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4))
    assert load_checkpoint_into(model, str(path)) == str(path)
    torch.testing.assert_close(model[0].weight, state["0.weight"], rtol=0, atol=0)


def test_load_checkpoint_into_refuses_missing_and_reports_unexpected(tmp_path, capsys):
    state = _small_model().state_dict()
    state["extra.weight"] = torch.zeros(2)
    torch.save(state, tmp_path / "extra.pt")
    load_checkpoint_into(_small_model(), str(tmp_path / "extra.pt"))
    assert "extra.weight" in capsys.readouterr().out
    del state["1.running_var"]
    torch.save(state, tmp_path / "missing.pt")
    with pytest.raises(KeyError, match="running_var"):
        load_checkpoint_into(_small_model(), str(tmp_path / "missing.pt"))


def test_get_model_path_picks_the_named_or_newest_file_and_refuses_orbax(tmp_path):
    with pytest.raises(FileNotFoundError):
        get_model_path(str(tmp_path))
    torch.save({}, tmp_path / "epoch_1.pt")
    os.utime(tmp_path / "epoch_1.pt", (1, 1))
    torch.save({}, tmp_path / "epoch_2.ckpt")
    (tmp_path / "code").mkdir()
    assert get_model_path(str(tmp_path), "best") == str(tmp_path / "epoch_2.ckpt")
    torch.save({}, tmp_path / "best_model.pt")
    os.utime(tmp_path / "best_model.pt", (1, 1))
    assert get_model_path(str(tmp_path), "best") == str(tmp_path / "best_model.pt")
    (tmp_path / "last").mkdir()
    (tmp_path / "last" / "_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="orbax"):
        get_model_path(str(tmp_path), "latest")
    with pytest.raises(ValueError, match="orbax"):
        load_torch_checkpoint(str(tmp_path / "last"))


# --------------------------------------------------------------------------
# the evaluation CLI
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def narrow_ckpt(tmp_path_factory):
    """A `.pt` of the seeded narrow POCO-CLIFF, in a run logdir."""
    logdir = tmp_path_factory.mktemp("run")
    with pytest.MonkeyPatch.context() as mp:
        model = narrow_models(mp, "cliff", seed=5)["model"]
        torch.save({"model": model.state_dict()}, logdir / "best_model.pt")
    return logdir


def _patch_narrow(monkeypatch, jax_too: bool = False):
    _, name, port_backbone, jax_backbone = NARROW["cliff"]
    monkeypatch.setitem(port_poco.BACKBONES, name, port_backbone)
    if jax_too:
        monkeypatch.setitem(jax_poco.BACKBONES, name, jax_backbone)


def _cli_args(ckpt, out, *extra):
    return ["--cfg", str(CLIFF_YAML), "--ckpt", str(ckpt), "--dataset", "smoke",
            "--data_dir", str(DATA), "--batch_size", "6", "--out", str(out), *extra]


@pytest.mark.parametrize("flip_test", [False, True])
def test_cli_report_equals_run_eval(native_path, monkeypatch, narrow_ckpt, tmp_path, flip_test):
    """The CLI on the CPU (a logdir as --ckpt) prints and writes exactly
    the report of `run_eval` on the same weights, data and SMPLs."""
    _patch_narrow(monkeypatch)
    out = tmp_path / "report.json"
    flags = ["--device", "cpu"] + (["--flip_test"] if flip_test else [])
    payload = cli_eval.main(_cli_args(narrow_ckpt, out, *flags))
    assert json.loads(out.read_text()) == json.loads(json.dumps(payload))
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32

    model = port_poco.POCO(port_poco.PocoConfig()).eval()
    load_checkpoint_into(model, str(narrow_ckpt / "best_model.pt"))
    smpl = resolve_smpl_params(None, "neutral", "cpu")
    result = run_eval(
        model, PocoDataset(str(SMOKE_NPZ), img_dir=str(DATA), dataset_name="smoke",
                           is_train=False),
        smpl, smpl, smpl, batch_size=6, loss_ver=model.cfg.loss_ver, flip_test=flip_test,
    )
    expect = {
        "summary": result.summary(),
        "splits": pw3d_split_report(result.imgnames, result.mpjpe_mm, result.pa_mpjpe_mm,
                                    result.v2v_mm),
        "per_joint": result.per_joint_stats(),
    }
    assert payload == expect


def test_cli_asks_for_the_card_and_raises_without_one(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_eval.main(_cli_args(tmp_path / "none.pt", tmp_path / "r.json"))
    assert cli_eval.parse_args(["--cfg", "x"]).device == "cuda"


@pytest.mark.slow
def test_cli_report_matches_jax_eval_py(native_path, monkeypatch, narrow_ckpt, tmp_path):
    """The repo's `eval.py` (JAX, on 8 virtual CPU devices) and the port's
    CLI on the same `.pt`: the summary and splits within rtol 1e-4 or atol
    1e-6, but the correlations within 1e-3: the smoke set's 16 images
    are alike, so the random model's sigma spans only ~1e-4 across them
    and fp32 noise in sigma (~3e-7) moves a Pearson over 16 samples by
    ~1e-3 (run_eval on varied images is held to rtol 1e-4 in
    test_torch_eval.py). Slow: JAX builds and compiles its model and
    eval step here, 40-80 s on the CPU."""
    _patch_narrow(monkeypatch, jax_too=True)
    port_out, jax_out = tmp_path / "port.json", tmp_path / "jax.json"
    ckpt = narrow_ckpt / "best_model.pt"
    port = cli_eval.main(_cli_args(ckpt, port_out, "--device", "cpu"))
    monkeypatch.setattr(sys, "argv", ["eval.py"] + _cli_args(ckpt, jax_out))
    runpy.run_path(str(REPO / "eval.py"), run_name="__main__")
    ref = json.loads(jax_out.read_text())
    assert set(port) == set(ref) == {"summary", "splits", "per_joint"}
    assert set(port["summary"]) == set(ref["summary"])
    for key, value in ref["summary"].items():
        tol = dict(rtol=0, atol=1e-3) if key.endswith("_corr") else dict(rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(port["summary"][key], value, err_msg=key, **tol)
    assert set(port["splits"]) == set(ref["splits"])
    for split, values in ref["splits"].items():
        for key, value in values.items():
            np.testing.assert_allclose(port["splits"][split][key], value, rtol=1e-4,
                                       atol=1e-6, err_msg=f"{split} {key}")
    assert port["per_joint"]["joint_names"] == ref["per_joint"]["joint_names"]
    np.testing.assert_allclose(port["per_joint"]["sigma_mean"], ref["per_joint"]["sigma_mean"],
                               atol=2e-5)
