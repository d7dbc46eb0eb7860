"""PyTorch port vs JAX package: the matmul crop and the package's
operational modules (`ops/preprocess.crop_and_resize_mxu`,
`utils/os_utils.py`, `utils/comp_cache.py` with `device.resolve_device`,
`cli/compute_error.py`).

  * `crop_and_resize_mxu` within 1e-4 of JAX's (grey levels 0-255), and
    within 1e-2 of the port's gather, JAX's own bar between its two crops
    (tests/test_preprocess.py:154-168), crops off the image's edges
    included;
  * `copy_code` snapshots the package (no `_build/`, no caches) and
    `chip_smoke.py`; `cli.train` writes it under `<logdir>/code`;
  * POCO_TPU_PLATFORM picks the entry points' default device and never
    turns a card that is asked for and absent into the CPU;
  * `cli.compute_error` prints the report of the repo's
    `tools/compute_error.py` on the same pkl.
"""

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poco_tpu.ops.preprocess import crop_and_resize_mxu as jax_crop_mxu

from poco_tpu_torch import device as port_device
from poco_tpu_torch.cli import compute_error as cli_compute_error
from poco_tpu_torch.cli import demo as cli_demo
from poco_tpu_torch.ops.preprocess import crop_and_resize, crop_and_resize_mxu
from poco_tpu_torch.utils import comp_cache
from poco_tpu_torch.utils.os_utils import copy_code

REPO = Path(__file__).resolve().parent.parent


def _crop_inputs(seed: int):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 255, (96, 128, 3)).astype(np.float32)
    centers = np.float32([[64.0, 48.0], [30.0, 20.0], [-8.0, 90.0], [120.5, 3.25]])
    sizes = np.float32([60.0, 40.0, 75.0, 33.3])
    return img, centers, sizes


@pytest.mark.parametrize("seed", [5, 6])
def test_mxu_crop_matches_jax_and_the_gather(seed):
    img, centers, sizes = _crop_inputs(seed)
    got = crop_and_resize_mxu(torch.from_numpy(img), torch.from_numpy(centers),
                              torch.from_numpy(sizes), out_res=32).numpy()
    ref = np.asarray(jax_crop_mxu(jnp.asarray(img), jnp.asarray(centers), jnp.asarray(sizes),
                                  out_res=32))
    assert got.shape == (4, 32, 32, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    gather = crop_and_resize(torch.from_numpy(img), torch.from_numpy(centers),
                             torch.from_numpy(sizes), out_res=32).numpy()
    np.testing.assert_allclose(got, gather, atol=1e-2, rtol=0)
    assert (got[2] == 0).any()      # the crop off the image's edge is zero-padded


def test_mxu_crop_takes_uint8_images():
    img, centers, sizes = _crop_inputs(7)
    as_uint8 = crop_and_resize_mxu(torch.from_numpy(img.astype(np.uint8)),
                                   torch.from_numpy(centers), torch.from_numpy(sizes), 16)
    as_float = crop_and_resize_mxu(torch.from_numpy(img), torch.from_numpy(centers),
                                   torch.from_numpy(sizes), 16)
    np.testing.assert_array_equal(as_uint8.numpy(), as_float.numpy())


def test_copy_code_snapshots_the_package(tmp_path):
    dst = Path(copy_code(str(tmp_path)))
    assert dst == tmp_path / "code"
    assert (dst / "chip_smoke.py").read_bytes() == (REPO / "chip_smoke.py").read_bytes()
    src = REPO / "poco_tpu_torch" / "utils" / "os_utils.py"
    assert (dst / "poco_tpu_torch" / "utils" / "os_utils.py").read_bytes() == src.read_bytes()
    assert (dst / "poco_tpu_torch" / "csrc" / "skinning.cu").exists()
    names = {p.name for p in dst.rglob("*")}
    assert "_build" not in names and "__pycache__" not in names
    assert not (dst / "poco_tpu").exists()


def test_train_cli_copies_the_code(tmp_path):
    """`cli.train` on tiny_smoke for one epoch writes `<logdir>/code`."""
    logdir = tmp_path / "run"
    proc = subprocess.run(
        [sys.executable, "-m", "poco_tpu_torch.cli.train", "--cfg", "configs/tiny_smoke.yaml",
         "--logdir", str(logdir), "--max_epochs", "1", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert (logdir / "code" / "poco_tpu_torch" / "cli" / "train.py").exists()
    assert (logdir / "code" / "chip_smoke.py").exists()


@pytest.mark.parametrize("value,device", [("cpu", "cpu"), ("CPU", "cpu"), ("", None),
                                          ("gpu", "cuda"), ("cuda", "cuda")])
def test_platform_variable_names_the_default_device(monkeypatch, value, device):
    monkeypatch.setenv(comp_cache.ENV, value)
    assert comp_cache.platform_from_env() == device
    assert port_device.default_device() == (device or "cuda")


def test_platform_variable_reaches_the_entry_points(monkeypatch):
    """With POCO_TPU_PLATFORM=cpu a CLI's --device defaults to the CPU and
    `resolve_device(None)` is the CPU; a named device wins."""
    monkeypatch.setenv(comp_cache.ENV, "cpu")
    assert cli_demo.parse_args([]).device == "cpu"
    assert cli_demo.parse_args(["--device", "cuda"]).device == "cuda"
    assert port_device.resolve_device(None) == torch.device("cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks a host without a card")
def test_platform_variable_never_hides_a_missing_card(monkeypatch):
    """Asking for the card without one raises, whatever the variable says:
    POCO_TPU_PLATFORM=cuda raises, and =cpu does not turn an explicit
    cuda into a CPU run."""
    monkeypatch.setenv(comp_cache.ENV, "cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_device.resolve_device(None)
    monkeypatch.setenv(comp_cache.ENV, "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_device.resolve_device("cuda")


def test_platform_variable_refuses_other_values(monkeypatch):
    monkeypatch.setenv(comp_cache.ENV, "tpu")
    with pytest.raises(ValueError, match="POCO_TPU_PLATFORM"):
        port_device.resolve_device(None)


def _eval_pkl(path: Path) -> dict:
    rng = np.random.RandomState(4)
    names = ([f"imageFiles/downtown_walking_00/image_{i:05d}.jpg" for i in range(5)]
             + [f"imageFiles/courtyard_basketball_00/image_{i:05d}.jpg" for i in range(4)]
             + [f"imageFiles/outdoors_fencing_01/image_{i:05d}.jpg" for i in range(3)])
    payload = {"imgname": names, "mpjpe": rng.rand(12) * 100, "pampjpe": rng.rand(12) * 60,
               "v2v": rng.rand(12) * 120, "uncert": rng.rand(12), "epoch": 3}
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    return payload


def test_compute_error_cli_matches_the_repo_tool(tmp_path, capsys):
    """`cli.compute_error` on a trainer-style pkl: the report equals the
    repo's `tools/compute_error.py` (JAX package) on the same file, printed
    and written to --out."""
    _eval_pkl(tmp_path / "evaluation_results_3dpw.pkl")
    report = cli_compute_error.main(["--result_file",
                                     str(tmp_path / "evaluation_results_3dpw.pkl"),
                                     "--out", str(tmp_path / "port.json")])
    printed = json.loads(capsys.readouterr().out)
    proc = subprocess.run(
        [sys.executable, "tools/compute_error.py", "--result_file",
         str(tmp_path / "evaluation_results_3dpw.pkl"), "--out", str(tmp_path / "jax.json")],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = json.loads((tmp_path / "jax.json").read_text())
    assert report == printed == json.loads((tmp_path / "port.json").read_text()) == ref
    assert len(ref) >= 2
