"""PyTorch port: two processes over gloo against one process, and against
the JAX package on a two-device mesh.

The property that tests/test_multiprocess.py holds the JAX package to: a
run on two processes, each holding half of every global batch, gives the
result of one process on the same global batch. The ranks run
`tests/torch_mp_worker.py` (which imports only the port; rendezvous
through a `file://` under the test's temporary directory, so no port is
taken); the one-process references run the worker's same functions here.
Tolerances, stated at each test: the batch-norm case at the fp32 floor
(each side within 1e-6 of the float64 computation, relative to the
array's largest value); the train step at the fp32 noise of a gradient
summed in another order (about 1e-4 of a leaf's largest on this data, as
between one and four threads of one process); the fit as
tests/test_multiprocess.py (losses and validation rtol 2e-4, parameter
checksum 1e-5, per-sample metrics 1e-4 m).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from poco_tpu.config import model_config_from_hparams as jax_model_config
from poco_tpu.config import update_hparams as jax_update_hparams
from poco_tpu.data.dataset import PocoDataset as JaxPocoDataset
from poco_tpu.eval.runner import run_eval as jax_run_eval
from poco_tpu.models.poco import POCO as JaxPOCO
from poco_tpu.parallel.mesh import make_mesh
from poco_tpu.smpl.assets import resolve_smpl_params as jax_resolve_smpl

from poco_tpu_torch.cli import eval as eval_cli
from poco_tpu_torch.config import model_config_from_hparams, update_hparams
from poco_tpu_torch.eval.runner import EvalResult, pw3d_split_report
from poco_tpu_torch.models.poco import POCO

from . import torch_mp_worker as worker
from .test_torch_model import jax_variables

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "data"
TINY = REPO / "configs" / "tiny_smoke.yaml"
TIMEOUT = 600


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module (see
    tests/test_torch_eval.py). Restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _env() -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for key in ("POCO_COORDINATOR", "POCO_NUM_PROCESSES", "POCO_PROCESS_ID", "RANK",
                "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    return env


def _run_ranks(cmds: list[list[str]], envs: list[dict]) -> list[str]:
    """Start the ranks together, wait for all; any failure fails the test
    with its output."""
    procs = [subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for cmd, env in zip(cmds, envs)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT)
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"rank failed (rc={p.returncode}):\n{out[-4000:]}"
    return outs


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The worker's cases on two ranks: each rank's npz, by case."""
    out = tmp_path_factory.mktemp("pair")
    _run_ranks(
        [[sys.executable, "tests/torch_mp_worker.py", "--world", "2", "--rank", str(r),
          "--init", str(out / "init"), "--outdir", str(out), "--data_dir", str(DATA)]
         for r in range(2)],
        [_env()] * 2,
    )
    return {case: [dict(np.load(out / f"{case}_rank{r}.npz")) for r in range(2)]
            for case in ("bn", "step", "fit")} | {"weights": out / "fit.pt"}


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    """The same cases in this process, on every row."""
    out = tmp_path_factory.mktemp("single")
    fit, _ = worker.fit_case(str(out / "fit"), str(DATA))
    return {
        "bn": worker.bn_case(slice(0, 4)),
        "bn64": worker.bn_case(slice(0, 4), torch.float64),
        "step": worker.step_case(slice(0, worker.GLOBAL_BATCH), str(out / "step"), str(DATA)),
        "fit": fit,
    }


def _rel(got, ref) -> float:
    """Largest difference over the reference's largest magnitude."""
    return float(np.abs(np.asarray(got, np.float64) - ref).max() / np.abs(ref).max())


def test_cross_rank_batch_norm_matches_one_process(pair, single):
    """2 ranks x batch 2 against 1 x batch 4, in training inside
    `flax_variance_update`: outputs, the input's gradient, the parameters'
    gradients (summed over ranks), running mean and flax-style running
    variance within 1e-6 of the one-process run and of its float64
    twin, relative to each array's largest value."""
    ranks, ref, ref64 = pair["bn"], single["bn"], single["bn64"]
    for key in ref:
        got = (np.concatenate([r[key] for r in ranks]) if key in ("out", "x_grad")
               else ranks[0][key])
        for other in ranks[1:]:  # every rank holds the same statistics and gradients
            if key not in ("out", "x_grad"):
                np.testing.assert_array_equal(other[key], ranks[0][key], err_msg=key)
        assert _rel(got, ref[key]) <= 1e-6, key
        assert _rel(got, ref64[key]) <= 1e-6, key
        assert _rel(ref[key], ref64[key]) <= 1e-6, key
    assert ranks[0]["buffer/1.num_batches_tracked"] == 1


def test_train_step_with_uneven_masks_matches_one_process(pair, single):
    """One train step, global batch 8, dropout live: has_smpl, has_pose_3d
    and the conditioned rows fall unevenly (the conditioned rows all in
    rank 0's half). The global loss terms within rtol 1e-5; every gradient
    within 5e-4 of its leaf's largest; the weights after Adam within 1e-7,
    except where the gradient is under 1e-3 of its leaf's largest (Adam's
    first step moves such an element by the learning rate in the sign that
    fp32 noise gives it); BN's running statistics within 1e-4 relative."""
    ranks, ref = pair["step"], single["step"]
    assert ranks[0]["cond_mask"].sum() == 3 and ranks[1]["cond_mask"].sum() == 0
    check_step_matches(ranks, ranks, ref)


def check_step_matches(ranks: list[dict], shards: list[dict], ref: dict) -> None:
    """`ranks`' train step (every rank's npz; `shards` one rank of each
    data index, in order) against one process's `ref`, at the bars of
    test_train_step_with_uneven_masks_matches_one_process; every rank
    holds the same metrics, gradients and weights."""
    np.testing.assert_array_equal(np.concatenate([r["cond_mask"] for r in shards]),
                                  ref["cond_mask"])
    for key, value in ref.items():
        if key == "cond_mask":
            continue
        for other in ranks[1:]:
            np.testing.assert_array_equal(other[key], ranks[0][key], err_msg=key)
        got = ranks[0][key]
        if key.startswith("metric/"):
            np.testing.assert_allclose(got, value, rtol=1e-5, err_msg=key)
        elif key.startswith("grad/"):
            assert _rel(got, value) <= 5e-4, key
        elif "running" in key:
            np.testing.assert_allclose(got, value, rtol=1e-4, atol=1e-7, err_msg=key)
        elif "grad/" + key[len("state/"):] in ref:
            grad = np.abs(ref["grad/" + key[len("state/"):]])
            firm = grad >= 1e-3 * grad.max()
            np.testing.assert_allclose(got[firm], value[firm], atol=1e-7, rtol=0, err_msg=key)
        else:
            np.testing.assert_array_equal(got, value, err_msg=key)


def test_trainer_fit_matches_one_process(pair, single):
    """Trainer.fit of tiny_smoke (batch 8, one epoch, no augmentation,
    GT_POSE_COND 0.5 on the smoke set) on 2 ranks: per-step losses, the
    train-time uncertainty statistics (over the gathered `var_pose` rows)
    and validation MPJPE / PA-MPJPE / V2V within rtol 2e-4, the parameter
    checksum within 1e-5, and run_eval's per-sample metrics of the fitted
    weights within 1e-4 m, as tests/test_multiprocess.py holds JAX (sigma
    within 2e-3, the per-joint rotation distance within 1e-3 relative: the
    two fits' weights differ by fp32 noise)."""
    ranks, ref = pair["fit"], single["fit"]
    assert len(ranks[0]["losses"]) == len(ref["losses"]) == 2
    assert "losses" not in ranks[1]  # rank 0 alone writes the logs
    np.testing.assert_allclose(ranks[0]["losses"], ref["losses"], rtol=2e-4)
    # the per-joint sigma statistics of every step's global rows
    np.testing.assert_allclose(ranks[0]["uncert_stats"], ref["uncert_stats"], rtol=2e-4)
    for r in ranks:
        for key in ("val/mpjpe", "val/pa_mpjpe", "val/v2v"):
            np.testing.assert_allclose(r[key], ref[key], rtol=2e-4, err_msg=key)
        np.testing.assert_allclose(r["param_sum"], ref["param_sum"], rtol=1e-5)
        np.testing.assert_array_equal(r["eval/imgnames"], ref["eval/imgnames"])
        for key in ("eval/mpjpe_mm", "eval/pa_mpjpe_mm", "eval/v2v_mm"):
            np.testing.assert_allclose(r[key], ref[key], atol=0.1, rtol=0, err_msg=key)
        np.testing.assert_allclose(r["eval/uncert"], ref["eval/uncert"], atol=2e-3, rtol=0)
        np.testing.assert_allclose(r["eval/pose_dist"], ref["eval/pose_dist"], rtol=1e-3,
                                   atol=1e-6)


def _eval_cmd(out: Path) -> list[str]:
    return ["--cfg", str(TINY), "--dataset", "smoke", "--data_dir", str(DATA),
            "--batch_size", "8", "--device", "cpu", "--out", str(out)]


def test_eval_cli_dist_matches_one_process(tmp_path, capsys):
    """`python -m poco_tpu_torch.cli.eval --dist` on 2 ranks (POCO_* with a
    file:// coordinator) gives the one-process report: summary and split
    rows within rtol 2e-4 (tests/test_multiprocess.py:196-216); exactly
    one rank prints the report, and each rank says its place."""
    single = eval_cli.main(_eval_cmd(tmp_path / "single.json"))
    capsys.readouterr()
    envs = [dict(_env(), POCO_COORDINATOR=f"file://{tmp_path / 'init'}",
                 POCO_NUM_PROCESSES="2", POCO_PROCESS_ID=str(r)) for r in range(2)]
    cmd = [sys.executable, "-m", "poco_tpu_torch.cli.eval", "--dist",
           *_eval_cmd(tmp_path / "pair.json")]
    outs = _run_ranks([cmd] * 2, envs)
    assert sum('"summary"' in o for o in outs) == 1, "the report prints on rank 0 only"
    for r, out in enumerate(outs):
        assert f"world: rank {r} of 2 (backend gloo)" in out
    with open(tmp_path / "pair.json") as f:
        pair = json.load(f)
    for key in ("mpjpe", "pa_mpjpe", "v2v"):
        np.testing.assert_allclose(pair["summary"][key], single["summary"][key], rtol=2e-4,
                                   err_msg=key)
    assert pair["splits"].keys() == single["splits"].keys()
    for split, row in single["splits"].items():
        for key, value in row.items():
            np.testing.assert_allclose(pair["splits"][split][key], value, rtol=2e-4,
                                       err_msg=f"{split}/{key}")


def test_two_rank_run_eval_matches_jax_on_a_two_device_mesh(pair, monkeypatch):
    """The port's 2-rank `run_eval` (the fitted tiny_smoke weights, the
    smoke test set, batch 8) against JAX's `run_eval` on a 2-device mesh
    with the same weights through the bridge, over the same crops (the JAX
    package's native decode and warp): names equal; per-sample metrics
    within 0.1 mm, sigma 2e-3, pose_dist 1e-5, the split report rtol 1e-4
    (tests/test_torch_eval.py's bars)."""
    monkeypatch.setenv("POCO_TPU_NATIVE_LOADER", "1")
    hparams = update_hparams(str(TINY))
    model = POCO(model_config_from_hparams(hparams))
    model.load_state_dict(torch.load(pair["weights"]))
    jax_hparams = jax_update_hparams(str(TINY))
    ref = jax_run_eval(
        JaxPOCO(cfg=jax_model_config(jax_hparams)), jax_variables(model),
        JaxPocoDataset(str(DATA / "dataset_extras" / "smoke_test.npz"), img_dir=str(DATA),
                       dataset_name="smoke", is_train=False,
                       options={"IMG_RES": jax_hparams.DATASET.IMG_RES}),
        jax_resolve_smpl(None, "neutral"), batch_size=worker.GLOBAL_BATCH,
        mesh=make_mesh(n_devices=2), loss_ver=jax_hparams.POCO.LOSS_VER,
    )
    got = pair["fit"][0]
    assert list(got["eval/imgnames"]) == ref.imgnames and len(ref.imgnames) == 16
    for key in ("mpjpe_mm", "pa_mpjpe_mm", "v2v_mm"):
        np.testing.assert_allclose(got[f"eval/{key}"], getattr(ref, key), atol=0.1, rtol=0,
                                   err_msg=key)
    np.testing.assert_allclose(got["eval/uncert"], ref.uncert, atol=2e-3, rtol=0)
    np.testing.assert_allclose(got["eval/pose_dist"], ref.pose_dist, atol=1e-5, rtol=0)
    port = EvalResult(imgnames=list(got["eval/imgnames"]), mpjpe_mm=got["eval/mpjpe_mm"],
                      pa_mpjpe_mm=got["eval/pa_mpjpe_mm"], v2v_mm=got["eval/v2v_mm"],
                      uncert=got["eval/uncert"], pose_dist=got["eval/pose_dist"])
    rep = pw3d_split_report(port.imgnames, port.mpjpe_mm, port.pa_mpjpe_mm, port.v2v_mm)
    rep_ref = pw3d_split_report(ref.imgnames, ref.mpjpe_mm, ref.pa_mpjpe_mm, ref.v2v_mm)
    assert rep.keys() == rep_ref.keys()
    for split in rep_ref:
        for key in rep_ref[split]:
            np.testing.assert_allclose(rep[split][key], rep_ref[split][key], rtol=1e-4,
                                       atol=1e-6, err_msg=f"{split} {key}")
