"""PyTorch port vs JAX package: the training-science and gate tools
(`poco_tpu_torch/cli/{convergence_bench, make_smoke_data,
calibration_decay, camera_bringup, detector_quality, convert_checkpoint,
golden_gate, profile_model}.py` against the repo's `tools/*.py`, loaded as
tests/test_tools.py loads them).

  * `runtime.raster.circles_filled` equals `cv2.circle(..., -1)` (LINE_8)
    pixel for pixel, radii 6 and 60, centres inside, on and past the edges;
  * the synthetic sets (`conv`, `convhet`, `smoke`) from the same seeds:
    every npz key equal (floats within 1e-5 relative; the joints come from
    each package's fp32 SMPL forward), the RGB arrays that reach the
    JPEG encoder equal, the decoded JPEGs within 1 grey level on average
    and at least 40 dB PSNR apart (both decoded by cv2);
  * the pure parts: IoU, GT boxes and recall, the convergence bench's
    resume decision (driven through both tools' `main` up to their first
    CLI call) and the calibration-decay verdict, on the same inputs;
  * two camera bring-up steps on tiny-cliff (dropout all-keep on both
    sides) against the JAX tool's masked, clipped optax SGD: `deccam`
    within 1e-5 relative (L2), every other parameter and BN statistic
    unchanged;
  * the golden gate on a tiny reference-format checkpoint: the port's
    MPJPE within 0.01 mm of JAX's `golden_gate.eval_jax` on the same
    weights, SMPL files and smoke set; a reference 1 mm off exits 1; a
    checkpoint missing a tensor is refused, and so is one with a tensor
    the model lacks; `convert_checkpoint`'s coverage line and its output
    loading in `cli.eval`;
  * a one-epoch `cli.convergence_bench --device cpu` on a tiny recipe,
    then `cli.calibration_decay`, `cli.camera_bringup` and
    `cli.detector_quality` on its run, and `cli.profile_model --device
    cpu` at batch 2 for one step (the backbone patched to the tiny one),
    each writing what it should.
"""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import cv2
import jax
import numpy as np
import optax
import pytest
import torch
import yaml

import poco_tpu_torch.models.poco as port_poco
from poco_tpu_torch.cli import calibration_decay as port_cd
from poco_tpu_torch.cli import camera_bringup as port_cam
from poco_tpu_torch.cli import convergence_bench as port_cb
from poco_tpu_torch.cli import convert_checkpoint as port_convert
from poco_tpu_torch.cli import detector_quality as port_dq
from poco_tpu_torch.cli import golden_gate as port_gate
from poco_tpu_torch.cli import make_smoke_data as port_smoke
from poco_tpu_torch.cli import profile_model as port_profile
from poco_tpu_torch.config import loss_config_from_hparams, update_hparams
from poco_tpu_torch.models.backbones.tiny import tiny_cls
from poco_tpu_torch.runtime.raster import circles_filled
from poco_tpu_torch.train.step import TRAIN_STAGES, make_train_step
from poco_tpu_torch.utils.weights import state_dict_from_jax

from .test_torch_model import jax_variables
from .test_torch_train import _all_keep, _j, _t, _tiny_models, _train_batch

REPO = Path(__file__).resolve().parents[1]
TINY_YAML = REPO / "configs" / "tiny_smoke.yaml"
FT2D_YAML = REPO / "configs" / "convergence_ft2d.yaml"
NPZ_FLOAT_TOL = 1e-5    # relative, and absolute near 0 (`part` holds pixels of ~100)
JPEG_MEAN_LEVELS, JPEG_PSNR_DB = 1.0, 40.0
CAMERA_RTOL = 1e-5      # deccam after the steps, relative L2
GATE_MM = 0.01          # the port's golden-gate MPJPE against JAX's


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module (see
    tests/test_torch_eval.py). Restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --------------------------------------------------------------------------
# the filled circle and the synthetic sets
# --------------------------------------------------------------------------

@pytest.mark.parametrize("radius", [6, 60])
def test_filled_circle_equals_cv2(radius):
    rng = np.random.RandomState(radius)
    h, w = 96, 128
    centres = [(64, 48), (0, 0), (w - 1, h - 1), (-3, 40), (w + 2, 10), (50, -radius),
               (70, h + radius - 1), (-radius - 1, 20), (w + radius, h + radius), (5, h - 2)]
    for cx, cy in centres:
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        ref, got = img.copy(), img.copy()
        cv2.circle(ref, (cx, cy), radius, (200, 180, 160), -1)
        circles_filled(got, np.array([[cx, cy]]), radius, (200, 180, 160))
        np.testing.assert_array_equal(got, ref, err_msg=f"centre {(cx, cy)}")


def _capture_disk_rgb(monkeypatch, port_module):
    """The RGB arrays each tool hands its JPEG encoder, as they reach the
    file: cv2.imwrite reads its array as BGR."""
    seen = {"jax": [], "port": []}
    imwrite, write = cv2.imwrite, port_module.write_image

    def jax_write(path, img, *args):
        seen["jax"].append(np.ascontiguousarray(img[:, :, ::-1]))
        return imwrite(path, img, *args)

    def port_write(path, img):
        seen["port"].append(np.array(img))
        return write(path, img)

    monkeypatch.setattr(cv2, "imwrite", jax_write)
    monkeypatch.setattr(port_module, "write_image", port_write)
    return seen


def _same_sets(jax_npz, port_npz, seen, jax_dir, port_dir):
    ref, got = np.load(jax_npz), np.load(port_npz)
    assert ref.files == got.files
    for key in ref.files:
        if ref[key].dtype.kind == "f":
            np.testing.assert_allclose(got[key], ref[key], atol=NPZ_FLOAT_TOL, rtol=NPZ_FLOAT_TOL,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    assert len(seen["jax"]) == len(seen["port"]) == len(ref["imgname"])
    for a, b in zip(seen["jax"], seen["port"]):
        np.testing.assert_array_equal(b, a)
    for name in ref["imgname"]:
        a = cv2.imread(str(jax_dir / name)).astype(np.float64)
        b = cv2.imread(str(port_dir / name)).astype(np.float64)
        mse = float(((a - b) ** 2).mean())
        assert np.abs(a - b).mean() <= JPEG_MEAN_LEVELS, name
        assert mse == 0 or 10 * np.log10(255.0**2 / mse) >= JPEG_PSNR_DB, name


@pytest.mark.parametrize("hetero", [False, True], ids=["conv", "convhet"])
def test_convergence_sets_match_jax(monkeypatch, tmp_path, hetero):
    seen = _capture_disk_rgb(monkeypatch, port_cb)
    ref = _load("convergence_bench").make_split(str(tmp_path / "jax"), "test", 6, seed=3,
                                                hetero=hetero)
    got = port_cb.make_split(str(tmp_path / "port"), "test", 6, seed=3, hetero=hetero)
    assert os.path.basename(got) == os.path.basename(ref)
    _same_sets(ref, got, seen, tmp_path / "jax", tmp_path / "port")


def test_smoke_set_matches_jax(monkeypatch, tmp_path):
    seen = _capture_disk_rgb(monkeypatch, port_smoke)
    ref = _load("make_smoke_data").make_split(str(tmp_path / "jax"), "train", 4, seed=0)
    got = port_smoke.make_split(str(tmp_path / "port"), "train", 4, seed=0)
    _same_sets(ref, got, seen, tmp_path / "jax", tmp_path / "port")


# --------------------------------------------------------------------------
# the pure parts
# --------------------------------------------------------------------------

def test_detector_quality_helpers_match_jax(tmp_path):
    dq = _load("detector_quality")
    rng = np.random.RandomState(0)
    for _ in range(200):
        a = np.concatenate([rng.uniform(0, 100, 2), rng.uniform(0, 60, 2)]).astype(np.float32)
        b = np.concatenate([rng.uniform(0, 100, 2), rng.uniform(0, 60, 2)]).astype(np.float32)
        assert port_dq.iou_cxcywh(a, b) == dq.iou_cxcywh(a, b)

    part = rng.uniform(0, 200, (5, 24, 3)).astype(np.float32)
    part[..., 2] = rng.rand(5, 24) > 0.4
    part[1, :, 2] = 0          # no visible joint: no box
    part[2, 1:, 2] = 0         # one visible joint: no box
    part[part[..., 2] == 0] = 0
    names = np.array([f"f{i}.jpg" for i in range(5)])
    np.savez(tmp_path / "part.npz", imgname=names, part=part)
    np.savez(tmp_path / "bbox.npz", imgname=names, bbox=rng.uniform(10, 90, (5, 4)))
    for npz in ("part.npz", "bbox.npz"):
        got_names, got = port_dq.gt_boxes_from_npz(str(tmp_path / npz))
        ref_names, ref = dq.gt_boxes_from_npz(str(tmp_path / npz))
        assert got_names == ref_names
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)

    _, gts = dq.gt_boxes_from_npz(str(tmp_path / "part.npz"))
    dets = [np.asarray([[100, 100, 150, 150], [20, 20, 10, 10]], np.float32),
            np.zeros((0, 4), np.float32), gts[2], gts[3] + 5, gts[4] * 0.8]

    class Batched:
        def detect_batch(self, frames):
            return dets

    for detector in (lambda f: dets[f], Batched()):
        for thresh in (0.3, 0.5):
            assert (port_dq.evaluate(detector, list(range(5)), gts, thresh)
                    == dq.evaluate(detector, list(range(5)), gts, thresh))


class _FirstCall(Exception):
    pass


def _first_cli_call(monkeypatch, run_main):
    """What a tool's `main` does before its first subprocess: ("train",
    resumed logdir or None), ("eval",) or ("exit", message)."""
    def fake_run(cmd, *args, **kwargs):
        raise _FirstCall(cmd)

    monkeypatch.setattr(subprocess, "run", fake_run)
    try:
        run_main()
    except _FirstCall as call:
        cmd = [str(c) for c in call.args[0]]
        if any("eval" in c for c in cmd[1:3]):
            return ("eval",)
        return ("train", cmd[cmd.index("--resume") + 1] if "--resume" in cmd else None)
    except SystemExit as e:
        # the two tools name the same fault with their own CLIs' names
        return ("exit", str(e.code).split(":")[0].split(" was written")[0].split(" is ")[0])
    raise AssertionError("the tool made no CLI call")


def _run_dir(work, name, next_epoch=None, metrics_age=None, torn=False, age=0):
    d = work / "logs" / "experiments" / "poco" / "convergence" / name
    d.mkdir(parents=True)
    if torn:
        (d / "last.trainer.json").write_text("{")
    elif next_epoch is not None:
        (d / "last.trainer.json").write_text(json.dumps({"next_epoch": next_epoch}))
    now = __import__("time").time()
    if metrics_age is not None:
        (d / "metrics.jsonl").write_text("{}\n")
        os.utime(d / "metrics.jsonl", (now - metrics_age,) * 2)
    os.utime(d, (now - age,) * 2)
    return d


@pytest.mark.parametrize("case", [
    "none", "resume", "live", "torn", "torn_skip", "finished_live", "fresh", "no_sidecar",
    "newest_by_mtime", "skip_train",
])
def test_convergence_resume_decision_matches_jax(monkeypatch, tmp_path, case):
    work = tmp_path / "work"
    (tmp_path / "data" / "dataset_extras").mkdir(parents=True)
    (tmp_path / "data" / "dataset_extras" / "conv_train.npz").write_bytes(b"")
    flags = ["--epochs", "5"]
    if case == "resume":
        _run_dir(work, "convergence_ID00_a", next_epoch=3, metrics_age=600)
    elif case == "live":
        _run_dir(work, "convergence_ID00_a", next_epoch=3, metrics_age=10)
    elif case in ("torn", "torn_skip"):
        _run_dir(work, "convergence_ID00_a", torn=True)
        flags += ["--skip_train"] if case == "torn_skip" else []
    elif case == "finished_live":
        _run_dir(work, "convergence_ID00_a", next_epoch=5, metrics_age=10)
    elif case == "fresh":
        _run_dir(work, "convergence_ID00_a", next_epoch=3, metrics_age=600)
        flags += ["--fresh"]
    elif case == "no_sidecar":
        _run_dir(work, "convergence_ID00_a", metrics_age=600)
    elif case == "newest_by_mtime":
        _run_dir(work, "convergence_ID00_b", next_epoch=1, metrics_age=600, age=900)
        _run_dir(work, "convergence_ID00_a", next_epoch=2, metrics_age=600, age=100)
    elif case == "skip_train":
        _run_dir(work, "convergence_ID00_a", next_epoch=2, metrics_age=10)
        flags += ["--skip_train"]
    if case != "none":
        # a run of another recipe is never a candidate
        _run_dir(work / "other", "convergence_pare_ID00_x", next_epoch=1, metrics_age=600)
    jax_tool = _load("convergence_bench")
    jax_tool.REPO = str(work)
    argv = ["--root", str(tmp_path / "data"), *flags]
    monkeypatch.setattr(sys, "argv", ["convergence_bench.py", *argv])
    ref = _first_cli_call(monkeypatch, jax_tool.main)
    got = _first_cli_call(monkeypatch, lambda: port_cb.main(
        argv + ["--device", "cpu", "--work_dir", str(work)]))
    assert got == ref


def _decay_report(mpjpe, corr, cov=None):
    rep = {"summary": {"mpjpe": mpjpe, "uncert_pose_corr": corr}}
    if cov is not None:
        rep["per_joint"] = {"pose_dist_cov": cov, "sigma_cov": 0.1}
    return rep


@pytest.mark.parametrize("reports", [
    [_decay_report(60.0, 0.7, 0.5), _decay_report(50.0, 0.3, 0.2)],      # confirmed
    [_decay_report(60.0, 0.7, 0.5), _decay_report(50.0, 0.3, 0.6)],      # the spread grows
    [_decay_report(60.0, 0.3, 0.5), _decay_report(70.0, 0.2, 0.2)],      # MPJPE worse
    [_decay_report(60.0, 0.7, 0.5), _decay_report(55.0, 0.5, 0.4), _decay_report(50.0, 0.2, 0.1)],
    [_decay_report(60.0, 0.7), _decay_report(50.0, 0.3)],                # no per-joint stats
    [_decay_report(60.123456, 0.712345, 0.5)],                           # one row
], ids=["confirmed", "spread_grows", "mpjpe_worse", "three", "no_per_joint", "one_row"])
def test_calibration_decay_verdict_matches_jax(monkeypatch, tmp_path, capsys, reports):
    names = [f"epoch_{10 * i + 9:03d}" for i in range(len(reports))]
    by_name = dict(zip(names, reports))
    logdir = tmp_path / "run"
    logdir.mkdir()
    (logdir / "config_to_run.yaml").write_text("METHOD: poco\n")

    def fake_run(cmd, *args, **kwargs):
        ckpt = Path(cmd[cmd.index("--ckpt") + 1]).name.removesuffix(".pt")
        out = cmd[cmd.index("--out") + 1]
        if out.startswith(str(tmp_path)):   # the port's report; JAX's is read via `open`
            Path(out).write_text(json.dumps(by_name[ckpt]))
        return types.SimpleNamespace(returncode=0)

    jax_tool = _load("calibration_decay")
    real_open = open

    def jax_open(path, *args, **kwargs):
        name = os.path.basename(str(path)).removeprefix("calib_decay_").removesuffix(".json")
        if name in by_name:
            import io
            return io.StringIO(json.dumps(by_name[name]))
        return real_open(path, *args, **kwargs)

    jax_tool.open = jax_open
    monkeypatch.setattr(subprocess, "run", fake_run)
    monkeypatch.setattr(sys, "argv", ["calibration_decay.py", "--logdir", str(logdir),
                                      "--ckpts", ",".join(names)])
    jax_tool.main()
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = port_cd.main(["--logdir", str(logdir), "--ckpts", ",".join(names), "--device", "cpu"])
    assert got == ref
    assert port_cd.homogenization_verdict(got["rows"]) == ref["homogenization_confirmed"]


# --------------------------------------------------------------------------
# the camera bring-up step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kp_weight", [2.5, 25.0], ids=["unclipped", "clipped"])
def test_camera_step_matches_jax(monkeypatch, kp_weight):
    """Two steps of the camera decoder alone on tiny-cliff (the second one
    through SGD's momentum), dropout all-keep on both sides, with the JAX
    tool's loss (configs/convergence_ft2d.yaml's, the 3D, pose, beta,
    shape and flow weights at 0) and its optax chain in multi_transform;
    at the config's 2D weight the camera gradient stays under the global
    bound, at ten times it the global clip scales every step."""
    from poco_tpu.config import loss_config_from_hparams as jax_loss_config
    from poco_tpu.config import update_hparams as jax_update_hparams
    from poco_tpu.train.state import create_train_state
    from poco_tpu.train.step import make_train_step as jax_make_train_step

    twin = _tiny_models(monkeypatch)
    _all_keep(monkeypatch)
    model = twin["model"]
    lr = 1e-3   # large enough that the steps move deccam well past fp32 noise
    zeros = dict(keypoint3d_loss_weight=0.0, pose_loss_weight=0.0, beta_loss_weight=0.0,
                 shape_loss_weight=0.0, nf_loss_weight=0.0, keypoint2d_loss_weight=kp_weight)
    n_cam = port_cam.camera_only(model)
    assert n_cam == 3 * 1024 + 3
    before = {k: v.clone() for k, v in model.state_dict().items()}
    batches = [_train_batch(7), _train_batch(8)]

    variables = jax.tree.map(np.array, jax_variables(model))
    mask = jax.tree_util.tree_map_with_path(
        lambda path, _: any(getattr(k, "key", str(k)) == "deccam" for k in path),
        variables["params"])
    labels = jax.tree.map(lambda m: "cam" if m else "frozen", mask)
    tx = optax.multi_transform({
        "cam": optax.chain(optax.zero_nans(), optax.clip(1e3), optax.clip_by_global_norm(1.0),
                           optax.sgd(lr, momentum=0.9)),
        "frozen": optax.set_to_zero(),
    }, labels)
    state = create_train_state(twin["jax_model"], variables, tx)
    jax_step = jax_make_train_step(twin["jax_model"], dataclasses.replace(
        jax_loss_config(jax_update_hparams(str(FT2D_YAML))), **zeros), donate=False)
    for i, batch in enumerate(batches):
        state, _ = jax_step(state, _j(batch), twin["jax_smpl"], jax.random.PRNGKey(i))
    norms = []

    loss_cfg = dataclasses.replace(loss_config_from_hparams(update_hparams(str(FT2D_YAML))),
                                   **zeros)
    step = make_train_step(model, port_cam.CameraSGD(model, lr), loss_cfg)
    stats = port_cam.bn_statistics(model)
    for batch in batches:
        norms.append(float(step(_t(batch), twin["smpl"])["grad_norm"]))
        port_cam.restore(model, stats)

    jax_params = state_dict_from_jax({"params": jax.tree.map(np.asarray, state.params)})
    after = model.state_dict()
    moved = 0
    for key, value in after.items():
        if port_cam.is_deccam(key):
            ref = jax_params[key].double()
            err = float((value.double() - ref).norm())
            assert err <= CAMERA_RTOL * float(ref.norm()), (key, err, float(ref.norm()))
            moved += float(ref.norm()) > 0
        else:
            assert torch.equal(value, before[key]), key
    assert moved == 2
    # the global clip taken at every step, or at none
    assert all((n > port_cam.MAX_NORM) == (kp_weight > 2.5) for n in norms), norms


# --------------------------------------------------------------------------
# the golden gate and the checkpoint audit
# --------------------------------------------------------------------------

def _write_smpl_npz(path, seed):
    """A synthetic SMPL in the distribution layout, as tests/test_golden.py
    writes it (V=512; neutral, male and female differ)."""
    from poco_tpu.constants import SMPL_PARENTS
    from poco_tpu.smpl.assets import synthetic_smpl_model as jax_synthetic_smpl

    p = jax_synthetic_smpl(num_verts=512, seed=seed)
    np.savez(path, v_template=np.asarray(p.v_template), shapedirs=np.asarray(p.shapedirs),
             posedirs=np.asarray(p.posedirs), J_regressor=np.asarray(p.j_regressor),
             weights=np.asarray(p.lbs_weights),
             kintree_table=np.stack([np.asarray(SMPL_PARENTS, np.int64),
                                     np.arange(24, dtype=np.int64)]),
             f=np.asarray(p.faces))


@pytest.fixture(scope="module")
def gate_assets(tmp_path_factory):
    """Gendered SMPL files and a reference-format tiny-cliff checkpoint
    (`{"model": state_dict}` in the reference's names)."""
    root = tmp_path_factory.mktemp("gate")
    smpl_dir = root / "smpl"
    smpl_dir.mkdir()
    for gender, seed in (("NEUTRAL", 0), ("MALE", 1), ("FEMALE", 2)):
        _write_smpl_npz(str(smpl_dir / f"SMPL_{gender}.npz"), seed)
    mp = pytest.MonkeyPatch()
    model = _tiny_models(mp)["model"].eval()
    mp.undo()
    ckpt = root / "ref_tiny.pt"
    torch.save({"model": model.state_dict()}, ckpt)
    return {"smpl_dir": smpl_dir, "ckpt": ckpt, "model": model, "root": root}


def _gate_argv(assets, ckpt=None):
    return ["--smpl_dir", str(assets["smpl_dir"]), "--torch_ckpt", str(ckpt or assets["ckpt"]),
            "--data_dir", str(REPO / "data"), "--cfg", str(TINY_YAML), "--dataset", "smoke",
            "--batch_size", "8", "--device", "cpu"]


def test_golden_gate_matches_jax(gate_assets):
    from poco_tpu.config import update_hparams as jax_update_hparams

    gate = _load("golden_gate")
    args = types.SimpleNamespace(data_dir=str(REPO / "data"), dataset="smoke",
                                 smpl_dir=str(gate_assets["smpl_dir"]), batch_size=8)
    ref = gate.eval_jax(args, jax_update_hparams(str(TINY_YAML)),
                        jax_variables(gate_assets["model"]))
    verdict = port_gate.main(_gate_argv(gate_assets) + ["--ref_mpjpe", str(ref)])
    assert abs(verdict["mpjpe_port_mm"] - ref) <= GATE_MM, (verdict, ref)
    assert verdict["pass"] and verdict["mpjpe_port_mm"] > 0.1
    assert set(verdict) == {"gate", "mpjpe_port_mm", "mpjpe_ref_mm", "delta_mm", "budget_mm",
                            "pass"}


def test_golden_gate_negative_controls(gate_assets):
    """A reference 1 mm off exits 1 (the CLI, in a process of its own); a
    checkpoint missing a tensor, or holding one the model lacks, is
    refused before any evaluation."""
    mpjpe = port_gate.main(_gate_argv(gate_assets) + ["--ref_mpjpe", "0"])["mpjpe_port_mm"]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "poco_tpu_torch.cli.golden_gate", *_gate_argv(gate_assets),
         "--ref_mpjpe", str(mpjpe + 1.0)], env=env, capture_output=True, text=True)
    assert proc.returncode == 1, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1])["pass"] is False

    sd = dict(gate_assets["model"].state_dict())
    for label, edit in (("missing", lambda d: d.pop("head.deccam.bias")),
                        ("unmatched", lambda d: d.update({"head.extra.weight": torch.ones(3)}))):
        bad = dict(sd)
        edit(bad)
        path = gate_assets["root"] / f"{label}.pt"
        torch.save({"model": bad}, path)
        with pytest.raises(SystemExit, match=label):
            port_gate.main(_gate_argv(gate_assets, path) + ["--ref_mpjpe", str(mpjpe)])


FAKE_REFERENCE = {
    "pocolib/__init__.py": "",
    "pocolib/models/__init__.py": "",
    "pocolib/models/backbone/__init__.py": "",
    "pocolib/models/head/__init__.py": "",
    # the reference's modules import these packages; the gate stubs them
    "pocolib/models/backbone/hrnet.py": "import yacs.config, loguru\n"
                                        "def hrnet_w32(pretrained=False):\n"
                                        "    raise AssertionError('a CLIFF gate builds no W32')\n",
    "pocolib/models/backbone/hrnet_cls.py": (
        "import torchvision.models.utils\n"
        "from poco_tpu_torch.models.backbones.tiny import tiny_cls\n"
        "def hrnet_w48_cls():\n"
        "    return tiny_cls()\n"),
    "pocolib/models/head/pare_head.py": "SMPL_MEAN_PARAMS = None\n"
                                        "def pare_head(*args):\n"
                                        "    raise AssertionError('a CLIFF gate builds no PARE')\n",
    "pocolib/models/head/cliff_head.py": (
        "import numpy as np, smplx\n"
        "from poco_tpu_torch.models.backbones.tiny import tiny_cls\n"
        "from poco_tpu_torch.models.heads.cliff import CliffHead\n"
        "SMPL_MEAN_PARAMS = None\n"
        "class Head(CliffHead):\n"
        "    def forward(self, features, extra):\n"
        "        return super().forward(features, extra['bbox_info'])\n"
        "def cliff_head(num_features, uncert_layer, activation):\n"
        "    assert np.load(SMPL_MEAN_PARAMS)['pose'].shape == (144,)\n"
        "    return Head(num_input_features=tiny_cls().out_channels)\n"),
}


def test_golden_gate_reference_route(gate_assets, monkeypatch, tmp_path):
    """`--reference_root`: the reference's own modules (here a stand-in
    source tree whose factories build the port's tiny modules, so the two
    sides hold the same weights) scored by the same protocol: the gate
    passes with the two MPJPEs equal within GATE_MM."""
    for rel, text in FAKE_REFERENCE.items():
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_text(text)
    before = set(sys.modules)
    monkeypatch.setattr(sys, "path", list(sys.path))
    try:
        verdict = port_gate.main(_gate_argv(gate_assets) + ["--reference_root", str(tmp_path)])
    finally:
        stubbed = {"pocolib", "yacs", "loguru", "pytorch_lightning", "flatten_dict",
                   "torchvision", "smplx"}
        for name in set(sys.modules) - before:   # the stand-ins and the stubs
            if name.split(".")[0] in stubbed:
                del sys.modules[name]
    assert verdict["pass"] and verdict["delta_mm"] <= GATE_MM, verdict
    assert verdict["mpjpe_ref_mm"] > 0.1


def test_convert_checkpoint_audits_and_eval_loads_it(gate_assets, tmp_path, capsys):
    from poco_tpu_torch.cli import eval as cli_eval

    out = port_convert.main(["--torch_ckpt", str(gate_assets["ckpt"]), "--cfg", str(TINY_YAML),
                             "--out", str(tmp_path / "tiny")])
    n = len(gate_assets["model"].state_dict())
    assert f"loaded {n} tensors, skipped 0" in capsys.readouterr().out
    assert out == str(tmp_path / "tiny.pt")
    payload = cli_eval.main(["--cfg", str(TINY_YAML), "--ckpt", out, "--dataset", "smoke",
                             "--batch_size", "8", "--device", "cpu"])
    assert np.isfinite(payload["summary"]["mpjpe"])


# --------------------------------------------------------------------------
# the tools end to end on the CPU
# --------------------------------------------------------------------------

def test_convergence_chain_on_cpu(monkeypatch, tmp_path, capsys):
    """One epoch of a tiny recipe (configs/convergence.yaml with tiny-cliff,
    validation every epoch, 20 + 10 samples) through `cli.convergence_bench
    --device cpu`, then `cli.calibration_decay` of its epoch checkpoint (its
    MPJPE the trainer's validation), `cli.camera_bringup` of its best model
    (a checkpoint that differs from it in deccam alone, which
    `cli.detector_quality` then loads)."""
    cfg = yaml.safe_load((REPO / "configs" / "convergence.yaml").read_text())
    cfg["POCO"].update(BACKBONE="tiny-cliff", CONTEXT_DIM=64)
    cfg["TRAINING"].update(CHECK_VAL_EVERY_N_EPOCH=1, FREEZE_PARAMS="0-flow_head-uncert_head,1")
    cfg["DATASET"]["BATCH_SIZE"] = 10
    (tmp_path / "conv.yaml").write_text(yaml.safe_dump(cfg))
    cfg["POCO"]["KEYPOINT_2D_LOSS_WEIGHT"] = 2.5
    (tmp_path / "ft2d.yaml").write_text(yaml.safe_dump(cfg))
    monkeypatch.setattr(port_cb, "N_TRAIN", 20)
    monkeypatch.setattr(port_cb, "N_TEST", 10)
    monkeypatch.setitem(port_cb.RECIPES, "cliff", (str(tmp_path / "conv.yaml"), "convergence"))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    data = str(tmp_path / "data")

    out = port_cb.main(["--root", data, "--epochs", "1", "--device", "cpu", "--work_dir",
                        str(tmp_path / "work"), "--mpjpe_thresh", "1e9", "--corr_thresh", "-2"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    keys = {"benchmark", "which", "curve", "epochs", "val_mpjpe_mm", "uncert_pose_corr",
            "uncert_mpjpe_corr", "mpjpe_thresh", "corr_thresh", "pass", "logdir",
            "best_mpjpe_var"}
    assert set(out) == keys and out["pass"] and [c["epoch"] for c in out["curve"]] == [0]
    logdir = Path(out["logdir"])
    assert logdir.parent.parent.parent == tmp_path / "work" / "logs" / "experiments"
    for name in ("best_model.pt", "best_model_mpjpe_var.pt", "epoch_000.pt", "last.pt",
                 "last.trainer.json", "val_accuracy.json"):
        assert (logdir / name).exists(), name
    assert abs(out["val_mpjpe_mm"] - out["curve"][0]["mpjpe"]) < 0.01

    decay = port_cd.main(["--logdir", str(logdir), "--root", data, "--device", "cpu"])
    val = json.loads((logdir / "val_accuracy.json").read_text())[0]
    report = json.loads((logdir / "calibration_decay_epoch_000.json").read_text())
    assert [r["ckpt"] for r in decay["rows"]] == ["epoch_000"]
    assert decay["homogenization_confirmed"] is None
    assert report["summary"]["mpjpe"] == pytest.approx(val["mpjpe"], abs=1e-3)

    cam = port_cam.main(["--ckpt", str(logdir), "--cfg", str(tmp_path / "ft2d.yaml"),
                         "--data_dir", data, "--epochs", "1", "--max_steps", "1",
                         "--eval_batches", "1", "--device", "cpu"])
    assert cam["out"] == str(logdir / "best_model_cam.pt") and cam["trainable_params"] == 3075
    base = torch.load(logdir / "best_model.pt", weights_only=False)["model"]
    tuned = torch.load(cam["out"], weights_only=False)["model"]
    assert set(base) == set(tuned)
    for key in base:
        same = torch.equal(base[key], tuned[key])
        assert same != port_cam.is_deccam(key), key

    dq = port_dq.main(["--gt", os.path.join(data, "dataset_extras", "conv_test.npz"),
                       "--img_root", data, "--cfg", str(tmp_path / "conv.yaml"),
                       "--ckpt", cam["out"], "--limit", "2", "--device", "cpu"])
    assert set(dq["detectors"]) == {"full_frame", "hog", "refine", "uncert"}
    assert dq["detectors"]["full_frame"] == dq["detectors"]["hog"]
    assert all(r["n_gt"] == 2 for r in dq["detectors"].values())


@pytest.mark.parametrize("mode", ["infer", "train"])
def test_profile_model_on_cpu(monkeypatch, tmp_path, mode):
    """`cli.profile_model --device cpu` at batch 2 for one step, with
    PocoConfig's backbone patched to the tiny one: a Chrome trace whose
    events hold the train step's TRAIN_STAGES ranges in train mode."""
    monkeypatch.setitem(port_poco.BACKBONES, "hrnet_w48_cls", tiny_cls)
    path = port_profile.main(["--mode", mode, "--batch", "2", "--steps", "1", "--precision", "32",
                              "--out", str(tmp_path), "--device", "cpu"])
    assert path == str(tmp_path / f"poco_{mode}_b2.json")
    names = {e.get("name") for e in json.loads(Path(path).read_text())["traceEvents"]}
    assert (set(TRAIN_STAGES) <= names) == (mode == "train")
    assert any(n and "conv" in n for n in names)
