"""PyTorch port: the trainer, its data plumbing and the training CLI, on the
CPU at the size of `configs/tiny_smoke.yaml` (tiny-cliff, a V=432
synthetic SMPL, in-memory data or the repo's 16-sample smoke set).

Against the JAX package on the same inputs: the mixed-dataset draws, the
resumable sampler and the loader's order (exact), and the keys that
`python -m poco_tpu_torch.cli.train` writes to metrics.jsonl against
those of the repo's `train.py` on the same config. On the port alone:
fit, validate and checkpoint; a run killed and resumed repeats the
uninterrupted one exactly; top-k keeps the best 5; the plateau halves the
LR in place; a freeze boundary freezes the named modules; PRECISION: 16
and METHOD: spin train; `cli.eval --ckpt <logdir>` loads the run's
`best_model`.
"""

import json
import os
import runpy
import sys

import numpy as np
import pytest
import torch

from poco_tpu.data.dataset import DataLoader as JaxDataLoader
from poco_tpu.data.dataset import ResumableSampler as JaxSampler
from poco_tpu.data.mixed import RatioMixedDataset as JaxMixed
from poco_tpu.data.mixed import parse_datasets_and_ratios as jax_parse_ratios
from poco_tpu.data.mixed import parse_stage_datasets as jax_parse_stages
from poco_tpu.data.mixed import spin_mixed_partition as jax_spin_partition
from poco_tpu.data.mixed import stage_for_epoch as jax_stage_for_epoch

from poco_tpu_torch.config import get_hparams_defaults
from poco_tpu_torch.data.dataset import DataLoader, ResumableSampler
from poco_tpu_torch.data.mixed import (
    RatioMixedDataset,
    parse_datasets_and_ratios,
    parse_stage_datasets,
    spin_mixed_partition,
    stage_for_epoch,
)
from poco_tpu_torch.smpl.assets import synthetic_smpl_model
from poco_tpu_torch.train.trainer import Trainer, select_gt_pose_cond

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module (see
    tests/test_torch_eval.py). Restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _ArrayDataset:
    """In-memory dataset with PocoDataset's item schema."""

    def __init__(self, n=8, seed=0, names=("h36m",)):
        rng = np.random.RandomState(seed)
        self.items = []
        for i in range(n):
            self.items.append({
                "img": rng.rand(224, 224, 3).astype(np.float32) * 255,
                "pose": (0.2 * rng.randn(72)).astype(np.float32),
                "betas": (0.5 * rng.randn(10)).astype(np.float32),
                "pose_3d": rng.randn(24, 4).astype(np.float32),
                "keypoints": rng.rand(49, 3).astype(np.float32),
                "keypoints_fullimg": rng.rand(49, 3).astype(np.float32) * 500,
                "has_smpl": np.float32(1.0),
                "has_pose_3d": np.float32(1.0),
                "scale": np.float32(1.0),
                "center": np.array([500.0, 400.0], np.float32),
                "orig_shape": np.array([800.0, 1000.0], np.float32),
                "focal_length": np.float32(1280.0),
                "bbox_info": rng.randn(3).astype(np.float32),
                "gender": np.int32(i % 2),
                "sample_index": np.int32(i),
                "dataset_name": names[i % len(names)],
                "imgname": f"img_{i}.jpg",
            })

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _hparams(logdir, **training):
    h = get_hparams_defaults()
    h.LOG_DIR = str(logdir)
    h.METHOD = "poco"
    h.SEED_VALUE = 0
    h.POCO.BACKBONE = "tiny-cliff"
    h.POCO.NUM_NEURONS = "216-"
    h.POCO.SIGMA_DIM = 1
    h.POCO.UNCERT_INP_TYPE = "feat-pose-net"
    h.POCO.LOSS_VER = "norm_flow_res_gaus"
    h.POCO.COND_NFLOW = True
    h.POCO.CONTEXT_DIM = 64
    h.POCO.NUM_FLOW_LAYERS = 1
    h.POCO.GT_POSE_COND = True
    h.POCO.KEYPOINT_2D_NONCROP = True
    h.DATASET.BATCH_SIZE = 4
    h.TRAINING.LOG_SAVE_INTERVAL = 1
    h.TRAINING.update(training)
    return h


def _trainer(logdir, train=None, val=None, **training):
    ds = train or _ArrayDataset(n=8, names=("h36m", "coco"))
    return Trainer(
        _hparams(logdir, **training), synthetic_smpl_model(device="cpu"),
        train_dataset_fn=lambda epoch: ds, val_dataset=val, device="cpu",
    )


def _params(trainer):
    return {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}


# --------------------------------------------------------------------------
# data plumbing against the JAX package
# --------------------------------------------------------------------------

def test_mixed_datasets_and_specs_match_jax():
    spec = "h36m_coco_lspet_mpii_mpi-inf-3dhp-spin_0.5_0.233_0.046_0.021_0.2"
    assert parse_datasets_and_ratios(spec) == jax_parse_ratios(spec)
    stages = "0+h36m_1.0,3+h36m_coco_0.5_0.5"
    assert parse_stage_datasets(stages) == jax_parse_stages(stages)
    for epoch in range(5):
        assert stage_for_epoch(parse_stage_datasets(stages), epoch) == jax_stage_for_epoch(
            jax_parse_stages(stages), epoch)
    assert spin_mixed_partition([10, 5, 7, 3, 9, 4]) == jax_spin_partition([10, 5, 7, 3, 9, 4])
    members = [_ArrayDataset(n, seed=n, names=(f"ds{n}",)) for n in (5, 8, 3)]
    port = RatioMixedDataset(members, [0.5, 0.3, 0.2], seed=4)
    ref = JaxMixed(members, [0.5, 0.3, 0.2], seed=4)
    assert len(port) == len(ref) == 8
    for i in range(12):
        assert port[i]["sample_index"] == ref[i]["sample_index"]
        assert port[i]["dataset_name"] == ref[i]["dataset_name"]
    a, b = port.get_batch([3, 1, 7, 0]), ref.get_batch([3, 1, 7, 0])
    assert a["dataset_name"] == b["dataset_name"]
    np.testing.assert_array_equal(a["img"], b["img"])


def test_sampler_and_loader_order_match_jax():
    port, ref = ResumableSampler(11, seed=3), JaxSampler(11, seed=3)
    np.testing.assert_array_equal(port.take(4), ref.take(4))
    state = port.state_dict()
    assert state == ref.state_dict()
    resumed = ResumableSampler(11)
    resumed.load_state_dict(state)
    np.testing.assert_array_equal(resumed.take(7), ref.take(7))
    assert resumed.remaining == ref.remaining == 0
    resumed.next_epoch()
    ref.next_epoch()
    np.testing.assert_array_equal(resumed.take(11), ref.take(11))

    ds = _ArrayDataset(n=10)
    order = [b["sample_index"].tolist() for b in DataLoader(ds, 4, shuffle=True, seed=2)]
    jax_order = [b["sample_index"].tolist() for b in JaxDataLoader(ds, 4, shuffle=True, seed=2)]
    assert order == jax_order and len(order) == 2


def test_gt_pose_cond_selection():
    mask = select_gt_pose_cond(["h36m"] * 8 + ["coco"] * 4, "h36m", 0.25)
    assert mask.sum() == 2 and mask[:2].all() and not mask[8:].any()
    assert select_gt_pose_cond(["a", "b"], "all", 0.1).all()


# --------------------------------------------------------------------------
# the trainer
# --------------------------------------------------------------------------

def test_fit_validate_checkpoint_resume(tmp_path):
    trainer = _trainer(tmp_path, val=_ArrayDataset(n=8, seed=1), FREEZE_PARAMS="0-backbone")
    trainer.hparams.TESTING.SAVE_RESULTS = True
    before = _params(trainer)
    summary = trainer.fit(max_epochs=1)
    trainer.close()
    assert np.isfinite(summary["best_model_metric"])
    for name in ("val_accuracy.json", "metrics.jsonl", "evaluation_results_3dpw.pkl",
                 "best_model.pt", "best_model.trainer.json", "last.pt", "epoch_000.pt",
                 "best_model_mpjpe_var.pt", "uncert_stats_train_e0.json"):
        assert os.path.exists(tmp_path / name), name
    after = _params(trainer)
    # epoch 0 freezes the backbone: its weights stay, the head's move
    assert all(torch.equal(before[k], after[k]) for k in before
               if k.startswith("backbone.") and k.endswith("weight"))
    assert not torch.equal(before["head.fc1.weight"], after["head.fc1.weight"])

    resumed = _trainer(tmp_path)
    resumed.load_checkpoint(str(tmp_path / "best_model"))
    for k, v in _params(resumed).items():
        assert torch.equal(v, after[k]), k
    assert resumed.best_metric == trainer.best_metric
    assert resumed.epoch == 1 and resumed.step == trainer.step == 2
    resumed.close()


def test_checkpoint_keys_must_match_exactly(tmp_path):
    trainer = _trainer(tmp_path / "a")
    trainer.save_checkpoint("last")
    trainer.close()
    payload = torch.load(tmp_path / "a" / "last.pt", weights_only=False)
    del payload["model"]["head.fc1.bias"]
    torch.save(payload, tmp_path / "a" / "broken.pt")
    other = _trainer(tmp_path / "b")
    with pytest.raises(ValueError, match="does not match the model"):
        other.load_checkpoint(str(tmp_path / "a" / "broken"))
    other.close()


def test_kill_and_resume_reproduces_trajectory(tmp_path):
    """Killed after epoch 1 of 2 and resumed from 'last' in a fresh
    trainer: the same weights, BN statistics, optimizer moments, val
    history and top-k as the uninterrupted run, exactly (the sidecar
    carries the generator states, so the dropout masks repeat)."""
    val = _ArrayDataset(n=8, seed=1)
    a = _trainer(tmp_path / "a", val=val)
    a.fit(max_epochs=2)
    a.close()
    b = _trainer(tmp_path / "b", val=val)
    b.fit(max_epochs=1)
    b.close()
    b2 = _trainer(tmp_path / "b", val=val)
    b2.load_checkpoint(str(tmp_path / "b" / "last"))
    assert b2.epoch == 1
    b2.fit(max_epochs=2)
    b2.close()
    pa, pb = _params(a), _params(b2)
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
    sa, sb = a.optimizer.optimizer.state_dict(), b2.optimizer.optimizer.state_dict()
    for i in sa["state"]:
        assert torch.equal(sa["state"][i]["exp_avg_sq"], sb["state"][i]["exp_avg_sq"])
    assert [h["mpjpe"] for h in a.val_history] == [h["mpjpe"] for h in b2.val_history]
    assert a._topk == b2._topk and a.best_metric == b2.best_metric


def test_keeps_best_5(tmp_path):
    trainer = _trainer(tmp_path)
    for epoch, metric in enumerate([50.0, 40.0, 60.0, 30.0, 45.0, 70.0, 35.0]):
        trainer._retain_top_k(epoch, metric)
    trainer.close()
    kept = sorted(f for f in os.listdir(tmp_path) if f.startswith("epoch_") and f.endswith(".pt"))
    assert kept == ["epoch_000.pt", "epoch_001.pt", "epoch_003.pt", "epoch_004.pt", "epoch_006.pt"]
    sidecars = sorted(f for f in os.listdir(tmp_path) if f.endswith(".trainer.json"))
    assert sidecars == [k.replace(".pt", ".trainer.json") for k in kept]


def test_plateau_halves_the_lr_without_a_new_optimizer(tmp_path):
    trainer = _trainer(tmp_path)
    trainer.hparams.OPTIMIZER.LR_PLATEAU_PATIENCE = 2
    trainer.hparams.OPTIMIZER.MODULE_LR = ""
    opt = trainer.optimizer
    lr = trainer.hparams.OPTIMIZER.LR
    trainer._maybe_reduce_lr_on_plateau(10.0)
    trainer._maybe_reduce_lr_on_plateau(11.0)
    trainer._maybe_reduce_lr_on_plateau(11.0)  # second miss: halve
    assert trainer._current_lr == lr * 0.5
    assert trainer.optimizer is opt and opt.lr_scale == 0.5
    assert all(g["lr"] == pytest.approx(lr * 0.5 * g["lr_mult"]) for g in opt.groups)
    trainer._maybe_reduce_lr_on_plateau(9.0)  # a new best: no change
    assert trainer._current_lr == lr * 0.5
    trainer.close()


def test_freeze_boundary_freezes_the_named_modules(tmp_path):
    """FREEZE_PARAMS '1-backbone-head': epoch 0 trains everything; from
    epoch 1 a new optimizer leaves the backbone and head alone while the
    uncertainty and flow heads train on."""
    trainer = _trainer(tmp_path, FREEZE_PARAMS="1-backbone-head")
    p0 = _params(trainer)
    trainer.train_epoch(0)
    p1 = _params(trainer)
    assert not torch.equal(p0["backbone.conv1.weight"], p1["backbone.conv1.weight"])
    trainer.train_epoch(1)
    p2 = _params(trainer)
    assert trainer.optimizer.frozen_modules == ("backbone", "head")
    for k in p1:
        if k.startswith(("backbone.", "head.")) and k.endswith(("weight", "bias")) and "bn" not in k:
            assert torch.equal(p1[k], p2[k]), k
    assert not torch.equal(p1["uncert_head.uncert_fc1.weight"], p2["uncert_head.uncert_fc1.weight"])
    assert not torch.equal(p1["flow_head.cond_layer.weight"], p2["flow_head.cond_layer.weight"])
    with open(tmp_path / "metrics.jsonl") as f:
        events = [json.loads(line) for line in f]
    assert {"event": "freeze", "epoch": 1, "frozen": ["backbone", "head"]}.items() <= next(
        e for e in events if e.get("event") == "freeze").items()
    trainer.close()


def test_precision_16_trains(tmp_path):
    trainer = _trainer(tmp_path, PRECISION=16)
    assert trainer.autocast_dtype == torch.bfloat16
    metrics = trainer.train_epoch(0)
    assert np.isfinite(metrics["loss/total_loss"])
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())
    trainer.close()


def test_spin_method_trains_hmr(tmp_path):
    h = _hparams(tmp_path)
    h.METHOD = "spin"
    h.SPIN.BACKBONE = "tiny"
    trainer = Trainer(h, synthetic_smpl_model(device="cpu"),
                      train_dataset_fn=lambda e: _ArrayDataset(n=8),
                      val_dataset=_ArrayDataset(n=8, seed=1), device="cpu")
    summary = trainer.fit(max_epochs=1)
    trainer.close()
    assert np.isfinite(summary["mpjpe"]) and "uncert_mpjpe_corr" not in summary
    assert not hasattr(trainer.model, "uncert_head")


def test_csv_and_tensorboard_logs(tmp_path):
    h = _hparams(tmp_path)
    h.PREF_LOGGER = "tensorboard,csv"
    trainer = Trainer(h, synthetic_smpl_model(device="cpu"),
                      train_dataset_fn=lambda e: _ArrayDataset(n=4), device="cpu")
    trainer._log({"loss/total_loss": 1.25})
    trainer._log({"mpjpe": 77.0})
    trainer.close()
    with open(tmp_path / "metrics.csv") as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    header = lines[0].split(",")
    assert "loss/total_loss" in header and "mpjpe" in header and "total" in header
    assert dict(zip(header, lines[-1].split(",")))["mpjpe"] == "77.0"
    assert any(f.startswith("events.out.tfevents") for f in os.listdir(tmp_path))


def test_refuses_features_of_later_slices(tmp_path):
    """Only DATASET.USE_SYNTHETIC_OCCLUSION is refused now: SAVE_IMAGES and
    the render and part-segmentation losses came with their slice."""
    _trainer(tmp_path / "a", SAVE_IMAGES=True).close()
    _trainer(tmp_path / "b", USE_SMPL_RENDER_LOSS=True, USE_SMPL_SEGM_LOSS=True).close()
    h = _hparams(tmp_path)
    h.DATASET.USE_SYNTHETIC_OCCLUSION = True
    with pytest.raises(NotImplementedError, match="occlusion"):
        Trainer(h, synthetic_smpl_model(device="cpu"), lambda e: None, device="cpu")


def test_save_images_writes_the_grid_where_jax_writes_it(tmp_path):
    """Every LOG_SAVE_INTERVAL step's grid at the JAX trainer's path
    (`<logdir>/images/train_e{epoch}_s{step}.png`, JAX train_viz.
    save_training_grid), 4 rows of [crop | GT | prediction], 224 px."""
    import cv2

    from poco_tpu.viz.train_viz import save_training_grid as jax_save

    trainer = _trainer(tmp_path / "run", SAVE_IMAGES=True, LOG_SAVE_INTERVAL=1)
    trainer.fit(1)
    trainer.close()
    names = sorted(os.listdir(tmp_path / "run" / "images"))
    assert names == ["train_e0_s0.png", "train_e0_s1.png"]
    grid = cv2.imread(str(tmp_path / "run" / "images" / names[0]))
    assert grid.shape == (4 * 224, 3 * 224, 3)
    want = jax_save(grid, str(tmp_path / "jax"), "train_e0_s0")
    assert os.path.relpath(want, tmp_path / "jax") == os.path.join("images", names[0])


def test_profile_dir_traces_the_first_steps(monkeypatch, tmp_path):
    """POCO_TPU_PROFILE_DIR (the JAX trainer's knob): a Chrome trace of
    epoch 0's first steps, with every TRAIN_STAGES range, and none for a
    later epoch."""
    from poco_tpu_torch.train.step import TRAIN_STAGES

    monkeypatch.setenv("POCO_TPU_PROFILE_DIR", str(tmp_path / "prof"))
    trainer = _trainer(tmp_path / "run")
    trainer.fit(2)
    trainer.close()
    assert os.listdir(tmp_path / "prof") == ["train_e0_rank0.json"]
    with open(tmp_path / "prof" / "train_e0_rank0.json") as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert set(TRAIN_STAGES) <= names


def test_warm_start_from_a_reference_pt(tmp_path):
    source = _trainer(tmp_path / "a")
    state = {k: v + 1.0 if v.is_floating_point() else v
             for k, v in source.model.state_dict().items()}
    state["head.not_a_module.weight"] = torch.zeros(3)
    torch.save({"model": state}, tmp_path / "ref.pt")
    source.close()
    warm = _trainer(tmp_path / "b", PRETRAINED=str(tmp_path / "ref.pt"))
    for k, v in warm.model.state_dict().items():
        assert torch.equal(v, state[k]), k
    warm.close()
    with open(tmp_path / "b" / "metrics.jsonl") as f:
        event = next(json.loads(line) for line in f if "warm_start" in line)
    assert event["loaded"] == len(state) - 1 and event["skipped"] == 1
    (tmp_path / "orbax").mkdir()
    (tmp_path / "orbax" / "_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="orbax"):
        _trainer(tmp_path / "c", PRETRAINED=str(tmp_path / "orbax"))


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------

def _keys_by_kind(path):
    kinds = {}
    with open(path) as f:
        for line in f:
            record = json.loads(line)
            kind = record.get("event", "train_step")
            kinds.setdefault(kind, set()).update(record)
    return kinds


def test_cli_trains_on_the_smoke_set_and_matches_jax_train_py_keys(monkeypatch, tmp_path):
    """`python -m poco_tpu_torch.cli.train` on configs/tiny_smoke.yaml and
    the repo's smoke data, on the CPU, against the repo's `train.py` on
    the same config: the same metrics.jsonl records with the same keys
    (the parameter counts name the backbone `backbone` where JAX names it
    `backbone_net`); then `cli.eval --ckpt <logdir>` evaluates the run's
    best_model."""
    from poco_tpu_torch.cli import eval as eval_cli
    from poco_tpu_torch.cli import train as train_cli

    monkeypatch.chdir(REPO)
    summary = train_cli.main(["--cfg", "configs/tiny_smoke.yaml", "--max_epochs", "1",
                              "--logdir", str(tmp_path / "port"), "--device", "cpu"])
    assert np.isfinite(summary["best_model_metric"])

    monkeypatch.setattr(sys, "argv", ["train.py", "--cfg", "configs/tiny_smoke.yaml",
                                      "--max_epochs", "1", "--logdir", str(tmp_path / "jax")])
    runpy.run_path(os.path.join(REPO, "train.py"), run_name="__main__")

    port = _keys_by_kind(tmp_path / "port" / "metrics.jsonl")
    ref = _keys_by_kind(tmp_path / "jax" / "metrics.jsonl")
    ref["params"] = {"backbone" if k == "backbone_net" else k for k in ref["params"]}
    assert port == ref

    payload = eval_cli.main(["--cfg", "configs/tiny_smoke.yaml", "--ckpt", str(tmp_path / "port"),
                             "--dataset", "smoke", "--batch_size", "8", "--device", "cpu"])
    assert payload["summary"]["mpjpe"] == pytest.approx(summary["mpjpe"], rel=1e-5)


def test_cli_resumes_a_run_in_its_logdir(monkeypatch, tmp_path):
    from poco_tpu_torch.cli import train as train_cli

    monkeypatch.chdir(REPO)
    common = ["--cfg", "configs/tiny_smoke.yaml", "--logdir", str(tmp_path), "--device", "cpu"]
    train_cli.main(common + ["--max_epochs", "1"])
    summary = train_cli.main(common + ["--max_epochs", "2", "--resume", str(tmp_path / "last")])
    assert summary["epoch"] == 1
    with open(tmp_path / "val_accuracy.json") as f:
        assert [h["epoch"] for h in json.load(f)] == [0, 1]


def test_cli_refuses_dist_and_make_launcher(monkeypatch, tmp_path, capsys):
    """--make_launcher writes the grid-search launcher and exits (the
    launchers are held to JAX's in tests/test_torch_launchers.py). --dist,
    refused before multi-GPU was ported, now forms a world from torchrun's
    environment (here one gloo process on the CPU), trains in it, and
    leaves no process group behind."""
    import socket

    from poco_tpu_torch.cli import train as train_cli

    monkeypatch.chdir(tmp_path)
    out = train_cli.main(["--cfg", os.path.join(REPO, "configs", "tiny_smoke.yaml"),
                          "--make_launcher", "bash"])
    assert out == {"launcher": os.path.join("scripts", "tiny_smoke.sh")}
    assert "poco_tpu_torch.cli.train" in (tmp_path / "scripts" / "tiny_smoke.sh").read_text()
    monkeypatch.chdir(REPO)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for key, value in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                       "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}.items():
        monkeypatch.setenv(key, value)
    summary = train_cli.main(["--cfg", "configs/tiny_smoke.yaml", "--dist", "--logdir",
                              str(tmp_path), "--max_epochs", "1", "--device", "cpu"])
    assert "world: rank 0 of 1 (backend gloo)" in capsys.readouterr().out
    assert not torch.distributed.is_initialized()
    assert summary["epoch"] == 0
    with open(tmp_path / "metrics.jsonl") as f:
        assert any("loss/total_loss" in json.loads(line) for line in f)
