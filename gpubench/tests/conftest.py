"""Fixtures of the benchmark's CPU tests: the harness importable, and a
copy of the benchmark at a tiny size (HRNet at width 8, 4 boxes a
request, batches of 4) whose cells keep the real cells' limits, but for
`late_update_leaf` (see `short_window_limits`)."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

GPUBENCH = Path(__file__).resolve().parents[1]
REPO = GPUBENCH.parent
for path in (str(GPUBENCH), str(REPO)):
    if path not in sys.path:
        sys.path.insert(0, path)

TINY_CELLS = {"cliff_frames_b128": ("poco_cliff", "frames"),
              "pare_frames_b128": ("poco_pare", "frames"),
              "cliff_train_b64": ("poco_cliff", "train_batches")}


def copy_bench(root: Path) -> Path:
    """gpubench/ copied under `root`, with BENCHMARK.json beside it."""
    copy = root / "gpubench"
    shutil.copytree(GPUBENCH, copy, ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    return copy


def add_cells(copy: Path, added: dict[str, str]) -> None:
    """Entries in the copy's BENCHMARK.json for cell files added to it
    (name: the cell whose metrics it reports)."""
    path = copy.parent / "BENCHMARK.json"
    bench = json.loads(path.read_text())
    for name, like in added.items():
        cell = json.loads((copy / "workloads" / f"{name}.json").read_text())
        bench["workloads"].append(
            {"name": name, **{k: cell[k] for k in ("config", "traffic", "chips", "why")}})
        for metric in bench["end_to_end"] + bench["per_layer"]:
            if like in metric.get("workloads", []):
                metric["workloads"].append(name)
    path.write_text(json.dumps(bench, indent=1))


def short_window_limits(limits: dict) -> dict:
    """A cell's limits for a test's short window, which ends a few steps
    after set-up, where Adam is as young as in the first three steps and
    a step's change reads as far from the reference's as there: its late
    steps' change is held to the first steps' limit, not to the one set
    from the late steps of a 51-s window."""
    if "late_update_leaf" in limits:
        limits = dict(limits, late_update_leaf=limits["update_leaf"])
    return limits


def make_tiny_copy(root: Path) -> Path:
    """gpubench/ copied under `root`, with a tiny_<cell> beside each cell:
    the same configuration but for an HRNet of width 8 (`hrnet_w8_cls`,
    `hrnet_w8`), and the same traffic at a tiny size."""
    copy = copy_bench(root)
    for name in ("poco_cliff", "poco_pare"):
        cfg = json.loads((copy / "configs" / f"{name}.json").read_text())
        cfg["name"] = f"tiny_{name}"
        cfg["model"]["backbone"] = (cfg["model"]["backbone"].replace("hrnet_w48_cls", "hrnet_w8_cls")
                                    .replace("hrnet_w32", "hrnet_w8"))
        (copy / "configs" / f"tiny_{name}.json").write_text(json.dumps(cfg))
    frames = json.loads((copy / "traffic" / "frames.json").read_text())
    frames.update(frames=2, boxes=4, box_sets=3, frame_height=240, frame_width=320,
                  center_margin=40)
    (copy / "traffic" / "tiny_frames.json").write_text(json.dumps(frames))
    batches = json.loads((copy / "traffic" / "train_batches.json").read_text())
    batches.update(batch=4, batches=4)
    (copy / "traffic" / "tiny_train_batches.json").write_text(json.dumps(batches))
    for cell, (config, traffic) in TINY_CELLS.items():
        data = json.loads((copy / "workloads" / f"{cell}.json").read_text())
        data.update(config=f"tiny_{config}", traffic=f"tiny_{traffic}", check_requests=2,
                    limits=short_window_limits(data["limits"]))
        (copy / "workloads" / f"tiny_{cell}.json").write_text(json.dumps(data))
    add_cells(copy, {f"tiny_{cell}": cell for cell in TINY_CELLS})
    return copy


def make_small_copy(root: Path) -> Path:
    """gpubench/ copied under `root`, with a small_<cell> beside each cell:
    the cell's own configuration at full width, its traffic cut to 8 boxes
    a request or batches of 8, for a test on the card."""
    copy = copy_bench(root)
    for name, size in (("frames", {"boxes": 8, "frames": 2, "box_sets": 4}),
                       ("train_batches", {"batch": 8, "batches": 4})):
        data = json.loads((copy / "traffic" / f"{name}.json").read_text())
        data.update(size)
        (copy / "traffic" / f"small_{name}.json").write_text(json.dumps(data))
    for cell, (_, traffic) in TINY_CELLS.items():
        data = json.loads((copy / "workloads" / f"{cell}.json").read_text())
        data.update(traffic=f"small_{traffic}", check_requests=2,
                    limits=short_window_limits(data["limits"]))
        (copy / "workloads" / f"small_{cell}.json").write_text(json.dumps(data))
    add_cells(copy, {f"small_{cell}": cell for cell in TINY_CELLS})
    return copy


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny_copy(tmp_path_factory.mktemp("tiny"))


@pytest.fixture
def narrow_hrnet(monkeypatch):
    """The width-8 HRNets in the port's and the reference's registries."""
    import torch

    from poco_tpu_torch.models import poco as port_poco
    from poco_tpu_torch.models.backbones.hrnet import HRNet
    from reference import poco as ref_poco
    from reference.hrnet import HRNet as RefHRNet

    torch.set_num_threads(2)
    monkeypatch.setitem(port_poco.BACKBONES, "hrnet_w8_cls", lambda: HRNet(width=8))
    monkeypatch.setitem(port_poco.BACKBONES, "hrnet_w8", lambda: HRNet(width=8, variant="pose"))
    monkeypatch.setitem(ref_poco.BACKBONES, "hrnet_w8_cls", lambda: RefHRNet(width=8))
    monkeypatch.setitem(ref_poco.BACKBONES, "hrnet_w8",
                        lambda: RefHRNet(width=8, variant="pose"))
