"""The benchmark is driven by data: every cell, configuration, traffic mix
and per-layer metric is a file found by its name, BENCHMARK.json agrees
with them, and a cell added as a new file is found with no edit."""

from __future__ import annotations

import json
import re

import pytest

from bench import manifest
from conftest import REPO, add_cells, copy_bench

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")


@pytest.mark.parametrize("cell", manifest.names("workloads"))
def test_cell_found_and_valid(cell):
    data = manifest.load_cell(cell)
    entry = {w["name"]: w for w in BENCH["workloads"]}[cell]
    assert (entry["config"], entry["traffic"], entry["chips"], entry["why"]) == (
        data["config"], data["traffic"], data["chips"], data["why"])
    reported = {m["name"] for m in BENCH["end_to_end"] if cell in m.get("workloads", [cell])}
    assert reported == set(data["end_to_end"])
    layer = {m["name"] for m in BENCH["per_layer"]
             if m["moves"] in reported and cell in m.get("workloads", [cell])}
    assert layer == set(data["per_layer"])
    units = {m["name"]: m["unit"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    assert data["units"] == {k: units[k] for k in reported | layer}


@pytest.mark.parametrize("kind", ["configs", "traffic", "runners", "metrics"])
def test_every_part_is_used_and_found(kind):
    cells = [manifest.load_cell(c) for c in manifest.names("workloads")]
    used = {"configs": {c["config"] for c in cells},
            "traffic": {c["traffic"] for c in cells},
            "runners": {c["traffic_data"]["kind"] for c in cells},
            "metrics": {m["name"] for m in BENCH["per_layer"]}}[kind]
    assert used == set(manifest.names(kind))
    if kind == "metrics":
        for name in used:
            assert manifest.metric_reader(name)({}) is None   # nothing to read: nothing returned
    if kind == "runners":
        for name in used:
            module = manifest.runner(name)
            assert all(hasattr(module, n) for n in manifest.RUNNER_NAMES)
            assert "setup_s" in module.END_TO_END


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gpubench"] and BENCH["command"][1] == "gpubench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for config in BENCH["configs"]:
        data = json.loads((REPO / config["file"]).read_text())
        assert data["name"] == config["name"] and data["reduced"] == config["reduced"] == []
        assert data["source"] == config["source"]
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for metric in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    for metric in BENCH["end_to_end"]:
        assert 0.01 <= metric["bound"] <= 0.25 and metric["source"] in ("host_clock",
                                                                           "device_trace")
    for metric in BENCH["per_layer"]:
        assert metric["moves"] in e2e and "\n" not in metric["layer"]
        assert set(metric["workloads"]) <= set(e2e[metric["moves"]].get("workloads", names))
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_added_cell_is_found_without_an_edit(tmp_path):
    root = copy_bench(tmp_path)
    cell = json.loads((root / "workloads" / "cliff_frames_b128.json").read_text())
    cell.update(traffic="frames_b8", why="video users: 8 boxes a frame")
    (root / "workloads" / "cliff_frames_b8.json").write_text(json.dumps(cell))
    traffic = json.loads((root / "traffic" / "frames.json").read_text())
    traffic["boxes"] = 8
    (root / "traffic" / "frames_b8.json").write_text(json.dumps(traffic))
    (root / "metrics" / "crops_a_call.infer.py").write_text(
        'def read(summary):\n    return summary.get("rows")\n')
    add_cells(root, {"cliff_frames_b8": "cliff_frames_b128"})
    assert "cliff_frames_b8" in manifest.names("workloads", root)
    loaded = manifest.load_cell("cliff_frames_b8", root)
    assert loaded["traffic_data"]["boxes"] == 8 and loaded["config_data"]["name"] == "poco_cliff"
    assert manifest.metric_reader("crops_a_call.infer", root)({"rows": 512}) == 512


ECHO_RUNNER = '''"""A throwaway kind of traffic: answers without driving anything."""
END_TO_END = ("setup_s", "echoes_per_s")
READINGS = ("gap",)
PRECISIONS = ("fp32",)
CELL_KEYS = ("echoes",)


def check(cell):
    return [] if cell["echoes"] > 0 else ["echoes"]


def run(ctx):
    n = ctx.cell["echoes"] * ctx.traffic["rate"]
    return {"attempted": n, "failed": 0, "summary": None, "readings": {"gap": 0.0},
            "e2e": {"setup_s": 0.5, "echoes_per_s": n / ctx.seconds},
            "memory_peak_bytes": 0, "requests": n}


def control(ctx):
    return {"control": {"gap": 1.0}}
'''


def test_added_traffic_kind_is_found_without_an_edit(tmp_path):
    """A kind of traffic, with its runner, mix, cell and end-to-end metric,
    added as new files and entries, is listed, validated and run."""
    import run

    root = copy_bench(tmp_path)
    (root / "runners" / "echo.py").write_text(ECHO_RUNNER)
    (root / "traffic" / "echo.json").write_text(json.dumps({"kind": "echo", "rate": 3}))
    cell = {"config": "poco_cliff", "traffic": "echo", "chips": 1, "why": "echoes",
            "end_to_end": ["setup_s", "echoes_per_s"], "per_layer": [], "trace_calls": 1,
            "limits": {"gap": 0.5}, "echoes": 4}
    (root / "workloads" / "cliff_echo.json").write_text(json.dumps(cell))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["end_to_end"].append({"name": "echoes_per_s", "unit": "echoes/s", "better": "higher",
                                "bound": 0.03, "source": "host_clock",
                                "workloads": ["cliff_echo"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    add_cells(root, {"cliff_echo": "no_such_cell"})
    assert "echo" in manifest.names("runners", root)
    assert manifest.load_cell("cliff_echo", root)["units"] == {"setup_s": "s",
                                                               "echoes_per_s": "echoes/s"}
    result = run.run_cell("cliff_echo", 2**31 + 11, 2.0, False, "cpu", root=root)
    assert result["correct"] and result["metrics"]["echoes_per_s"] == {"value": 6.0,
                                                                      "unit": "echoes/s"}
    cell["echoes"] = 0
    (root / "workloads" / "cliff_echo.json").write_text(json.dumps(cell))
    with pytest.raises(ValueError, match="echoes"):
        manifest.load_cell("cliff_echo", root)


def _reported(cell):
    cell["per_layer"] = ["no_such_metric.train"]


def _setup_left_out(cell):
    cell["end_to_end"] = ["train_crops_per_s"]


def _not_the_runners(cell):
    cell["end_to_end"] = ["setup_s", "crops_per_s"]


def _reading_unknown(cell):
    cell["limits"] = {"no_such_reading": 1.0}


def _drifts_from_benchmark(cell):
    cell["chips"] = 4


@pytest.mark.parametrize("fault", [_reported, _setup_left_out, _not_the_runners,
                                   _reading_unknown, _drifts_from_benchmark])
def test_invalid_cell_is_refused(tmp_path, fault):
    root = copy_bench(tmp_path)
    cell = json.loads((root / "workloads" / "cliff_train_b64.json").read_text())
    fault(cell)
    (root / "workloads" / "cliff_train_b64.json").write_text(json.dumps(cell))
    with pytest.raises(ValueError, match="cell cliff_train_b64"):
        manifest.load_cell("cliff_train_b64", root)


@pytest.mark.parametrize("change", [{"precision": "bf16"}, {"precision": None},
                                    {"optimizer": {"weight_decay": 0.01}}])
def test_configuration_the_runner_cannot_hold_is_refused(tmp_path, change):
    """A precision the runners do not apply, or an optimizer setting the
    reference does not follow, is refused before any run."""
    root = copy_bench(tmp_path)
    path = root / "configs" / "poco_cliff.json"
    config = json.loads(path.read_text())
    for key, value in change.items():
        config[key] = dict(config[key], **value) if isinstance(value, dict) else value
    path.write_text(json.dumps(config))
    with pytest.raises(ValueError, match="precision|weight decay"):
        manifest.load_cell("cliff_train_b64", root)
