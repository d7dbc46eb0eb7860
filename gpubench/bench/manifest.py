"""The benchmark's parts, each a file of its own, found by name:

    configs/<config>.json      a configuration as it is run
    workloads/<cell>.json      a cell: its config, traffic, chips, why,
                               the metrics it reports, its limits
    traffic/<mix>.json         a traffic mix: its kind and the parameters
                               that kind's runner reads
    runners/<kind>.py          a kind of traffic: the code that drives the
                               program with a mix of that kind (see below)
    metrics/<metric>.py        a per-layer metric's reader, `read(summary)`

A runner module holds
    END_TO_END   the end-to-end metrics it measures,
    READINGS     the numbers it compares with the reference,
    PRECISIONS   the configurations' `precision`s it runs as stated,
    CELL_KEYS    what else a cell of its kind names (may be empty),
    check(cell)  its own checks of a loaded cell, a list of problems,
    run(ctx)     one run (see `run.py`), and
    control(ctx) the readings that set its cells' limits from above.

The units of every metric are BENCHMARK.json's, beside this folder. A
later change adds a cell, configuration, traffic mix, kind of traffic or
metric by adding such files (and its entries in BENCHMARK.json), and
edits none."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
CELL_KEYS = {"config", "traffic", "chips", "why", "end_to_end", "per_layer", "trace_calls",
             "limits"}
RUNNER_NAMES = ("END_TO_END", "READINGS", "PRECISIONS", "CELL_KEYS", "check", "run", "control")
_modules: dict[Path, object] = {}


def _load(kind: str, name: str, root: Path) -> dict:
    if not NAME.match(name):
        raise ValueError(f"{kind} name {name!r} is not a benchmark name")
    path = root / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} file {path.relative_to(root.parent)}")
    return json.loads(path.read_text())


def _module(path: Path, prefix: str):
    """The module in `path`, loaded once."""
    path = path.resolve()
    if path not in _modules:
        name = f"gpubench_{prefix}_" + re.sub(r"\W", "_", path.stem)
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _modules[path] = module
    return _modules[path]


def names(kind: str, root: Path = ROOT) -> list[str]:
    suffix = ".py" if kind in ("metrics", "runners") else ".json"
    return sorted(p.name[: -len(suffix)] for p in (root / kind).glob(f"*{suffix}"))


def benchmark(root: Path = ROOT) -> dict:
    """BENCHMARK.json, beside the benchmark's folder."""
    return json.loads((root.parent / "BENCHMARK.json").read_text())


def runner(kind: str, root: Path = ROOT):
    """The module runners/<kind>.py."""
    if not NAME.match(kind) or not (root / "runners" / f"{kind}.py").is_file():
        raise FileNotFoundError(f"traffic kind {kind!r} has no runners/{kind}.py "
                                f"({names('runners', root)})")
    return _module(root / "runners" / f"{kind}.py", "runner")


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell with its configuration, traffic mix, runner and the units
    of its metrics, validated."""
    cell = _load("workloads", name, root)
    cell["name"] = name
    cell["config_data"] = _load("configs", cell["config"], root)
    cell["traffic_data"] = _load("traffic", cell["traffic"], root)
    problems = validate(cell, root)
    if problems:
        raise ValueError(f"cell {name}: " + "; ".join(problems))
    return cell


def _entries(bench: dict, cell: str) -> tuple[dict, dict, dict]:
    """BENCHMARK.json's entry of the cell, and its end-to-end and
    per-layer metrics, by name."""
    entry = {w["name"]: w for w in bench["workloads"]}.get(cell)
    e2e = {m["name"]: m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])}
    layer = {m["name"]: m for m in bench["per_layer"]
             if m["moves"] in e2e and cell in m.get("workloads", [cell])}
    return entry, e2e, layer


def validate(cell: dict, root: Path = ROOT) -> list[str]:
    missing = CELL_KEYS - set(cell)
    if missing:
        return [f"missing keys {sorted(missing)}"]
    kind = cell["traffic_data"].get("kind")
    try:
        mod = runner(str(kind), root)
    except FileNotFoundError as err:
        return [str(err)]
    absent = [n for n in RUNNER_NAMES if not hasattr(mod, n)]
    if absent:
        return [f"runners/{kind}.py lacks {absent}"]
    problems = []
    entry, e2e, layer = _entries(benchmark(root), cell["name"])
    if entry is None:
        problems.append("BENCHMARK.json has no such workload")
    elif (entry["config"], entry["traffic"], entry["chips"], entry["why"]) != (
            cell["config"], cell["traffic"], cell["chips"], cell["why"]):
        problems.append("config, traffic, chips or why differ from BENCHMARK.json's")
    if set(cell["end_to_end"]) != set(e2e) or set(cell["per_layer"]) != set(layer):
        problems.append("the metrics differ from those BENCHMARK.json gives the cell")
    if cell["chips"] not in (1, 4):
        problems.append(f"chips {cell['chips']}")
    if not 1 <= len(cell["why"]) <= 200 or "\n" in cell["why"]:
        problems.append("why: one line of 1 to 200 characters")
    if "setup_s" not in cell["end_to_end"]:
        problems.append("every cell reports setup_s")
    unknown = set(cell["end_to_end"]) - set(mod.END_TO_END)
    if unknown:
        problems.append(f"end-to-end metrics {sorted(unknown)} are not the {kind} runner's")
    for metric in cell["per_layer"]:
        if not (root / "metrics" / f"{metric}.py").is_file():
            problems.append(f"no reader metrics/{metric}.py")
    lacking = set(mod.CELL_KEYS) - set(cell)
    if lacking:
        problems.append(f"a {kind} cell names {sorted(lacking)}")
    if not cell["limits"] or set(cell["limits"]) - set(mod.READINGS):
        problems.append(f"limits {sorted(cell['limits'])}: some of {sorted(mod.READINGS)}")
    config = cell["config_data"]
    if config.get("name") != cell["config"]:
        problems.append("the configuration file's name differs from its file name")
    if config.get("precision") not in mod.PRECISIONS:
        problems.append(f"precision {config.get('precision')!r}: the {kind} runner runs "
                        f"{list(mod.PRECISIONS)}")
    problems += mod.check(cell)
    cell["units"] = {m["name"]: m["unit"] for m in [*e2e.values(), *layer.values()]}
    return problems


def metric_reader(name: str, root: Path = ROOT):
    """`read(summary)` of metrics/<name>.py."""
    return _module(root / "metrics" / f"{name}.py", "metric").read
