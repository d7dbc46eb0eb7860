"""The port's one span system: named host intervals at its layer
boundaries (a request, its upload, crop and model parts; a train step and
its stages; the eval step's and the demo's stages).

    with span("poco/backbone"):
        ...
    with span("poco/upload", wait=True):   # the host blocks on the card here
        ...

A span is read two ways, and costs two flag checks when neither is on:

* under a running `torch.profiler`, it opens a `record_function` range of
  its name, so the device trace's kernels correlate to it by the
  profiler's own clock (the `POCO_TPU_PROFILE_DIR` trace, `chip_smoke.py`
  phase 6, the benchmark's traced runs);
* under `recording()`, it appends a `Record` to the list that `recording`
  returns: its name, id, parent's id, root's id (the outermost span open
  on its thread: one request or one train step), `wait`, thread and host
  start and end (`time.perf_counter_ns`). Nothing is written to disk, and
  nothing waits on the card or records a CUDA event.

`wait=True` marks a span where the host blocks on the card (a pageable
copy, a value read back): the host time of a root less its wait spans is
the time it took to launch its work. While torch compiles or exports, a
span does nothing, so an exported program holds no profiler op.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import NamedTuple

import torch
from torch.profiler import record_function

# a request (`demo/tester.py:detect_forward`) and the model's parts
# (`models/poco.py:POCO._forward`)
REQUEST = "poco/request"
UPLOAD = "poco/upload"
CROP = "poco/crop"
BACKBONE = "poco/backbone"
HEAD = "poco/head"
SMPL = "poco/smpl"
UNCERT = "poco/uncert"
FLOW = "poco/flow"
# each block of a ViT trunk (`models/backbones/vit.py`): its LayerNorm,
# qkv, attention and projection; its LayerNorm, fc1, GELU and fc2
VIT_ATTENTION = "poco/vit_attention"
VIT_MLP = "poco/vit_mlp"
# zero-length, under a request's root, when the request starts while the
# card is still running the request before it: the host has run ahead
AHEAD = "poco/ahead"
# a train step (`train/step.py:make_train_step`) and its stages, in order
TRAIN_STEP = "train_step"
TRAIN_STAGES = ("train_step/gt", "train_step/forward", "train_step/backward",
                "train_step/optimizer")
# the eval step's stages (`eval/runner.py:make_gendered_eval_step`), in order
EVAL_STAGES = ("eval_step/forward", "eval_step/flip_tta", "eval_step/gt_meshes",
               "eval_step/joints", "eval_step/metrics")
# the demo's stages (`demo/tester.py:PocoTester`)
DEMO_STAGES = ("decode", "detect", "poco", "smooth", "render", "write")
# around the small constants of a request or a train step that, copied to
# the card from the host, would block it (a pageable copy waits for the
# card's queue to drain); they are made on the card, so there these spans
# hold no wait. The host tables key on their names and `wait` flags.
SYNC_TRUE_HW = "sync/true_hw"              # ops/preprocess.py:preprocess_crops
SYNC_NORM = "sync/norm_constants"          # ops/preprocess.py:normalize_image
SYNC_PARENTS = "sync/parent_index"         # smpl/lbs.py:batch_rigid_transform
SYNC_VERTEX_IDS = "sync/vertex_joint_ids"  # smpl/lbs.py:smpl_forward
SYNC_JOINT_MAP = "sync/joint_map_49"       # smpl/model.py:smpl_49
SYNC_FOCAL = "sync/focal_length"           # ops/camera.py:perspective_projection
SYNC_FLOW_PARTS = "sync/flow_parts"        # models/heads/flow.py:FlowHead.forward
# the spans in which the host blocks on the card
WAITS = (UPLOAD, SYNC_TRUE_HW, SYNC_NORM, SYNC_PARENTS, SYNC_VERTEX_IDS, SYNC_JOINT_MAP,
         SYNC_FOCAL, SYNC_FLOW_PARTS)
LAYERS = (REQUEST, UPLOAD, CROP, BACKBONE, HEAD, SMPL, UNCERT, FLOW, TRAIN_STEP, AHEAD,
          VIT_ATTENTION, VIT_MLP)


def names() -> dict[str, bool]:
    """Every span name the port opens, and whether it is a wait."""
    every = LAYERS + WAITS + TRAIN_STAGES + EVAL_STAGES + DEMO_STAGES
    return {name: name in WAITS for name in every}


class Record(NamedTuple):
    name: str
    id: int
    parent: int | None
    root: int
    wait: bool
    thread: int
    start_ns: int
    end_ns: int


_records: list[Record] | None = None
_ids = itertools.count(1)
_local = threading.local()
_OFF = contextlib.nullcontext()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "wait", "records", "range", "id", "parent", "root", "start")

    def __init__(self, name: str, wait: bool, records: list | None, profiled: bool):
        self.name, self.wait, self.records = name, wait, records
        self.range = record_function(name) if profiled else None

    def __enter__(self):
        if self.range is not None:
            self.range.__enter__()
        if self.records is not None:
            stack = _stack()
            outer = stack[-1] if stack else None
            self.id = next(_ids)
            self.parent = outer.id if outer else None
            self.root = outer.root if outer else self.id
            stack.append(self)
            self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.records is not None:
            end = time.perf_counter_ns()
            _stack().pop()
            self.records.append(Record(self.name, self.id, self.parent, self.root, self.wait,
                                       threading.get_ident(), self.start, end))
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def active() -> bool:
    """Whether a span opened now would be read (a profiler runs or spans
    record): for a span whose condition costs more than the span itself."""
    if torch.compiler.is_compiling() or torch.compiler.is_exporting():
        return False
    return _records is not None or torch.autograd._profiler_enabled()


def span(name: str, wait: bool = False):
    """A context manager for the span `name` (see the module's docstring)."""
    if torch.compiler.is_compiling() or torch.compiler.is_exporting():
        return _OFF
    profiled = torch.autograd._profiler_enabled()
    if not profiled and _records is None:
        return _OFF
    return _Span(name, wait, _records, profiled)


@contextlib.contextmanager
def recording():
    """Spans are recorded while this is open: yields the list of `Record`s
    it fills (each appended when its span closes). A recording opened
    inside another takes the spans until it closes."""
    global _records
    outer, records = _records, []
    _records = records
    try:
        yield records
    finally:
        _records = outer
