"""The port's spans (`poco_tpu_torch/utils/spans.py`) and the waits they
name: a request (`detect_forward`) and a train step of tiny models on the
CPU.

Off, a span opens nothing. Recorded, a request and a step give exactly
their span names, nested as the code nests them, one root a request or
step. Under `torch.profiler` every span is a range, nested as recorded.
An export made while spans record or a profiler runs holds no profiler op.
A CPU request gives bitwise what it gave with the constants made from
host numbers at every call (list indexes, `true_hw`, mean and std, the
focal length as tensors).

Card tests (marker `gpu`; skipped without a card), at full width:

    python -m pytest --noconftest -m gpu tests/test_torch_spans.py

every synchronizing call of a request (POCO-CLIFF, POCO-PARE) and of a
POCO-CLIFF train step falls inside a `wait=True` span, by torch's sync
debug mode, and after a warm-up a 128-box request of either model and a
step at batch 4 make none (sync debug mode "error"); a request's outputs
fetched after the next request was dispatched are bitwise those fetched at
once; outputs read on the caller's stream and freed before that read ran
are not overwritten by the next request; requests dispatched one ahead of
their fetch start while the card runs the one before and open
`poco/ahead`; and the device time under `poco/backbone`,
`poco/head` and `poco/uncert` equals that under the benchmark's forward
hooks (`gpubench/bench/trace.py:layer_ranges`) within 1%, as for HMR 2.0
under `poco/backbone` and `poco/head`, whose requests open 32
`poco/vit_attention` and 32 `poco/vit_mlp` spans and launch `skinning`
once.
"""

from __future__ import annotations

import collections
import dataclasses
import sys
import threading
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from poco_tpu_torch.demo.tester import detect_forward
from poco_tpu_torch.eval.runner import EVAL_STAGES, make_gendered_eval_step
from poco_tpu_torch.losses.losses import LossConfig
from poco_tpu_torch.models.poco import (POCO, PocoConfig, build_hmr2, build_poco_cliff,
                                        build_poco_pare)
from poco_tpu_torch.smpl.assets import synthetic_smpl_model
from poco_tpu_torch.train.state import ModuleAdam
from poco_tpu_torch.train.step import TRAIN_STAGES, make_train_step
from poco_tpu_torch.utils import spans

REPO = Path(__file__).resolve().parents[1]
TINY = {"cliff": dict(backbone="tiny-cliff", num_neurons=(64,), context_dim=64),
        "pare": dict(backbone="tiny_pose-pare", num_neurons=(64,), context_dim=64)}
SMPL_SYNCS = (spans.SYNC_PARENTS, spans.SYNC_VERTEX_IDS, spans.SYNC_JOINT_MAP)
# (span, the span it opens in) of a request and of a train step
REQUEST_NESTING = collections.Counter([
    (spans.REQUEST, None), (spans.UPLOAD, spans.REQUEST), (spans.CROP, spans.REQUEST),
    (spans.SYNC_TRUE_HW, spans.CROP), (spans.SYNC_NORM, spans.CROP),
    (spans.BACKBONE, spans.REQUEST), (spans.HEAD, spans.REQUEST), (spans.SMPL, spans.REQUEST),
    *((s, spans.SMPL) for s in SMPL_SYNCS + (spans.SYNC_FOCAL,)),
    (spans.UNCERT, spans.REQUEST),
])
STEP_NESTING = collections.Counter([
    (spans.TRAIN_STEP, None), *((s, spans.TRAIN_STEP) for s in TRAIN_STAGES),
    *((s, "train_step/gt") for s in SMPL_SYNCS),
    *((s, "train_step/forward") for s in (spans.BACKBONE, spans.HEAD, spans.SMPL,
                                          spans.UNCERT, spans.FLOW)),
    *((s, spans.SMPL) for s in SMPL_SYNCS + (spans.SYNC_FOCAL,)),
    (spans.SYNC_FLOW_PARTS, spans.FLOW),
])


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module (see tests/test_torch_eval.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny_model(kind: str, device="cpu") -> POCO:
    torch.manual_seed(0)
    return POCO(PocoConfig(**TINY[kind])).to(device).eval()


def request(seed: int = 0, boxes: int = 3) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A 240x320 uint8 frame with `boxes` boxes, from numpy (as a client sends)."""
    rng = np.random.RandomState(seed)
    frame = rng.randint(0, 256, (240, 320, 3)).astype(np.uint8)
    centers = rng.uniform(80, 160, (boxes, 2)).astype(np.float32)
    scales = rng.uniform(0.5, 1.0, boxes).astype(np.float32)
    return frame, centers, scales


def train_batch(seed: int = 1, b: int = 2, device="cpu") -> dict[str, torch.Tensor]:
    """A train batch with every GT key of the loss (tests/test_torch_train.py's)."""
    rng = np.random.RandomState(seed)
    center = rng.uniform(300, 900, (b, 2))
    scale = rng.uniform(1.5, 3.0, b)
    focal = np.full(b, float(np.hypot(720, 1280)))
    batch = {
        "img": rng.randn(b, 224, 224, 3), "focal_length": focal, "scale": scale,
        "center": center, "orig_shape": np.tile([[720.0, 1280.0]], (b, 1)),
        "bbox_info": np.stack([(center[:, 0] - 640) / focal * 2.8,
                               (center[:, 1] - 360) / focal * 2.8,
                               (scale * 200 - 0.24 * focal) / (0.06 * focal)], 1),
        "pose": rng.uniform(-0.3, 0.3, (b, 72)), "betas": rng.uniform(-0.5, 0.5, (b, 10)),
        "has_smpl": np.ones(b), "has_pose_3d": np.asarray([1.0, 0.0] * b)[:b],
        "pose_3d": np.concatenate([0.3 * rng.randn(b, 24, 3), np.ones((b, 24, 1))], -1),
        "keypoints": rng.uniform(-1, 1, (b, 49, 3)),
        "keypoints_fullimg": np.concatenate(
            [center[:, None] + 60 * rng.randn(b, 49, 2), np.ones((b, 49, 1))], -1),
    }
    out = {k: torch.from_numpy(np.asarray(v, np.float32)).to(device) for k, v in batch.items()}
    out["gt_pose_cond_mask"] = torch.tensor([True, False] * b)[:b].to(device)
    return out


def step_of(model) -> callable:
    return make_train_step(model, ModuleAdam(model, lr=1e-4), LossConfig(keypoint2d_noncrop=True))


@pytest.fixture(scope="module")
def smpl():
    return synthetic_smpl_model(num_verts=96, device="cpu")


def nesting(records) -> collections.Counter:
    """(name, the name of the span it opened in) of every record."""
    by_id = {r.id: r for r in records}
    return collections.Counter(
        (r.name, by_id[r.parent].name if r.parent is not None else None) for r in records)


def test_stage_names_are_unchanged():
    assert TRAIN_STAGES == ("train_step/gt", "train_step/forward", "train_step/backward",
                            "train_step/optimizer")
    assert EVAL_STAGES == ("eval_step/forward", "eval_step/flip_tta", "eval_step/gt_meshes",
                           "eval_step/joints", "eval_step/metrics")
    names = spans.names()
    assert all(not names[s] for s in TRAIN_STAGES + EVAL_STAGES)
    assert {n for n, wait in names.items() if wait} == set(spans.WAITS)
    assert spans.AHEAD == "poco/ahead" and names[spans.AHEAD] is False


def test_off_opens_nothing(smpl, monkeypatch):
    """No profiler and no recording: a request and a train step make no
    span object, so they record nothing and open no profiler range."""
    made = []
    monkeypatch.setattr(spans, "_Span", lambda *a: made.append(a))
    model = tiny_model("cliff")
    detect_forward(model, smpl, *request())
    step_of(model)(train_batch(), smpl)
    assert made == [] and spans._records is None


@pytest.mark.parametrize("kind", ["cliff", "pare"])
def test_recorded_request(smpl, kind):
    """Two requests: exactly the request's spans, nested as the code nests
    them, every span of a request under that request's root."""
    model = tiny_model(kind)
    with spans.recording() as records:
        for seed in (0, 1):
            detect_forward(model, smpl, *request(seed))
    assert nesting(records) == collections.Counter({p: 2 * n for p, n in REQUEST_NESTING.items()})
    roots = [r for r in records if r.parent is None]
    assert [r.name for r in roots] == [spans.REQUEST] * 2
    for root in roots:
        inside = [r for r in records if r.root == root.id]
        assert len(inside) == REQUEST_NESTING.total()
        assert all(root.start_ns <= r.start_ns <= r.end_ns <= root.end_ns for r in inside)
    assert all(r.wait == (r.name in spans.WAITS) for r in records)
    assert len({r.thread for r in records}) == 1


def parent_projection(points, translation, focal_length, camera_center=None, rotation=None):
    """`ops/camera.py:perspective_projection` as it was: the focal length
    a tensor on the points' device."""
    assert rotation is None
    points = points + translation[:, None, :]
    proj = points[..., :2] / points[..., 2:3]
    f = torch.as_tensor(focal_length, dtype=points.dtype, device=points.device)
    if f.ndim == 0:
        f = f.expand(points.shape[0])
    proj = proj * f[:, None, None]
    if camera_center is not None:
        proj = proj + camera_center[:, None, :]
    return proj


@pytest.mark.parametrize("kind", ["cliff", "pare"])
def test_cpu_request_is_bitwise_as_before(smpl, kind, monkeypatch):
    """`detect_forward` on the CPU against the request made as before the
    constants were kept: `true_hw`, the ImageNet mean and std made from
    host numbers, the SMPL gathers by a list (parents), a tensor of the
    tuple (vertex ids) and of the int32 joint map, and the focal length a
    tensor. Every output bitwise."""
    from poco_tpu_torch.constants import IMG_NORM_MEAN, IMG_NORM_STD, JOINT_MAP_49
    from poco_tpu_torch.ops import preprocess
    from poco_tpu_torch.smpl import model as smpl_model

    model = tiny_model(kind)
    frame, centers, scales = request(3)
    got = detect_forward(model, smpl, frame, centers, scales)

    image, c, s = (torch.from_numpy(x) for x in (frame, centers, scales))
    true_hw = torch.tensor(frame.shape[:2], dtype=torch.float32)
    crops = preprocess.crop_and_resize(image, c, s * 200.0)
    mean = torch.tensor(IMG_NORM_MEAN, dtype=torch.float32)
    std = torch.tensor(IMG_NORM_STD, dtype=torch.float32)
    orig_shape = true_hw.expand(len(c), 2)
    batch = {"img": (crops / 255.0 - mean) / std,
             "bbox_info": preprocess.calculate_bbox_info(c, s, orig_shape),
             "focal_length": preprocess.calculate_focal_length(true_hw[0], true_hw[1]).expand(
                 len(c)),
             "scale": s, "center": c, "orig_shape": orig_shape}
    before = dataclasses.replace(smpl)
    for name, index in (("parent_index", list(smpl.parents[1:])),
                        ("vertex_joint_index", torch.as_tensor(smpl.vertex_joint_ids)),
                        ("joint_map_49", torch.as_tensor(JOINT_MAP_49))):
        object.__setattr__(before, name, index)
    monkeypatch.setattr(smpl_model, "perspective_projection", parent_projection)
    with torch.inference_mode():
        want = model(batch, before)
    assert type(got) is dict and got.keys() == want.keys()
    for key, value in want.items():
        assert (got[key] is None if value is None else torch.equal(got[key], value)), key


def test_recorded_train_step(smpl):
    """One step: the root `train_step`, its four stages in order, the
    model's parts under the forward stage, the SMPL syncs of the GT mesh
    under the GT stage; no span from autograd's threads."""
    model = tiny_model("cliff")
    step = step_of(model)
    with spans.recording() as records:
        step(train_batch(), smpl)
    assert nesting(records) == STEP_NESTING
    (root,) = [r for r in records if r.parent is None]
    assert root.name == spans.TRAIN_STEP and all(r.root == root.id for r in records)
    stages = sorted((r for r in records if r.name in TRAIN_STAGES), key=lambda r: r.start_ns)
    assert tuple(r.name for r in stages) == TRAIN_STAGES


def test_recorded_eval_step(smpl):
    """The eval step's stages are spans under their names."""
    model = tiny_model("cliff")
    batch = train_batch()
    batch["gender"] = torch.tensor([0, 1], dtype=torch.int32)
    with spans.recording() as records:
        make_gendered_eval_step(model, flip_test=True)(batch, smpl, smpl, smpl)
    roots = [r.name for r in records if r.parent is None]
    assert roots == list(EVAL_STAGES)


def test_profiler_ranges_nest_as_recorded(smpl):
    """Under torch.profiler every span is a range of its name, and the
    innermost span range around each is the span it was recorded in."""
    from torch.profiler import ProfilerActivity, profile

    model = tiny_model("cliff")
    step = step_of(model)
    with profile(activities=[ProfilerActivity.CPU]) as prof, spans.recording() as records:
        detect_forward(model, smpl, *request())
        step(train_batch(), smpl)
    names = spans.names()
    ranges = sorted((e for e in prof.events() if e.name in names),
                    key=lambda e: (e.time_range.start, -e.time_range.end))
    found = collections.Counter()
    for i, e in enumerate(ranges):
        around = [o for o in ranges[:i] if o.thread == e.thread
                  and o.time_range.start <= e.time_range.start
                  and e.time_range.end <= o.time_range.end]
        found[(e.name, around[-1].name if around else None)] += 1
    assert found == nesting(records)
    assert len(ranges) == len(records)


def test_export_holds_no_profiler_op(smpl, tmp_path):
    """An artifact exported while spans record and a profiler runs: its
    graph calls no profiler op, and the only spans recorded are those of
    the one eager forward that reads the output keys after the export."""
    from torch.profiler import ProfilerActivity, profile

    from poco_tpu_torch.runtime.export import PROGRAM_NAME, export_poco

    model = tiny_model("cliff")
    with profile(activities=[ProfilerActivity.CPU]), spans.recording() as records:
        export_poco(model, smpl, str(tmp_path / "art"), batch_sizes=(2,), device="cpu")
    eager_forward = [spans.BACKBONE, spans.HEAD, spans.SMPL, *SMPL_SYNCS, spans.SYNC_FOCAL,
                     spans.UNCERT]
    assert sorted(r.name for r in records) == sorted(eager_forward)
    program = torch.export.load(str(tmp_path / "art" / PROGRAM_NAME))
    targets = [str(node.target)
               for module in program.graph_module.modules()
               if isinstance(module, torch.fx.GraphModule)
               for node in module.graph.nodes if node.op == "call_function"]
    assert targets and not [t for t in targets if "profiler" in t or "record_function" in t]


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def unwaited_syncs(run) -> list[str]:
    """Every synchronizing call of `run()` (torch's sync debug mode) that
    no open `wait=True` span holds, by the spans open at the call."""
    found = []

    def hook(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" not in str(message):
            return
        open_spans = list(spans._stack())
        if not any(s.wait for s in open_spans):
            found.append(" > ".join(s.name for s in open_spans) or "no span")

    with spans.recording(), warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return found


def full_width(kind: str, device) -> POCO:
    torch.manual_seed(0)
    return (build_poco_cliff if kind == "cliff" else build_poco_pare)(device=device).eval()


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["cliff", "pare"])
def test_request_syncs_only_in_wait_spans(cuda, kind):
    model = full_width(kind, cuda)
    smpl = synthetic_smpl_model(num_verts=6890, device=cuda)
    frame, centers, scales = request(boxes=8)
    detect_forward(model, smpl, frame, centers, scales)   # cuDNN's first calls
    assert unwaited_syncs(lambda: [detect_forward(model, smpl, frame, centers, scales)
                                   for _ in range(2)]) == []


@pytest.mark.gpu
def test_train_step_syncs_only_in_wait_spans(cuda):
    model = full_width("cliff", cuda)
    smpl = synthetic_smpl_model(num_verts=6890, device=cuda)
    step = step_of(model)
    batch = train_batch(b=4, device=cuda)
    step(batch, smpl)
    assert unwaited_syncs(lambda: [step(batch, smpl) for _ in range(2)]) == []


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["cliff", "pare"])
def test_model_spans_carry_the_benchmarks_device_time(cuda, kind):
    """One profiled stretch of 3 requests of 32 boxes: the device time
    under each of the program's model spans is that under the benchmark's
    forward hook on the same module, within 1%."""
    sys.path.insert(0, str(REPO / "gpubench"))
    try:
        from bench import trace
    finally:
        sys.path.remove(str(REPO / "gpubench"))
    model = full_width(kind, cuda)
    smpl = synthetic_smpl_model(num_verts=6890, device=cuda)
    frame, centers, scales = request(boxes=32)
    detect_forward(model, smpl, frame, centers, scales)
    with trace.layer_ranges(model):
        summary = trace.profile_stretch(
            lambda: [detect_forward(model, smpl, frame, centers, scales) for _ in range(3)],
            cuda)
    ranges = summary["ranges_s"]
    for ours, theirs in ((spans.BACKBONE, "gpubench/backbone"), (spans.HEAD, "gpubench/head"),
                         (spans.UNCERT, "gpubench/uncert_head")):
        assert summary["calls"][ours] == summary["calls"][theirs] == 3
        assert ranges[ours] == pytest.approx(ranges[theirs], rel=0.01), ours


@pytest.mark.gpu
def test_hmr2_spans_carry_the_benchmarks_device_time(cuda):
    """HMR 2.0 at full width, one profiled stretch of 3 requests of 32
    boxes: `poco/backbone` and `poco/head` carry the device time of the
    benchmark's hooks within 1%; each request opens 32 `poco/vit_attention`
    and 32 `poco/vit_mlp` spans and launches `skinning` once."""
    sys.path.insert(0, str(REPO / "gpubench"))
    try:
        from bench import trace
    finally:
        sys.path.remove(str(REPO / "gpubench"))
    torch.manual_seed(0)
    model = build_hmr2(device=cuda)
    smpl = synthetic_smpl_model(num_verts=6890, device=cuda)
    frame, centers, scales = request(boxes=32)
    detect_forward(model, smpl, frame, centers, scales)
    with trace.layer_ranges(model):
        summary = trace.profile_stretch(
            lambda: [detect_forward(model, smpl, frame, centers, scales) for _ in range(3)],
            cuda)
    ranges, calls = summary["ranges_s"], summary["calls"]
    for ours, theirs in ((spans.BACKBONE, "gpubench/backbone"), (spans.HEAD, "gpubench/head")):
        assert calls[ours] == calls[theirs] == 3
        assert ranges[ours] == pytest.approx(ranges[theirs], rel=0.01), ours
    assert calls[spans.VIT_ATTENTION] == calls[spans.VIT_MLP] == 32 * 3
    assert calls["poco_tpu_torch::skinning"] == 3


def fetch(out) -> dict[str, np.ndarray]:
    """A request's outputs in host memory, as a client fetches them."""
    return {k: v.cpu().numpy() for k, v in out.items() if v is not None}


@pytest.fixture(scope="module")
def card_smpl():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return synthetic_smpl_model(num_verts=6890, device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["cliff", "pare"])
def test_request_never_syncs(cuda, card_smpl, kind):
    """After a warm-up, a 128-box request from numpy dispatches without one
    synchronizing call: sync debug mode "error" raises at any."""
    model = full_width(kind, cuda)
    frame, centers, scales = request(boxes=128)
    fetch(detect_forward(model, card_smpl, frame, centers, scales))
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = detect_forward(model, card_smpl, frame, centers, scales)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert np.isfinite(fetch(out)["smpl_vertices"]).all()


@pytest.mark.gpu
def test_train_step_never_syncs(cuda, card_smpl):
    """After a warm-up, a POCO-CLIFF train step at batch 4 runs without one
    synchronizing call."""
    model = full_width("cliff", cuda)
    step = step_of(model)
    batch = train_batch(b=4, device=cuda)
    step(batch, card_smpl)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        metrics = step(batch, card_smpl)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(metrics["loss/total_loss"]))
    assert bool(torch.isfinite(metrics["grad_norm"]))


@pytest.mark.gpu
def test_fetch_after_the_next_dispatch_is_bitwise(cuda, card_smpl):
    """Request N fetched after N+1 was dispatched (the depth-1 client) gives
    bitwise what N fetched at once gives."""
    model = full_width("cliff", cuda)
    first, second = request(0, boxes=128), request(1, boxes=128)
    at_once = fetch(detect_forward(model, card_smpl, *first))
    pending = detect_forward(model, card_smpl, *first)
    following = detect_forward(model, card_smpl, *second)
    late = fetch(pending)
    assert late.keys() == at_once.keys()
    for key in at_once:
        assert np.array_equal(late[key], at_once[key], equal_nan=True), key
    assert np.isfinite(fetch(following)["smpl_vertices"]).all()


@pytest.mark.gpu
def test_outputs_read_on_the_callers_stream_outlive_the_next_request(cuda, card_smpl):
    """An output read on the caller's stream behind a long sleep there, and
    freed at once, while the next request runs from a thread whose stream
    does not wait on the caller's: the read sees the output's own values
    (`record_stream` holds the memory until the caller's stream passes the
    free), not the next request's."""
    model = full_width("cliff", cuda)
    frame, centers, scales = request(0, boxes=128)
    other = request(1, boxes=128)
    want = fetch(detect_forward(model, card_smpl, frame, centers, scales))["smpl_vertices"]
    out = detect_forward(model, card_smpl, frame, centers, scales)
    vertices = out["smpl_vertices"]
    torch.cuda._sleep(2_000_000_000)   # ~1 s of the caller's stream
    read = vertices * 1.0
    del out, vertices

    def next_request():
        with torch.cuda.stream(torch.cuda.Stream()):
            fetch(detect_forward(model, card_smpl, *other))

    thread = threading.Thread(target=next_request)
    thread.start()
    thread.join()
    torch.cuda.synchronize()
    assert np.array_equal(read.cpu().numpy(), want)


@pytest.mark.gpu
def test_depth_one_requests_run_ahead(cuda, card_smpl):
    """Five 128-box requests of POCO-CLIFF, each dispatched before the one
    before it is fetched (the frames cells' client): the later four start
    while the card is still running the request before, so they open
    `poco/ahead` under their own root; the first, after a drained card,
    does not."""
    model = full_width("cliff", cuda)
    frame, centers, scales = request(0, boxes=128)
    fetch(detect_forward(model, card_smpl, frame, centers, scales))
    torch.cuda.synchronize()
    with spans.recording() as records:
        pending = None
        for _ in range(5):
            current = detect_forward(model, card_smpl, frame, centers, scales)
            if pending is not None:
                fetch(pending)
            pending = current
        fetch(pending)
    by_id = {r.id: r for r in records}
    ahead = [r for r in records if r.name == spans.AHEAD]
    assert len(ahead) == 4
    for r in ahead:
        assert by_id[r.parent].name == spans.REQUEST and r.root == r.parent
        assert r.end_ns - r.start_ns < 1_000_000
