"""The program's spans read for the benchmark (`bench/spans.py`,
`spans_report.py`): the host table from hand-made records, launches and
idle gaps by span from a canned event list, `trace.summarize` unchanged
on that list, and a whole run of a tiny cell read by its spans on the CPU."""

from __future__ import annotations

import time

import pytest
from test_gpubench_metrics import EVENTS, cpu, gpu

from bench import spans, trace
from poco_tpu_torch.utils.spans import Record

MS = 1_000_000   # ns


def rec(name, id, parent, root, start_ms, end_ms, wait=False):
    return Record(name, id, parent, root, wait, 1, int(start_ms * MS), int(end_ms * MS))


def request(first_id, t0, upload_ms, backbone_ms):
    """A request of 10 ms + upload + backbone: upload (a wait), crop 1 ms
    holding a 0.5-ms wait, backbone."""
    i, t = first_id, t0
    return [
        rec("poco/upload", i + 1, i, i, t, t + upload_ms, wait=True),
        rec("sync/norm_constants", i + 3, i + 2, i, t + upload_ms, t + upload_ms + 0.5, wait=True),
        rec("poco/crop", i + 2, i, i, t + upload_ms, t + upload_ms + 1),
        rec("poco/backbone", i + 4, i, i, t + upload_ms + 1, t + upload_ms + 1 + backbone_ms),
        rec("poco/request", i, None, i, t, t + upload_ms + backbone_ms + 10),
    ]


def test_host_table():
    records = (request(1, 0, 2, 100) + request(10, 200, 4, 120) + request(20, 400, 6, 110)
               + [rec("decode", 30, None, 30, 600, 700)])   # not a request or a step
    table = spans.host_table(records)
    assert table["roots"] == {"poco/request": {
        "launch_ms": pytest.approx(120 - 0.5), "wait_ms": pytest.approx(4.5), "roots": 3}}
    assert table["spans"]["poco/request"]["host_ms"] == pytest.approx(126)   # of 112, 134, 126
    assert table["spans"]["poco/request"]["self_ms"] == pytest.approx(9)
    assert table["spans"]["poco/crop"] == {"host_ms": pytest.approx(1),
                                           "self_ms": pytest.approx(0.5), "calls": 1}
    assert "decode" not in table["spans"]


def test_host_table_counts_a_wait_inside_a_wait_once():
    records = [rec("sync/joint_map_49", 3, 2, 1, 1, 2, wait=True),
               rec("poco/upload", 2, 1, 1, 0, 4, wait=True),
               rec("train_step", 1, None, 1, 0, 10)]
    assert spans.host_table(records)["roots"]["train_step"] == {
        "launch_ms": pytest.approx(6), "wait_ms": pytest.approx(4), "roots": 1}


def test_device_by_span():
    """The canned request of `test_gpubench_metrics` with program spans
    beside the benchmark's ranges: launches a range, and every idle gap by
    the innermost program span open at its start."""
    events = EVENTS + [
        cpu("poco/request", 0, 400), cpu("poco/upload", 1, 14),
        cpu("poco/crop", 14, 40), cpu("poco/backbone", 60, 300),
        cpu("poco/smpl", 380, 395), cpu("other thread's span", 0, 1000, thread=2),
    ]
    names = {"poco/request": False, "poco/upload": True, "poco/crop": False,
             "poco/backbone": False, "poco/smpl": False}
    out = spans.device_by_span(events, names)
    assert out["launches"]["poco/request"] == 5
    assert out["launches"][trace.REQUEST] == 5
    assert out["launches"]["poco/backbone"] == 1
    assert out["launches"]["poco/crop"] == 0   # the crop kernel's op starts in the upload
    assert out["launches"]["poco/upload"] == 1
    # idle 0-15, 35-110, 310-320, 370-371, 381-390 and 410-1000
    assert out["idle_by_span"] == {
        "poco/request": pytest.approx(26e-6), "poco/crop": pytest.approx(75e-6),
        "poco/smpl": pytest.approx(9e-6), spans.OUTSIDE: pytest.approx(590e-6)}
    assert sum(out["idle_by_span"].values()) == pytest.approx(1000e-6 - 300e-6)
    assert spans.host_idle_s(out["idle_by_span"], names) == pytest.approx(110e-6)


def test_device_by_span_without_a_stretch_reads_nothing():
    assert spans.device_by_span([cpu("poco/request", 0, 10), gpu("k", 0, 5)], {}) == {}


def test_summarize_keeps_its_keys():
    """`trace.summarize` on the canned list, every key and value."""
    assert trace.summarize(EVENTS) == {
        "window_s": pytest.approx(1000e-6), "busy_s": pytest.approx(300e-6),
        "ranges_s": {
            trace.STRETCH: pytest.approx(300e-6), trace.REQUEST: pytest.approx(300e-6),
            trace.MODEL: pytest.approx(280e-6), "gpubench/backbone": pytest.approx(200e-6),
            "gpubench/head": pytest.approx(50e-6), "gpubench/uncert_head": pytest.approx(10e-6),
            "poco_tpu_torch::skinning": pytest.approx(20e-6)},
        "calls": {trace.STRETCH: 1, trace.REQUEST: 1, trace.MODEL: 1, "gpubench/backbone": 1,
                  "gpubench/head": 1, "gpubench/uncert_head": 1,
                  "poco_tpu_torch::skinning": 1},
        "device_ops": [["conv_kernel", pytest.approx(200e-6)],
                       ["gemm_kernel", pytest.approx(50e-6)],
                       ["crop_kernel", pytest.approx(20e-6)],
                       ["skin_tc_kernel", pytest.approx(20e-6)],
                       ["uncert_kernel", pytest.approx(10e-6)]],
        "idle_gaps": [["outside any range", pytest.approx(590e-6)],
                      [trace.REQUEST, pytest.approx(75e-6)],
                      [trace.REQUEST, pytest.approx(15e-6)],
                      ["gpubench/head", pytest.approx(10e-6)],
                      [trace.MODEL, pytest.approx(9e-6)],
                      ["gpubench/uncert_head", pytest.approx(1e-6)]],
    }


def test_span_names_are_the_programs():
    names = spans.span_names()
    assert set(spans.ROOTS) <= set(names)
    assert names["poco/upload"] and not names["poco/request"]


def test_report_of_a_tiny_run(tiny_root, narrow_hrnet):
    """A tiny frames cell, recorded and traced on the CPU: `correct`, the
    host table over its requests, and the traced stretch's launches and
    idle gaps by span (no device here: nought launches, all idle)."""
    import spans_report

    line = spans_report.report("tiny_cliff_frames_b128", 2**31 + 97, 0.5, True, True, "cpu",
                               tiny_root, time.perf_counter())
    assert line["correct"]
    roots = line["host"]["roots"]["poco/request"]
    assert roots["roots"] >= 4 and 0 < roots["launch_ms"] and 0 < roots["wait_ms"]
    assert {"poco/backbone", "poco/upload", "sync/joint_map_49"} <= set(line["host"]["spans"])
    assert line["launches"]["poco/request"] == 0
    assert set(line["idle_by_span_ms"]) == {spans.OUTSIDE} and line["host_idle_ms"] == 0
    assert trace.summarize is not None and trace.summarize.__name__ == "summarize"
