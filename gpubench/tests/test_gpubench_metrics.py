"""The reduction of a profiler trace to per-layer metrics, on a canned
list of events: ranges, self time, busy and idle time, the idle gaps'
names, rooflines and `mfu`."""

from __future__ import annotations

import types

import pytest
from torch.autograd import DeviceType

from bench import manifest, peaks, trace

H100 = peaks.PEAKS["NVIDIA H100 80GB HBM3"]


def cpu(name, start, end, thread=1, kernels=()):
    return types.SimpleNamespace(
        name=name, device_type=DeviceType.CPU, thread=thread,
        time_range=types.SimpleNamespace(start=start, end=end),
        kernels=[types.SimpleNamespace(name=k, duration=d) for k, d in kernels])


def gpu(name, start, end):
    return types.SimpleNamespace(name=name, device_type=DeviceType.CUDA, thread=0,
                                 time_range=types.SimpleNamespace(start=start, end=end),
                                 kernels=[])


# one request in a stretch of 1000 us: crop 20 us, backbone 200, head 50,
# uncertainty 10, skinning 20 (launched by an op inside the custom op)
EVENTS = [
    cpu(trace.STRETCH, 0, 1000),
    cpu(trace.REQUEST, 0, 400), cpu(trace.MODEL, 50, 395),
    cpu("gpubench/backbone", 60, 300), cpu("gpubench/head", 300, 350),
    cpu("gpubench/uncert_head", 350, 380),
    cpu("aten::copy_", 10, 12, kernels=[("crop_kernel", 20)]),
    cpu("aten::convolution", 100, 105, kernels=[("conv_kernel", 200)]),
    # the profiler's overhead event credited with the same kernel: skipped
    cpu("Command Buffer Full", 101, 104, kernels=[("conv_kernel", 200)]),
    cpu("aten::addmm", 320, 322, kernels=[("gemm_kernel", 50)]),
    cpu("aten::linear", 360, 361, kernels=[("uncert_kernel", 10)]),
    cpu("poco_tpu_torch::skinning", 382, 390), cpu("poco_tpu_torch::skinning", 383, 389),
    cpu("cudaLaunchKernel", 384, 385, kernels=[("skin_tc_kernel", 20)]),
    gpu("crop_kernel", 15, 35), gpu("conv_kernel", 110, 310), gpu("gemm_kernel", 320, 370),
    gpu("uncert_kernel", 371, 381), gpu("skin_tc_kernel", 390, 410),
    gpu(trace.REQUEST, 0, 400),   # the range's mirror on the device: not a kernel
]


@pytest.fixture
def summary():
    s = trace.summarize(EVENTS)
    s.update(requests=1, rows=128, flops_per_call=1e12, calls_per_s=10.0, peaks=H100,
             skinning_shape=(128, 6890))
    return s


def read(name, summary):
    return manifest.metric_reader(name)(summary)


def test_ranges_and_busy(summary):
    assert summary["window_s"] == pytest.approx(1000e-6)
    assert summary["busy_s"] == pytest.approx(300e-6)
    assert summary["ranges_s"][trace.REQUEST] == pytest.approx(300e-6)
    assert summary["ranges_s"][trace.MODEL] == pytest.approx(280e-6)
    # the custom op's nested dispatch counts once
    assert summary["calls"]["poco_tpu_torch::skinning"] == 1
    assert summary["ranges_s"]["poco_tpu_torch::skinning"] == pytest.approx(20e-6)
    assert summary["device_ops"][0] == ["conv_kernel", pytest.approx(200e-6)]
    assert summary["idle_gaps"][0] == ["outside any range", pytest.approx(590e-6)]
    assert summary["idle_gaps"][1] == ["gpubench/request", pytest.approx(75e-6)]


@pytest.mark.parametrize("metric, expected", [
    ("crop_ms.infer", 0.020), ("backbone_ms.infer", 0.200), ("head_ms.infer", 0.050),
    ("uncert_ms.infer", 0.010), ("smpl_ms.infer", 0.020),
    ("device_idle_share.infer", 70.0),
    ("skinning_roofline.infer", 100 * peaks.skinning_bound_s(128, 6890, H100) / 20e-6),
    ("mfu.infer", 100 * 1e13 / (494.7e12 / 3)),
])
def test_readers(summary, metric, expected):
    assert read(metric, summary) == pytest.approx(expected)


def test_train_readers():
    events = [
        cpu(trace.STRETCH, 0, 1000),
        cpu("train_step/gt", 0, 100), cpu("train_step/forward", 100, 400),
        cpu("train_step/backward", 400, 900), cpu("train_step/optimizer", 900, 990),
        cpu("aten::mm", 50, 51, kernels=[("k", 10)]),
        cpu("aten::conv", 200, 201, kernels=[("k", 300)]),
        # autograd's own thread launches the backward's kernels
        cpu("poco_tpu_torch::skinning_backward", 500, 520, thread=2),
        cpu("cudaLaunchKernel", 505, 506, thread=2, kernels=[("grad_tc_kernel", 40)]),
        cpu("aten::conv_backward", 600, 601, thread=2, kernels=[("k", 400)]),
        cpu("Optimizer.step#Adam.step", 910, 980, kernels=[("adam", 5)]),
        gpu("k", 60, 70), gpu("k", 210, 510), gpu("grad_tc_kernel", 510, 550),
        gpu("k", 550, 950), gpu("adam", 950, 955),
    ]
    s = trace.summarize(events)
    s.update(requests=1, peaks=H100, skinning_backward_shape=(64, 6890))
    assert read("gt_ms.train", s) == pytest.approx(0.010)
    assert read("forward_ms.train", s) == pytest.approx(0.300)
    assert read("backward_ms.train", s) == pytest.approx(0.440)
    assert read("optimizer_ms.train", s) == pytest.approx(0.005)
    assert read("device_idle_share.train", s) == pytest.approx(100 * (1 - 755 / 1000))
    assert read("skinning_backward_roofline.train", s) == pytest.approx(
        100 * peaks.backward_bound_s(64, 6890, H100) / 40e-6)
    assert read("mfu.train", s) is None   # no FLOPs counted: nothing to read


def test_no_device_trace_reads_nothing():
    s = trace.summarize([e for e in EVENTS if e.device_type == DeviceType.CPU])
    s.update(requests=1, peaks=None, skinning_shape=(128, 6890))
    for metric in ("crop_ms.infer", "backbone_ms.infer", "skinning_roofline.infer",
                   "device_idle_share.infer", "mfu.infer"):
        assert read(metric, s) is None
