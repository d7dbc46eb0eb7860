"""PyTorch port vs JAX package: the webcam-replay stream
(`poco_tpu_torch/demo/stream.py`) and `cli.demo --mode webcam`.

`run_stream` over a 4-frame replay directory, the JAX `_tiny_tester` and
the port's twin on the same weights (tests/test_torch_demo.py's
`testers`): every frame's result after the stream's One-Euro smoothing
(vertices and 3D joints within one fp16 ulp, orig_cam within 2e-3
relative, var within 2e-3: `_assert_result_close`) and the written
`stream_%06d.png` frames at the renderer's bar. The JAX stream pads each
frame to a 256-px bucket for XLA; the port dispatches frames at their
own size, and the results agree all the same. In the port, the
pipelined and the sequential stream give bit-identical results and
frames. Camera and stream-URL sources raise, naming the ROADMAP item.
"""

import os

import numpy as np
import pytest
import torch

from poco_tpu.demo import stream as jax_stream

from poco_tpu_torch.cli import demo as cli_demo
from poco_tpu_torch.demo import stream

from .test_torch_demo import (  # noqa: F401  (fixtures)
    TINY_YAML,
    _assert_frames_close,
    _assert_result_close,
    frame_folder,
    testers,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module (see tests/test_torch_eval.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _recorded_stream(run, module, tester, folder, out, **kwargs):
    """run_stream with every finalized result recorded (the dicts the
    stream smooths in place)."""
    results = []
    finalize = tester.infer_frame_finalize

    def recording(handle):
        result = finalize(handle)
        results.append(result)
        return result

    tester.infer_frame_finalize = recording
    try:
        stats = run(tester, module.DirectoryFrameSource(folder), output_folder=out, **kwargs)
    finally:
        del tester.infer_frame_finalize
    return stats, results


def test_run_stream_matches_jax(testers, frame_folder, tmp_path):
    port, ref = testers
    got_stats, got = _recorded_stream(stream.run_stream, stream, port, frame_folder,
                                      str(tmp_path / "port"))
    want_stats, want = _recorded_stream(jax_stream.run_stream, jax_stream, ref, frame_folder,
                                        str(tmp_path / "jax"))
    assert got_stats["frames"] == want_stats["frames"] == 4
    assert got_stats["detections"] == want_stats["detections"] == 4
    assert set(got_stats) == set(want_stats)
    assert len(got) == len(want) == 4
    for g, r in zip(got, want):
        _assert_result_close(g, r)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == [
        f"stream_{i:06d}.png" for i in range(4)]
    for name in names:
        _assert_frames_close(tmp_path / "port" / name, tmp_path / "jax" / name)


def test_pipelined_and_sequential_streams_are_bit_identical(testers, frame_folder, tmp_path):
    port, _ = testers
    runs = {}
    for pipeline in (True, False):
        out = tmp_path / str(pipeline)
        stats, results = _recorded_stream(stream.run_stream, stream, port, frame_folder,
                                          str(out), pipeline=pipeline)
        assert stats["pipelined"] is pipeline and stats["frames"] == 4
        frames = {n: (out / n).read_bytes() for n in sorted(os.listdir(out))}
        runs[pipeline] = (results, frames)
    (a, fa), (b, fb) = runs[True], runs[False]
    assert fa == fb and len(fa) == 4
    for ra, rb in zip(a, b):
        assert ra.keys() == rb.keys()
        for k in ra:
            if ra[k] is None:
                assert rb[k] is None
            else:
                np.testing.assert_array_equal(ra[k], rb[k], err_msg=k)


def test_open_source_refuses_cameras_and_urls(frame_folder):
    assert len(stream.open_source(frame_folder, max_frames=2).files) == 2
    for spec in ("0", "webcam:1", "rtsp://camera/stream"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue A item 4"):
            stream.open_source(spec)


def test_cli_webcam_replays_a_directory(frame_folder, tmp_path, capsys):
    for flags in ([], ["--stream_sequential"]):
        stats = cli_demo.main(["--cfg", TINY_YAML, "--mode", "webcam", "--webcam_source",
                               frame_folder, "--output_folder", str(tmp_path / str(len(flags))),
                               "--max_frames", "3", "--device", "cpu", *flags])
        assert stats["frames"] == 3 and stats["pipelined"] is not flags
        assert sorted(os.listdir(tmp_path / str(len(flags)))) == [
            f"stream_{i:06d}.png" for i in range(3)]
    assert "poco stream: 3 frames" in capsys.readouterr().out
