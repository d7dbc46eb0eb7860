"""PyTorch port vs JAX package: pose tracking (`utils/pose_tracker.py`) and
the demo's `--tracking_method pose`.

  * `read_posetrack_keypoints` on seeded posetrack JSON (people coming and
    going, ids as lists and as numbers, negative ids, frames without
    people): the tracklets equal the JAX package's exactly;
  * `run_posetracker` with a STAF folder runs its `openpose.bin` (here a
    stub that records its arguments and writes JSON) with the JAX
    package's command line, in the STAF folder, and parses what it wrote;
    without one it reads existing JSON and runs nothing;
  * `python -m poco_tpu_torch.cli.demo --mode video --tracking_method
    pose` on the CPU reads the JSON under `<output_folder>/posetrack` and
    renders every frame of the tracks (boxes from the keypoints);
    `PocoTester.run_on_video` on keypoint tracks (no `bbox`) matches the
    JAX tester's at tests/test_torch_demo.py's bars.
"""

import json
import os
import stat
import sys

import numpy as np
import pytest
import torch

from poco_tpu.utils import pose_tracker as jax_pose_tracker

from poco_tpu_torch.cli import demo as cli_demo
from poco_tpu_torch.utils import pose_tracker

from .test_torch_demo import (  # noqa: F401
    TINY_YAML, _assert_video_results_close, frame_folder, testers,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module (see
    tests/test_torch_eval.py). Restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def write_posetrack(folder, frames: int, seed: int = 0, hw=(240, 320)) -> None:
    """Seeded OpenPose/STAF JSON, one file a frame (BODY_21A: 21 joints):
    person 0 in every frame, person 3 from frame 1 (its id a bare
    number), an untracked person (-1) in frame 0 and nobody in the last
    frame but one when there are more than two frames."""
    rng = np.random.RandomState(seed)
    os.makedirs(folder, exist_ok=True)
    h, w = hw
    center = np.float32([w / 2, h / 2])
    for t in range(frames):
        people = []
        if not (frames > 2 and t == frames - 2):
            joints = center + rng.uniform(-0.3, 0.3, (21, 2)) * [w, h]
            kp = np.concatenate([joints, rng.uniform(0.5, 1.0, (21, 1))], 1)
            people.append({"person_id": [0], "pose_keypoints_2d": kp.ravel().tolist()})
            if t >= 1:
                people.append({"person_id": 3, "pose_keypoints_2d": kp.ravel().tolist()})
        if t == 0:
            people.append({"person_id": [-1], "pose_keypoints_2d": [0.0] * 63})
        with open(os.path.join(folder, f"frame_{t:012d}_keypoints.json"), "w") as f:
            json.dump({"version": 1.3, "people": people}, f)


def _same_tracks(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for pid in want:
        assert got[pid].keys() == want[pid].keys()
        for key in want[pid]:
            np.testing.assert_array_equal(got[pid][key], want[pid][key])
            assert got[pid][key].dtype == want[pid][key].dtype


@pytest.mark.parametrize("frames", [1, 2, 6])
def test_read_posetrack_keypoints_matches_jax(tmp_path, frames):
    write_posetrack(tmp_path, frames, seed=frames)
    got = pose_tracker.read_posetrack_keypoints(str(tmp_path))
    _same_tracks(got, jax_pose_tracker.read_posetrack_keypoints(str(tmp_path)))
    assert got[0]["joints2d"].shape[1:] == (21, 3)


def _stub_staf(root) -> str:
    """A STAF folder whose openpose.bin records its arguments and working
    directory and writes three frames of JSON into --write_json."""
    binary = root / "build" / "examples" / "openpose" / "openpose.bin"
    binary.parent.mkdir(parents=True)
    binary.write_text(
        f"#!{sys.executable}\n"
        "import json, os, sys\n"
        "sys.path.insert(0, os.environ['POSE_TEST_DIR'])\n"
        "from test_torch_pose_tracker_stub import write\n"
        "args = sys.argv[1:]\n"
        "with open(os.environ['POSE_TEST_LOG'], 'a') as f:\n"
        "    f.write(json.dumps({'args': args, 'cwd': os.getcwd()}) + '\\n')\n"
        "write(args[args.index('--write_json') + 1])\n"
    )
    binary.chmod(binary.stat().st_mode | stat.S_IXUSR)
    return str(root)


@pytest.mark.parametrize("source", ["frames", "clip.mp4"])
def test_run_posetracker_runs_the_staf_binary_as_jax_does(tmp_path, monkeypatch, source):
    """With a STAF folder both packages run `openpose.bin` with the same
    arguments (`--video` for an .mp4, else `--image_dir`), in the STAF
    folder, then parse its JSON to the same tracks."""
    (tmp_path / "stub").mkdir()
    (tmp_path / "stub" / "test_torch_pose_tracker_stub.py").write_text(
        "import sys\n"
        f"sys.path.insert(0, {os.path.dirname(os.path.dirname(os.path.abspath(__file__)))!r})\n"
        "from tests.test_torch_pose_tracker import write_posetrack\n"
        "def write(folder):\n"
        "    write_posetrack(folder, 3, seed=5)\n")
    log = tmp_path / "calls.jsonl"
    monkeypatch.setenv("POSE_TEST_DIR", str(tmp_path / "stub"))
    monkeypatch.setenv("POSE_TEST_LOG", str(log))
    staf = _stub_staf(tmp_path / "staf")
    video = str(tmp_path / source)
    out = str(tmp_path / "posetrack")
    got = pose_tracker.run_posetracker(video, staf_folder=staf, posetrack_output_folder=out)
    want = jax_pose_tracker.run_posetracker(video, staf_folder=staf,
                                            posetrack_output_folder=out)
    calls = [json.loads(line) for line in log.read_text().splitlines()]
    assert len(calls) == 2 and calls[0] == calls[1]
    assert calls[0]["cwd"] == staf
    flag = "--video" if source.endswith(".mp4") else "--image_dir"
    assert calls[0]["args"] == ["--model_pose", "BODY_21A", "--tracking", "1", "--render_pose",
                                "0", flag, video, "--write_json", out, "--display", "0"]
    _same_tracks(got, want)
    assert sorted(got) == [0, 3]


def test_run_posetracker_without_staf_reads_existing_json(tmp_path):
    write_posetrack(tmp_path / "pt", 4, seed=2)
    got = pose_tracker.run_posetracker(str(tmp_path / "frames"),
                                       posetrack_output_folder=str(tmp_path / "pt"))
    _same_tracks(got, jax_pose_tracker.read_posetrack_keypoints(str(tmp_path / "pt")))


def test_run_posetracker_needs_its_output_folder(tmp_path):
    """The output folder has no default (the JAX package's is a fixed path
    outside the checkout): leaving it out is an error, before any binary
    runs or any folder is made."""
    with pytest.raises(TypeError, match="posetrack_output_folder"):
        pose_tracker.run_posetracker(str(tmp_path / "frames"), staf_folder=str(tmp_path))
    assert list(tmp_path.iterdir()) == []


def test_video_on_keypoint_tracks_matches_jax(testers, frame_folder, tmp_path):  # noqa: F811
    """`run_on_video` on keypoint tracks (no `bbox`: the boxes come from
    the smoothed keypoints) against the JAX tester on the same tracks."""
    port, ref = testers
    write_posetrack(tmp_path / "pt", 4, seed=7)
    tracks = pose_tracker.read_posetrack_keypoints(str(tmp_path / "pt"))
    assert all("bbox" not in t for t in tracks.values())
    got = port.run_on_video(frame_folder, tracks=tracks)
    want = ref.run_on_video(frame_folder, tracks=tracks)
    assert want and all(len(r["frame_ids"]) for r in want.values())
    _assert_video_results_close(got, want)


def test_cli_video_with_pose_tracking(frame_folder, tmp_path, capsys):  # noqa: F811
    """`cli.demo --mode video --tracking_method pose --device cpu`: the
    tracks are the JSON's people, and every frame renders."""
    out = tmp_path / "video"
    write_posetrack(out / "posetrack", 4, seed=7)
    results = cli_demo.main(["--cfg", TINY_YAML, "--mode", "video", "--image_folder",
                             frame_folder, "--output_folder", str(out), "--tracking_method",
                             "pose", "--device", "cpu"])
    assert sorted(results) == [0, 3]
    assert sorted(os.listdir(out / "rendered")) == [f"{i:06d}.png" for i in range(4)]
    assert not (out / "tracking_results.pkl").exists()
    assert "poco FPS" in capsys.readouterr().out
