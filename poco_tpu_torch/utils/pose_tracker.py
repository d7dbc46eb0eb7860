"""Keypoint-based person tracking from OpenPose/STAF-style JSON output
(port of `poco_tpu.utils.pose_tracker`, whole).

Reference contract: pocolib/utils/pose_tracker.py:25-179 — shells out to
the OpenPose/STAF binary, then parses per-frame posetrack JSON into
per-person keypoint tracklets. The binary runs as a subprocess only when
a STAF folder is given (the same command line as the JAX package's); the
JSON parsing and tracklet assembly are self-contained, so precomputed
keypoint dumps work without OpenPose installed. `cli.demo --mode video
--tracking_method pose` reads its tracks here; `PocoTester.run_on_video`
takes them (`joints2d`, no `bbox`: the boxes come from the keypoints).
"""

from __future__ import annotations

import json
import os
import os.path as osp
import subprocess

import numpy as np


def run_openpose_binary(
    staf_folder: str,
    image_folder: str,
    output_folder: str,
    vis: bool = False,
) -> None:
    """Invoke the STAF/OpenPose tracking binary (reference
    pose_tracker.py:25-54). Requires a local STAF build."""
    cmd = [
        osp.join(staf_folder, "build/examples/openpose/openpose.bin"),
        "--model_pose", "BODY_21A",
        "--tracking", "1",
        "--render_pose", "1" if vis else "0",
        "--video" if image_folder.endswith(".mp4") else "--image_dir",
        image_folder,
        "--write_json", output_folder,
        "--display", "0",
    ]
    subprocess.run(cmd, check=True, cwd=staf_folder)


def read_posetrack_keypoints(output_folder: str) -> dict[int, dict]:
    """Parse per-frame posetrack JSON into person tracklets.

    Reference: pose_tracker.py:79-139. Each frame file contains
    `people: [{person_id: [id], pose_keypoints_2d: [x, y, c, ...]}]`.

    Returns:
        dict[person_id] -> {'joints2d': (T, K, 3), 'frames': (T,)}.
    """
    people: dict[int, dict] = {}
    files = sorted(
        f for f in os.listdir(output_folder) if f.endswith(".json")
    )
    for frame_id, fname in enumerate(files):
        with open(osp.join(output_folder, fname)) as f:
            data = json.load(f)
        for person in data.get("people", []):
            pid_field = person.get("person_id", [-1])
            pid = int(pid_field[0] if isinstance(pid_field, list) else pid_field)
            if pid < 0:
                continue
            kp = np.asarray(
                person["pose_keypoints_2d"], np.float32
            ).reshape(-1, 3)
            entry = people.setdefault(pid, {"joints2d": [], "frames": []})
            entry["joints2d"].append(kp)
            entry["frames"].append(frame_id)
    return {
        pid: {
            "joints2d": np.stack(v["joints2d"]),
            "frames": np.asarray(v["frames"], np.int64),
        }
        for pid, v in people.items()
        if v["frames"]
    }


def run_posetracker(
    video_file_or_folder: str,
    staf_folder: str | None = None,
    *,
    posetrack_output_folder: str,
    vis: bool = False,
) -> dict[int, dict]:
    """End-to-end pose tracking: run the binary (if available) and parse.

    When `staf_folder` is None, `posetrack_output_folder` must already
    contain the JSON dumps (precomputed-keypoints workflow). The folder has
    no default (the JAX package's is /tmp/posetrack_output): the caller
    names it, as `cli.demo` does with <output_folder>/posetrack.
    """
    if staf_folder:
        os.makedirs(posetrack_output_folder, exist_ok=True)
        run_openpose_binary(
            staf_folder, video_file_or_folder, posetrack_output_folder, vis
        )
    return read_posetrack_keypoints(posetrack_output_folder)
