"""The traffic is made from the seed alone: the same seed gives the same
frames, boxes, SMPL and batches, another seed others."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from bench import synth
from conftest import GPUBENCH
from reference.train import smpl_from_arrays

FRAMES = dict(json.loads((GPUBENCH / "traffic" / "frames.json").read_text()),
              frames=2, box_sets=5, frame_height=64, frame_width=96, center_margin=10)
BATCHES = dict(json.loads((GPUBENCH / "traffic" / "train_batches.json").read_text()),
               batch=8, batches=2)
CLIFF = json.loads((GPUBENCH / "configs" / "poco_cliff.json").read_text())
SEEDS = (2**31 + 11, 2**33 + 5)   # beyond 32 signed bits


def made(seed: int) -> dict:
    gen = synth.generator(seed, "cpu")
    frames = synth.frame_pool(gen, "cpu", FRAMES)
    boxes = synth.box_sets(gen, "cpu", FRAMES)
    arrays = synth.smpl_arrays(gen, "cpu", num_verts=6890, num_faces=13776)
    batches = synth.train_batches(gen, "cpu", BATCHES, CLIFF["model"], smpl_from_arrays(arrays))
    return {"frames": np.stack(frames), "centers": np.stack([c for c, _ in boxes]),
            "scales": np.stack([s for _, s in boxes]),
            **{f"smpl/{k}": v.numpy() for k, v in arrays.items()},
            **{f"batch{i}/{k}": v.numpy() for i, b in enumerate(batches) for k, v in b.items()}}


@pytest.fixture(scope="module")
def runs():
    return {"a": made(SEEDS[0]), "a_again": made(SEEDS[0]), "b": made(SEEDS[1])}


def test_same_seed_same_traffic(runs):
    for key, value in runs["a"].items():
        np.testing.assert_array_equal(value, runs["a_again"][key], err_msg=key)


@pytest.mark.parametrize("key", ["frames", "centers", "scales", "smpl/v_template",
                                 "smpl/weights", "batch0/img", "batch1/pose", "batch0/betas"])
def test_other_seed_other_traffic(runs, key):
    assert not np.array_equal(runs["a"][key], runs["b"][key])


def test_traffic_follows_its_parameters(runs):
    a = runs["a"]
    assert a["frames"].shape == (2, 64, 96, 3) and a["frames"].dtype == np.uint8
    assert a["centers"].shape == (5, FRAMES["boxes"], 2)
    assert (a["centers"][..., 0] >= 10).all() and (a["centers"][..., 0] <= 86).all()
    assert (a["scales"] >= 0.8).all() and (a["scales"] <= 3.0).all()
    assert np.abs(a["batch0/pose"]).max() <= 0.3 and np.abs(a["batch0/betas"]).max() <= 0.5
    assert a["smpl/f"].shape == (13776, 3)
    np.testing.assert_allclose(a["smpl/weights"].sum(1), 1.0, rtol=1e-5)
    cond, has3d = a["batch0/gt_pose_cond_mask"], a["batch0/has_pose_3d"]
    assert cond.sum() <= has3d.sum()   # conditioned rows are h36m rows, which carry 3D joints


def test_seeded_weights_repeat_and_keep_scale():
    def build():
        torch.manual_seed(0)
        model = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.BatchNorm1d(8),
                                    torch.nn.Linear(8, 2))
        torch.nn.init.zeros_(model[2].bias)
        return model

    bound = float(build()[0].weight.abs().max())
    first, second = build(), build()
    for model in (first, second):
        synth.seeded_weights(model, synth.generator(7, "cpu"))
    for a, b in zip(first.parameters(), second.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float(first[2].bias.abs().max()) == 0.0
    assert float(first[0].weight.abs().max()) <= bound
    assert 0.5 <= float(first[1].weight.min()) and float(first[1].weight.max()) <= 1.5
