"""Whole runs of the harness on the CPU at a tiny size (the card's look
skipped): the frozen reference agrees with the port's forward and train
step on shared weights, so `correct` is true, and with the timed path
broken underneath `correct` comes out false, once for each fault the
cell can have. One process runs one card, so no cell has an exchange
between chips to leave out."""

from __future__ import annotations

import time

import pytest
import torch

import run

SEED = 2**31 + 97


def run_tiny(root, cell, trace=False):
    return run.run_cell(f"tiny_{cell}", SEED, 0.5, trace, "cpu", root=root,
                        t_start=time.perf_counter())


@pytest.mark.parametrize("cell", ["cliff_frames_b128", "pare_frames_b128", "cliff_train_b64"])
def test_sound_run_is_correct(tiny_root, narrow_hrnet, cell):
    result = run_tiny(tiny_root, cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == set(run.manifest.load_cell(cell)["end_to_end"])


def test_traced_run_reads_the_stretch(tiny_root, narrow_hrnet):
    result = run_tiny(tiny_root, "cliff_frames_b128", trace=True)
    assert result["correct"]
    summary = result["summary"]
    assert summary["calls"]["gpubench/request"] == summary["requests"] == 4
    assert summary["calls"]["gpubench/backbone"] == 4
    assert summary["calls"]["poco_tpu_torch::skinning"] == 4
    assert summary["flops_per_call"] > 0
    assert result["metrics"] == {}   # no device on the CPU: no per-layer number


def altered_answer(monkeypatch):
    from poco_tpu_torch.models.poco import POCO

    forward = POCO._forward

    def altered(self, batch, smpl):
        out = forward(self, batch, smpl)
        verts = out["smpl_vertices"].clone()
        verts[0, 0, 0] += 1e-3     # 1 mm, on one vertex of one crop
        return dict(out, smpl_vertices=verts)

    monkeypatch.setattr(POCO, "_forward", altered)


def half_the_boxes(monkeypatch):
    from poco_tpu_torch.demo import tester

    preprocess = tester.preprocess_crops

    def half(image, centers, scales, **kw):
        n = len(centers) // 2
        return preprocess(image, centers[:n], scales[:n], **kw)

    monkeypatch.setattr(tester, "preprocess_crops", half)


def stale_answer(monkeypatch):
    from poco_tpu_torch.demo import tester

    forward, kept = tester.detect_forward, []

    def stale(*args, **kw):
        if not kept:
            kept.append(forward(*args, **kw))
        return kept[0]

    monkeypatch.setattr(tester, "detect_forward", stale)


@pytest.mark.parametrize("fault", [altered_answer, half_the_boxes, stale_answer])
def test_frames_fault_is_not_correct(tiny_root, narrow_hrnet, monkeypatch, fault):
    fault(monkeypatch)
    result = run_tiny(tiny_root, "cliff_frames_b128")
    assert not result["correct"], result["checks"]


def unchanged_state(monkeypatch):
    from poco_tpu_torch.train import state

    def step(self):
        return state.global_norm([p.grad for p in self.params if p.grad is not None])

    monkeypatch.setattr(state.ModuleAdam, "step", step)


def _rows(tree, n):
    return {k: v[:n] if torch.is_tensor(v) and v.dim() and v.shape[0] > n else v
            for k, v in tree.items()}


def half_the_batch(monkeypatch):
    from poco_tpu_torch.train import step

    loss = step.poco_loss

    def half(out, gt, cfg):
        n = len(gt["pose"]) // 2
        return loss(_rows(out, n), _rows(gt, n), cfg)

    monkeypatch.setattr(step, "poco_loss", half)


def altered_loss(monkeypatch):
    from poco_tpu_torch.train import step

    loss = step.poco_loss

    def altered(out, gt, cfg):
        total, terms = loss(out, gt, cfg)
        total = total * (1.0 + 1e-3)
        return total, dict(terms, **{"loss/total_loss": total})

    monkeypatch.setattr(step, "poco_loss", altered)


def in_the_window(fault):
    """`fault` from the port's fourth step on: the set-up's three checked
    steps run sound, the window's steps do not."""
    def planted(monkeypatch):
        from poco_tpu_torch.train import state, step

        sound_step, sound_loss = state.ModuleAdam.step, step.poco_loss
        fault(monkeypatch)
        broken_step, broken_loss, calls = state.ModuleAdam.step, step.poco_loss, [0]

        def adam_step(self):
            calls[0] += 1
            return (sound_step if calls[0] <= 3 else broken_step)(self)

        def loss(out, gt, cfg):
            return (sound_loss if calls[0] < 3 else broken_loss)(out, gt, cfg)

        monkeypatch.setattr(state.ModuleAdam, "step", adam_step)
        monkeypatch.setattr(step, "poco_loss", loss)

    planted.__name__ = f"{fault.__name__}_in_the_window"
    return planted


@pytest.mark.parametrize("fault", [unchanged_state, half_the_batch, altered_loss,
                                   in_the_window(unchanged_state),
                                   in_the_window(altered_loss)])
def test_train_fault_is_not_correct(tiny_root, narrow_hrnet, monkeypatch, fault):
    fault(monkeypatch)
    result = run_tiny(tiny_root, "cliff_train_b64")
    assert not result["correct"], result["checks"]
