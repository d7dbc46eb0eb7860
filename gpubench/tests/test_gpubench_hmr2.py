"""The cell `hmr2_frames_b128` (HMR 2.0 through the `frames_hmr2`
runner): listed, validated and run on the CPU at a tiny width on a copy
of the folder (a ViT of width 64 and 2 blocks, a decoder of 2 layers, 4
boxes a request), `correct` false with the timed path broken, a program
without HMR 2.0 refused at once, and the ViT MLP's FLOPs and bytes
(`bench/vit_bounds.py`)."""

from __future__ import annotations

import functools
import json
import time

import pytest
import torch

import run
from bench import manifest, readers, vit_bounds
from bench.peaks import PEAKS
from conftest import add_cells, make_tiny_copy

SEED = 2**31 + 101
TINY_TRUNK = {"img_size": [256, 192], "patch_size": 16, "embed_dim": 64, "depth": 2,
              "num_heads": 4, "mlp_ratio": 4}
TINY_DECODER = {"dim": 32, "depth": 2, "heads": 2, "dim_head": 16, "mlp_dim": 32}


@pytest.fixture(scope="module")
def hmr2_root(tmp_path_factory):
    """The tiny copy of the folder with tiny_hmr2_frames_b128: the ViT and
    decoder above (registered in the port as `vit_tiny`), 4 boxes a request."""
    copy = make_tiny_copy(tmp_path_factory.mktemp("hmr2"))
    config = json.loads((copy / "configs" / "hmr2_vith.json").read_text())
    config.update(name="tiny_hmr2_vith", trunk=TINY_TRUNK, decoder=TINY_DECODER)
    config["model"]["backbone"] = "vit_tiny-hmr2"
    (copy / "configs" / "tiny_hmr2_vith.json").write_text(json.dumps(config))
    tiny_frames = json.loads((copy / "traffic" / "tiny_frames.json").read_text())
    (copy / "traffic" / "tiny_frames_hmr2.json").write_text(
        json.dumps(dict(tiny_frames, kind="frames_hmr2")))
    cell = json.loads((copy / "workloads" / "hmr2_frames_b128.json").read_text())
    cell.update(config="tiny_hmr2_vith", traffic="tiny_frames_hmr2", check_requests=2)
    (copy / "workloads" / "tiny_hmr2_frames_b128.json").write_text(json.dumps(cell))
    add_cells(copy, {"tiny_hmr2_frames_b128": "hmr2_frames_b128"})
    return copy


@pytest.fixture
def tiny_vit(monkeypatch):
    """`vit_tiny` (the trunk above) in the port's registry and the port's
    decoder head at the widths above."""
    from poco_tpu_torch.models import poco
    from poco_tpu_torch.models.backbones.vit import ViT

    trunk = dict(TINY_TRUNK, img_size=tuple(TINY_TRUNK["img_size"]))
    monkeypatch.setitem(poco.BACKBONES, "vit_tiny", lambda: ViT(**trunk))
    monkeypatch.setattr(poco, "Hmr2Head", functools.partial(poco.Hmr2Head, **TINY_DECODER))
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def run_tiny(root, cell, trace=False):
    return run.run_cell(f"tiny_{cell}", SEED, 0.5, trace, "cpu", root=root,
                        t_start=time.perf_counter())


def test_cell_is_listed_and_valid():
    """One chip, the frames cells' end-to-end metrics, `frames.json`'s
    traffic, the whole configuration, and the per-layer metrics of
    `cliff_frames_b128` but for those that read an uncertainty head."""
    assert "hmr2_frames_b128" in manifest.names("workloads")
    loaded = manifest.load_cell("hmr2_frames_b128")
    like = manifest.load_cell("cliff_frames_b128")
    assert loaded["chips"] == 1 and loaded["config_data"]["reduced"] == []
    assert set(loaded["end_to_end"]) == {"crops_per_s", "request_p95_ms", "setup_s"}
    assert {k: v for k, v in loaded["traffic_data"].items() if k not in ("kind", "about")} == {
        k: v for k, v in like["traffic_data"].items() if k not in ("kind", "about")}
    assert set(loaded["per_layer"]) == (set(like["per_layer"]) - {"smpl_ms.infer",
                                                                   "uncert_ms.infer"}) | {
        "vit_attention_ms.infer", "vit_mlp_ms.infer", "vit_mlp_roofline.infer"}


def test_sound_run_is_correct(hmr2_root, tiny_vit):
    result = run_tiny(hmr2_root, "hmr2_frames_b128")
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"crops_per_s", "request_p95_ms", "setup_s"}


def test_traced_run_reads_the_vit_spans(hmr2_root, tiny_vit):
    result = run_tiny(hmr2_root, "hmr2_frames_b128", trace=True)
    assert result["correct"]
    summary = result["summary"]
    requests = summary["requests"]
    assert summary["calls"]["gpubench/backbone"] == summary["calls"]["gpubench/head"] == requests
    for span in ("poco/vit_attention", "poco/vit_mlp"):
        assert summary["calls"][span] == TINY_TRUNK["depth"] * requests
    assert summary["calls"]["poco_tpu_torch::skinning"] == requests
    assert summary["vit_mlp_shape"] == (4 * 16 * 12, 64, 256)
    assert summary["skinning_shape"] == (4, 6890)
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


def crop_at_224(monkeypatch):
    """The request's crop made at the constant 224 px, as before the crop
    followed the model's `img_res`, then resized to the model's 256 (left
    at 224, the trunk's position table does not fit, and the run raises)."""
    from poco_tpu_torch.demo import tester

    preprocess = tester.preprocess_crops

    def at_224(image, centers, scales, out_res, **kw):
        batch = preprocess(image, centers, scales, **kw)
        img = torch.nn.functional.interpolate(batch["img"].permute(0, 3, 1, 2), size=out_res,
                                              mode="bilinear", align_corners=False)
        return dict(batch, img=img.permute(0, 2, 3, 1))

    monkeypatch.setattr(tester, "preprocess_crops", at_224)


@pytest.mark.parametrize("fault", [altered_answer, half_the_boxes, stale_answer, crop_at_224])
def test_fault_is_not_correct(hmr2_root, tiny_vit, monkeypatch, fault):
    fault(monkeypatch)
    result = run_tiny(hmr2_root, "hmr2_frames_b128")
    assert not result["correct"], result["checks"]


def test_program_without_hmr2_fails_at_once(hmr2_root, tiny_vit, monkeypatch):
    """A port whose registry has no such trunk (the parent of HMR 2.0)
    raises as the model is built, before the first request."""
    from poco_tpu_torch.models import poco

    monkeypatch.delitem(poco.BACKBONES, "vit_tiny")
    t0 = time.perf_counter()
    with pytest.raises(NotImplementedError, match="not in the registry"):
        run_tiny(hmr2_root, "hmr2_frames_b128")
    assert time.perf_counter() - t0 < 60


def test_mlp_flops_and_bytes():
    """One block's MLP at 128 crops of 192 tokens, width 1280, hidden 5120:
    two products of 2 * 24576 * 1280 * 5120 FLOPs; the input and output
    (24576 x 1280 fp32 each) and both layers' weights and biases."""
    tokens, dim, hidden = 128 * 192, 1280, 5120
    assert vit_bounds.mlp_flops(tokens, dim, hidden) == 644_245_094_400
    assert vit_bounds.mlp_bytes(tokens, dim, hidden) == (
        2 * 24576 * 1280 * 4 + 2 * 1280 * 5120 * 4 + 5120 * 4 + 1280 * 4) == 304_112_640
    peaks = PEAKS["NVIDIA H100 80GB HBM3"]
    bound = vit_bounds.mlp_bound_s(tokens, dim, hidden, peaks)
    assert bound == pytest.approx(644_245_094_400 / (494.7e12 / 3))   # compute-bound
    assert vit_bounds.mlp_bound_s(1, dim, hidden, peaks) == pytest.approx(
        vit_bounds.mlp_bytes(1, dim, hidden) / 3.35e12)              # one token: memory-bound


def test_roofline_reader_takes_a_call():
    """`vit_mlp_roofline.infer` divides the bound by the device time of
    one `poco/vit_mlp` call; with no span recorded it reads nothing."""
    reader = manifest.metric_reader("vit_mlp_roofline.infer")
    peaks = PEAKS["NVIDIA H100 80GB HBM3"]
    shape = (128 * 192, 1280, 5120)
    bound = vit_bounds.mlp_bound_s(*shape, peaks)
    summary = {"peaks": peaks, "vit_mlp_shape": shape, "requests": 4, "busy_s": 1.0,
               "calls": {"poco/vit_mlp": 128}, "ranges_s": {"poco/vit_mlp": 128 * 4 * bound}}
    assert reader(summary) == pytest.approx(25.0)
    assert readers.per_call_ms(summary, "poco/vit_mlp") == pytest.approx(32 * 4 * bound * 1e3)
    assert reader(dict(summary, calls={}, ranges_s={})) is None
    assert reader({}) is None
