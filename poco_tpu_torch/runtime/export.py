"""Ahead-of-time export and serving artifacts, with `torch.export`.

Port of `poco_tpu.runtime.export`: the fused inference program (224 px
crops -> backbone -> head -> SMPL -> projection -> uncertainty) is traced
ahead of time and written to an artifact directory that serves without
the model's Python code or its config:

    meta.json     model cfg, batch buckets, dtypes, device, SMPL static
                  fields, torch version
    forward.pt2   one `torch.export.save` program, weights and SMPL
                  tensors included, whose batch dimension is dynamic
                  (1 to the largest bucket)

One program with a dynamic batch stores the weights once and holds them
on the card once. The buckets stay: a request is padded up to the
smallest bucket that fits and chunked by the largest, as the JAX
artifact's static programs are, so the card sees a few shapes only
(cuDNN picks its algorithms per shape, and `warmup` runs each bucket).

The SMPL skinning is the `poco_tpu_torch::skinning` custom op
(`ops/skinning.py`); the exported graph keeps a call to it, which
launches the hand-written kernel wherever the program runs on the card.
Importing this module registers the op before any program is loaded.

The program holds the device it was exported on (its weights, and
constants such as `torch.eye(3, device=...)`), so an artifact serves on
that device type only: exported on the card, it serves on the card, and
a CPU artifact serves on the CPU. Not ported, and refused with an error:
data-parallel artifacts (ROADMAP queue A item 3), bf16 export (queue A
item 6: the port's gated precision is fp32 with TF32 off) and lowering
for another platform than the export device (the JAX format's "export on
one platform, serve on another", queue A item 3).
"""

from __future__ import annotations

import dataclasses
import json
import os
import os.path as osp
import time

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..models.poco import make_dummy_batch
from ..ops import skinning as _skinning_ops  # noqa: F401  registers the custom ops
from ..ops.preprocess import normalize_image
from ..smpl.lbs import _TENSOR_FIELDS, SmplParams

META_NAME = "meta.json"
PROGRAM_NAME = "forward.pt2"
FORMAT_VERSION = 1
LAYOUT = "one torch.export program, dynamic batch"

# Outputs cast to fp16 on the device when compact=True (rendering-grade,
# within 1 mm at body scale: the JAX package's policy, export.py:46-49).
_HEAVY_KEYS = ("smpl_vertices", "smpl_joints3d", "smpl_joints2d")


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch runtime yet (ROADMAP.md queue A, {item})"
    )


class ServedPoco(nn.Module):
    """`model(batch, smpl)` as one module: the SMPL tensors are buffers
    (stored with the weights, as the JAX artifact's smpl.npz), `parents`
    and `vertex_joint_ids` constants of the trace. `None` outputs are
    dropped; with `uint8_input` the crops arrive as raw uint8 and are
    normalized on the device; with `compact` the vertices and joints
    leave as fp16."""

    def __init__(self, model: nn.Module, smpl: SmplParams, compact: bool, uint8_input: bool):
        super().__init__()
        self.model = model
        for name in _TENSOR_FIELDS:
            self.register_buffer(f"smpl_{name}", getattr(smpl, name))
        self.parents = tuple(int(p) for p in smpl.parents)
        self.vertex_joint_ids = tuple(int(i) for i in smpl.vertex_joint_ids)
        self.compact = compact
        self.uint8_input = uint8_input

    def forward(self, batch: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        smpl = SmplParams(
            parents=self.parents,
            vertex_joint_ids=self.vertex_joint_ids,
            **{name: getattr(self, f"smpl_{name}") for name in _TENSOR_FIELDS},
        )
        if self.uint8_input:
            batch = dict(batch)
            batch["img"] = normalize_image(batch["img"].float())
        out = {k: v for k, v in self.model(batch, smpl).items() if v is not None}
        if self.compact:
            for k in _HEAVY_KEYS:
                if k in out:
                    out[k] = out[k].half()
        return out


def export_poco(
    model: nn.Module,
    smpl: SmplParams,
    out_dir: str,
    batch_sizes: tuple[int, ...] = (1, 32),
    compact: bool = False,
    uint8_input: bool = False,
    device: str | torch.device = "cuda",
    data_parallel: int | None = None,
    platforms: tuple[str, ...] | None = None,
) -> str:
    """Export `model(batch, smpl)` inference to an artifact directory.

    Args:
        model: a POCO (models/poco.py) in eval mode, fp32, on `device`.
        smpl: the SMPL weights to bake into the artifact.
        out_dir: artifact directory (created).
        batch_sizes: the batch buckets; the program's batch dimension is
            dynamic from 1 to the largest.
        compact: cast the vertex and joint outputs to fp16 on the device.
        uint8_input: the program takes raw uint8 crops and normalizes on
            the device (4x smaller uploads; the natural serving format).
        device: the device the program is traced and served on; CUDA
            unless the caller asks for the CPU.
        data_parallel, platforms: not ported; given, they raise.

    Returns out_dir.
    """
    if data_parallel:
        raise not_ported("data-parallel export", "item 3, serving and export")
    if platforms is not None:
        raise not_ported(
            "export for another platform than the export device", "item 3, serving and export"
        )
    device = resolve_device(device)
    batch_sizes = tuple(sorted({int(b) for b in batch_sizes}))
    if not batch_sizes or batch_sizes[0] < 1:
        raise ValueError(f"batch_sizes must be positive, got {batch_sizes}")
    if model.training:
        raise ValueError("export_poco: put the model in eval mode first (model.eval())")
    dtypes = {p.dtype for p in model.parameters()}
    if dtypes != {torch.float32}:
        raise not_ported(f"export of {sorted(map(str, dtypes))} weights", "item 6, bf16")
    where = {p.device for p in model.parameters()} | {smpl.v_template.device}
    if any(d.type != device.type for d in where):
        raise ValueError(
            f"export_poco: model and SMPL must lie on {device}, found {sorted(map(str, where))}"
        )

    served = ServedPoco(model, smpl, compact=compact, uint8_input=uint8_input)
    largest = batch_sizes[-1]
    example = _example_batch(model.cfg, min(2, largest), uint8_input, device)
    dynamic = None
    if largest > 1:
        dim = torch.export.Dim("batch", min=1, max=largest)
        dynamic = ({k: {0: dim} for k in example},)
    with torch.no_grad():
        program = torch.export.export(served, (example,), dynamic_shapes=dynamic, strict=False)
    with torch.inference_mode():
        output_keys = sorted(served(example))

    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(program, osp.join(out_dir, PROGRAM_NAME))
    cfg = {k: list(v) if isinstance(v, tuple) else v
           for k, v in dataclasses.asdict(model.cfg).items()}
    meta = {
        "format_version": FORMAT_VERSION,
        "layout": LAYOUT,
        "model_cfg": cfg,
        "compute_dtype": "float32",
        "batch_sizes": list(batch_sizes),
        "compact": bool(compact),
        "uint8_input": bool(uint8_input),
        "batch_keys": sorted(example),
        "output_keys": output_keys,
        "smpl_static": {
            "parents": list(served.parents),
            "vertex_joint_ids": list(served.vertex_joint_ids),
        },
        "device": device.type,
        "torch_version": torch.__version__,
    }
    with open(osp.join(out_dir, META_NAME), "w") as f:
        json.dump(meta, f, indent=1)
    return out_dir


def _example_batch(cfg, batch: int, uint8_input: bool, device) -> dict[str, torch.Tensor]:
    example = make_dummy_batch(cfg, batch, include_gt=False, device=device)
    if uint8_input:
        example["img"] = example["img"].to(torch.uint8)
    return example


class ExportedPoco:
    """A loaded artifact: padded, bucketed batch prediction.

    Needs torch and numpy only: the program embeds the model, so no module
    code or config parsing runs at load time. The program and its weights
    go to `device` once, at load; a request ships only its batch.
    """

    def __init__(self, path: str, device: str | torch.device = "cuda"):
        with open(osp.join(path, META_NAME)) as f:
            self.meta = json.load(f)
        if self.meta.get("format_version") != FORMAT_VERSION:
            raise ValueError(
                f"artifact format {self.meta.get('format_version')} != "
                f"supported {FORMAT_VERSION}"
            )
        if "device" not in self.meta:
            raise ValueError(
                f"{path} is not an artifact of this runtime (no device in its meta.json; "
                "a JAX artifact is served by poco_tpu.runtime)"
            )
        self.device = resolve_device(device)
        exported_on = self.meta["device"]
        if exported_on != self.device.type:
            raise ValueError(
                f"artifact {path} was exported on {exported_on} and holds that device's "
                f"tensors in its graph; it cannot serve on {self.device}. Export it again "
                f"with device={self.device.type!r}"
            )
        self.path = path
        self.batch_sizes = sorted(self.meta["batch_sizes"])
        self.batch_keys = list(self.meta["batch_keys"])
        self.uint8_input = bool(self.meta.get("uint8_input", False))
        start = time.perf_counter()
        self._program = torch.export.load(osp.join(path, PROGRAM_NAME)).module()
        self.load_seconds = time.perf_counter() - start
        self.warmup_seconds: dict[int, float] = {}
        self._warm: set[int] = set()

    def warmup(self) -> None:
        """Dispatch every bucket once (cuDNN's algorithm choice for each
        shape, the kernels' builds) and record its seconds."""
        for b in self.batch_sizes:
            batch = {
                k: np.zeros((b,) + self._key_shape(k), self._key_dtype(k))
                for k in self.batch_keys
            }
            start = time.perf_counter()
            self.predict(batch)
            self.warmup_seconds[b] = time.perf_counter() - start

    def buckets_for(self, n: int) -> list[int]:
        """Bucket sequence a size-n request dispatches to (chunking rule)."""
        largest = self.batch_sizes[-1]
        return [
            next((b for b in self.batch_sizes if b >= min(largest, n - s)), largest)
            for s in range(0, n, largest)
        ]

    def is_warm(self, n: int) -> bool:
        """True when every bucket a size-n dispatch needs has run once, so
        dispatching now does not stall on a first call's set-up. Serving
        uses it to flush a completed wave before a cold dispatch."""
        return all(b in self._warm for b in self.buckets_for(n))

    def _key_shape(self, key: str) -> tuple[int, ...]:
        res = self.meta["model_cfg"]["img_res"]
        return {
            "img": (res, res, 3),
            "bbox_info": (3,),
            "focal_length": (),
            "scale": (),
            "center": (2,),
            "orig_shape": (2,),
        }[key]

    def _key_dtype(self, key: str):
        if key == "img" and self.uint8_input:
            return np.uint8
        return np.float32

    def predict_async(self, batch: dict[str, np.ndarray]) -> "PendingPrediction":
        """Dispatch inference without waiting for the outputs.

        Pads up to the smallest bucket that fits and chunks by the largest
        bucket. On the card each chunk's outputs are copied to pinned host
        buffers without blocking, behind a recorded CUDA event, so the
        caller can dispatch the next wave before it waits on this one
        (`MicroBatcher` does). `.result()` of the handle returns numpy.
        """
        missing = [k for k in self.batch_keys if k not in batch]
        if missing:
            raise KeyError(f"batch missing keys {missing}")
        n = int(np.shape(batch[self.batch_keys[0]])[0])
        if n == 0:
            raise ValueError("empty batch")
        if self.uint8_input and np.asarray(batch["img"]).dtype != np.uint8:
            raise ValueError(
                "artifact was exported with uint8_input=True (on-device normalize); got "
                f"img dtype {np.asarray(batch['img']).dtype}: send raw uint8 crops"
            )
        largest = self.batch_sizes[-1]
        chunks = []
        for start in range(0, n, largest):
            chunk = {
                k: np.asarray(batch[k], self._key_dtype(k))[start:start + largest]
                for k in self.batch_keys
            }
            m = int(chunk[self.batch_keys[0]].shape[0])
            bucket = next((b for b in self.batch_sizes if b >= m), largest)
            if m < bucket:
                chunk = {
                    k: np.concatenate([v, np.repeat(v[-1:], bucket - m, axis=0)], axis=0)
                    for k, v in chunk.items()
                }
            inputs = {
                k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device, non_blocking=True)
                for k, v in chunk.items()
            }
            with torch.inference_mode():
                out = self._program(inputs)
                event = None
                if self.device.type == "cuda":
                    out = {k: _to_pinned_host(v) for k, v in out.items()}
                    event = torch.cuda.Event()
                    event.record()
            self._warm.add(bucket)
            chunks.append((out, m, event))
        return PendingPrediction(chunks)

    def predict(self, batch: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        """Run inference on a host batch of any size (dispatch + fetch)."""
        return self.predict_async(batch).result()


def _to_pinned_host(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


class PendingPrediction:
    """Handle to dispatched chunks; `.result()` waits for their copies to
    the host and returns numpy, trimmed of the padding rows."""

    def __init__(self, chunks: list[tuple[dict, int, torch.cuda.Event | None]]):
        self._chunks = chunks

    def result(self) -> dict[str, np.ndarray]:
        outs = []
        for out, m, event in self._chunks:
            if event is not None:
                event.synchronize()
            outs.append({k: v[:m].numpy() for k, v in out.items()})
        if len(outs) == 1:
            return outs[0]
        return {k: np.concatenate([o[k] for o in outs], axis=0) for k in outs[0]}


def load_exported(path: str, device: str | torch.device = "cuda") -> ExportedPoco:
    return ExportedPoco(path, device=device)
