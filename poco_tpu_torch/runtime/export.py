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

An artifact computes in fp32 or, with `dtype="bf16"`, in bf16 as the
JAX package's `POCO(dtype=jnp.bfloat16)` does (`models.poco.
compute_precision`: backbone and heads in bf16, SMPL in fp32); its
weights stay fp32 either way. Outputs that the program gives
in bf16 (`uncert_feat`, `body_feat2`, `var_pose`) reach numpy as float32:
numpy has no bfloat16 without `ml_dtypes`, where the JAX artifact hands
back bfloat16 arrays.

The program holds the device it was exported on (its weights, and
constants such as `torch.eye(3, device=...)`). `meta["platforms"]` lists
the device types it may serve on, by default ("cpu", "cuda"): at load the
program is moved to its device with `torch.export.passes.
move_to_device_pass` (and its autocast regions to that device type), so
an artifact exported on a CPU build host serves on the card. A type that
is not listed is refused before the program is read. Exported on the
card, an artifact loads only where a card is (the program's tensors are
made on their saved device first).

A data-parallel artifact (`data_parallel=N`, every bucket divisible by
N) is served by N replicas, each its own copy of the program and weights
on its own device, put there once at load: by default the first N
devices of the requested type, or the `devices` the caller names (two
replicas may share a device only where they are named so). A padded
bucket is split into N equal shards; each replica has a host thread of
its own (and on the card a CUDA stream of its own), so every shard is
dispatched without waiting for the others, and the rows come back in
order. JAX runs such an artifact as one SPMD program over a device
mesh; here the replicas are threads of one process. A data-parallel
artifact lists its export device type only, as the JAX one lists its
export platform.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import os
import os.path as osp
import time
from concurrent.futures import Future, ThreadPoolExecutor, wait

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..models.poco import COMPUTE_DTYPES, compute_precision, make_dummy_batch
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


PLATFORMS = ("cpu", "cuda")


class ServedPoco(nn.Module):
    """`model(batch, smpl)` as one module: the SMPL tensors are buffers
    (stored with the weights, as the JAX artifact's smpl.npz), `parents`
    and `vertex_joint_ids` constants of the trace. `None` outputs are
    dropped; with `uint8_input` the crops arrive as raw uint8 and are
    normalized on the device (in fp32); `dtype="bf16"` runs the model in
    `compute_precision`'s bf16 region; with `compact` the vertices and
    joints leave as fp16, cast after that region."""

    def __init__(self, model: nn.Module, smpl: SmplParams, compact: bool, uint8_input: bool,
                 dtype: str = "fp32"):
        super().__init__()
        self.model = model
        for name in _TENSOR_FIELDS:
            self.register_buffer(f"smpl_{name}", getattr(smpl, name))
        self.parents = tuple(int(p) for p in smpl.parents)
        self.vertex_joint_ids = tuple(int(i) for i in smpl.vertex_joint_ids)
        self.compact = compact
        self.uint8_input = uint8_input
        self.compute_dtype = COMPUTE_DTYPES[dtype]

    def forward(self, batch: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        smpl = SmplParams(
            parents=self.parents,
            vertex_joint_ids=self.vertex_joint_ids,
            **{name: getattr(self, f"smpl_{name}") for name in _TENSOR_FIELDS},
        )
        if self.uint8_input:
            batch = dict(batch)
            batch["img"] = normalize_image(batch["img"].float())
        with compute_precision(batch["img"].device.type, self.compute_dtype):
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
    dtype: str = "fp32",
    data_parallel: int | None = None,
    platforms: tuple[str, ...] = PLATFORMS,
) -> str:
    """Export `model(batch, smpl)` inference to an artifact directory.

    Args:
        model: a POCO (models/poco.py) in eval mode, fp32 weights, on `device`.
        smpl: the SMPL weights to bake into the artifact.
        out_dir: artifact directory (created).
        batch_sizes: the batch buckets; the program's batch dimension is
            dynamic from 1 to the largest (to the largest / data_parallel).
        compact: cast the vertex and joint outputs to fp16 on the device.
        uint8_input: the program takes raw uint8 crops and normalizes on
            the device (4x smaller uploads; the natural serving format).
        device: the device the program is traced on; CUDA unless the
            caller asks for the CPU.
        dtype: "fp32", or "bf16" to compute as the JAX package's
            `POCO(dtype=jnp.bfloat16)` does (the weights stay fp32).
        data_parallel: serve each bucket as this many equal shards on as
            many replicas (see `ExportedPoco`); every bucket must divide.
        platforms: the device types the artifact may be served on; must
            hold the export device's. Ignored for data-parallel exports,
            which list the export device's type only.

    Returns out_dir.
    """
    device = resolve_device(device)
    if dtype not in COMPUTE_DTYPES:
        raise ValueError(f"dtype must be one of {sorted(COMPUTE_DTYPES)}, got {dtype!r}")
    batch_sizes = tuple(sorted({int(b) for b in batch_sizes}))
    if not batch_sizes or batch_sizes[0] < 1:
        raise ValueError(f"batch_sizes must be positive, got {batch_sizes}")
    replicas = int(data_parallel or 1)
    if replicas < 1:
        raise ValueError(f"data_parallel must be positive, got {data_parallel}")
    bad = [b for b in batch_sizes if b % replicas]
    if bad:
        raise ValueError(f"batch buckets {bad} not divisible by data_parallel={replicas}")
    if model.training:
        raise ValueError("export_poco: put the model in eval mode first (model.eval())")
    if smpl.shard is not None:
        raise ValueError("export_poco: an artifact holds the whole SMPL; pass the unsharded "
                         "params, not shard_smpl_params' (one process's vertex range)")
    dtypes = {p.dtype for p in model.parameters()}
    if dtypes != {torch.float32}:
        raise ValueError(
            f"export_poco: the weights are {sorted(map(str, dtypes))}; an artifact keeps fp32 "
            "weights, as the JAX package's variables are. Export the fp32 model with "
            "dtype='bf16' (cli.export --dtype bf16) to compute in bf16"
        )
    where = {p.device for p in model.parameters()} | {smpl.v_template.device}
    if any(d.type != device.type for d in where):
        raise ValueError(
            f"export_poco: model and SMPL must lie on {device}, found {sorted(map(str, where))}"
        )

    if data_parallel:
        platforms = (device.type,)
    platforms = tuple(dict.fromkeys(platforms))
    if set(platforms) - set(PLATFORMS) or device.type not in platforms:
        raise ValueError(f"platforms {platforms} must be of {PLATFORMS} and hold the export "
                         f"device's type, {device.type!r}")

    served = ServedPoco(model, smpl, compact=compact, uint8_input=uint8_input, dtype=dtype)
    per_call = batch_sizes[-1] // replicas
    example = _example_batch(model.cfg, min(2, per_call), uint8_input, device)
    dynamic = None
    if per_call > 1:
        dim = torch.export.Dim("batch", min=1, max=per_call)
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
        "compute_dtype": str(COMPUTE_DTYPES[dtype] or torch.float32).removeprefix("torch."),
        "batch_sizes": list(batch_sizes),
        "platforms": list(platforms),
        "compact": bool(compact),
        "uint8_input": bool(uint8_input),
        "data_parallel": replicas if data_parallel else None,
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
    go to `device` once, at load; a request ships only its batch. A
    data-parallel artifact loads one replica on each of `devices` (by
    default the first `data_parallel` devices of `device`'s type; fewer
    raise).
    """

    def __init__(self, path: str, device: str | torch.device = "cuda",
                 devices: list[str | torch.device] | None = None):
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
        replicas = int(self.meta.get("data_parallel") or 1)
        if devices is None:
            devices = _first_devices(resolve_device(device), replicas)
        else:
            devices = [resolve_device(d) for d in devices]
            if len(devices) != replicas:
                raise ValueError(f"artifact {path} has {replicas} replica(s); devices names "
                                 f"{len(devices)}: {[str(d) for d in devices]}")
        exported_on = self.meta["device"]
        platforms = self.meta.get("platforms", [exported_on])
        for d in devices:
            if d.type not in platforms:
                raise ValueError(
                    f"artifact {path} was exported on {exported_on} for the device types "
                    f"{platforms}; it cannot serve on {d}. Export it again with "
                    f"platforms including {d.type!r}"
                )
        self.path = path
        self.device = devices[0]
        self.devices = devices
        self.batch_sizes = sorted(self.meta["batch_sizes"])
        self.batch_keys = list(self.meta["batch_keys"])
        self.uint8_input = bool(self.meta.get("uint8_input", False))
        start = time.perf_counter()
        program = torch.export.load(osp.join(path, PROGRAM_NAME))
        # each replica its own copy of the program and weights (the move is in place)
        self._replicas = [
            _Replica(_moved(copy.deepcopy(program) if i + 1 < len(devices) else program, d), d,
                     threaded=replicas > 1)
            for i, d in enumerate(devices)
        ]
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
            rows = bucket // len(self._replicas)
            shards = [
                replica.dispatch({k: v[i * rows:(i + 1) * rows] for k, v in chunk.items()})
                for i, replica in enumerate(self._replicas)
            ]
            self._warm.add(bucket)
            chunks.append((shards, m))
        return PendingPrediction(chunks)

    def predict(self, batch: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        """Run inference on a host batch of any size (dispatch + fetch)."""
        return self.predict_async(batch).result()

    def close(self) -> None:
        """Stop the replicas' host threads (a data-parallel artifact's)."""
        for replica in self._replicas:
            replica.close()


def _first_devices(device: torch.device, count: int) -> list[torch.device]:
    """`device` for one replica; else the first `count` devices of its type."""
    if count == 1:
        return [device]
    have = torch.cuda.device_count() if device.type == "cuda" else 1
    if have < count:
        raise ValueError(
            f"artifact needs {count} devices, host has {have} {device.type} device(s); name "
            f"the replicas with devices=[...] to run several on one device"
        )
    return [torch.device(device.type, i) for i in range(count)]


def _moved(program, device: torch.device):
    """`program` moved to `device` (its state, constants and the devices
    written into its graph, and its autocast regions' device type) by
    `move_to_device_pass`, as a callable module."""
    from torch.export.passes import move_to_device_pass

    program = move_to_device_pass(program, str(device))
    for module in program.graph_module.modules():
        if isinstance(module, torch.fx.GraphModule):
            for node in module.graph.nodes:
                if node.target is torch.ops.higher_order.wrap_with_autocast:
                    node.args = (device.type, *node.args[1:])
    return program.module()


class _Replica:
    """One copy of the program and its weights on one device. With
    `threaded`, its dispatches run on a host thread of its own (and on the
    card a CUDA stream of its own), in order; otherwise in the caller's
    thread, on the current stream."""

    def __init__(self, program, device: torch.device, threaded: bool):
        self.program, self.device = program, device
        self._pool = ThreadPoolExecutor(1, thread_name_prefix=f"poco-{device}") if threaded else None
        self._stream = torch.cuda.Stream(device) if threaded and device.type == "cuda" else None

    def dispatch(self, shard: dict[str, np.ndarray]) -> Future:
        """Start the shard: a Future of its (outputs, event) pair, already
        done where the replica runs in the caller's thread."""
        if self._pool is not None:
            return self._pool.submit(self._run, shard)
        done = Future()
        done.set_result(self._run(shard))
        return done

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown()

    def _run(self, shard: dict[str, np.ndarray]):
        on_card = self.device.type == "cuda"
        with (torch.cuda.device(self.device) if on_card else contextlib.nullcontext()), \
                (torch.cuda.stream(self._stream) if self._stream else contextlib.nullcontext()), \
                torch.inference_mode():
            inputs = {
                k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device, non_blocking=True)
                for k, v in shard.items()
            }
            out = self.program(inputs)
            event = None
            if on_card:
                out = {k: _to_pinned_host(v) for k, v in out.items()}
                event = torch.cuda.Event()
                event.record()
        return out, event


def _to_pinned_host(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def _numpy(t: torch.Tensor) -> np.ndarray:
    """numpy of a host tensor; bf16 as float32 (numpy has no bfloat16)."""
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class PendingPrediction:
    """Handle to dispatched chunks; `.result()` waits for their copies to
    the host and returns numpy, trimmed of the padding rows. A chunk is
    its replicas' shards, in row order."""

    def __init__(self, chunks: list[tuple[list, int]]):
        self._chunks = chunks

    def result(self) -> dict[str, np.ndarray]:
        # every replica's shards finish (or fail) before any is read
        wait([s for shards, _ in self._chunks for s in shards])
        outs = []
        for shards, m in self._chunks:
            parts = []
            for shard in shards:
                out, event = shard.result()
                if event is not None:
                    event.synchronize()
                parts.append(out)
            out = parts[0] if len(parts) == 1 else {
                k: torch.cat([p[k] for p in parts]) for k in parts[0]}
            outs.append({k: _numpy(v[:m]) for k, v in out.items()})
        if len(outs) == 1:
            return outs[0]
        return {k: np.concatenate([o[k] for o in outs], axis=0) for k in outs[0]}


def load_exported(path: str, device: str | torch.device = "cuda",
                  devices: list[str | torch.device] | None = None) -> ExportedPoco:
    return ExportedPoco(path, device=device, devices=devices)
