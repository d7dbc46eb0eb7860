#!/usr/bin/env python3
"""Where the skinning backward kernel's time goes, on one NVIDIA card.

    python3 ablate_skinning_backward.py [--batch 64 128] [--seed 0]

Builds `poco_tpu_torch/csrc/skinning_backward.cu` whole and with parts
left out (`-DPOCO_ABLATE=<bits>`: 1 the blend, 2 the reduction, 4 the
warps' sum; 7 leaves the loads, the transforms' split, the epilogue and
the stores), one nvcc each, all at once, into `poco_tpu_torch/_build/`.
The whole build must give the library's bits and meet the plain
version's bar; the others give wrong gradients by design. Each variant is
timed hot (inputs in L2, CUDA events around CUDA-graph replays, as
`chip_smoke.py` phase 7b times the library) in turns, whole first and
last, at each batch at V=6890, beside the byte bound. Exits 1 without a
CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

import torch

import chip_smoke as smoke
from poco_tpu_torch.ops import kernels
from poco_tpu_torch.ops.skinning import NUM_JOINTS, skinning_backward

VARIANTS = {"whole": 0, "no_blend": 1, "no_reduce": 2, "no_sum": 4, "io_only": 7}
NUM_VERTS = 6890


def build() -> dict[str, ctypes.CDLL]:
    """One library a variant, nvcc's `-Xptxas -v` lines of the main kernel
    printed."""
    source = kernels.CSRC_DIR / kernels.SOURCES["skinning_backward"]
    out_dir = kernels.BUILD_DIR / "ablate"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {
        name: subprocess.Popen(
            [kernels.nvcc_path(), *kernels.NVCC_FLAGS, f"-DPOCO_ABLATE={bits}",
             "-o", str(out_dir / f"lib{name}.so"), str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, bits in VARIANTS.items()
    }
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{log}")
        lines = log.splitlines()
        at = max(i for i, line in enumerate(lines) if "grad_tc_kernel" in line)
        print(f"{name} (POCO_ABLATE={VARIANTS[name]}): "
              f"{[line.strip() for line in lines[at:] if 'Used' in line]}")
        libs[name] = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
    return libs


def launcher(lib: ctypes.CDLL):
    """The variant's launch on the current stream: fresh outputs, as the
    library's wrapper allocates them."""
    fn = lib.poco_skinning_backward_f32
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    chunk = lib.poco_skinning_backward_chunk()

    def run(w, tfms, vp, g):
        batch, num_verts = vp.shape[:2]
        grad_vp = torch.empty_like(vp)
        grad_tfms = torch.empty(batch, NUM_JOINTS, 4, 4, device=vp.device)
        partial = torch.empty(batch, -(-num_verts // chunk), NUM_JOINTS * 12,
                              device=vp.device)
        rc = fn(*(t.data_ptr() for t in (w, tfms, vp, g, grad_vp, grad_tfms, partial)),
                batch, num_verts, NUM_JOINTS, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return grad_vp, grad_tfms

    return run


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, nargs="+", default=[64, 128])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("ablate_skinning_backward: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    _, peaks = smoke.phase_environment()
    fns = {name: launcher(lib) for name, lib in build().items()}
    for batch in args.batch:
        inputs = smoke.skinning_inputs(batch, NUM_VERTS, args.seed + batch)
        inputs.append(smoke.backward_grad(batch, NUM_VERTS, args.seed + batch))
        got, want = fns["whole"](*inputs), skinning_backward(*inputs)
        ref = smoke.skinning_backward_reference(*inputs)
        torch.cuda.synchronize()
        smoke.check(all(torch.equal(a, b) for a, b in zip(got, want)),
                    "the whole build differs from the library")
        for name, a, r in zip(("grad_v_posed", "grad_rel_tfms"), got, ref):
            bar = smoke.BACKWARD_RTOL * float(r.abs().max()) + smoke.BACKWARD_ATOL
            smoke.check(float((a - r).abs().max()) <= bar, f"whole build: {name} misses")
        bound = smoke.backward_bound(batch, NUM_VERTS, peaks)["ms"]
        times = {name: [] for name in VARIANTS}
        for name in [*VARIANTS, *reversed(VARIANTS)]:
            times[name].append(smoke.hot_ms(fns[name], inputs))
        whole = sum(times["whole"]) / 2
        for name, ts in times.items():
            mean = sum(ts) / 2
            print(f"B={batch} V={NUM_VERTS} {name}: hot {ts[0]:.5f} {ts[1]:.5f} ms, "
                  f"{mean / whole:.3f} of whole; bound {bound:.5f} ms "
                  f"({bound / mean:.3f} of it)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
