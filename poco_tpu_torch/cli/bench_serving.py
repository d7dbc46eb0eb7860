"""Load benchmark of the HTTP serving path (`runtime/server.py`): the
combo table of the repo's `tools/bench_serving.py`, on the port.

Drives an in-process `PocoServer` with N concurrent clients over real HTTP
on localhost and reports, per (clients x crops-per-request) combo: p50 /
p99 request latency, crops/s over the run, and requests per device
dispatch (the micro-batcher's coalescence).

    python -m poco_tpu_torch.cli.bench_serving --uint8 \\
        [--combos 1x1,8x1,64x1,1x16,8x16,64x16] [--buckets 1,8,32,128] \\
        [--which cliff|pare] [--artifact DIR] [--window-ms 5] \\
        [--requests-per-client 8] [--compact] [--device cuda|cpu]

Prints one JSON line per combo, each with the device it ran on. Without
`--artifact` the config's model (random weights, torch seed 0, a V=6890
synthetic SMPL) is exported fresh into a temporary directory on the
device. Not ported yet (ROADMAP.md queue A item 3): `--sweep-window`,
`--overload` and `--server-subproc`.
"""

from __future__ import annotations

import argparse
import io
import json
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch
from ..device import default_device


def _make_payload(n_crops: int, rng: np.random.RandomState) -> bytes:
    # uint8 crops: the realistic client format and 4x fewer bytes than
    # float32 (the server normalizes, on the device for a uint8 artifact)
    crops = rng.randint(0, 256, (n_crops, 224, 224, 3), dtype=np.uint8)
    buf = io.BytesIO()
    np.savez(buf, img=crops)
    return buf.getvalue()


def run_combo(
    base: str,
    batcher,
    n_clients: int,
    crops_per_req: int,
    requests_per_client: int,
    check=None,
) -> dict:
    """`n_clients` threads, each posting `requests_per_client` requests of
    `crops_per_req` uint8 crops to `base`/predict back to back, after one
    settling request; raises if any request fails. `check(pairs)`, where
    given, gets every timed request's (request body, response body) pair
    after the timed window and fails the combo by raising."""
    payloads = [
        _make_payload(crops_per_req, np.random.RandomState(100 + i))
        for i in range(n_clients)
    ]
    # settle: one request primes the connection path and the bucket
    try:
        urllib.request.urlopen(
            urllib.request.Request(f"{base}/predict", data=payloads[0], method="POST"),
            timeout=600,
        ).read()
    except urllib.error.HTTPError as e:
        raise RuntimeError(f"settle request failed: {e.code} {e.read().decode()[:500]}") from e

    req0, disp0 = batcher.request_count, batcher.dispatch_count
    latencies: list[list[float]] = [[] for _ in range(n_clients)]
    errors: list[str] = []
    responses: list[tuple[bytes, bytes]] = []

    def client(i: int) -> None:
        req = urllib.request.Request(f"{base}/predict", data=payloads[i], method="POST")
        for _ in range(requests_per_client):
            t0 = time.perf_counter()
            try:
                body = urllib.request.urlopen(req, timeout=600).read()
            except Exception as e:  # noqa: BLE001 — record, then fail the combo
                detail = e.read().decode()[:500] if isinstance(e, urllib.error.HTTPError) else ""
                errors.append(f"{type(e).__name__}: {e} {detail}")
                return
            latencies[i].append(time.perf_counter() - t0)
            if check is not None:
                responses.append((payloads[i], body))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise RuntimeError(f"{len(errors)} client errors, first: {errors[0]}")
    if check is not None:
        check(responses)

    lat = np.sort(np.concatenate([np.asarray(c) for c in latencies]))
    # measured, not intended: the ratio uses what the batcher received
    total_reqs = batcher.request_count - req0
    dispatches = batcher.dispatch_count - disp0
    return {
        "clients": n_clients,
        "crops_per_request": crops_per_req,
        "requests": total_reqs,
        "p50_ms": float(np.percentile(lat, 50)) * 1e3,
        "p99_ms": float(np.percentile(lat, 99)) * 1e3,
        "crops_per_s": total_reqs * crops_per_req / wall,
        "dispatches": int(dispatches),
        "coalescence": total_reqs / max(dispatches, 1),
        "wall_s": wall,
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--artifact", default="",
                    help="serve this artifact (else export the --which config fresh)")
    ap.add_argument("--which", default="cliff", choices=["cliff", "pare"])
    ap.add_argument("--buckets", default="1,8,32,128")
    ap.add_argument("--uint8", action="store_true",
                    help="export with uint8_input=True (raw-crop ingest, on-device normalize)")
    ap.add_argument("--compact", action="store_true",
                    help="export with fp16 vertex/joint outputs")
    ap.add_argument("--window-ms", type=float, default=5.0)
    ap.add_argument("--combos", default="1x1,8x1,64x1,1x16,8x16,64x16",
                    help="comma list of <clients>x<crops_per_request>")
    ap.add_argument("--requests-per-client", type=int, default=8)
    ap.add_argument("--device", default=default_device(),
                    help="cuda or cpu (default: $POCO_TPU_PLATFORM, else cuda)")
    return ap


def main(argv=None) -> list[dict]:
    args = build_parser().parse_args(argv)

    from ..device import resolve_device
    from ..runtime.export import export_poco, load_exported
    from ..runtime.server import PocoServer

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        artifact = args.artifact
        if not artifact:
            from ..config import model_config_from_hparams, update_hparams
            from ..models.poco import POCO
            from ..smpl.assets import synthetic_smpl_model

            cfg = model_config_from_hparams(update_hparams(f"configs/poco_{args.which}.yaml"))
            torch.manual_seed(0)
            model = POCO(cfg).to(device).eval()
            artifact = f"{tmp}/poco_{args.which}"
            start = time.perf_counter()
            export_poco(model, synthetic_smpl_model(num_verts=6890, device=device), artifact,
                        batch_sizes=tuple(int(b) for b in args.buckets.split(",")),
                        uint8_input=args.uint8, compact=args.compact, device=device)
            print(f"exported -> {artifact} ({time.perf_counter() - start:.1f} s)", flush=True)
            del model
        server = PocoServer(load_exported(artifact, device=device), port=0,
                            batch_window_ms=args.window_ms).start(warmup=True)
        rows = []
        try:
            base = f"http://127.0.0.1:{server.port}"
            kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
            for combo in args.combos.split(","):
                n_clients, crops = (int(v) for v in combo.split("x"))
                row = {"window_ms": args.window_ms, "device": kind,
                       **run_combo(base, server.batcher, n_clients, crops,
                                   args.requests_per_client)}
                print(json.dumps(row), flush=True)
                rows.append(row)
        finally:
            server.stop()
    return rows


if __name__ == "__main__":
    main()
