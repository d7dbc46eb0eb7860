"""Load benchmark of the HTTP serving path (`runtime/server.py`): the
port's counterpart of the repo's `tools/bench_serving.py`, with its modes
and JSON keys.

Drives a `PocoServer` with N concurrent clients over real HTTP on
localhost and reports, per (clients x crops-per-request) combo: p50 /
p99 request latency, crops/s over the run, and requests per device
dispatch (the micro-batcher's coalescence).

    python -m poco_tpu_torch.cli.bench_serving --uint8 \\
        [--combos 1x1,8x1,64x1,1x16,8x16,64x16] [--buckets 1,8,32,128] \\
        [--which cliff|pare] [--artifact DIR] [--window-ms 5] \\
        [--requests-per-client 8] [--compact] [--repeats N] [--device cuda|cpu]
    # the window sweep: one row per batch_window_ms, at --sweep-combo
    python -m poco_tpu_torch.cli.bench_serving --sweep-window 0,2,5,10,20
    # overload: flood past the admission budget, the server its own process
    python -m poco_tpu_torch.cli.bench_serving --overload --server-subproc \\
        --max-pending-rows 64 [--overload-clients 256 --overload-crops 16 \\
        --overload-duration 30 --overload-floods 2]
    # the serving path alone: tiny-cliff on the CPU, in-process
    python -m poco_tpu_torch.cli.bench_serving --loopback --repeats 5

Prints one JSON line per measurement, each with the device it ran on.
Without `--artifact` the config's model (random weights, torch seed 0, a
V=6890 synthetic SMPL) is exported fresh into a temporary directory on
the device, in bf16 as the JAX tool exports it; with `--loopback`,
tiny-cliff in fp32 on the CPU (the model's compute negligible, the
serving path's work on 6890-vertex outputs not). `--repeats N` prints
every run and a median row whose runs more than 5% off the median are
run again (at most 3 times, the repo's `bench.py` rule). `--overload`
prints a `"scenario": "overload"` row a flood: rejections must be 429
or 503 with a Retry-After, the server's pending-row high-water mark
within its budget; with `--server-subproc` the server is
`python -m poco_tpu_torch.cli.serve` in a process of its own, so that
its peak RSS (`/proc/<pid>/status`: VmHWM, or VmRSS sampled where the
kernel keeps no VmHWM; the row's `rss_source`) leaves out the flood
clients' buffers.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import torch
from ..device import default_device

REPO = Path(__file__).resolve().parents[2]   # the checkout holding the package
OUTLIER_TOL = 0.05   # a repeat more than this far off the median is run again
MAX_RERUNS = 3


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
    gc_off: bool = False,
) -> dict:
    """`n_clients` threads, each posting `requests_per_client` requests of
    `crops_per_req` uint8 crops to `base`/predict back to back, after one
    settling request; raises if any request fails. `check(pairs)`, where
    given, gets every timed request's (request body, response body) pair
    after the timed window and fails the combo by raising. `gc_off` keeps
    the garbage collector off while timing (the loopback trend)."""
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
    if gc_off:
        # a collection over the multi-MB npz buffers inside the window is
        # noise of the protocol, not of the path: collect first, and keep
        # the collector off only while timing
        import gc

        gc.collect()
        gc.disable()
    try:
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
    finally:
        if gc_off:
            gc.enable()
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


def run_overload(
    base: str,
    stats_fn,
    rss_mb_fn,
    n_clients: int,
    crops_per_req: int,
    duration_s: float,
) -> dict:
    """Flood the server past its admission budget for `duration_s` and
    measure the shape of the failure: rejections must come in
    milliseconds (429 / 503 with Retry-After), accepted requests must
    still complete, the server's memory must stay flat, and its pending-row
    high-water mark within the budget.

    `stats_fn()` returns the /healthz counters (read after the flood);
    `rss_mb_fn()` the server's peak RSS in MB (the server process alone
    with --server-subproc). While the flood runs, raw `Expect:
    100-continue` probes time the shed decision without an upload."""
    payloads = [
        _make_payload(crops_per_req, np.random.RandomState(500 + i))
        for i in range(n_clients)
    ]
    # settle (primes the bucket so that accepted latency is warm); a budget
    # smaller than one payload sheds it, and the flood is measured cold
    try:
        urllib.request.urlopen(
            urllib.request.Request(f"{base}/predict", data=payloads[0], method="POST"),
            timeout=600,
        ).read()
    except urllib.error.HTTPError as e:
        if e.code not in (429, 503):
            raise RuntimeError(f"settle request failed: {e.code} {e.read().decode()[:500]}") from e
        e.read()
        print(f"settle request shed ({e.code}); measuring cold", file=sys.stderr)

    rss0 = rss_mb_fn()
    tally_lock = threading.Lock()
    ok_lat: list[float] = []
    shed_lat: list[float] = []
    shed_codes: dict[int, int] = {}
    retry_afters: list[int] = []
    shed_without_retry_after = [0]
    conn_resets = [0]
    errors: list[str] = []
    stop_at = time.monotonic() + duration_s

    def client(i: int) -> None:
        req = urllib.request.Request(f"{base}/predict", data=payloads[i], method="POST")
        while time.monotonic() < stop_at:
            t0 = time.perf_counter()
            try:
                urllib.request.urlopen(req, timeout=600).read()
                with tally_lock:
                    ok_lat.append(time.perf_counter() - t0)
            except urllib.error.HTTPError as e:
                dt = time.perf_counter() - t0
                if e.code in (429, 503):
                    ra = e.headers.get("Retry-After")
                    with tally_lock:
                        shed_lat.append(dt)
                        shed_codes[e.code] = shed_codes.get(e.code, 0) + 1
                        if ra:
                            retry_afters.append(int(ra))
                        else:
                            shed_without_retry_after[0] += 1
                    e.read()
                else:
                    with tally_lock:
                        errors.append(f"HTTP {e.code}: {e.read()[:200]}")
                    return
            except (urllib.error.URLError, ConnectionError, OSError):
                # expected under deliberate overload: the accept-time 503
                # and a shed whose body outran the drain cap close
                # connections that can reset mid-exchange
                with tally_lock:
                    conn_resets[0] += 1
            except Exception as e:  # noqa: BLE001 — record, then fail the flood
                with tally_lock:
                    errors.append(f"{type(e).__name__}: {e}")
                return

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    # while the flood holds the budget full: the decision latency of an
    # Expect: 100-continue shed, which never uploads its body
    time.sleep(min(2.0, duration_s / 4))
    host, port = base.split("//", 1)[1].split(":")
    probe_lat: list[float] = []
    probe_shed = 0
    body_len = len(payloads[0])
    for _ in range(50):
        if time.monotonic() >= stop_at:
            break
        try:
            status, dt, _ra = expect_shed_probe(host, int(port), body_len)
        except OSError:
            continue  # an accept-time 503 reset under the herd: not a probe
        if status in (429, 503):
            probe_shed += 1
            probe_lat.append(dt)
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    rss1 = rss_mb_fn()
    stats = stats_fn()
    if errors:
        raise RuntimeError(f"{len(errors)} client errors, first: {errors[0]}")

    ok = np.sort(np.asarray(ok_lat)) if ok_lat else np.asarray([np.nan])
    shed = np.sort(np.asarray(shed_lat)) if shed_lat else np.asarray([np.nan])
    return {
        "scenario": "overload",
        "clients": n_clients,
        "crops_per_request": crops_per_req,
        "duration_s": wall,
        "accepted": len(ok_lat),
        "rejected": len(shed_lat),
        "rejected_by_code": shed_codes,
        "rejected_without_retry_after": shed_without_retry_after[0],
        "accepted_crops_per_s": len(ok_lat) * crops_per_req / wall,
        "accepted_p50_ms": float(np.percentile(ok, 50)) * 1e3,
        "accepted_p99_ms": float(np.percentile(ok, 99)) * 1e3,
        "shed_p50_ms": float(np.percentile(shed, 50)) * 1e3,
        "shed_p99_ms": float(np.percentile(shed, 99)) * 1e3,
        "retry_after_s_median": int(np.median(retry_afters)) if retry_afters else None,
        "conn_resets": conn_resets[0],
        "expect_probes_shed": probe_shed,
        "expect_shed_p50_ms": float(np.percentile(probe_lat, 50)) * 1e3 if probe_lat else None,
        "expect_shed_p99_ms": float(np.percentile(probe_lat, 99)) * 1e3 if probe_lat else None,
        "pending_rows_hwm": stats["pending_rows_hwm"],
        "budget_rows": stats["max_pending_rows"],
        "rss_peak_delta_mb": rss1 - rss0,
        "refused_at_accept": stats["refused_at_accept"],
    }


def expect_shed_probe(
    host: str, port: int, body_len: int, timeout: float = 30.0
) -> tuple[int, float, int | None]:
    """A raw HTTP/1.1 POST with `Expect: 100-continue` (RFC 9110), whose
    body is never sent: returns (status, seconds to the decision,
    Retry-After). On a shed the decision latency is connect + headers,
    the true cost of a rejection. (urllib cannot send Expect.)"""
    s = socket.create_connection((host, port), timeout=timeout)
    try:
        req = (
            f"POST /predict HTTP/1.1\r\nHost: {host}\r\n"
            f"Content-Length: {body_len}\r\n"
            f"Expect: 100-continue\r\nConnection: close\r\n\r\n"
        )
        t0 = time.perf_counter()
        s.sendall(req.encode())
        data = b""
        while b"\r\n\r\n" not in data:
            chunk = s.recv(65536)
            if not chunk:
                break
            data += chunk
        dt = time.perf_counter() - t0
        head = data.split(b"\r\n\r\n", 1)[0].decode("latin1", "replace")
        parts = head.split()
        if len(parts) < 2 or not parts[1].isdigit():
            # an empty or garbled answer (the accept-time refusal's socket
            # closed clean): the connection-level failure it is
            raise OSError(f"no HTTP status in response: {head[:80]!r}")
        retry_after = None
        for ln in head.split("\r\n"):
            if ln.lower().startswith("retry-after:"):
                retry_after = int(ln.split(":", 1)[1])
        return int(parts[1]), dt, retry_after
    finally:
        s.close()


def _status_mb(pid: int, field: str) -> float | None:
    """A `kB` field of /proc/<pid>/status in MB; None where it is absent."""
    with open(f"/proc/{pid}/status") as f:
        for ln in f:
            if ln.startswith(field + ":"):
                return int(ln.split()[1]) / 1024.0
    return None


class PeakRss:
    """Peak RSS of a process in MB, called for the overload's memory
    verdict: VmHWM of /proc/<pid>/status where the kernel keeps it;
    where it does not (some container kernels' /proc has VmRSS alone), the
    largest VmRSS that a thread samples every 10 ms until `close()`."""

    def __init__(self, pid: int):
        self.pid = pid
        self.source = "VmHWM" if _status_mb(pid, "VmHWM") is not None else "VmRSS sampled"
        self._peak = 0.0
        self._stop = threading.Event()
        self._thread = None
        if self.source != "VmHWM":
            if _status_mb(pid, "VmRSS") is None:
                raise RuntimeError(f"/proc/{pid}/status has neither VmHWM nor VmRSS")
            self._thread = threading.Thread(target=self._sample, daemon=True)
            self._thread.start()

    def _sample(self) -> None:
        while not self._stop.wait(0.01):
            try:
                self._peak = max(self._peak, _status_mb(self.pid, "VmRSS") or 0.0)
            except OSError:
                return   # the process is gone

    def __call__(self) -> float:
        if self.source == "VmHWM":
            return _status_mb(self.pid, "VmHWM")
        self._peak = max(self._peak, _status_mb(self.pid, "VmRSS") or 0.0)
        return self._peak

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)


def _spawn_server_subproc(artifact: str, args, device: torch.device):
    """Start `python -m poco_tpu_torch.cli.serve` on the artifact and wait
    until it answers /healthz (after its warm-up). Returns (proc,
    base_url). A process of its own is what makes the overload's memory
    verdict the server's: in-process, the peak RSS counts the flood
    clients' payload buffers too."""
    cmd = [
        sys.executable, "-m", "poco_tpu_torch.cli.serve", "--artifact", artifact,
        "--host", "127.0.0.1", "--port", "0", "--batch-window-ms", str(args.window_ms),
        "--device", str(device),
    ]
    if args.max_pending_rows is not None:
        cmd += ["--max-pending-rows", str(args.max_pending_rows)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True, cwd=REPO)
    line = proc.stdout.readline()
    m = re.search(r"on 127\.0\.0\.1:(\d+)", line)
    if not m:
        _stop(proc)
        raise RuntimeError(f"server did not announce a port: {line!r}")
    base = f"http://127.0.0.1:{m.group(1)}"
    deadline = time.monotonic() + 600
    while True:
        try:
            urllib.request.urlopen(f"{base}/healthz", timeout=5).read()
            return proc, base
        except Exception:  # noqa: BLE001 — retry until warm or dead
            if proc.poll() is not None:
                raise RuntimeError(
                    f"server subprocess died during warmup (rc={proc.returncode})"
                ) from None
            if time.monotonic() > deadline:
                _stop(proc)
                raise RuntimeError("server warmup timed out") from None
            time.sleep(0.5)


def _stop(proc) -> None:
    proc.terminate()
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=10)


def _adjudicate(samples: list[float], sample_fn) -> tuple[list[float], dict]:
    """Runs more than OUTLIER_TOL off the median are run again (at most
    MAX_RERUNS times), and the verdict rides in the row: the repo's
    `bench.py` rule for a spread."""
    samples = list(samples)
    info: dict = {"outliers_rerun": [], "rerun_values": []}
    for _ in range(MAX_RERUNS):
        med = float(np.median(samples))
        dev = [abs(s - med) / med for s in samples]
        worst = int(np.argmax(dev))
        if dev[worst] <= OUTLIER_TOL:
            break
        info["outliers_rerun"].append(samples.pop(worst))
        new = float(sample_fn())
        info["rerun_values"].append(new)
        samples.append(new)
    med = float(np.median(samples))
    residual = [s for s in samples if abs(s - med) / med > OUTLIER_TOL]
    if not info["outliers_rerun"] and not residual:
        info["verdict"] = "clean"
    elif not residual:
        info["verdict"] = "outliers_replaced"
    else:
        info["verdict"] = "unstable"
        info["residual_outliers"] = residual
    info["tol_pct"] = OUTLIER_TOL * 100
    return samples, info


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--artifact", default="",
                    help="serve this artifact (else export the --which config fresh, bf16)")
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
    ap.add_argument("--sweep-window", default="",
                    help="comma list of window_ms; sweeps at --sweep-combo")
    ap.add_argument("--sweep-combo", default="64x1")
    ap.add_argument("--overload", action="store_true",
                    help="flood past the admission budget for --overload-duration seconds and "
                         "report shed latency, memory and budget adherence")
    ap.add_argument("--overload-clients", type=int, default=256)
    ap.add_argument("--overload-crops", type=int, default=16)
    ap.add_argument("--overload-duration", type=float, default=30.0)
    ap.add_argument("--overload-floods", type=int, default=2,
                    help="floods against the same server; a near-zero peak-RSS delta on the "
                         "second and later is the memory-stays-flat proof")
    ap.add_argument("--server-subproc", action="store_true",
                    help="run the server as its own process (python -m "
                         "poco_tpu_torch.cli.serve), so the overload's memory verdict is "
                         "the server's")
    ap.add_argument("--max-pending-rows", type=int, default=None)
    ap.add_argument("--loopback", action="store_true",
                    help="the serving path alone: tiny-cliff in fp32 on the CPU, in-process")
    ap.add_argument("--repeats", type=int, default=1,
                    help="run each combo N times: per-run rows and a median + spread row")
    ap.add_argument("--device", default=default_device(),
                    help="cuda or cpu (default: $POCO_TPU_PLATFORM, else cuda; "
                         "--loopback: cpu)")
    return ap


def _export(args, device: torch.device, buckets: tuple[int, ...], out: str) -> None:
    from ..models.poco import POCO, PocoConfig
    from ..runtime.export import export_poco
    from ..smpl.assets import synthetic_smpl_model

    if args.loopback:
        cfg, dtype = PocoConfig(backbone="tiny-cliff", num_neurons=(64,), context_dim=64), "fp32"
    else:
        from ..config import model_config_from_hparams, update_hparams

        cfg = model_config_from_hparams(update_hparams(f"configs/poco_{args.which}.yaml"))
        dtype = "bf16"
    torch.manual_seed(0)
    model = POCO(cfg).to(device).eval()
    start = time.perf_counter()
    export_poco(model, synthetic_smpl_model(num_verts=6890, device=device), out,
                batch_sizes=buckets, uint8_input=args.uint8, compact=args.compact,
                device=device, dtype=dtype)
    print(f"exported -> {out} ({dtype}, {time.perf_counter() - start:.1f} s)", file=sys.stderr,
          flush=True)


def main(argv=None) -> list[dict]:
    args = build_parser().parse_args(argv)

    from ..device import resolve_device
    from ..runtime.export import load_exported
    from ..runtime.server import PocoServer

    device = resolve_device("cpu" if args.loopback else args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    rows: list[dict] = []

    def emit(row: dict) -> None:
        row = {**row, "device": kind}
        print(json.dumps(row), flush=True)
        rows.append(row)

    with tempfile.TemporaryDirectory() as tmp:
        artifact = args.artifact
        if not artifact:
            artifact = os.path.join(tmp, f"poco_{'loopback' if args.loopback else args.which}")
            _export(args, device, tuple(int(b) for b in args.buckets.split(",")), artifact)
        loaded: list = []

        def serve(window_ms: float) -> PocoServer:
            # loaded once: the window sweep serves it again per setting
            if not loaded:
                loaded.append(load_exported(artifact, device=device))
            return PocoServer(loaded[0], port=0, batch_window_ms=window_ms,
                              max_pending_rows=args.max_pending_rows).start(warmup=True)

        if args.overload:
            def flood(base: str, stats_fn, rss: PeakRss) -> None:
                try:
                    for i in range(args.overload_floods):
                        if i:   # each flood reports its own counters
                            urllib.request.urlopen(urllib.request.Request(
                                f"{base}/stats/reset", data=b"", method="POST"),
                                timeout=60).read()
                        row = run_overload(base, stats_fn, rss, args.overload_clients,
                                           args.overload_crops, args.overload_duration)
                        emit({**row, "flood": i, "rss_source": rss.source})
                finally:
                    rss.close()

            if args.server_subproc:
                proc, base = _spawn_server_subproc(artifact, args, device)
                try:
                    def stats_fn() -> dict:
                        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
                            return json.loads(r.read())

                    flood(base, stats_fn, PeakRss(proc.pid))
                finally:
                    _stop(proc)
            else:
                server = serve(args.window_ms)
                try:
                    def stats_fn() -> dict:
                        b = server.batcher
                        return {"pending_rows_hwm": b.pending_rows_hwm,
                                "max_pending_rows": b.max_pending_rows,
                                "refused_at_accept": server.httpd.refused_count}

                    flood(f"http://127.0.0.1:{server.port}", stats_fn, PeakRss(os.getpid()))
                finally:
                    server.stop()
            return rows

        if args.sweep_window:
            n_clients, crops = (int(v) for v in args.sweep_combo.split("x"))
            for w in (float(v) for v in args.sweep_window.split(",")):
                server = serve(w)
                try:
                    row = run_combo(f"http://127.0.0.1:{server.port}", server.batcher,
                                    n_clients, crops, args.requests_per_client)
                finally:
                    server.stop()
                emit({"window_ms": w, **row})
            return rows

        server = serve(args.window_ms)
        try:
            base = f"http://127.0.0.1:{server.port}"
            for combo in args.combos.split(","):
                n_clients, crops = (int(v) for v in combo.split("x"))

                def one_run() -> dict:
                    return run_combo(base, server.batcher, n_clients, crops,
                                     args.requests_per_client, gc_off=args.loopback)

                runs = []
                for r in range(args.repeats):
                    row = {"window_ms": args.window_ms, **one_run()}
                    if args.repeats > 1:
                        row["run"] = r
                    emit(row)
                    runs.append(row["crops_per_s"])
                if args.repeats > 1:
                    runs, adjudication = _adjudicate(runs, lambda: one_run()["crops_per_s"])
                    med = float(np.median(runs))
                    emit({"combo": combo, "loopback": bool(args.loopback),
                          "median_crops_per_s": med,
                          "spread_pct": (max(runs) - min(runs)) / med * 100 if med else 0.0,
                          "runs": runs, **adjudication})
        finally:
            server.stop()
    return rows


if __name__ == "__main__":
    main()
