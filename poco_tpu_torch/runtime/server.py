"""Minimal HTTP inference server over an exported artifact.

Port of `poco_tpu.runtime.server`: a threaded stdlib HTTP server whose
/predict endpoint takes an npz request body and streams back an npz of
model outputs, over an artifact of `runtime/export.py`. No web framework
(the stdlib only), but the contract is real: warm-up on start, batch
buckets, uint8 or pre-normalized float crops, a health endpoint,
micro-batching and backpressure.

Endpoints:
    GET  /healthz      -> {"status": "ok", "buckets": [...], ...}
    POST /predict      body: npz with the artifact's batch keys.
                       `img` may be uint8 HWC crops (normalized here with
                       the training constants, or on the device for a
                       uint8_input artifact) or float32 already-normalized.
                       Missing conditioning keys are defaulted like
                       make_dummy_batch. Response: npz of output arrays.
    POST /stats/reset  zero the observability counters.

One worker thread issues every call to the card (`MicroBatcher`); the
HTTP handler threads only parse, validate and wait.
"""

from __future__ import annotations

import collections
import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

import numpy as np

import torch

from ..constants import IMG_NORM_MEAN, IMG_NORM_STD
from .export import ExportedPoco, load_exported


def prepare_request_batch(
    model: ExportedPoco, arrays: dict[str, np.ndarray]
) -> dict[str, np.ndarray]:
    """Fill and normalize a request into a model batch.

    uint8 images are normalized with the training constants; absent
    CLIFF conditioning keys get the make_dummy_batch defaults (full
    crop, canonical focal length).

    Validation is strict: a malformed request coalesced into a shared
    micro-batch would otherwise fail its batchmates with a 500; shape
    errors must be caught here so the offender alone gets a 400.
    """
    if "img" not in arrays:
        raise KeyError("request must contain 'img'")
    img = np.asarray(arrays["img"])
    if img.ndim == 3:
        img = img[None]
    if img.ndim != 4 or img.shape[-1] != 3:
        raise ValueError(f"img must be (N, H, W, 3), got {img.shape}")
    res = int(model.meta["model_cfg"]["img_res"])
    if img.shape[1:3] != (res, res):
        raise ValueError(
            f"img must be {res}x{res} crops, got {img.shape[1]}x{img.shape[2]}"
        )
    if getattr(model, "uint8_input", False):
        # The artifact normalizes ON DEVICE: ship raw uint8 (4x fewer
        # request/upload bytes). A pre-normalized float body cannot be
        # recovered into uint8 — reject it rather than mis-normalize.
        if img.dtype != np.uint8:
            raise ValueError(
                "this artifact takes raw uint8 crops (on-device "
                f"normalize); got {img.dtype}"
            )
        n = img.shape[0]
        batch = {"img": img}
    else:
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
            img = (img - np.asarray(IMG_NORM_MEAN, np.float32)) / np.asarray(
                IMG_NORM_STD, np.float32
            )
        n = img.shape[0]
        batch = {"img": img.astype(np.float32)}
    defaults = {
        "bbox_info": np.zeros((n, 3), np.float32),
        "focal_length": np.full((n,), 1000.0, np.float32),
        "scale": np.full((n,), 1.0, np.float32),
        "center": np.full((n, 2), 500.0, np.float32),
        "orig_shape": np.full((n, 2), 1000.0, np.float32),
    }
    for k in model.batch_keys:
        if k == "img":
            continue
        if k in arrays:
            v = np.asarray(arrays[k], np.float32)
            want = defaults.get(k)
            if want is not None and v.shape != want.shape:
                raise ValueError(
                    f"'{k}' must have shape {want.shape} for a {n}-crop "
                    f"request, got {v.shape}"
                )
            batch[k] = v
        elif k in defaults:
            batch[k] = defaults[k]
        else:
            raise KeyError(f"request missing batch key '{k}'")
    return batch


class OverloadedError(RuntimeError):
    """Raised by MicroBatcher.submit when the pending-row budget is
    exhausted — the request is shed in microseconds instead of queueing
    toward an eventual timeout. Carries a Retry-After estimate derived
    from the backlog and the measured dispatch rate."""

    def __init__(self, msg: str, retry_after_s: float):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class MicroBatcher:
    """Coalesce concurrent requests into one device batch.

    The card's scaling axis is batch: N concurrent 1-crop requests
    should cost one padded dispatch, not N. A single worker
    thread takes the oldest pending request, keeps draining the queue
    until the largest bucket is full or `window_ms` elapses, runs ONE
    `predict` on the concatenated batch, and scatters the row ranges
    back to the waiting handler threads. Per-sample outputs are
    batchmate-independent (inference-mode BN uses running stats), so
    batching is invisible to clients.

    Backpressure: admission is bounded by ROWS (crops), not requests —
    a 16-crop request costs 16x a 1-crop one. `max_pending_rows`
    defaults to `queue_budget_waves` full waves of the largest bucket,
    i.e. the worst-case queueing delay is ~queue_budget_waves dispatch
    latencies; beyond that, submit() sheds instantly with
    OverloadedError instead of letting every queued client time out at
    p99=timeout (the failure mode a 600 s unbounded queue produces).
    """

    def __init__(self, model: ExportedPoco, window_ms: float = 5.0,
                 max_pending_rows: int | None = None,
                 queue_budget_waves: int = 12):
        self.model = model
        self.window = window_ms / 1000.0
        self.max_rows = model.batch_sizes[-1]
        self.max_pending_rows = (
            max_pending_rows
            if max_pending_rows is not None
            else queue_budget_waves * self.max_rows
        )
        self._queue: queue.Queue = queue.Queue()
        self.request_count = 0
        self.dispatch_count = 0
        self.rejected_count = 0
        # Server-side high-water mark of admitted rows: the budget-
        # adherence gauge an overload bench reads AFTER the flood (a
        # client-side sampler under-counts — it only sees the gauge
        # between its own requests).
        self.pending_rows_hwm = 0
        self._pending_rows = 0
        self._pending_lock = threading.Lock()
        # Smoothed device throughput (rows/s) for Retry-After estimates;
        # seeded pessimistically so a cold server suggests a real wait.
        self._rows_per_s = 100.0
        # Rolling per-wave dispatch->fetch latencies for /healthz
        # observability (bounded; appended by the single worker thread,
        # read by handler threads under _wave_lock).
        self._wave_lat: collections.deque = collections.deque(maxlen=256)
        self._wave_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    @property
    def pending_rows(self) -> int:
        return self._pending_rows

    def reset_stats(self) -> None:
        """Zero the observability counters (rejected count, pending-row
        high-water mark, wave latencies) so a measurement window reads
        its OWN behavior, not the all-time peak. Admission state itself
        (pending rows, budget) is untouched."""
        with self._pending_lock:
            self.pending_rows_hwm = self._pending_rows
        self.rejected_count = 0
        with self._wave_lock:
            self._wave_lat.clear()

    def latency_stats(self) -> dict:
        """Rolling wave latency for /healthz: p50/p99 of the last <=256
        device waves (dispatch to fetch-complete, ms) + the smoothed
        rows/s throughput behind Retry-After estimates."""
        # Unlike the JAX server, which sorts the deque while the worker
        # may append to it ("deque mutated during iteration"), the
        # snapshot is taken under the lock the worker appends under.
        with self._wave_lock:
            lat = sorted(self._wave_lat)
        if not lat:
            return {"waves_measured": 0, "rows_per_s": round(
                self._rows_per_s, 1)}
        def pct(p: float) -> float:
            return lat[min(int(p * (len(lat) - 1) + 0.5), len(lat) - 1)]
        return {
            "waves_measured": len(lat),
            "wave_p50_ms": round(pct(0.50) * 1e3, 2),
            "wave_p99_ms": round(pct(0.99) * 1e3, 2),
            "rows_per_s": round(self._rows_per_s, 1),
        }

    def overloaded_precheck(self) -> float | None:
        """Cheap pre-admission probe: if the budget is already full,
        return a Retry-After estimate (else None). Lets the HTTP layer
        shed BEFORE reading a multi-MB request body — the rejected
        client pays connect+headers, not upload+parse."""
        with self._pending_lock:
            if self._pending_rows >= self.max_pending_rows:
                self.rejected_count += 1
                return min(
                    60.0, max(1.0, self._pending_rows / self._rows_per_s)
                )
        return None

    def submit(self, batch: dict[str, np.ndarray],
               timeout: float = 600.0) -> dict[str, np.ndarray]:
        n = int(np.shape(batch[next(iter(batch))])[0])
        with self._pending_lock:
            if self._pending_rows + n > self.max_pending_rows:
                self.rejected_count += 1
                backlog = self._pending_rows
                retry = min(60.0, max(1.0, backlog / self._rows_per_s))
                raise OverloadedError(
                    f"server overloaded: {backlog} crops pending "
                    f"(budget {self.max_pending_rows})", retry,
                )
            self._pending_rows += n
            if self._pending_rows > self.pending_rows_hwm:
                self.pending_rows_hwm = self._pending_rows
        item = {"batch": batch, "n": n,
                "event": threading.Event(), "out": None, "err": None}
        self.request_count += 1
        self._queue.put(item)
        if not item["event"].wait(timeout=timeout):
            raise TimeoutError("prediction timed out")
        if item["err"] is not None:
            raise item["err"]
        return item["out"]

    def _loop(self) -> None:
        # Depth-1 dispatch pipeline, SINGLE thread: wave N+1 is
        # dispatched (the upload, the program's launches and the
        # non-blocking copies to pinned host buffers are enqueued on the
        # stream and return) BEFORE wave N's outputs are waited for, so
        # N+1's host work overlaps N's device work. One thread issues
        # every CUDA call.
        prev: tuple[list, Any] | None = None
        while not self._stop.is_set():
            try:
                # With a wave in flight, don't sleep long on an empty
                # queue — its waiters are blocked on our finalize.
                first = self._queue.get(timeout=0.003 if prev else 0.1)
            except queue.Empty:
                if prev is not None:
                    self._finalize(*prev)
                    prev = None
                continue
            items = [first]
            rows = first["n"]
            deadline = time.monotonic() + self.window
            while rows < self.max_rows:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                items.append(nxt)
                rows += nxt["n"]
            # A cold bucket's first call (cuDNN's algorithm search, a
            # kernel's build) runs SYNCHRONOUSLY inside the dispatch
            # call — don't hold wave N's already-computed responses
            # hostage to it: flush N first.
            if prev is not None and not self.model.is_warm(rows):
                self._finalize(*prev)
                prev = None
            pending = None
            try:
                if len(items) == 1:
                    merged = first["batch"]
                else:
                    merged = {
                        k: np.concatenate(
                            [np.asarray(it["batch"][k]) for it in items],
                            axis=0,
                        )
                        for k in first["batch"]
                    }
                self.dispatch_count += 1
                pending = self.model.predict_async(merged)
            except Exception as e:  # noqa: BLE001 — fail the waiters, not the loop
                for it in items:
                    it["err"] = e
                self._complete(items)
            if prev is not None:
                self._finalize(*prev)
                prev = None
            if pending is not None:
                prev = (items, pending, time.monotonic(), rows)
        if prev is not None:
            self._finalize(*prev)

    def _finalize(self, items: list, pending, t_dispatch: float = 0.0,
                  rows: int = 0) -> None:
        """Fetch a dispatched wave's outputs and wake its waiters."""
        try:
            out = pending.result()
            if rows and t_dispatch:
                dt = max(time.monotonic() - t_dispatch, 1e-6)
                # EMA of device throughput feeding Retry-After estimates
                self._rows_per_s = 0.7 * self._rows_per_s + 0.3 * (rows / dt)
                with self._wave_lock:
                    self._wave_lat.append(dt)
            offset = 0
            for it in items:
                it["out"] = {
                    k: v[offset : offset + it["n"]] for k, v in out.items()
                }
                offset += it["n"]
        except Exception as e:  # noqa: BLE001 — fail the waiters, not the loop
            for it in items:
                it["err"] = e
        self._complete(items)

    def _complete(self, items: list) -> None:
        """Return admitted rows to the budget and wake the waiters."""
        freed = sum(it["n"] for it in items)
        with self._pending_lock:
            self._pending_rows -= freed
        for it in items:
            it["event"].set()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10)


def _npz_bytes(arrays: dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **{k: np.asarray(v) for k, v in arrays.items()})
    return buf.getvalue()


class _Handler(BaseHTTPRequestHandler):
    server_version = "poco-torch-serve/1.0"
    # HTTP/1.1 so `Expect: 100-continue` is honored (handle_expect_100
    # below): an overloaded server then sheds BEFORE the client uploads
    # its multi-MB body — the shed costs connect+headers, milliseconds,
    # instead of an upload bounded by the server's drain pacing.
    # Connection semantics stay one-request-per-connection (every
    # handler sets close_connection), so the in-flight thread cap keeps
    # meaning requests, not idle keep-alives.
    protocol_version = "HTTP/1.1"
    model: ExportedPoco  # set on the server class

    def handle_expect_100(self):
        """Admission check at the Expect handshake (RFC 9110 §10.1.1).

        Overloaded + /predict -> final 429 with Retry-After; the client
        never sends the body. Otherwise 100 Continue as usual."""
        if self.path == "/predict":
            batcher = getattr(self.server, "batcher", None)
            if batcher is not None:
                retry = batcher.overloaded_precheck()
                if retry is not None:
                    self.close_connection = True
                    self._send_429(
                        retry, "server overloaded: admission budget full"
                    )
                    return False
        return super().handle_expect_100()

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        try:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass  # client gave up mid-response; nothing to salvage

    def _send_json(self, code: int, obj: dict) -> None:
        self._send(code, json.dumps(obj).encode(), "application/json")

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def do_GET(self):
        # one request per connection: an idle keep-alive must not hold
        # an in-flight handler slot (HTTP/1.1 defaults to persistent)
        self.close_connection = True
        if self.path == "/healthz":
            m = self.server.model  # type: ignore[attr-defined]
            b = self.server.batcher  # type: ignore[attr-defined]
            self._send_json(200, {
                "status": "ok",
                "buckets": m.batch_sizes,
                "batch_keys": m.batch_keys,
                "compact": m.meta.get("compact", False),
                "model": m.meta["model_cfg"]["backbone"],
                "device": str(getattr(m, "device", "")),
                "requests": b.request_count,
                "dispatches": b.dispatch_count,
                "rejected": b.rejected_count,
                "pending_rows": b.pending_rows,
                "pending_rows_hwm": b.pending_rows_hwm,
                "max_pending_rows": b.max_pending_rows,
                "refused_at_accept": getattr(
                    self.server, "refused_count", 0
                ),
                **b.latency_stats(),
            })
        else:
            self._send_json(404, {"error": f"no route {self.path}"})

    def _send_429(self, retry_after_s: float, msg: str) -> None:
        body = json.dumps({"error": msg}).encode()
        try:
            self.send_response(429)
            self.send_header("Retry-After", str(int(round(retry_after_s))))
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass

    def _drain_body(self, cap: int = 64 << 20) -> None:
        """Discard up to `cap` bytes of an unread request body in chunks
        (constant memory). Bodies beyond the cap are left unread — the
        close then RSTs, which is the right outcome for an upload too
        large to be worth draining."""
        try:
            left = min(int(self.headers.get("Content-Length", "0")), cap)
            while left > 0:
                chunk = self.rfile.read(min(left, 1 << 20))
                if not chunk:
                    break
                left -= len(chunk)
        except (OSError, ValueError):
            pass

    def do_POST(self):
        self.close_connection = True  # see do_GET
        if self.path == "/stats/reset":
            # Observability window reset (per-flood benches): counters
            # only, never admission state.
            self.server.batcher.reset_stats()  # type: ignore[attr-defined]
            if hasattr(self.server, "refused_count"):
                self.server.refused_count = 0
            self._send_json(200, {"status": "reset"})
            return
        if self.path != "/predict":
            self._send_json(404, {"error": f"no route {self.path}"})
            return
        batcher = self.server.batcher  # type: ignore[attr-defined]
        retry = batcher.overloaded_precheck()
        if retry is not None:
            # Shed BEFORE parsing the body: the request is doomed anyway
            # and decoding its (multi-MB) npz would cost host memory.
            # Respond first — the client sees the 429 as soon as its
            # upload completes — then drain a bounded amount of the
            # unread body so the close is a clean FIN: closing with
            # unread data in the socket sends an RST that can destroy
            # the in-flight 429 before the client reads it.
            self.close_connection = True
            self._send_429(retry, "server overloaded: admission budget full")
            self._drain_body()
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
            body = self.rfile.read(length)
            try:
                with np.load(io.BytesIO(body)) as z:
                    arrays = {k: z[k] for k in z.files}
            except Exception as e:  # noqa: BLE001 — any parse failure
                # is the client's malformed body (empty -> EOFError,
                # truncated zip -> BadZipFile, pickled -> ValueError):
                # a 400, never a 500
                self._send_json(
                    400,
                    {"error":
                     f"malformed npz body: {type(e).__name__}: {e}"},
                )
                return
            model = self.server.model  # type: ignore[attr-defined]
            out = self.server.batcher.submit(  # type: ignore[attr-defined]
                prepare_request_batch(model, arrays)
            )
            self._send(200, _npz_bytes(out), "application/octet-stream")
        except OverloadedError as e:
            # Shed early and cheaply: the client learns in milliseconds
            # (with a backlog-derived Retry-After) instead of queueing
            # toward the 600 s submit timeout. (The pre-read probe above
            # catches a full budget; this path catches a request whose
            # row count would overflow a non-full one.)
            self._send_429(e.retry_after_s, str(e))
        except (KeyError, ValueError) as e:
            self._send_json(400, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 — serving must not die
            self._send_json(500, {"error": f"{type(e).__name__}: {e}"})


class _Server(ThreadingHTTPServer):
    # Default socketserver backlog is 5: a 64-client connect wave gets
    # connection-reset before a single request is read.
    request_queue_size = 128

    # In-flight handler-thread cap: ThreadingHTTPServer otherwise spawns
    # one thread per accepted connection without bound, so a client
    # flood grows host memory with the flood. Connections beyond the cap
    # are refused AT ACCEPT with a raw 503 — no thread, no body read,
    # constant cost per refusal.
    max_handler_threads = 128

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._handler_slots = threading.BoundedSemaphore(
            self.max_handler_threads
        )
        self.refused_count = 0

    def process_request(self, request, client_address):
        if not self._handler_slots.acquire(blocking=False):
            self.refused_count += 1
            body = b'{"error": "too many in-flight connections"}'
            try:
                request.sendall(
                    b"HTTP/1.1 503 Service Unavailable\r\n"
                    b"Retry-After: 1\r\n"
                    b"Content-Type: application/json\r\n"
                    b"Content-Length: " + str(len(body)).encode() + b"\r\n"
                    b"Connection: close\r\n\r\n" + body
                )
            except OSError:
                pass
            self.shutdown_request(request)
            return
        try:
            super().process_request(request, client_address)
        except BaseException:
            self._handler_slots.release()
            raise

    def process_request_thread(self, request, client_address):
        try:
            super().process_request_thread(request, client_address)
        finally:
            self._handler_slots.release()


class PocoServer:
    """Threaded HTTP server bound to an exported artifact.

    Device work is funneled through a MicroBatcher: the device runs
    one program at a time anyway, so concurrency belongs in the batch
    (concurrent requests coalesce into one padded dispatch), not in
    racing dispatches. A path is loaded on `device`, CUDA unless the
    caller asks for the CPU (no card raises), a data-parallel artifact's
    replicas on `devices` where they are named.
    """

    def __init__(self, artifact: str | ExportedPoco,
                 host: str = "127.0.0.1", port: int = 0,
                 batch_window_ms: float = 5.0,
                 max_pending_rows: int | None = None,
                 max_handler_threads: int | None = None,
                 device: str | torch.device = "cuda",
                 devices: list[str | torch.device] | None = None):
        # an artifact loaded here is closed by `stop`; one passed in, by its owner
        self._owns_model = not isinstance(artifact, ExportedPoco)
        self.model = (
            load_exported(artifact, device=device, devices=devices) if self._owns_model
            else artifact
        )
        self.batcher = MicroBatcher(
            self.model, window_ms=batch_window_ms,
            max_pending_rows=max_pending_rows,
        )
        server_cls = _Server
        if max_handler_threads is not None:
            server_cls = type(
                "_Server", (_Server,),
                {"max_handler_threads": int(max_handler_threads)},
            )
        self.httpd = server_cls((host, port), _Handler)
        self.httpd.model = self.model  # type: ignore[attr-defined]
        self.httpd.batcher = self.batcher  # type: ignore[attr-defined]
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self, warmup: bool = True) -> "PocoServer":
        if warmup:
            self.model.warmup()
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def serve_forever(self, warmup: bool = True) -> None:
        if warmup:
            self.model.warmup()
        self.httpd.serve_forever()

    def stop(self) -> None:
        self.httpd.shutdown()
        if self._thread is not None:
            self._thread.join(timeout=10)
        self.httpd.server_close()
        self.batcher.stop()
        if self._owns_model:
            self.model.close()
