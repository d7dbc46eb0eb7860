"""The port's HTTP server (`poco_tpu_torch/runtime/server.py`) on the CPU,
case by case as tests/test_export.py holds the JAX one: the round trip,
isolation of concurrent requests, the micro-batcher's coalescing,
scattering and error propagation, request validation and the uint8
paths, the backpressure (429 over budget, the shed at `Expect:
100-continue`, 503 at the handler cap), `latency_stats` beside a
concurrent appender, the refusal to serve on a card that is not there,
`cli.bench_serving.run_combo` over loopback, a data-parallel artifact behind
the server, and the bench's loopback, window-sweep and overload modes.
"""

import io
import json
import socket
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from poco_tpu_torch.cli import bench_serving
from poco_tpu_torch.constants import IMG_NORM_MEAN, IMG_NORM_STD
from poco_tpu_torch.models.poco import POCO, PocoConfig
from poco_tpu_torch.runtime.export import export_poco, load_exported
from poco_tpu_torch.runtime.server import (
    MicroBatcher,
    OverloadedError,
    PocoServer,
    prepare_request_batch,
)
from poco_tpu_torch.smpl.assets import synthetic_smpl_model

from .test_torch_export import TINY


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module (see tests/test_torch_eval.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """A tiny-cliff artifact (seeded weights, V=96), buckets (2, 4), float
    input, on the CPU."""
    torch.manual_seed(0)
    model = POCO(PocoConfig(**TINY)).eval()
    out = str(tmp_path_factory.mktemp("served") / "tiny_cliff")
    export_poco(model, synthetic_smpl_model(num_verts=96, device="cpu"), out,
                batch_sizes=(2, 4), device="cpu")
    return out


class _Done:
    """A finished wave: what `PendingPrediction` is to the batcher."""

    def __init__(self, out):
        self._out = out

    def result(self):
        return self._out


class FakeBase:
    """The model interface `MicroBatcher` calls: `predict_async` runs the
    fake's `predict` at once, and every bucket is warm."""

    def is_warm(self, n):
        return True

    def predict_async(self, batch):
        return _Done(self.predict(batch))


def serve(artifact, **kwargs) -> PocoServer:
    return PocoServer(artifact, port=0, device="cpu", **kwargs).start(warmup=False)


def npz(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def post(base: str, body: bytes, path: str = "/predict", timeout: float = 120):
    req = urllib.request.Request(f"{base}{path}", data=body, method="POST")
    return urllib.request.urlopen(req, timeout=timeout).read()


def health(base: str) -> dict:
    return json.loads(urllib.request.urlopen(f"{base}/healthz", timeout=30).read())


class TestServer:
    def test_http_roundtrip(self, artifact):
        server = serve(artifact)
        try:
            base = f"http://127.0.0.1:{server.port}"
            h = health(base)
            assert h["status"] == "ok"
            assert h["buckets"] == [2, 4]
            assert h["device"] == "cpu"

            out = np.load(io.BytesIO(post(base, npz(img=np.zeros((3, 224, 224, 3), np.uint8)))))
            assert out["pred_pose"].shape == (3, 24, 3, 3)
            assert out["smpl_vertices"].shape == (3, 96, 3)

            # /healthz observability: rolling wave latency is live
            h = health(base)
            assert h["waves_measured"] >= 1
            assert h["wave_p50_ms"] > 0
            assert h["rows_per_s"] > 0

            # every malformed body is the client's error: 400, never 500
            for payload in (b"not-npz", b"", b"PK\x03\x04truncated"):
                with pytest.raises(urllib.error.HTTPError) as e:
                    post(base, payload, timeout=30)
                assert e.value.code == 400, payload
        finally:
            server.stop()

    def test_micro_batcher_coalesces_and_scatters(self):
        """Concurrent submits merge into few dispatches; each caller gets
        exactly its own rows back."""

        class FakeModel(FakeBase):
            batch_sizes = [8]

            def __init__(self):
                self.calls = []

            def predict(self, batch):
                self.calls.append(int(batch["x"].shape[0]))
                return {"y": np.asarray(batch["x"]) * 2.0}

        fake = FakeModel()
        mb = MicroBatcher(fake, window_ms=1000.0)
        try:
            results = {}

            def worker(i):
                results[i] = mb.submit({"x": np.full((1, 3), float(i), np.float32)})

            threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
                assert not t.is_alive()
            for i in range(4):
                np.testing.assert_allclose(results[i]["y"], np.full((1, 3), 2.0 * i))
            assert mb.request_count == 4
            # 4 near-simultaneous 1-row submits inside a 1 s window must
            # not take 4 dispatches
            assert mb.dispatch_count < 4, fake.calls
        finally:
            mb.stop()

    def test_micro_batcher_propagates_errors(self):
        class Boom(FakeBase):
            batch_sizes = [4]

            def predict(self, batch):
                raise RuntimeError("device on fire")

        mb = MicroBatcher(Boom(), window_ms=1.0)
        try:
            with pytest.raises(RuntimeError, match="device on fire"):
                mb.submit({"x": np.zeros((1, 2), np.float32)})
        finally:
            mb.stop()

    def test_concurrent_http_requests_are_isolated(self, artifact):
        """Distinct concurrent requests return their own predictions
        (batching is invisible to clients)."""
        server = serve(artifact, batch_window_ms=50.0)
        try:
            base = f"http://127.0.0.1:{server.port}"
            imgs = np.random.RandomState(7).randn(4, 1, 224, 224, 3).astype(np.float32)
            got = {}

            def fetch(i):
                got[i] = np.load(io.BytesIO(post(base, npz(img=imgs[i]))))

            threads = [threading.Thread(target=fetch, args=(i,)) for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
                assert not t.is_alive()
            for i in range(4):
                want = server.model.predict(prepare_request_batch(server.model, {"img": imgs[i]}))
                np.testing.assert_allclose(got[i]["pred_pose"], want["pred_pose"], atol=1e-5)
        finally:
            server.stop()

    def test_request_validation_rejects_bad_shapes(self, artifact):
        """Malformed requests fail in prepare_request_batch (a 400 to the
        offender) rather than poisoning a shared micro-batch."""
        loaded = load_exported(artifact, device="cpu")
        with pytest.raises(ValueError, match="224x224"):
            prepare_request_batch(loaded, {"img": np.zeros((1, 128, 128, 3), np.float32)})
        with pytest.raises(ValueError, match="bbox_info"):
            prepare_request_batch(loaded, {
                "img": np.zeros((2, 224, 224, 3), np.float32),
                "bbox_info": np.zeros((1, 3), np.float32),  # wrong leading dim
            })

    def test_prepare_request_normalizes_uint8(self, artifact):
        loaded = load_exported(artifact, device="cpu")
        batch = prepare_request_batch(loaded, {"img": np.full((1, 224, 224, 3), 255, np.uint8)})
        want = (1.0 - np.asarray(IMG_NORM_MEAN)) / np.asarray(IMG_NORM_STD)
        np.testing.assert_allclose(batch["img"][0, 0, 0], want, atol=1e-6)
        assert batch["focal_length"].shape == (1,)

    def test_prepare_request_uint8_passthrough(self, artifact):
        """For a uint8_input artifact the server does not normalize on the
        host: raw bytes pass through; float bodies are rejected."""
        loaded = load_exported(artifact, device="cpu")
        loaded.uint8_input = True  # view the same artifact as raw-ingest
        batch = prepare_request_batch(loaded, {"img": np.full((1, 224, 224, 3), 7, np.uint8)})
        assert batch["img"].dtype == np.uint8
        assert batch["img"][0, 0, 0, 0] == 7
        with pytest.raises(ValueError, match="uint8"):
            prepare_request_batch(loaded, {"img": np.zeros((1, 224, 224, 3), np.float32)})

    def test_latency_stats_beside_a_concurrent_appender(self):
        """`latency_stats` takes its snapshot of the wave latencies under
        the lock the worker appends under: read while another thread
        appends and clears, with a short switch interval, it never
        raises and its percentiles stay ordered."""

        class Idle(FakeBase):
            batch_sizes = [4]

        mb = MicroBatcher(Idle(), window_ms=1.0)
        stop = threading.Event()
        errors = []

        def appender():
            i = 0
            while not stop.is_set():
                with mb._wave_lock:
                    mb._wave_lat.append(1e-3 * (i % 97 + 1))
                i += 1
                if i % 1000 == 0:
                    mb.reset_stats()

        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        threads = [threading.Thread(target=appender) for _ in range(4)]
        try:
            for t in threads:
                t.start()
            deadline = time.monotonic() + 2.0
            reads = 0
            while time.monotonic() < deadline:
                try:
                    stats = mb.latency_stats()
                except RuntimeError as e:  # "deque mutated during iteration"
                    errors.append(e)
                    break
                if stats["waves_measured"]:
                    assert stats["wave_p50_ms"] <= stats["wave_p99_ms"]
                reads += 1
        finally:
            stop.set()
            sys.setswitchinterval(interval)
            for t in threads:
                t.join(timeout=30)
            mb.stop()
        assert not errors, errors
        assert reads > 0 and not any(t.is_alive() for t in threads)

    def test_server_refuses_the_card_when_there_is_none(self, artifact):
        """PocoServer loads on CUDA unless asked for the CPU: without a card
        it refuses to start instead of serving on the CPU unasked."""
        if torch.cuda.is_available():
            pytest.skip("this case is about a host without a card")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PocoServer(artifact, port=0)

    def test_bench_serving_run_combo_over_loopback(self, artifact):
        """`run_combo` drives concurrent clients over loopback HTTP and
        reports latencies, crops/s and requests per dispatch."""
        server = serve(artifact, batch_window_ms=20.0)
        seen = []

        def check(pairs):
            for request, response in pairs:
                crops = np.load(io.BytesIO(request))["img"]
                seen.append((crops.shape, np.load(io.BytesIO(response))["pred_pose"].shape))

        try:
            row = bench_serving.run_combo(f"http://127.0.0.1:{server.port}", server.batcher,
                                          n_clients=3, crops_per_req=1, requests_per_client=2,
                                          check=check)
        finally:
            server.stop()
        assert seen == [((1, 224, 224, 3), (1, 24, 3, 3))] * 6
        assert row["requests"] == 6 and row["clients"] == 3
        assert 0 < row["p50_ms"] <= row["p99_ms"]
        assert row["crops_per_s"] > 0
        assert 1 <= row["dispatches"] <= 6
        assert row["coalescence"] == 6 / row["dispatches"]


class TestBackpressure:
    """Overload: shed early with 429/503 instead of queueing every client
    toward the 600 s submit timeout."""

    def test_micro_batcher_sheds_over_budget_and_recovers(self):
        release = threading.Event()

        class SlowModel(FakeBase):
            batch_sizes = [4]

            def predict(self, batch):
                release.wait(timeout=30)
                return {"y": np.asarray(batch["x"])}

        mb = MicroBatcher(SlowModel(), window_ms=1.0, max_pending_rows=2)
        try:
            done = []
            t = threading.Thread(
                target=lambda: done.append(mb.submit({"x": np.zeros((2, 1), np.float32)})))
            t.start()
            deadline = time.time() + 10
            while mb.pending_rows < 2 and time.time() < deadline:
                time.sleep(0.005)
            assert mb.pending_rows == 2

            t0 = time.perf_counter()
            with pytest.raises(OverloadedError) as ei:
                mb.submit({"x": np.zeros((1, 1), np.float32)})
            # shed in milliseconds, not after a queue timeout
            assert time.perf_counter() - t0 < 1.0
            assert ei.value.retry_after_s >= 1.0
            assert mb.rejected_count == 1

            release.set()
            t.join(timeout=30)
            assert not t.is_alive() and len(done) == 1
            # budget returned: admitted again
            out = mb.submit({"x": np.ones((1, 1), np.float32)})
            np.testing.assert_allclose(out["y"], np.ones((1, 1)))
            assert mb.pending_rows == 0
        finally:
            release.set()
            mb.stop()

    def test_http_429_when_overloaded(self, artifact):
        server = serve(artifact, max_pending_rows=0)
        try:
            base = f"http://127.0.0.1:{server.port}"
            body = npz(img=np.zeros((1, 224, 224, 3), np.float32))
            with pytest.raises(urllib.error.HTTPError) as ei:
                post(base, body, timeout=30)
            assert ei.value.code == 429
            assert int(ei.value.headers["Retry-After"]) >= 1
            h = health(base)
            assert h["rejected"] == 1
            assert h["max_pending_rows"] == 0

            # observability window reset: counters zero, admission state
            # (the 0-row budget) untouched, so the next request still 429s
            post(base, b"", path="/stats/reset", timeout=30)
            h = health(base)
            assert h["rejected"] == 0
            assert h["pending_rows_hwm"] == 0
            with pytest.raises(urllib.error.HTTPError) as ei2:
                post(base, body, timeout=30)
            assert ei2.value.code == 429
        finally:
            server.stop()

    def test_expect_100_shed_before_upload(self, artifact):
        """`Expect: 100-continue`: an overloaded server answers 429 at the
        header handshake (the body is never sent); a healthy one sends
        100 Continue and then serves the body."""

        def probe(port: int, body: bytes | None, body_len: int):
            s = socket.create_connection(("127.0.0.1", port), timeout=30)
            try:
                s.sendall(
                    b"POST /predict HTTP/1.1\r\nHost: t\r\n"
                    b"Content-Length: " + str(body_len).encode() + b"\r\n"
                    b"Expect: 100-continue\r\nConnection: close\r\n\r\n"
                )
                data = b""
                while b"\r\n\r\n" not in data:
                    chunk = s.recv(65536)
                    if not chunk:
                        break
                    data += chunk
                head, rest = data.split(b"\r\n\r\n", 1)
                if body is None:
                    return head.decode("latin1"), None, rest
                s.sendall(body)
                while True:
                    chunk = s.recv(1 << 20)
                    if not chunk:
                        break
                    rest += chunk
                final_head, payload = rest.split(b"\r\n\r\n", 1)
                return head.decode("latin1"), final_head.decode("latin1"), payload
            finally:
                s.close()

        body = npz(img=np.zeros((1, 224, 224, 3), np.float32))
        server = serve(artifact, max_pending_rows=0)
        try:
            head, _, _ = probe(server.port, None, len(body))
            assert " 429 " in head.split("\r\n")[0] + " "
            assert any(ln.lower().startswith("retry-after:") for ln in head.split("\r\n"))
            assert server.batcher.rejected_count == 1
        finally:
            server.stop()

        server = serve(artifact)
        try:
            interim, final, payload = probe(server.port, body, len(body))
            assert "100" in interim.split("\r\n")[0]
            assert " 200 " in final.split("\r\n")[0] + " "
            assert "pred_pose" in np.load(io.BytesIO(payload)).files
        finally:
            server.stop()

    def test_http_503_at_handler_cap(self, artifact):
        server = serve(artifact, max_handler_threads=1)
        try:
            base = f"http://127.0.0.1:{server.port}"
            # a deterministic stand-in for a slow in-flight connection:
            # hold the single handler slot while a request arrives
            assert server.httpd._handler_slots.acquire(blocking=False)
            try:
                with pytest.raises(urllib.error.HTTPError) as ei:
                    urllib.request.urlopen(f"{base}/healthz", timeout=30)
                assert ei.value.code == 503
                assert ei.value.headers["Retry-After"] == "1"
            finally:
                server.httpd._handler_slots.release()
            # slot freed: served normally again, refusal counted
            assert health(base)["status"] == "ok"
            assert server.httpd.refused_count == 1
        finally:
            server.stop()


class TestDataParallelServing:
    def test_http_roundtrip_data_parallel(self, artifact, tmp_path):
        """A data_parallel=2 artifact on two named CPU replicas behind the
        unchanged server (JAX's test_http_roundtrip_data_parallel):
        concurrent clients each get their own rows, equal to the single
        artifact's `predict` within the JAX package's bars."""
        torch.manual_seed(0)   # the `artifact` fixture's weights
        model = POCO(PocoConfig(**TINY)).eval()
        dp_dir = str(tmp_path / "tiny_dp2")
        export_poco(model, synthetic_smpl_model(num_verts=96, device="cpu"), dp_dir,
                    batch_sizes=(4, 8), data_parallel=2, device="cpu")
        loaded = load_exported(dp_dir, devices=["cpu", "cpu"])
        single = load_exported(artifact, device="cpu")
        server = PocoServer(loaded, port=0, batch_window_ms=20.0).start(warmup=True)
        try:
            base = f"http://127.0.0.1:{server.port}"
            assert health(base)["buckets"] == [4, 8]
            rng = np.random.RandomState(11)
            crops = [rng.randn(n, 224, 224, 3).astype(np.float32) for n in (3, 1, 2)]
            got = [None] * len(crops)

            def fetch(i):
                got[i] = np.load(io.BytesIO(post(base, npz(img=crops[i]))))

            threads = [threading.Thread(target=fetch, args=(i,)) for i in range(len(crops))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            for i, c in enumerate(crops):
                want = single.predict(prepare_request_batch(single, {"img": c}))
                assert got[i]["pred_pose"].shape == (len(c), 24, 3, 3)
                np.testing.assert_allclose(got[i]["pred_pose"], want["pred_pose"],
                                           rtol=2e-5, atol=1e-5)
                np.testing.assert_allclose(got[i]["smpl_vertices"], want["smpl_vertices"],
                                           atol=1e-5)
        finally:
            server.stop()


# the JAX tool's overload row (tools/bench_serving.py:266-294)
OVERLOAD_KEYS = {
    "scenario", "clients", "crops_per_request", "duration_s", "accepted", "rejected",
    "rejected_by_code", "accepted_crops_per_s", "accepted_p50_ms", "accepted_p99_ms",
    "shed_p50_ms", "shed_p99_ms", "retry_after_s_median", "conn_resets",
    "expect_probes_shed", "expect_shed_p50_ms", "expect_shed_p99_ms", "pending_rows_hwm",
    "budget_rows", "rss_peak_delta_mb", "refused_at_accept", "flood",
}
COMBO_KEYS = {"window_ms", "clients", "crops_per_request", "requests", "p50_ms", "p99_ms",
              "crops_per_s", "dispatches", "coalescence", "wall_s"}


class TestBenchServingModes:
    """`cli.bench_serving`'s modes, with the JAX tool's JSON keys, each a
    few seconds on the CPU."""

    def test_loopback_repeats(self, capsys):
        """--loopback (tiny-cliff, fp32, the CPU, in-process) with
        --repeats 2: a row a run, then the median and spread row."""
        rows = bench_serving.main(["--loopback", "--repeats", "2", "--combos", "2x1",
                                   "--requests-per-client", "2", "--buckets", "1,2"])
        assert [r.get("run") for r in rows] == [0, 1, None]
        for row in rows[:2]:
            assert COMBO_KEYS <= set(row) and row["device"] == "cpu" and row["requests"] == 4
        summary = rows[2]
        assert summary["combo"] == "2x1" and summary["loopback"] is True
        assert summary["verdict"] in ("clean", "outliers_replaced", "unstable")
        assert summary["median_crops_per_s"] == float(np.median(summary["runs"]))
        assert summary["spread_pct"] >= 0
        printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
        assert [p["device"] for p in printed] == ["cpu"] * 3

    def test_sweep_window(self, artifact):
        rows = bench_serving.main(["--artifact", artifact, "--device", "cpu",
                                   "--sweep-window", "0,5", "--sweep-combo", "2x1",
                                   "--requests-per-client", "2"])
        assert [r["window_ms"] for r in rows] == [0.0, 5.0]
        assert all(COMBO_KEYS <= set(r) and r["requests"] == 4 for r in rows)

    def test_overload_against_a_server_subprocess(self, artifact, monkeypatch):
        """--overload --server-subproc: `python -m poco_tpu_torch.cli.serve`
        in a process of its own, a row budget of 4 crops flooded by 8
        clients of 2 crops for 1 s, twice (the counters reset between):
        rejections come, each a 429 or 503 with a Retry-After, and the
        server's pending rows never passed its budget."""
        monkeypatch.setenv("OMP_NUM_THREADS", "1")
        rows = bench_serving.main([
            "--artifact", artifact, "--device", "cpu", "--overload", "--server-subproc",
            "--max-pending-rows", "4", "--overload-clients", "8", "--overload-crops", "2",
            "--overload-duration", "1", "--overload-floods", "2"])
        assert [r["flood"] for r in rows] == [0, 1]
        for row in rows:
            assert OVERLOAD_KEYS <= set(row), OVERLOAD_KEYS - set(row)
            assert row["scenario"] == "overload" and row["budget_rows"] == 4
            assert row["rejected"] > 0 and row["accepted"] > 0
            assert set(row["rejected_by_code"]) <= {429, 503}
            assert row["rejected_without_retry_after"] == 0
            assert row["retry_after_s_median"] >= 1
            assert row["pending_rows_hwm"] <= row["budget_rows"]
            assert row["rss_peak_delta_mb"] >= 0
