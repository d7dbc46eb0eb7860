"""Serve an exported POCO artifact over HTTP (the port's counterpart of
the repo's `tools/serve_model.py`).

    python -m poco_tpu_torch.cli.export --cfg ... --ckpt ... --uint8-input --out exported/cliff
    python -m poco_tpu_torch.cli.serve --artifact exported/cliff --port 8000

    # client:
    curl -s localhost:8000/healthz
    python - <<'PY'
    import io, urllib.request, numpy as np
    crops = np.zeros((3, 224, 224, 3), np.uint8)   # HWC uint8 crops
    buf = io.BytesIO(); np.savez(buf, img=crops)
    req = urllib.request.Request("http://localhost:8000/predict",
                                 data=buf.getvalue(), method="POST")
    out = np.load(io.BytesIO(urllib.request.urlopen(req).read()))
    print({k: out[k].shape for k in out.files})
    PY

The artifact serves on the card (`--device cuda`, the default; without a
card the server refuses to start) or on the CPU with `--device cpu`,
where its platforms list the device type. A data-parallel artifact's
replicas go on the first N devices of that type, or on `--devices`
(e.g. `cuda:0,cuda:0`: two replicas on one card). TF32 is switched off
for cuBLAS and cuDNN, so an fp32 artifact serves fp32's numbers.
"""

from __future__ import annotations

import argparse

import torch
from ..device import default_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--artifact", required=True)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--device", default=default_device(),
                    help="cuda or cpu (default: $POCO_TPU_PLATFORM, else cuda)")
    ap.add_argument("--devices", default=None,
                    help="comma list: the replicas of a data-parallel artifact")
    ap.add_argument("--no-warmup", action="store_true")
    ap.add_argument("--batch-window-ms", type=float, default=5.0,
                    help="micro-batch coalescing window")
    ap.add_argument("--max-pending-rows", type=int, default=None,
                    help="crop-denominated admission budget; beyond it requests are "
                         "shed with 429 + Retry-After (default: 12 waves of the "
                         "largest bucket)")
    ap.add_argument("--max-handler-threads", type=int, default=None,
                    help="in-flight connection cap; excess connections get an "
                         "instant 503 at accept (default 128)")
    return ap


def make_server(args):
    """The server of the parsed `args`, loaded and not yet serving."""
    from ..runtime.server import PocoServer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return PocoServer(args.artifact, host=args.host, port=args.port,
                      batch_window_ms=args.batch_window_ms,
                      max_pending_rows=args.max_pending_rows,
                      max_handler_threads=args.max_handler_threads,
                      device=args.device,
                      devices=args.devices.split(",") if args.devices else None)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    server = make_server(args)
    # flush: launchers read this line from a pipe to learn the bound port
    print(f"serving {args.artifact} on {args.host}:{server.port} "
          f"(buckets {server.model.batch_sizes}, device {server.model.device})", flush=True)
    try:
        server.serve_forever(warmup=not args.no_warmup)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()


if __name__ == "__main__":
    main()
