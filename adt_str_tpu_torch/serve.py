"""Online transcription server:
`python -m adt_str_tpu_torch.serve <config.yaml> [--host H] [--port P] [--beam]`.

Port of the root `serve.py`: loads the reference checkpoint named by the
config's `inference.checkpoint_path`, wraps it in the micro-batching
`ServingEngine` (every bucket warmed before the socket opens) and serves
`serving/http.py`'s endpoints:

- `GET  /healthz`        readiness
- `GET  /stats`          micro-batching counters: requests, batches, padded
                         rows, `decode_seconds`, each bucket's batches, and
                         `queue_wait_seconds`, the time requests waited in
                         the queue summed over requests (over `n_requests`,
                         the mean wait before a batch takes a request)
- `POST /v1/transcribe`  audio body (WAV/FLAC/raw f32 PCM) -> notes JSON/MIDI

With no `--device` and more than one visible card, the engine serves
data-parallel over all of them (each bucket split over the cards), as root
`serve.py` does over every device; with one card nothing changes.

`build_engine(cfg, model)` is the engine construction shared with
`chip_smoke.py`.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading

import torch

from adt_str_tpu_torch import resolve_device
from adt_str_tpu_torch.config import FrameworkConfig
from adt_str_tpu_torch.models.adt import ADTModel
from adt_str_tpu_torch.models.convert import load_reference_checkpoint
from adt_str_tpu_torch.parallel.mesh import make_mesh
from adt_str_tpu_torch.serving.engine import ServingEngine
from adt_str_tpu_torch.serving.http import make_server


def build_engine(cfg: FrameworkConfig, model: ADTModel, device=None, mesh=None, **overrides) -> ServingEngine:
    """The config's `serving:` engine around `model` on `device` (None:
    cuda) or over `mesh`; keyword overrides (the CLI flags) win over YAML."""
    return ServingEngine.from_config(model, cfg, device=device, mesh=mesh, **overrides)


def main() -> None:
    parser = argparse.ArgumentParser(
        description="ADT transcription server. Every knob below "
        "defaults to the config's `serving:` section; flags override YAML."
    )
    parser.add_argument("config_path", type=str)
    parser.add_argument("--host", type=str, default=None)
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument("--buckets", type=int, nargs="+", default=None,
                        help="batch buckets (sorted); requests are padded up to the smallest that fits")
    parser.add_argument("--max-wait-ms", type=float, default=None,
                        help="after the first queued request, wait at most this long for stragglers")
    parser.add_argument("--max-length", type=int, default=None,
                        help="decode token budget (default: config inference.max_length)")
    parser.add_argument("--beam", action="store_true", default=None, dest="use_beam",
                        help="beam-search decoding (serving.beam_size wide) instead of greedy")
    parser.add_argument("--device", type=str, default=None, help="torch device (default: cuda)")
    parser.add_argument("--no-precompile", action="store_true",
                        help="skip warming every bucket at startup")
    parser.add_argument("--verbose", action="store_true", help="log each HTTP request to stderr")
    args = parser.parse_args()

    cfg = FrameworkConfig.from_yaml(args.config_path)
    if not cfg.inference.checkpoint_path:
        raise SystemExit("config needs an `inference:` section with `checkpoint_path` set")
    device = resolve_device(args.device)
    print(f"Loading checkpoint: {cfg.inference.checkpoint_path}")
    model = ADTModel(cfg.model, device=device)
    model.load_state_dict(load_reference_checkpoint(cfg.inference.checkpoint_path, device), strict=True)

    mesh = None
    if args.device is None and torch.cuda.device_count() > 1:
        mesh = make_mesh()
        print(f"Serving data-parallel over {mesh.n_data} devices")
    engine = build_engine(
        cfg, model, device, mesh,
        max_length=args.max_length,
        buckets=tuple(args.buckets) if args.buckets else None,
        max_wait_ms=args.max_wait_ms,
        use_beam=args.use_beam,
    )
    if cfg.serving.precompile and not args.no_precompile:
        print(f"Warming {len(engine.buckets)} buckets ({'beam' if engine.use_beam else 'greedy'})...")
        print(f"Warm-up done in {engine.precompile():.1f}s")

    host = args.host if args.host is not None else cfg.serving.host
    port = args.port if args.port is not None else cfg.serving.port
    server = make_server(engine, host, port, quiet=not args.verbose)

    def _shutdown(signum, frame):
        print(f"signal {signum}: draining and shutting down", file=sys.stderr)
        # shutdown() blocks until serve_forever() returns, and this handler
        # runs on the serve_forever thread: call it from another thread
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _shutdown)
    signal.signal(signal.SIGINT, _shutdown)

    host, port = server.server_address[:2]
    print(f"Serving on http://{host}:{port} (POST /v1/transcribe)")
    try:
        server.serve_forever()
    finally:
        engine.close()
        server.server_close()


if __name__ == "__main__":
    main()
