"""Dependency-free HTTP front-end over the port's `ServingEngine`.

Port of `adt_str_tpu/serving/http.py` (its own copy: the JAX front-end
imports the JAX engine). Endpoints:
- `GET /healthz`        -> `{"ok": true}` (readiness: engine thread alive)
- `GET /stats`          -> engine micro-batching counters
- `POST /v1/transcribe` -> drum transcription of the request body audio.
  Body is either a container file (WAV/FLAC/anything ffmpeg reads;
  detected by magic) or raw float32 little-endian mono PCM at the
  configured sample rate (an `X-Sample-Rate` header has the server
  resample). Query params: `hop_sec=<float>`, `format=json|midi`.
  JSON response: `{"notes": [[onset, offset, pitch, velocity], ...], ...}`.

`ThreadingHTTPServer` gives one thread per in-flight request; each thread
only decodes audio bytes and waits on engine futures, so concurrent requests
share device micro-batches.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from adt_str_tpu_torch.serving.engine import ServingEngine
from adt_str_tpu_torch.utils.audio_io import load_and_resample, resample
from adt_str_tpu_torch.utils.midi_io import write_midi

MAX_BODY_BYTES = 1 << 30  # 1 GiB: ~3.7 h of 48 kHz stereo WAV; reject beyond


def _decode_body(body: bytes, headers, target_sr: int) -> np.ndarray:
    """Request bytes -> 1-D float32 mono wave at `target_sr`."""
    magic = body[:4]
    if magic in (b"RIFF", b"fLaC", b"OggS", b"FORM") or body[:3] == b"ID3":
        # container file: route through the same loader the CLI uses. The
        # loader dispatches on suffix (native scipy WAV reader vs ffmpeg),
        # so name the temp file by magic.
        suffix = ".wav" if magic == b"RIFF" else ".audio"
        with tempfile.NamedTemporaryFile(suffix=suffix, delete=False) as tf:
            tf.write(body)
            path = tf.name
        try:
            return load_and_resample(path, target_sr)
        finally:
            os.unlink(path)
    if len(body) % 4:
        raise ValueError(
            "raw body length is not a multiple of 4 bytes; expected float32 "
            "little-endian mono PCM (or a WAV/FLAC container)"
        )
    wave = np.frombuffer(body, dtype="<f4").astype(np.float32)
    src_sr = int(headers.get("X-Sample-Rate", target_sr))
    if src_sr != target_sr:
        wave = resample(wave, src_sr, target_sr)
    return wave


class _Handler(BaseHTTPRequestHandler):
    # set by make_server:
    engine: ServingEngine = None  # type: ignore[assignment]
    quiet: bool = True

    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # noqa: D102 — silence default stderr spam
        if not self.quiet:
            super().log_message(fmt, *args)

    def _send(self, code: int, payload: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def _send_json(self, code: int, obj) -> None:
        self._send(code, (json.dumps(obj) + "\n").encode(), "application/json")

    def do_GET(self) -> None:  # noqa: N802 — http.server API
        path = urlparse(self.path).path
        if path == "/healthz":
            alive = self.engine._thread.is_alive() and not self.engine._closed
            self._send_json(200 if alive else 503, {"ok": alive})
        elif path == "/stats":
            self._send_json(200, self.engine.stats())
        else:
            self._send_json(404, {"error": f"no route {path}"})

    def do_POST(self) -> None:  # noqa: N802 — http.server API
        url = urlparse(self.path)
        if url.path != "/v1/transcribe":
            self._send_json(404, {"error": f"no route {url.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            if not 0 < length <= MAX_BODY_BYTES:
                self._send_json(413 if length else 400,
                                {"error": f"bad Content-Length {length}"})
                return
            body = self.rfile.read(length)
            q = parse_qs(url.query)
            hop_sec = float(q["hop_sec"][0]) if "hop_sec" in q else None
            fmt = q.get("format", ["json"])[0]
            sr = self.engine.config.shared.sample_rate
            wave = _decode_body(body, self.headers, sr)
            notes = self.engine.transcribe(wave, hop_sec=hop_sec)
        except ValueError as exc:
            self._send_json(400, {"error": str(exc)})
            return
        except Exception as exc:  # engine/decode failure -> 500, not a hang
            self._send_json(500, {"error": f"{type(exc).__name__}: {exc}"})
            return
        if fmt == "midi":
            with tempfile.NamedTemporaryFile(suffix=".mid", delete=False) as tf:
                path = tf.name
            try:
                write_midi(path, notes, is_drum=True)
                with open(path, "rb") as f:
                    blob = f.read()
            finally:
                os.unlink(path)
            self._send(200, blob, "audio/midi")
        else:
            self._send_json(
                200,
                {
                    "notes": notes.tolist(),
                    "n_notes": int(len(notes)),
                    "duration_sec": round(len(wave) / sr, 3),
                },
            )


def make_server(
    engine: ServingEngine, host: str = "127.0.0.1", port: int = 0, quiet: bool = True
) -> ThreadingHTTPServer:
    """Build (not start) the HTTP server; `server.server_address` has the
    bound port when `port=0`. Run with `serve_forever()` or `start_in_thread`."""
    handler = type("BoundHandler", (_Handler,), {"engine": engine, "quiet": quiet})
    return ThreadingHTTPServer((host, port), handler)


def start_in_thread(server: ThreadingHTTPServer) -> threading.Thread:
    t = threading.Thread(target=server.serve_forever, name="adt-serving-http",
                         daemon=True)
    t.start()
    return t
