"""Brain service: text + context -> validated intent plan, on the port's engine.

Port of the engine path of ``tpu_voice_agent/services/brain.py``.
``POST /parse`` takes ``{text, session_id?, context}`` and answers with the
ParseResponse dict (every default field filled, as pydantic's
``model_dump()`` fills it); errors come back as ``{"error", "detail"}``:

- 400 ``invalid_request``: the body is not JSON or not a ParseRequest;
- 409 ``prefix_feed_unsupported``: this single-slot parser has no
  prefill-only admission path;
- 422 ``schema_validation_failed``: the decode ran out of budget before EOS;
- 500 ``llm_error``: the engine failed (poisoned row, prompt too long, ...).

Parses are serialized by one lock: a single-slot engine owns one KV cache.
``GET /health`` reports the backend and its device. The HTTP layer is the
standard library's ``ThreadingHTTPServer``.

    BRAIN_BACKEND=engine:tinyllama-1.1b BRAIN_QUANT=int8 \\
        python -m tpu_voice_agent_torch.services.brain

Environment (the JAX service's names): ``BRAIN_BACKEND`` (``engine[:preset]``,
default ``engine:tinyllama-1.1b``), ``BRAIN_QUANT`` (``int8``), ``BRAIN_FF`` (fast-forward width,
default 8), ``BRAIN_PREFIX`` (``0`` skips the cached prompt prefix),
``BRAIN_PORT`` (default 8090), ``BRAIN_BATCH`` (only 1 is ported), and
``BRAIN_DEVICE`` (default ``cuda``; ``cpu`` runs the plain versions).
"""

from __future__ import annotations

import json
import os
import threading
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..schemas import ValidationError, parse_response_from_json, validate_parse_request
from .prompts import render_prompt


class ParserError(Exception):
    def __init__(self, kind: str, detail: str):
        super().__init__(detail)
        self.kind = kind  # "schema_validation_failed" | "llm_error"
        self.detail = detail


def _result_to_response(res) -> dict:
    """GenerationResult -> the ParseResponse dict, with the service's
    error mapping: a poisoned row is ``llm_error``, a decode that never
    reached EOS is ``schema_validation_failed``."""
    if res.error:
        raise ParserError("llm_error", res.error)
    if not res.finished:
        raise ParserError("schema_validation_failed",
                          f"decode truncated after {res.steps} tokens (no EOS)")
    resp, err = parse_response_from_json(res.text)
    if resp is None:
        # unreachable under the grammar; kept as a hard backstop
        raise ParserError("schema_validation_failed", err or "invalid")
    return resp


def install_prompt_prefix(engine) -> int:
    """Prefill the request-invariant prompt head (system + few-shots) into
    the engine's shared-prefix cache: two differing sample payloads locate
    the common token prefix. Returns its length in tokens."""
    return engine.set_prompt_prefix(
        render_prompt("sample utterance alpha", {}),
        render_prompt("a rather different beta payload", {"last_query": "gamma"}),
    )


class EngineParser:
    """Grammar-constrained decode on the port's engine. ``render`` maps
    (text, context) -> prompt; the default is the few-shot prompt.
    ``last_result`` keeps the most recent GenerationResult (the service
    reads its timings under the parse lock)."""

    def __init__(self, engine, max_new_tokens: int = 512, render=None):
        self.engine = engine
        self.max_new_tokens = max_new_tokens
        self.render = render or render_prompt
        self.last_result = None

    def parse(self, text: str, context: dict) -> dict:
        prompt = self.render(text, context)
        self.last_result = None
        try:
            res = self.engine.generate(prompt, max_new_tokens=self.max_new_tokens,
                                       greedy=True, constrained=True)
        except ValueError as e:  # prompt too long etc.
            raise ParserError("llm_error", str(e)) from e
        self.last_result = res
        return _result_to_response(res)


def _wrap_engine(engine) -> EngineParser:
    """Cache the shared prompt head (``BRAIN_PREFIX=0`` skips it), then
    serve the engine through the serialized single-slot parser."""
    if os.environ.get("BRAIN_PREFIX", "1") != "0":
        install_prompt_prefix(engine)
    return EngineParser(engine)


def make_parser_from_env() -> EngineParser:
    """``BRAIN_BACKEND=engine[:preset]`` (default ``engine:tinyllama-1.1b``)
    with ``BRAIN_QUANT`` / ``BRAIN_FF`` / ``BRAIN_PREFIX``. The engine runs
    on ``BRAIN_DEVICE`` (default ``cuda``: with no card it raises)."""
    from ..serve.engine import DecodeEngine

    if int(os.environ.get("BRAIN_BATCH", "1")) != 1:
        raise ValueError("BRAIN_BATCH > 1: the continuous batcher is not ported")
    device = os.environ.get("BRAIN_DEVICE") or None
    backend = os.environ.get("BRAIN_BACKEND", "engine:tinyllama-1.1b")
    if backend.startswith("engine"):
        preset = backend.split(":", 1)[1] if ":" in backend else "tinyllama-1.1b"
        return _wrap_engine(DecodeEngine(
            preset=preset, quant=os.environ.get("BRAIN_QUANT") or None,
            fast_forward=int(os.environ.get("BRAIN_FF", "8")), device=device))
    raise ValueError(f"BRAIN_BACKEND {backend!r} is not ported (engine[:preset])")


# ---------------------------------------------------------------- app


class BrainApp:
    """The /parse and /health handlers, free of any HTTP machinery: each
    returns (status, body dict, extra headers)."""

    def __init__(self, parser):
        self.parser = parser
        self.lock = threading.Lock()

    def health(self) -> tuple[int, dict, dict]:
        engine = getattr(self.parser, "engine", None)
        body = {"ok": True, "service": "brain"}
        if engine is not None:
            body.update(device=str(engine.device), kernels=engine.kernels,
                        quant=engine.quant, fast_forward=engine.fast_forward,
                        prefix_tokens=len(engine.prefix_ids))
        return 200, body, {}

    def parse(self, raw: bytes, trace_id: str | None = None) -> tuple[int, dict, dict]:
        headers = {"x-trace-id": trace_id or uuid.uuid4().hex[:16]}

        def error(status: int, kind: str, detail: str):
            return status, {"error": kind, "detail": detail[:500]}, headers

        try:
            body = json.loads(raw or b"")
        except (json.JSONDecodeError, UnicodeDecodeError):
            return error(400, "invalid_request", "body must be JSON")
        try:
            preq = validate_parse_request(body)
        except ValidationError as e:
            return error(400, "invalid_request", str(e))
        if preq["prefix_feed"]:
            return error(409, "prefix_feed_unsupported",
                         "backend has no prefill-only admission path")
        with self.lock:
            try:
                resp = self.parser.parse(preq["text"], preq["context"])
            except ParserError as e:
                status = 422 if e.kind == "schema_validation_failed" else 500
                return error(status, e.kind, e.detail)
            except Exception as e:  # engine crash etc.
                return error(500, "llm_error", str(e))
            res = getattr(self.parser, "last_result", None)
        if res is not None:
            headers.update({"x-prefill-ms": f"{res.prefill_ms:.3f}",
                            "x-decode-ms": f"{res.decode_ms:.3f}",
                            "x-cached-tokens": str(res.cached_tokens),
                            "x-prompt-tokens": str(res.prompt_tokens)})
        return 200, resp, headers


def make_server(app: BrainApp, host: str = "127.0.0.1", port: int = 8090) -> ThreadingHTTPServer:
    """An HTTP server over ``app`` (``port=0`` picks a free one)."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _send(self, status: int, body: dict, headers: dict) -> None:
            data = json.dumps(body).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            for k, v in headers.items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/health":
                self._send(*app.health())
            else:
                self._send(404, {"error": "not_found", "detail": self.path}, {})

        def do_POST(self):
            raw = self.rfile.read(int(self.headers.get("Content-Length") or 0))
            if self.path == "/parse":
                self._send(*app.parse(raw, self.headers.get("x-trace-id")))
            else:
                self._send(404, {"error": "not_found", "detail": self.path}, {})

        def log_message(self, fmt, *args):  # quiet: one line per request is noise
            pass

    return ThreadingHTTPServer((host, port), Handler)


def main() -> None:
    port = int(os.environ.get("BRAIN_PORT", "8090"))
    server = make_server(BrainApp(make_parser_from_env()), host="0.0.0.0", port=port)
    print(f"brain: serving /parse on :{server.server_address[1]}", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
