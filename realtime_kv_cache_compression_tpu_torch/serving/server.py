"""HTTP serving front-end: an OpenAI-style /v1/completions API over the
continuous-batching engine (port of the JAX package's `serving/server.py`).

Pure stdlib (http.server + threading), so it needs nothing beyond PyTorch.

Threading model — the engine is single-threaded by design (one device
stream), so ALL engine interaction happens on one driver thread:

    HTTP handler threads ──(queue.Queue)──▶ driver thread ──▶ ServingEngine
            ▲                                   │
            └──── per-request result/stream ◀───┘

Handler threads never touch the engine; they enqueue a `_Job` and block on
its completion event (or consume its stream queue for SSE). The driver
thread drains submissions, calls `engine.step()` in a loop, and resolves
jobs as the engine finishes requests. Token→text streaming decodes the full
token list each chunk and emits the text delta, which is correct for
tokenizers whose decode is prefix-stable (HF BPE and the byte fallback).

Endpoints:
  GET  /health          liveness + engine occupancy
  GET  /v1/models       the served model id
  GET  /stats           engine summary (throughput, savings, prefix cache)
  POST /v1/completions  {"prompt": str | [int], "max_tokens": int,
                         "stop": [str]|str, "stream": bool, "echo": bool}
      → OpenAI-compatible completion object, or SSE stream of deltas when
      "stream": true. Per-request temperature/top_p are validated against
      the engine's fixed SamplingParams (a mismatch returns 400 rather than
      silently ignoring the field).
  POST /v1/prefixes     {"prompt": str | [int]}: register a shared prefix
      (engine.register_prefix; needs a prefix_continue_budget).
"""

from __future__ import annotations

import dataclasses
import json
import queue
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import torch

from ..utils.tokenizer import ByteTokenizer, decode_ids, encode_ids
from .engine import ServingEngine


@dataclasses.dataclass
class _Job:
    input_ids: List[int]
    max_new_tokens: Optional[int]
    stop_sequences: List[List[int]]
    stop_texts: List[str]
    stream: bool
    echo: bool
    register: bool = False  # prefix-registration job (no generation)
    rid: Optional[int] = None
    request: Any = None
    error: Optional[str] = None
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    # Stream queue carries text deltas; None is the end-of-stream sentinel.
    stream_q: "queue.Queue[Optional[str]]" = dataclasses.field(
        default_factory=queue.Queue)
    sent_text: str = ""


class CompletionServer:
    """Drives a ServingEngine from one background thread and serves HTTP."""

    def __init__(self, engine: ServingEngine, tokenizer=None,
                 model_id: str = "rtkv-compressed",
                 host: str = "127.0.0.1", port: int = 8000):
        self.engine = engine
        self.tokenizer = tokenizer or ByteTokenizer()
        self.model_id = model_id
        self.host = host
        self.port = port
        self._submit_q: "queue.Queue[_Job]" = queue.Queue()
        self._jobs: Dict[int, _Job] = {}
        self._stop = threading.Event()
        self._driver: Optional[threading.Thread] = None
        self._driver_error: Optional[str] = None
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._started_at = time.time()
        # Driver-published snapshots: handler threads read these plain-dict
        # references (atomic rebinds) instead of reaching into engine
        # internals from another thread.
        self._occupancy: Dict[str, Any] = engine.snapshot()
        self._summary: Dict[str, Any] = engine.summary()

    # -- lifecycle -----------------------------------------------------------

    def start(self):
        self._driver = threading.Thread(target=self._drive, daemon=True,
                                        name="rtkv-engine-driver")
        self._driver.start()
        server = self

        class Handler(_Handler):
            ctx = server

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]  # resolve port 0
        threading.Thread(target=self._httpd.serve_forever, daemon=True,
                         name="rtkv-httpd").start()
        return self

    def close(self):
        self._stop.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._driver is not None:
            self._driver.join(timeout=10)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()

    # -- driver thread (sole owner of the engine) ----------------------------

    def _drive(self):
        try:
            while not self._stop.is_set():
                try:
                    busy = self._drain_submissions()
                    if self.engine.has_work():
                        self.engine.step()
                        busy = True
                    # Resolve even without a step: a request can finish
                    # during submission itself (e.g. max_tokens=1 hits the
                    # budget at admission).
                    if self._jobs:
                        self._resolve_finished()
                    self._occupancy = self.engine.snapshot()
                except Exception as e:  # engine died: fail fast and visibly
                    self._driver_error = f"{type(e).__name__}: {e}"
                    break
                if not busy:
                    # Idle: park briefly; submissions wake on the next spin.
                    self._stop.wait(0.002)
        finally:
            # Always unblock waiters — on clean shutdown AND on driver
            # death; new submissions are rejected at submit_completion once
            # _driver_error is set / the thread is dead.
            err = self._driver_error or "server shutting down"
            for job in list(self._jobs.values()):
                job.error = job.error or err
                job.stream_q.put(None)
                job.done.set()
            self._jobs.clear()
            while True:
                try:
                    job = self._submit_q.get_nowait()
                except queue.Empty:
                    break
                job.error = err
                job.stream_q.put(None)
                job.done.set()

    def _drain_submissions(self) -> bool:
        moved = False
        while True:
            try:
                job = self._submit_q.get_nowait()
            except queue.Empty:
                return moved
            moved = True
            try:
                if job.register:
                    # Prefix registration runs synchronously on the driver
                    # (the engine is single-threaded by design).
                    self.engine.register_prefix(job.input_ids)
                    job.stream_q.put(None)
                    job.done.set()
                    continue
                on_token = self._make_streamer(job) if job.stream else None
                job.rid = self.engine.submit(
                    job.input_ids, max_new_tokens=job.max_new_tokens,
                    stop_sequences=job.stop_sequences, on_token=on_token)
                self._jobs[job.rid] = job
            except Exception as e:  # malformed request must not kill serving
                job.error = f"{type(e).__name__}: {e}"
                job.stream_q.put(None)
                job.done.set()

    def _make_streamer(self, job: _Job):
        def on_token(req, _new_tokens):
            text = decode_ids(self.tokenizer, req.tokens)
            # Withhold any trailing text that is still a prefix of a stop
            # sequence: the engine keeps a matched stop in req.tokens, and
            # non-streamed responses strip it — streams must match (OpenAI
            # stop semantics). The held-back tail is emitted (or discarded
            # as matched stop text) at resolution.
            safe = len(text)
            for s in job.stop_texts:
                for k in range(min(len(s), len(text)), 0, -1):
                    if s and text.endswith(s[:k]):
                        safe = min(safe, len(text) - k)
                        break
            if safe > len(job.sent_text):
                job.stream_q.put(text[len(job.sent_text):safe])
                job.sent_text = text[:safe]
        return on_token

    def _final_text(self, job: _Job) -> str:
        """Decoded completion with a matched stop sequence stripped (shared
        by streamed and non-streamed paths so the two never diverge)."""
        text = decode_ids(self.tokenizer, job.request.tokens)
        for s in job.stop_texts:  # OpenAI semantics: stop text not returned
            if s and text.endswith(s):
                return text[:-len(s)]
        return text

    def _resolve_finished(self):
        for rid in [r for r, j in self._jobs.items()
                    if r in self.engine.completed]:
            job = self._jobs.pop(rid)
            # release(): resolved requests must not accumulate in the engine
            # forever (lifetime stats live in O(1) aggregates).
            job.request = self.engine.release(rid)
            if job.stream:
                final = self._final_text(job)
                if len(final) > len(job.sent_text):
                    job.stream_q.put(final[len(job.sent_text):])
                job.sent_text = final
            job.stream_q.put(None)
            job.done.set()
        self._summary = self.engine.summary()

    # -- request handling (called from HTTP handler threads) -----------------

    def submit_completion(self, body: Dict[str, Any],
                          register: bool = False) -> _Job:
        if self._driver_error or (self._driver is not None
                                  and not self._driver.is_alive()):
            raise RuntimeError("engine driver is down: "
                               f"{self._driver_error or 'thread exited'}")
        try:
            prompt = body.get("prompt", "")
            if isinstance(prompt, list):
                input_ids = [int(t) for t in prompt]
            else:
                input_ids = encode_ids(self.tokenizer, str(prompt))
            max_new = (int(body["max_tokens"])
                       if body.get("max_tokens") is not None else None)
        except (TypeError, ValueError) as e:
            # Uniform 400 for malformed scalar types (JSON null max_tokens,
            # non-scalar prompt elements) instead of a crashed handler.
            raise ValueError(f"malformed request field: {e}")
        stop = body.get("stop") or []
        if isinstance(stop, str):
            stop = [stop]
        stop_texts = [str(s) for s in stop]
        stop_sequences = [encode_ids(self.tokenizer, s) for s in stop_texts]
        # ByteTokenizer prepends BOS to every encode; stop sequences must be
        # raw token runs.
        bos = getattr(self.tokenizer, "bos_token_id", None)
        stop_sequences = [s[1:] if (bos is not None and s and s[0] == bos)
                          else s for s in stop_sequences]
        # Sampling is fixed at engine build: reject conflicting
        # per-request values instead of silently ignoring them.
        for field in ("temperature", "top_p"):
            want = body.get(field)
            have = getattr(self.engine.sampling, field)
            if want is not None and abs(float(want) - float(have)) > 1e-6:
                raise ValueError(
                    f"{field}={want} differs from the engine's fixed "
                    f"sampling ({field}={have}); restart the server with "
                    f"the desired SamplingParams")
        job = _Job(
            input_ids=input_ids,
            max_new_tokens=max_new,
            stop_sequences=[s for s in stop_sequences if s],
            stop_texts=stop_texts,
            stream=bool(body.get("stream", False)),
            echo=bool(body.get("echo", False)),
            register=register,
        )
        self._submit_q.put(job)
        return job

    def completion_response(self, job: _Job, prompt_text: str) -> Dict:
        req = job.request
        text = self._final_text(job)
        choice: Dict[str, Any] = {
            "index": 0,
            "text": (prompt_text + text) if job.echo else text,
            "finish_reason": {"eos": "stop", "stop": "stop"}.get(
                req.stop_reason, "length"),
        }
        if self.engine.logprobs and req.logprobs:
            choice["logprobs"] = {"token_logprobs": list(req.logprobs)}
        return {
            "id": f"cmpl-{uuid.uuid4().hex[:24]}",
            "object": "text_completion",
            "created": int(time.time()),
            "model": self.model_id,
            "choices": [choice],
            "usage": {
                "prompt_tokens": len(job.input_ids),
                "completion_tokens": len(req.tokens),
                "total_tokens": len(job.input_ids) + len(req.tokens),
            },
            "rtkv": {  # framework extension: compression telemetry
                "ttft_s": req.ttft,
                "memory_savings": (req.prefill_stats or {}).get(
                    "avg_memory_savings"),
                "kept_ratio": (req.prefill_stats or {}).get(
                    "cumulative_compression"),
            },
        }

    def driver_alive(self) -> bool:
        return (self._driver is not None and self._driver.is_alive()
                and not self._driver_error)

    def stats(self) -> Dict[str, Any]:
        # Driver-published snapshots only — no cross-thread reads of engine
        # internals from HTTP handler threads.
        return {
            "uptime_s": time.time() - self._started_at,
            "driver_alive": self.driver_alive(),
            "driver_error": self._driver_error,
            **self._occupancy,
            "summary": self._summary,
        }


class _Handler(BaseHTTPRequestHandler):
    ctx: CompletionServer  # injected by CompletionServer.start
    protocol_version = "HTTP/1.1"

    def log_message(self, *args):  # quiet by default
        pass

    def _json(self, code: int, obj: Dict):
        payload = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def do_GET(self):
        if self.path == "/health":
            alive = self.ctx.driver_alive()
            self._json(200 if alive else 503, {
                "status": "ok" if alive else "driver_dead",
                "driver_error": self.ctx._driver_error,
                **self.ctx._occupancy})
        elif self.path == "/v1/models":
            self._json(200, {"object": "list", "data": [
                {"id": self.ctx.model_id, "object": "model"}]})
        elif self.path == "/stats":
            self._json(200, self.ctx.stats())
        else:
            self._json(404, {"error": "not found"})

    def do_POST(self):
        if self.path not in ("/v1/completions", "/completions",
                             "/v1/prefixes"):
            self._json(404, {"error": "not found"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length) or b"{}")
        except Exception:
            self._json(400, {"error": "invalid JSON body"})
            return
        if self.path == "/v1/prefixes":
            # Register a shared prefix (system prompt): later completions
            # extending it prefill only their suffix (partial hit).
            try:
                job = self.ctx.submit_completion(body, register=True)
            except (TypeError, ValueError) as e:
                self._json(400, {"error": str(e)})
                return
            except RuntimeError as e:
                self._json(503, {"error": str(e)})
                return
            job.done.wait()
            if job.error:
                self._json(400, {"error": job.error})
            else:
                self._json(200, {"registered": True,
                                 "prompt_tokens": len(job.input_ids)})
            return
        try:
            job = self.ctx.submit_completion(body)
        except (TypeError, ValueError) as e:
            self._json(400, {"error": str(e)})
            return
        except RuntimeError as e:  # engine driver dead — service unavailable
            self._json(503, {"error": str(e)})
            return
        prompt = body.get("prompt", "")
        prompt_text = prompt if isinstance(prompt, str) else ""
        if job.stream:
            self._stream(job)
            return
        job.done.wait()
        if job.error:
            self._json(500, {"error": job.error})
        else:
            self._json(200, self.ctx.completion_response(job, prompt_text))

    def _stream(self, job: _Job):
        """Server-sent events: one `data: {...}` line per text delta, then a
        final chunk carrying finish_reason, then `data: [DONE]`."""
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def chunk(data: str):
            enc = data.encode()
            self.wfile.write(f"{len(enc):X}\r\n".encode() + enc + b"\r\n")
            self.wfile.flush()

        cid = f"cmpl-{uuid.uuid4().hex[:24]}"
        try:
            while True:
                delta = job.stream_q.get()
                if delta is None:
                    break
                chunk("data: " + json.dumps({
                    "id": cid, "object": "text_completion",
                    "model": self.ctx.model_id,
                    "choices": [{"index": 0, "text": delta,
                                 "finish_reason": None}]}) + "\n\n")
            job.done.wait()
            if job.error:
                chunk("data: " + json.dumps({"error": job.error}) + "\n\n")
            else:
                req = job.request
                chunk("data: " + json.dumps({
                    "id": cid, "object": "text_completion",
                    "model": self.ctx.model_id,
                    "choices": [{"index": 0, "text": "",
                                 "finish_reason": {"eos": "stop",
                                                   "stop": "stop"}.get(
                                     req.stop_reason, "length")}]}) + "\n\n")
            chunk("data: [DONE]\n\n")
            chunk("")  # terminal zero-length chunk
        except (BrokenPipeError, ConnectionResetError):
            pass  # client went away; engine finishes the request regardless


def main(argv: Optional[List[str]] = None):
    """CLI: serve a (random-init or checkpoint) model over HTTP.

    Random-init weights (from seed 0, with the byte tokenizer) keep the full
    serving stack runnable without a download; pass --checkpoint for a
    local HF checkpoint directory. The model runs on --device (default
    cuda, K1 and K2 on the card); it raises when that device is absent.
    """
    import argparse

    from .. import config as C
    from ..models import llama
    from ..utils.tokenizer import load_tokenizer

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--preset", default="tinyllama",
                   choices=["tinyllama", "llama2-7b", "mistral-7b",
                            "qwen2-0.5b", "gemma-2b", "tiny-test"])
    p.add_argument("--checkpoint", default=None,
                   help="local HF checkpoint dir (safetensors)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the params and the KV caches")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--context-len", type=int, default=2048)
    p.add_argument("--max-new-tokens", type=int, default=256)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--prefix-cache", type=int, default=8)
    p.add_argument("--prefix-continue-budget", type=int, default=0,
                   help="enable longest-prefix continuation: prompts "
                        "extending a registered prefix (POST "
                        "/v1/prefixes {\"prompt\": ...}) prefill only "
                        "their suffix (<= this many tokens)")
    p.add_argument("--no-flash", action="store_true")
    args = p.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device")

    presets = {"tinyllama": C.TINYLLAMA_1_1B, "llama2-7b": C.LLAMA2_7B,
               "mistral-7b": C.MISTRAL_7B, "qwen2-0.5b": C.QWEN2_0_5B,
               "gemma-2b": C.GEMMA_2B, "tiny-test": C.tiny_test_model()}
    if args.checkpoint:
        from ..models.weights import config_from_hf, load_hf_checkpoint

        mcfg = config_from_hf(args.checkpoint)
        params = load_hf_checkpoint(args.checkpoint, mcfg, device=args.device)
        tokenizer = load_tokenizer(args.checkpoint)
    else:
        tokenizer = ByteTokenizer()
        mcfg = presets[args.preset]
        mcfg = dataclasses.replace(mcfg, vocab_size=max(
            mcfg.vocab_size, tokenizer.vocab_size))
        params = llama.init_params(0, mcfg, args.device)
    ccfg = C.CompressionConfig(num_layers=mcfg.num_layers)
    engine = ServingEngine(
        llama.fuse_params(params), mcfg, ccfg, num_slots=args.slots,
        context_len=args.context_len, max_new_tokens=args.max_new_tokens,
        use_flash=not args.no_flash, temperature=args.temperature,
        eos_token_id=getattr(tokenizer, "eos_token_id", None),
        prefix_cache_size=args.prefix_cache,
        prefix_continue_budget=args.prefix_continue_budget)
    srv = CompletionServer(engine, tokenizer, model_id=args.preset,
                           host=args.host, port=args.port).start()
    print(f"serving {args.preset} on http://{srv.host}:{srv.port} "
          f"({args.slots} slots, ctx {args.context_len}, {args.device})")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.close()


if __name__ == "__main__":
    main()
