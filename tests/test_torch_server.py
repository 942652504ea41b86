"""The port's HTTP front end (serving/server.py) over the port's engine.

Real HTTP over localhost on the CPU, a 2-layer float32 `tiny_test_model`
with the byte tokenizer's vocabulary. A token-id prompt answers with the
text, token count and logprobs of the port's engine driven directly, and
with the JAX engine's tokens for the same prompt (one JAX engine, run once
for the module; no JAX server). Then: SSE streaming against the
non-streamed text with a stop string, concurrent requests, release of
completed requests, 400 on malformed fields, 503 after the driver dies,
and `/v1/prefixes`.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

import realtime_kv_cache_compression_tpu as rj
import realtime_kv_cache_compression_tpu_torch as rt
from realtime_kv_cache_compression_tpu.serving import engine as je
from realtime_kv_cache_compression_tpu_torch.models import llama as tl
from realtime_kv_cache_compression_tpu_torch.serving import (
    CompletionServer, ServingEngine)
from realtime_kv_cache_compression_tpu_torch.utils.tokenizer import (
    ByteTokenizer, decode_ids)

from torch_parity import jax_tree

TOK = ByteTokenizer()
ENGINE = dict(num_slots=2, context_len=64, max_new_tokens=16, decode_chunk=4,
              logprobs=True)


@pytest.fixture(scope="module")
def model():
    cfg = rt.tiny_test_model(num_layers=2, vocab_size=TOK.vocab_size)
    params = tl.init_params(0, cfg, device="cpu")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, 256, size=n).tolist() for n in (40, 23, 61)]
    return cfg, params, prompts


def engine(model, **kw):
    cfg, params, _ = model
    return ServingEngine(params, cfg, rt.CompressionConfig(num_layers=2),
                         **{**ENGINE, **kw})


def direct(model, prompt, **kw):
    eng = engine(model)
    rid = eng.submit(prompt, **kw)
    return eng.run()[rid]


@pytest.fixture(scope="module")
def served(model):
    with CompletionServer(engine(model), TOK, host="127.0.0.1",
                          port=0) as srv:
        yield srv


def _post(srv, path, body, timeout=120):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _get(srv, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}{path}",
                                    timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _stream(srv, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}/v1/completions",
        data=json.dumps({**body, "stream": True}).encode(),
        headers={"Content-Type": "application/json"})
    deltas, finish = [], None
    with urllib.request.urlopen(req, timeout=120) as r:
        for raw in r:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            if line == "data: [DONE]":
                break
            ch = json.loads(line[len("data: "):])["choices"][0]
            if ch["finish_reason"] is None:
                deltas.append(ch["text"])
            else:
                finish = ch["finish_reason"]
    return "".join(deltas), finish


def test_token_prompt_answers_as_engine_and_jax(model, served):
    _, params, prompts = model
    want = direct(model, prompts[0], max_new_tokens=12)
    jeng = je.ServingEngine(jax_tree(params), rj.tiny_test_model(
        num_layers=2, vocab_size=TOK.vocab_size),
        rj.CompressionConfig(num_layers=2), **ENGINE)
    rid = jeng.submit(prompts[0], max_new_tokens=12)
    assert jeng.run()[rid].tokens == want.tokens
    code, out = _post(served, "/v1/completions",
                      {"prompt": prompts[0], "max_tokens": 12})
    assert code == 200
    choice = out["choices"][0]
    assert choice["text"] == decode_ids(TOK, want.tokens)
    assert choice["finish_reason"] == "length"
    assert choice["logprobs"]["token_logprobs"] == want.logprobs
    assert out["usage"] == {"prompt_tokens": len(prompts[0]),
                            "completion_tokens": 12,
                            "total_tokens": len(prompts[0]) + 12}
    assert out["rtkv"]["kept_ratio"] == want.prefill_stats[
        "cumulative_compression"]


def test_streamed_and_stop_text_agree(model, served):
    prompt = model[2][1]
    toks = direct(model, prompt).tokens
    text = decode_ids(TOK, toks)
    streamed, finish = _stream(served, {"prompt": prompt})
    assert (streamed, finish) == (text, "length")
    # A stop string of two printable bytes the model emits in a row (so it
    # matches at token level); the reply ends before its first match.
    at = next(i for i in range(len(toks) - 1)
              if all(32 <= t < 127 for t in toks[i:i + 2]))
    stop = bytes(toks[at:at + 2]).decode()
    kept = decode_ids(TOK, toks[:at])
    code, out = _post(served, "/v1/completions",
                      {"prompt": prompt, "stop": stop})
    assert code == 200
    assert out["choices"][0]["text"] == kept
    assert out["choices"][0]["finish_reason"] == "stop"
    assert _stream(served, {"prompt": prompt, "stop": [stop]}) == (
        kept, "stop")


def test_concurrent_requests(model, served):
    """Four handler threads at once over two slots."""
    prompts = model[2] + [model[2][0][:20]]
    results = {}

    def go(i):
        results[i] = _post(served, "/v1/completions",
                           {"prompt": prompts[i], "max_tokens": 6})

    threads = [threading.Thread(target=go, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and len(results) == 4
    for i, (code, out) in results.items():
        assert code == 200
        want = direct(model, prompts[i], max_new_tokens=6)
        assert out["choices"][0]["text"] == decode_ids(TOK, want.tokens)
        assert out["usage"]["completion_tokens"] == 6


def test_completed_requests_released_but_counted(model, served):
    engine_ = served.engine
    before = engine_.summary().get("completed", 0)
    code, _ = _post(served, "/v1/completions",
                    {"prompt": "count me", "max_tokens": 4})
    assert code == 200
    assert engine_.summary()["completed"] == before + 1
    assert not engine_.completed
    code, stats = _get(served, "/stats")
    assert code == 200 and stats["summary"]["completed"] == before + 1
    assert stats["driver_alive"] is True
    code, health = _get(served, "/health")
    assert code == 200 and health["status"] == "ok"
    code, models = _get(served, "/v1/models")
    assert models["data"][0]["id"] == served.model_id


def test_malformed_fields_return_400(served):
    for bad in ({"prompt": [1, [2]], "max_tokens": 4},
                {"prompt": "x", "max_tokens": "often"},
                {"prompt": "x", "temperature": 0.9}):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(served, "/v1/completions", bad)
        assert e.value.code == 400, bad
    req = urllib.request.Request(
        f"http://127.0.0.1:{served.port}/v1/completions", data=b"{oops",
        headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(served, "/nope", {})
    assert e.value.code == 404
    code, out = _post(served, "/v1/completions",
                      {"prompt": "x", "max_tokens": None})
    assert code == 200


def test_driver_death_returns_503(model):
    eng = engine(model)

    def boom():
        raise RuntimeError("injected engine failure")

    eng.step = boom
    with CompletionServer(eng, TOK, host="127.0.0.1", port=0) as srv:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(srv, "/v1/completions", {"prompt": "doomed",
                                           "max_tokens": 4}, timeout=60)
        assert e.value.code in (500, 503)
        srv._driver.join(timeout=10)
        assert not srv._driver.is_alive()
        code, health = _get(srv, "/health")
        assert code == 503 and health["status"] == "driver_dead"
        assert "injected engine failure" in health["driver_error"]
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(srv, "/v1/completions", {"prompt": "after",
                                           "max_tokens": 4}, timeout=60)
        assert e.value.code == 503


def test_prefix_registration_endpoint(model):
    sys_prompt = list(range(2, 34))
    with CompletionServer(engine(model, prefix_continue_budget=16), TOK,
                          host="127.0.0.1", port=0) as srv:
        code, out = _post(srv, "/v1/prefixes", {"prompt": sys_prompt})
        assert code == 200 and out == {"registered": True,
                                       "prompt_tokens": len(sys_prompt)}
        code, out = _post(srv, "/v1/completions",
                          {"prompt": sys_prompt + [40, 41, 42],
                           "max_tokens": 6})
        assert code == 200 and out["usage"]["completion_tokens"] == 6
        assert srv.engine.prefix_partial_hits == 1
        code, stats = _get(srv, "/stats")
        assert stats["summary"]["prefix_cache"]["partial_hits"] == 1
        assert stats["summary"]["prefix_cache"]["registered"] == 1
    with CompletionServer(engine(model), TOK, host="127.0.0.1",
                          port=0) as srv:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(srv, "/v1/prefixes", {"prompt": [1, 2, 3]})
        assert e.value.code == 400
