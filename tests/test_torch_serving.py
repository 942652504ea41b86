"""The port's continuous-batching engine vs the JAX package's (CPU, tiny).

One 2-layer float32 `tiny_test_model`: the port's `init_params` weights
feed both packages (`torch_parity.jax_tree`), and one scripted traffic
(`serve`) drives either engine through their shared API. JAX's engine
compiles per instance, so each configuration has one module-scoped JAX
engine (synchronous admission: its batches, and so the batch-wide byte
savings in `prefill_stats`, do not depend on timing) whose recorded
results every port case is held to: greedy tokens and stop reasons
exactly, `prefill_stats` within 1e-6, the streamed tokens and the
prefix-cache counters exactly, logprobs within 1e-4. One request is held
to 5e-4 on its decoded tokens' logprobs: decode attention reads the packed
codes, and the two packages' prefills may quantize a value on a rounding
boundary to neighbouring codes (the pinned whole-model difference,
MAX_CODE_FLIPS one-step codes a layer, tests/torch_parity.py); for prompt
5 one 8-bit V code of layer 1 does, and moves that request's decode
logprobs by 2.9e-4 (the others agree within 1e-5). The test holds that
prefill's codes to the pinned bound, so the looser limit covers that
difference and no other.

The traffic: more requests than slots, ragged and short prompts and an
in-batch duplicate; requests submitted between `step()` calls; stop
sequences spanning decode chunks and a per-request EOS (taken from the
first wave's tokens); an exact prefix-cache hit and a partial hit on a
registered prefix.
"""

import functools

import numpy as np
import pytest
import torch

import realtime_kv_cache_compression_tpu as rj
import realtime_kv_cache_compression_tpu_torch as rt
from realtime_kv_cache_compression_tpu.serving import engine as je
from realtime_kv_cache_compression_tpu.utils import data as jdata
from realtime_kv_cache_compression_tpu.utils import tokenizer as jtok
from realtime_kv_cache_compression_tpu_torch.models import llama as tl
from realtime_kv_cache_compression_tpu_torch.ops.sampling import (
    SamplingParams)
from realtime_kv_cache_compression_tpu_torch.serving import engine as te
from realtime_kv_cache_compression_tpu_torch.utils import data as tdata
from realtime_kv_cache_compression_tpu_torch.utils import tokenizer as ttok

from torch_parity import assert_caches_match, jax_tree

TOL_STATS, TOL_LOGPROBS, TOL_DECODE_LOGPROBS = 1e-6, 1e-4, 5e-4
ENGINE = dict(num_slots=2, context_len=64, max_new_tokens=9, decode_chunk=4,
              logprobs=True)
PREFIX = dict(prefix_cache_size=4, prefix_continue_budget=16)
CHUNKED = dict(prefill_chunk=16)
FLIPPED = {"i0"}  # prompt 5's request: its prefill has the pinned code flip


@pytest.fixture(scope="module")
def model():
    tcfg = rt.tiny_test_model(num_layers=2)
    params = tl.init_params(0, tcfg, device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 250, size=n).tolist()
               for n in (40, 64, 17, 5, 50, 33)]
    return {"tcfg": tcfg, "jcfg": rj.tiny_test_model(num_layers=2),
            "params": params, "jparams": jax_tree(params), "prompts": prompts}


def make(model, package, **kw):
    if package == "jax":
        return je.ServingEngine(model["jparams"], model["jcfg"],
                                rj.CompressionConfig(num_layers=2),
                                async_admission=False, **{**ENGINE, **kw})
    return te.ServingEngine(model["params"], model["tcfg"],
                            rt.CompressionConfig(num_layers=2),
                            **{**ENGINE, **kw})


def serve(eng, prompts, prefix: bool = True):
    """The scripted traffic; returns ({label: request}, {label: streamed
    tokens}) with every request finished."""
    rids, streams = {}, {}

    def submit(label, ids, **kw):
        rids[label] = eng.submit(ids, on_token=lambda req, new: streams
                                 .setdefault(label, []).extend(new), **kw)

    # Wave 1: six requests into two slots, the first two one prompt (an
    # in-batch duplicate sharing a prefill row), ragged and short prompts,
    # mixed budgets.
    for i, (p, m) in enumerate(zip([prompts[0]] + prompts[:5],
                                   (9, 9, 5, 9, 3, 7))):
        submit(f"w{i}", p, max_new_tokens=m)
    eng.run()
    if prefix:
        # Wave 2: submissions between engine steps.
        submit("i0", prompts[5], max_new_tokens=7)
        eng.step()
        eng.step()
        submit("i1", prompts[3], max_new_tokens=4)
        eng.run()
        # Wave 3: a stop sequence across the chunk boundary (tokens 4-5:
        # token 0 comes from the prefill, chunks hold 1-4 and 5-8), and a
        # per-request EOS, both from wave 1's tokens of the same prompts.
        done = eng.completed
        t0, t3 = done[rids["w0"]].tokens, done[rids["w3"]].tokens
        submit("stop", prompts[0], stop_sequences=[[999], t0[4:6]])
        submit("eos", prompts[2], eos_token_id=t3[2])
        # Wave 4: an exact hit on a cached prompt, and a partial hit: a
        # registered prefix extended by 3 tokens (its suffix prefilled by
        # extend_prefill).
        eng.register_prefix(prompts[4][:32])
        submit("exact", prompts[0], max_new_tokens=6)
        submit("partial", prompts[4][:32] + [5, 6, 7])
        eng.run()
    return {k: eng.completed[r] for k, r in rids.items()}, streams


def assert_stats_close(a, b, where):
    assert set(b) == set(a), where
    for k, v in a.items():
        if isinstance(v, dict):
            assert_stats_close(v, b[k], (where, k))
        else:
            np.testing.assert_allclose(b[k], v, rtol=0, atol=TOL_STATS,
                                       err_msg=str((where, k)))


def assert_same(jres, tres):
    (jreq, jstream), (treq, tstream) = jres, tres
    assert list(jreq) == list(treq)
    for label in jreq:
        a, b = jreq[label], treq[label]
        assert b.tokens == a.tokens, label
        assert b.stop_reason == a.stop_reason, label
        assert len(b.logprobs) == len(a.logprobs) == len(a.tokens), label
        np.testing.assert_allclose(b.logprobs[:1], a.logprobs[:1], rtol=0,
                                   atol=TOL_LOGPROBS, err_msg=label)
        tol = TOL_DECODE_LOGPROBS if label in FLIPPED else TOL_LOGPROBS
        np.testing.assert_allclose(b.logprobs, a.logprobs, rtol=0,
                                   atol=tol, err_msg=label)
        assert_stats_close(a.prefill_stats, b.prefill_stats, label)
    assert tstream == jstream


@pytest.fixture(scope="module")
def jax_run(model):
    eng = make(model, "jax", **PREFIX)
    res = serve(eng, model["prompts"])
    return res, eng.summary(), eng


@pytest.fixture(scope="module")
def port_run(model):
    eng = make(model, "torch", async_admission=False, **PREFIX)
    return serve(eng, model["prompts"]), eng


def test_sync_async_and_interleaved_match_jax(model, jax_run, port_run):
    (jres, jsummary, jeng), (tres, teng) = jax_run, port_run
    assert_same(jres, tres)
    assert teng.summary()["prefix_cache"] == jsummary["prefix_cache"]
    # The looser limit's cause: prompt 5's prefill, as both engines admit
    # it (one bucketed row), differs in no more codes than pinned.
    ids, n = teng._bucket_ids(model["prompts"][5])
    jstate = jeng._prefill(jeng.params, np.array([ids], np.int32),
                           np.array([n], np.int32))[1]
    tstate = teng._prefill(torch.tensor([ids]),
                           torch.tensor([n], dtype=torch.int32))[1]
    assert_caches_match(jstate.caches, tstate.caches,
                        rt.CompressionConfig(num_layers=2))
    eng = make(model, "torch", **PREFIX)  # asynchronous admission
    assert eng.async_admission
    assert_same(jres, serve(eng, model["prompts"]))


def test_chunked_admission_matches_jax(model):
    """Two admissions of two ragged rows each, prefilled in chunks of 16
    over the 64-token bucket."""
    prompts = model["prompts"]
    traffic = [prompts[1], prompts[4], prompts[2], prompts[3]]
    jeng = make(model, "jax", **CHUNKED)
    rids = [jeng.submit(p) for p in traffic]
    jdone = jeng.run()
    for async_admission in (False, True):
        eng = make(model, "torch", async_admission=async_admission,
                   **CHUNKED)
        trids = [eng.submit(p) for p in traffic]
        tdone = eng.run()
        assert_same(({i: jdone[r] for i, r in enumerate(rids)}, {}),
                    ({i: tdone[r] for i, r in enumerate(trids)}, {}))


def test_prefix_cache_hits_and_entries_own_their_tensors(model, jax_run,
                                                         port_run):
    (jres, _), jsummary, _ = jax_run
    (tres, _), teng = port_run
    assert jsummary["prefix_cache"]["partial_hits"] == 1
    assert tres["partial"].prefill_stats["prefix_partial"]
    assert tres["partial"].prefill_stats["suffix_tokens"] == 3
    # A cached entry and a registered prefix are byte-equal after their
    # slot has decoded (decode writes the slot state in place: it must
    # never alias an entry).
    prompts = model["prompts"]
    key = tuple(prompts[0])
    reg = tuple(prompts[4][:32])
    entry = teng._prefix_cache[key][1]
    before = [t.clone() for t in tl.decode_state_tensors(entry)]
    reg_before = [t.clone()
                  for t in tl.decode_state_tensors(teng._registered[reg][1])]
    rid = teng.submit(prompts[0], max_new_tokens=9)
    rid2 = teng.submit(list(reg) + [9, 9])
    done = teng.run()
    assert done[rid].tokens[:6] == jres["exact"].tokens
    assert len(done[rid2].tokens) == 9
    for a, b in zip(before, tl.decode_state_tensors(entry), strict=True):
        assert torch.equal(a, b)
    for a, b in zip(reg_before,
                    tl.decode_state_tensors(teng._registered[reg][1]),
                    strict=True):
        assert torch.equal(a, b)


def test_eos_stop_sequences_and_streaming(jax_run, port_run):
    (jres, jstream), _, _ = jax_run
    (tres, tstream), _ = port_run
    t0, t3 = tres["w0"].tokens, tres["w3"].tokens
    stop = tres["stop"]
    assert stop.stop_reason == "stop" and stop.tokens[-2:] == t0[4:6]
    assert stop.tokens == t0[:len(stop.tokens)]
    assert len(stop.logprobs) == len(stop.tokens)
    eos = tres["eos"]
    assert eos.stop_reason == "eos" and eos.tokens[-1] == t3[2]
    assert eos.tokens == t3[:t3.index(t3[2]) + 1]
    assert (jres["stop"].stop_reason, jres["eos"].stop_reason) == (
        "stop", "eos")
    for label, req in tres.items():  # the stream is exactly what was kept
        assert tstream[label] == req.tokens
    assert tstream == jstream


def test_sampled_decode(model):
    prompts = model["prompts"][:3]

    def run(sampling, **kw):
        eng = make(model, "torch", sampling=sampling, **kw)
        rids = [eng.submit(p) for p in prompts]
        done = eng.run()
        return [done[r].tokens for r in rids]

    greedy = run(SamplingParams())
    assert run(SamplingParams(temperature=0.8, top_k=1)) == greedy
    sampled = SamplingParams(temperature=0.8, top_p=0.9)
    first = run(sampled, seed=3)
    assert run(sampled, seed=3) == first
    assert first != greedy
    # Penalty counts restart at admission: one prompt served twice, one
    # after the other in the one slot, under a presence penalty that bars
    # every token seen so far. Counts kept from the first request would
    # bar its tokens from the second.
    penalty = SamplingParams(presence_penalty=100.0)
    eng = make(model, "torch", sampling=penalty, num_slots=1)
    rids = [eng.submit(prompts[0]) for _ in range(2)]
    done = eng.run()
    toks = done[rids[0]].tokens
    assert len(set(toks)) == len(toks) == 9
    assert done[rids[1]].tokens == toks


def test_warmup_covers_every_batch_size_and_leaks_nothing(model):
    eng = make(model, "torch", num_slots=4, prefix_cache_size=4)
    batches = []
    inner = eng._prefill
    eng._prefill = lambda ids, lens: (batches.append(ids.shape[0]),
                                      inner(ids, lens))[1]
    info = eng.warmup()
    assert info["batch_sizes"] == [1, 2, 4] and info["wall_s"] > 0
    assert sorted(set(batches)) == [1, 2, 4]
    assert eng.model_calls["prefill"] == len(batches)
    assert eng.summary() == {"completed": 0}
    assert not eng.completed and not eng._prefix_cache
    assert not eng.has_work()
    rid = eng.submit(model["prompts"][0], max_new_tokens=5)
    assert len(eng.run()[rid].tokens) == 5


def test_helpers_match_jax(model, monkeypatch):
    """estimate_prefill_seconds and resolve_prefill_chunk at an explicit
    effective throughput (JAX's default is a TPU figure, the port's one
    measured on the card), truncate_middle, and the byte tokenizer."""
    mc = dict(tcfg=model["tcfg"], jcfg=model["jcfg"])
    cases = [(s, tf) for s in (64, 4096, 32768) for tf in (1e-3, 5e-5, 40.0)]
    for s, tf in cases:
        j = je.estimate_prefill_seconds(model["jparams"], mc["jcfg"], s, tf)
        t = te.estimate_prefill_seconds(model["params"], mc["tcfg"], s, tf)
        assert t == pytest.approx(j, rel=1e-12)
        for mod in (je, te):
            monkeypatch.setattr(mod, "estimate_prefill_seconds",
                                functools.partial(mod.__dict__[
                                    "estimate_prefill_seconds"],
                                    effective_tf_s=tf))
        for budget in (0.5, 0.05):
            assert te.resolve_prefill_chunk(
                model["params"], mc["tcfg"], s, budget) == \
                je.resolve_prefill_chunk(model["jparams"], mc["jcfg"], s,
                                         budget), (s, tf, budget)
        monkeypatch.undo()
    ids = list(range(100))
    for n in (0, 1, 7, 50, 99, 100, 200):
        assert tdata.truncate_middle(ids, n) == jdata.truncate_middle(ids, n)
    tb, jb = ttok.ByteTokenizer(), jtok.ByteTokenizer()
    for text in ("", "hello", "héllo wörld ✓", "x" * 40):
        for kw in ({}, {"max_length": 5}, {"add_bos": False}):
            assert tb.encode(text, **kw) == jb.encode(text, **kw)
        ids = tb.encode(text) + [257, 300]
        assert ttok.decode_ids(tb, ids) == jtok.decode_ids(jb, ids)
        assert tb.decode(ids, skip_special_tokens=False) == \
            jb.decode(ids, skip_special_tokens=False)
    assert isinstance(ttok.load_tokenizer(None), ttok.ByteTokenizer)


def test_mesh_raises(model):
    """The sharded engine's refusals, which issue no collective: slots
    that the data axis does not divide, and a tree sharded over another
    mesh than mesh=. A registered prefix is no longer refused: its
    partial hits run the sharded `extend_prefill` (held to a one-rank
    engine over real ranks in `tests/test_torch_sharded_decoders.py`);
    here it is registered. Meshes of coordinates without groups stand in
    for the ranks (slicing needs none; the values computed over one
    rank's heads alone are not read)."""
    from realtime_kv_cache_compression_tpu_torch.parallel import (
        Mesh, shard_params)

    def mesh(data, model_):
        return Mesh(axis_names=("data", "model"),
                    shape={"data": data, "model": model_},
                    coords={"data": 0, "model": 0},
                    groups={"data": None, "model": None})

    with pytest.raises(ValueError, match="data-axis"):
        make(model, "torch", num_slots=3, mesh=mesh(2, 1))
    sharded = shard_params(model["params"], mesh(1, 2), model["tcfg"])
    with pytest.raises(ValueError, match="another mesh"):
        te.ServingEngine(sharded, model["tcfg"],
                         rt.CompressionConfig(num_layers=2),
                         mesh=mesh(1, 1), **ENGINE)
    eng = make(model, "torch", mesh=mesh(1, 2), **PREFIX)
    assert not eng.async_admission  # lockstep over more than one rank
    eng.register_prefix(model["prompts"][0])
    assert len(eng._registered) == 1
