"""Rank-side work of the port's multi-rank CPU tests (not a test module).

`parallel.launch.run_ranks` pickles these functions by import path, so
each spawned rank imports this module, which imports PyTorch and the port
and never JAX. Each function takes (rank, world_size, group, ...) and
returns CPU tensors; the tests concatenate the ranks' slices and hold them
to the JAX package's one-device functions.
"""

import torch

from realtime_kv_cache_compression_tpu_torch import CompressionConfig
from realtime_kv_cache_compression_tpu_torch.models import llama
from realtime_kv_cache_compression_tpu_torch.ops.attention import \
    sharded_window_attention_mass
from realtime_kv_cache_compression_tpu_torch.ops.importance import \
    importance_scores
from realtime_kv_cache_compression_tpu_torch.parallel import (
    MODEL_AXIS, SEQ_AXIS, comm, create_mesh, create_seq_mesh,
    gather_sharded_state, ring_prefill_attention, seq_parallel_prefill)


def _mine(x: torch.Tensor, rank: int, n: int, dim: int = 1) -> torch.Tensor:
    """This rank's block of x along dim."""
    return x.chunk(n, dim=dim)[rank].contiguous()


def ring_and_window(rank, n, group, q, k, v, prompt_len, prompt_lens,
                    window, pools, pm, qm, score_lengths):
    """Ring attention over this rank's block of q, k, v (uniform, then
    with per-row prompt_lens), the window mass of the last `window`
    queries at each pool width, the "both" importance scores of this
    rank's block of the masses pm and qm (uniform, then ragged at
    score_lengths), what the collectives, the meshes and the halo check
    give. Returns local slices."""
    b, s = q.shape[:2]
    s_loc = s // n
    ql, kl, vl = (_mine(x, rank, n) for x in (q, k, v))
    out = {"uniform": ring_prefill_attention(ql, kl, vl, prompt_len, group),
           "ragged": ring_prefill_attention(ql, kl, vl, prompt_len, group,
                                            prompt_lens=prompt_lens)}
    gpos = (rank * s_loc + torch.arange(s_loc))[None].expand(b, s_loc)
    q_pos = torch.arange(s - window, s)[None].expand(b, window)
    for pool in pools:
        out[f"mass_pool{pool}"] = sharded_window_attention_mass(
            q[:, s - window:], q_pos, torch.ones((b, window), dtype=bool), kl,
            gpos, torch.ones((b, s_loc), dtype=bool), group, pool=pool)
    try:
        sharded_window_attention_mass(
            q[:, s - window:], q_pos, torch.ones((b, window), dtype=bool), kl,
            gpos, torch.ones((b, s_loc), dtype=bool), group,
            pool=2 * s_loc + 3)
        out["halo_refused"] = False
    except ValueError:
        out["halo_refused"] = True
    ccfg = CompressionConfig(num_layers=2, importance_source="both")
    for key, lengths in (("scores", None), ("scores_ragged", score_lengths)):
        out[key] = importance_scores(
            _mine(pm, rank, n), 1, s_loc, ccfg.prompt_length(s), ccfg,
            lengths=lengths, position_offset=rank * s_loc, total_len=s,
            group=group, query_mass=_mine(qm, rank, n))
    mesh = create_mesh(data=2) if n == 4 else create_mesh()
    out["mesh"] = (mesh.shape, mesh.coords,
                   {a: comm.rank_and_size(g) for a, g in mesh.groups.items()},
                   comm.all_reduce_sum(torch.tensor([rank]),
                                       mesh.group(MODEL_AXIS)))
    out["seq_mesh"] = comm.rank_and_size(create_seq_mesh().group(SEQ_AXIS))
    x = torch.tensor([float(rank)])
    out["ring_shift"] = comm.ring_shift(x, group)
    out["left"] = comm.neighbour_shift(x, 1, group)
    out["right"] = comm.neighbour_shift(x, -1, group)
    out["gathered"] = comm.all_gather_tensors(
        [torch.full((2,), rank, dtype=torch.bfloat16),
         torch.tensor([rank % 2 == 0])], group)
    return out


def fail_on_rank_one(rank, n, group):
    """Rank 1 raises; the others wait in a collective it never joins."""
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    comm.all_reduce_sum(torch.zeros(1), group)
    return rank


def _state_cpu(state):
    return llama.map_decode_state(state, lambda t: t.cpu().clone(),
                                  state.ring_fill)


def seq_parallel_runs(rank, n, group, params, ids, cfg, runs, decode_steps,
                      max_decode_len):
    """seq_parallel_prefill once per entry of `runs` (name -> (ccfg,
    sharded_compression, lengths)), recording each layer's compression
    inputs on the sharded runs, then greedy decode from the state
    (gathered first when sharded). Also the refusals: S not a multiple of
    the ranks, and sharded compression with an empty tier."""
    from realtime_kv_cache_compression_tpu_torch.parallel import \
        seq_parallel as sp

    out = {}
    for name, (ccfg, sharded, lengths) in runs.items():
        inputs = []
        real = sp.compress_layer_kv

        def recording(k, v, pmass, layer_idx, *a, **kw):
            inputs.append({"k": k.clone(), "v": v.clone(),
                           "pmass": pmass.clone(),
                           "qmass": (None if kw.get("query_mass") is None
                                     else kw["query_mass"].clone())})
            return real(k, v, pmass, layer_idx, *a, **kw)

        sp.compress_layer_kv = recording
        try:
            logits, state, stats = seq_parallel_prefill(
                params, ids, cfg, ccfg, group, max_decode_len=max_decode_len,
                sharded_compression=sharded, lengths=lengths)
        finally:
            sp.compress_layer_kv = real
        full = gather_sharded_state(state, group) if sharded else state
        first = torch.argmax(logits, dim=-1)
        toks, _ = llama.decode_loop(params, first, llama.clone_decode_state(
            full), decode_steps, cfg, ccfg)
        out[name] = {"logits": logits, "state": _state_cpu(state),
                     "full": _state_cpu(full), "stats": stats,
                     "tokens": torch.cat([first[:, None], toks], dim=1),
                     "inputs": inputs if sharded else None}
    refused = {}
    try:
        seq_parallel_prefill(params, ids[:, :-1], cfg, runs["replicated"][0],
                             group)
    except ValueError:
        refused["length"] = True
    try:
        seq_parallel_prefill(params, ids[:, :8 * n], cfg,
                             runs["replicated"][0], group,
                             sharded_compression=True)
    except ValueError:
        refused["capacity"] = True
    out["refused"] = refused
    return out


def seq_parallel_on_card(rank, n, group, cfg, ccfg, s):
    """A seq_parallel_prefill on cuda:0 from init_params(0) and ids from a
    seeded CPU generator; returns the logits, the caches and this rank's
    (diagonal pair, mode (c)) launches, on the host."""
    from realtime_kv_cache_compression_tpu_torch.ops.cuda import \
        flash_prefill as fp

    params = llama.init_params(0, cfg, "cuda")
    ids = torch.randint(0, cfg.vocab_size, (1, s),
                        generator=torch.Generator().manual_seed(1)).cuda()
    fp.flash_diagonal_pair_attention.launches = 0
    fp.flash_full_pair_attention.launches = 0
    logits, state, _ = seq_parallel_prefill(params, ids, cfg, ccfg, group,
                                            max_decode_len=8)
    torch.cuda.synchronize()
    return {"logits": logits.cpu(),
            "caches": _state_cpu(state).caches,
            "launches": (fp.flash_diagonal_pair_attention.launches,
                         fp.flash_full_pair_attention.launches)}


def _kept(state, row0):
    """Per layer and tier, each row's kept positions as a sorted list,
    keyed by the row's global index (row0 + local row)."""
    out = {}
    for li, cache in enumerate(state.caches):
        for ti, t in enumerate(cache.tiers):
            for r in range(t.positions.shape[0]):
                out[(li, ti, row0 + r)] = sorted(
                    t.positions[r][t.valid[r]].tolist())
    return out


def tensor_parallel_runs(rank, n, group, meshes, cases, steps):
    """Per mesh (data, model) in `meshes`, each entry of `cases` (name ->
    (params, cfg, ccfg, prefill, ids, lengths, chunk)) on this rank's
    slice of the params (`shard_params`) through the named prefill with
    mesh=;
    the "base" case also runs `decode_step` at token 7 from a copy of its
    state and `decode_loop` for `steps` greedy steps. Returns, per mesh
    and case, the logits, the kept positions of this rank's rows, the
    stats, the rank's kv heads per cache and the decode results."""
    from realtime_kv_cache_compression_tpu_torch.parallel import (
        shard_params)

    out = {}
    for data, model in meshes:
        mesh = create_mesh(data, model)
        row0 = mesh.coords["data"] * (4 // data)
        for name, (params, cfg, ccfg, prefill, ids, lengths, chunk) in \
                cases.items():
            sp = shard_params(params, mesh, cfg)
            kw = {"lengths": lengths} if lengths is not None else {}
            if chunk:
                kw["chunk_size"] = chunk
            logits, state, stats = getattr(llama, prefill)(
                sp, ids, cfg, ccfg, max_decode_len=steps + 4, mesh=mesh,
                **kw)
            res = {"logits": logits, "kept": _kept(state, row0),
                   "stats": stats,
                   "kv_heads": state.caches[0].tiers[0].k_scale.shape[2]}
            if name == "base":
                step_logits, _ = llama.decode_step(
                    sp, torch.full((ids.shape[0],), 7), llama.
                    clone_decode_state(state), cfg, ccfg)
                toks, _ = llama.decode_loop(sp, torch.argmax(logits, -1),
                                            state, steps, cfg, ccfg)
                res.update(step_logits=step_logits, tokens=toks)
            out[(data, model, name)] = res
    return out


def expert_parallel_runs(rank, n, group, meshes, moe, xs, cfg, factors,
                         params, ids, ccfg, steps):
    """Per mesh (data, model): `ep_moe_mlp` on this rank's expert slice of
    `moe` for each input of `xs` at each capacity factor of `factors`,
    then the MoE model's `prefill_compressed` on its sharded `params`
    (mesh=) and `decode_loop` for `steps` greedy steps."""
    from realtime_kv_cache_compression_tpu_torch.parallel import (
        ep_moe_mlp, shard_params)

    out = {}
    for data, model in meshes:
        mesh = create_mesh(data, model)
        sp = shard_params(params, mesh, cfg)
        local = sp["layers"][0]["moe"]
        assert torch.equal(local["w_gate"], _mine(moe["w_gate"], mesh.coords[
            "model"], model, dim=0))
        out[(data, model, "ep")] = {
            (i, f): ep_moe_mlp(local, x, cfg, mesh, capacity_factor=f)
            for i, x in enumerate(xs) for f in factors}
        logits, state, stats = llama.prefill_compressed(
            sp, ids, cfg, ccfg, max_decode_len=steps + 4, mesh=mesh)
        toks, _ = llama.decode_loop(sp, torch.argmax(logits, -1), state,
                                    steps, cfg, ccfg)
        out[(data, model, "prefill")] = {
            "logits": logits, "kept": _kept(state, mesh.coords["data"]
                                            * (ids.shape[0] // data)),
            "stats": stats, "tokens": toks}
    return out


def tensor_parallel_on_card(rank, n, group, cfg, ccfg, s, steps):
    """`prefill_compressed` and `decode_loop` on cuda:0 over a 1 x n mesh,
    from init_params(0) cut to this rank's slice and ids from a seeded CPU
    generator; returns the logits, the tokens and this rank's (K1, K2)
    launches, on the host."""
    from realtime_kv_cache_compression_tpu_torch.ops.cuda import (
        decode_attention as da)
    from realtime_kv_cache_compression_tpu_torch.ops.cuda import \
        flash_prefill as fp
    from realtime_kv_cache_compression_tpu_torch.parallel import (
        shard_params)

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = create_mesh(1, n)
    params = shard_params(llama.init_params(0, cfg, "cuda"), mesh, cfg)
    ids = torch.randint(0, cfg.vocab_size, (1, s),
                        generator=torch.Generator().manual_seed(1)).cuda()
    fp.flash_prefill_with_prompt_mass.launches = 0
    da.fused_decode_attention.launches = 0
    logits, state, _ = llama.prefill_compressed(
        params, ids, cfg, ccfg, max_decode_len=steps + 4, mesh=mesh)
    toks, _ = llama.decode_loop(params, torch.argmax(logits, -1), state,
                                steps, cfg, ccfg)
    torch.cuda.synchronize()
    return {"logits": logits.cpu(), "tokens": toks.cpu(),
            "launches": (fp.flash_prefill_with_prompt_mass.launches,
                         da.fused_decode_attention.launches)}


def pipeline_runs(rank, n, group, params, cfg, ccfg, ids, steps, loss_mbs,
                  train_mbs, lr):
    """On a pipe mesh of the n ranks: `PipelineInference` prefill and
    `steps` - 1 greedy decode steps; the stack / unstack round trip;
    `pipeline_lm_loss` at each microbatch count of `loss_mbs`; with
    `train_mbs`, one `pipeline_train_step` (AdamW at `lr`) and the whole
    model unstacked after it."""
    from realtime_kv_cache_compression_tpu_torch.models import train
    from realtime_kv_cache_compression_tpu_torch.parallel import (
        PipelineInference, create_pipe_mesh, pipeline_lm_loss,
        pipeline_train_step, stack_pipeline_params, unstack_pipeline_params)

    mesh = create_pipe_mesh(n)
    pipe = PipelineInference(params, cfg, ccfg, mesh, max_decode_len=16)
    logits, stats = pipe.prefill(ids)
    first = torch.argmax(logits, dim=-1)
    toks = pipe.decode(first, steps - 1)
    stacked = stack_pipeline_params(params, mesh)
    out = {"logits": logits, "stats": stats,
           "tokens": torch.cat([first[:, None], toks], dim=1),
           "stage_wq": stacked["layers"]["wq"].clone(),
           "roundtrip": unstack_pipeline_params(stacked, mesh),
           "loss": {mb: pipeline_lm_loss(stacked, ids, cfg, mesh, mb)
                    for mb in loss_mbs}}
    if train_mbs:
        opt = train.make_optimizer(stacked, lr=lr)
        out["train_loss"] = pipeline_train_step(stacked, opt, ids, cfg, mesh,
                                                train_mbs)
        out["grad_norm"] = opt.last_grad_norm
        out["trained"] = unstack_pipeline_params(stacked, mesh)
    return out


def sharded_serving_runs(rank, n, group, params, cfg, ccfg, runs, prompts):
    """Per entry of `runs` (name -> (mesh (data, model), engine keyword
    arguments)), a `ServingEngine(mesh=)` on this rank serving `prompts`
    (each a (ids, max_new_tokens) pair) to the end. Returns per run the
    tokens, stop reasons and prefill stats of every request, the engine's
    summary and schedule, and this rank's slot-state rows."""
    from realtime_kv_cache_compression_tpu_torch.serving.engine import \
        ServingEngine

    out = {}
    for name, (shape, kw) in runs.items():
        eng = ServingEngine(params, cfg, ccfg, mesh=create_mesh(*shape), **kw)
        rids = [eng.submit(p, max_new_tokens=m) for p, m in prompts]
        done = eng.run()
        out[name] = {"tokens": [done[r].tokens for r in rids],
                     "stop": [done[r].stop_reason for r in rids],
                     "stats": [done[r].prefill_stats for r in rids],
                     "summary": eng.summary(),
                     "calls": dict(eng.model_calls),
                     "rows": eng._state.position.shape[0],
                     "async": eng.async_admission}
    return out


def sharded_decode_runs(rank, n, group, params, ids, cfg, runs, steps):
    """Per entry of `runs` (name -> (ccfg, ring capacity)):
    `seq_parallel_prefill(sharded_compression=True)`, the gathered state
    (`gather_sharded_state`, the reference, taken before decoding), then
    `steps` greedy `decode_step`s from the rank's own slot shard with
    `slot_group=group`, every all-gather of the decode recorded by the
    shapes it carried. Returns the tokens, the step logits, the slots the
    rank's tiers hold before and after, the recorded gathers and the
    gathered state."""
    from realtime_kv_cache_compression_tpu_torch.parallel import \
        seq_parallel as sp

    def slots(state):
        return [[t.positions.shape[1] for t in c.tiers] for c in state.caches]

    out = {}
    for name, (ccfg, ring) in runs.items():
        logits, state, _ = seq_parallel_prefill(
            params, ids, cfg, ccfg, group, max_decode_len=ring,
            sharded_compression=True)
        full = _state_cpu(gather_sharded_state(state, group))
        before = slots(state)
        gathers, real = [], comm.all_gather_tensors

        def recording(tensors, g):
            gathers.append([tuple(t.shape) for t in tensors])
            return real(tensors, g)

        tok, toks, step_logits = torch.argmax(logits, -1), [], []
        toks.append(tok)
        sp.comm.all_gather_tensors = recording
        try:
            for _ in range(steps):
                lg, state = llama.decode_step(params, tok, state, cfg, ccfg,
                                              slot_group=group)
                tok = torch.argmax(lg, -1)
                toks.append(tok)
                step_logits.append(lg)
        finally:
            sp.comm.all_gather_tensors = real
        out[name] = {"tokens": torch.stack(toks, 1),
                     "logits": torch.stack(step_logits),
                     "slots": (before, slots(state)), "gathers": gathers,
                     "full": full, "ring_len": state.recents[0].length}
    return out


def sharded_train_runs(rank, n, group, shape, params, cfg, ids, mask,
                       steps, lr, total):
    """On a (data, model) = `shape` mesh of the n ranks, this rank's slice
    of `params` (`shard_params`): `lm_loss` and its gradients (summed as
    `train_step` sums them: `ShardLayout.sync_grads`), unmasked and with
    `mask`; then, per clip norm (0.5 with the mask, 1e6 without), `steps`
    `train_step`s from a fresh slice (AdamW at `lr`, a schedule over
    `total` steps). Returns the rank's mesh coordinates, the losses, the
    gradient slices, the global gradient norms and the trained slices."""
    from realtime_kv_cache_compression_tpu_torch.models import train
    from realtime_kv_cache_compression_tpu_torch.parallel import shard_params

    mesh = create_mesh(*shape)
    out = {"coords": dict(mesh.coords), "shape": dict(mesh.shape),
           "grads": {}, "train": {}}
    # A slice of a replicated leaf is the leaf itself, and the parent's
    # tensors reach the ranks in shared memory: every run trains copies.
    fresh = lambda: shard_params(_tree_map(params, torch.clone),  # noqa
                                 mesh, cfg)
    for masked in (False, True):
        sp = fresh()
        opt = train.make_optimizer(sp)  # marks the slices as needing grad
        loss = train.lm_loss(sp, ids, cfg, use_flash=False,
                             loss_mask=mask if masked else None)
        loss.backward()
        sp.layout.sync_grads(opt.tensors, sp.layout.leaf_kinds(sp))
        out["grads"][masked] = (loss.detach(), _tree_map(
            sp, lambda t: t.grad.clone()))
    for clip, masked in ((0.5, True), (1e6, False)):
        sp = fresh()
        opt = train.make_optimizer(sp, lr=lr, total_steps=total,
                                   clip_norm=clip)
        losses, norms = [], []
        for _ in range(steps):
            losses.append(train.train_step(sp, opt, ids, cfg,
                                           use_flash=False,
                                           loss_mask=mask if masked
                                           else None))
            norms.append(opt.last_grad_norm.clone())
        out["train"][clip] = (losses, norms,
                              _tree_map(sp, lambda t: t.detach().clone()))
    return out


def _tree_map(tree, fn):
    """A plain dict / list tree of fn(leaf)."""
    if isinstance(tree, dict):
        return {k: _tree_map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(v, fn) for v in tree]
    return fn(tree)


def sharded_decoder_runs(rank, n, group, shape, params, cfg, ccfg, ids,
                         beam, spec, suffix, engine):
    """On a (data, model) = `shape` mesh, this rank's slice of `params`:
    `beam_search` (`beam`: keyword arguments) of `ids`; the sharded
    prefill of `ids` with ring room, then `speculative_decode_loop` from
    it (`spec`: n_steps, n_draft) and `extend_prefill` of `suffix` (ids,
    lengths) from another copy; with `engine` (engine keyword arguments,
    a prefix, prompts) a `ServingEngine(mesh=)` that registers the prefix
    and serves the prompts; and the beam-split refusal (one prompt over
    more than one data rank). Returns what the test compares, with the
    rank's row start and kv-head range."""
    from realtime_kv_cache_compression_tpu_torch.models import (beam_search,
                                                                speculative)
    from realtime_kv_cache_compression_tpu_torch.parallel import shard_params
    from realtime_kv_cache_compression_tpu_torch.serving.engine import \
        ServingEngine

    mesh = create_mesh(*shape)
    sp = shard_params(params, mesh, cfg)
    out = {"row0": sp.layout.row_start(ids.shape[0]),
           "kv_heads": sp.layout.kv_heads}
    out["beam"] = beam_search.beam_search(sp, ids, cfg, ccfg,
                                          return_all_beams=True, **beam)[:2]
    logits, state, _ = llama.prefill_compressed(sp, ids, cfg, ccfg,
                                                max_decode_len=16)
    first = torch.argmax(logits, -1)
    toks, _, stats = speculative.speculative_decode_loop(
        sp, first, llama.clone_decode_state(state), spec[0], cfg, ccfg, ids,
        n_draft=spec[1])
    out["spec"] = (torch.cat([first[:, None], toks], 1), stats)
    last, ext = speculative.extend_prefill(sp, state, *suffix, cfg, ccfg)
    out["extend"] = (last, ext.position, ext.recents[0].k.clone(),
                     ext.recents[0].length.clone())
    if engine is not None:
        kw, prefix, prompts = engine
        eng = ServingEngine(params, cfg, ccfg, mesh=mesh, **kw)
        eng.register_prefix(prefix)
        rids = [eng.submit(p) for p in prompts]
        done = eng.run()
        out["engine"] = ([done[r].tokens for r in rids],
                         eng.prefix_partial_hits)
    try:
        beam_search.beam_search(sp, ids[:1], cfg, ccfg, **beam)
        out["refused"] = None
    except ValueError as e:
        out["refused"] = str(e)
    return out
