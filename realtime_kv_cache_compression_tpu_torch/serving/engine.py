"""Continuous-batching serving engine over compressed KV caches (PyTorch).

Port of the JAX package's `serving/engine.py`, with its names. Design:
  * B fixed decode slots. Each slot holds one sequence's compressed tier
    pools + recent ring (+ decode pool) + position: one batched
    `DecodeState` indexed by slot, on the params' device.
  * Admission: ALL pending requests that fit free slots prefill together in
    ONE batched (ragged, right-padded) prefill, padded to a power-of-two
    batch (K1 on CUDA tensors); each row is then copied into its slot in
    place (`_tree_insert_row`). Admission is asynchronous by default: a
    CUDA event recorded after the prefill is polled between decode chunks
    (CPU tensors are ready at once). On the card the host takes longer
    to issue the prefill than the device to run it, so the event is ready
    at the first poll and async admission overlaps nothing yet (PERF.md).
  * Decode: `decode_loop` advances ALL slots, idle ones included, by
    `decode_chunk` steps (K2 on CUDA tensors); only active slots' tokens
    are delivered; finished slots (EOS, stop sequence or token budget) are
    freed and refilled.
  * Fixed shapes: slot count, context bucket and recent-ring capacity are
    set at engine build; per-sequence raggedness lives in positions,
    validity and the host ring fills.
  * Prefix caching (`prefix_cache_size=N`): completed prefills are kept
    (LRU) as single-row decode states keyed by the exact prompt; repeat
    prompts re-admit with zero prefill work. Decode updates rings, pools
    and positions in place, so an entry owns its tensors (a row sliced,
    then cloned) and the slot state never aliases one: admission copies.
  * Sharded serving (`mesh=`, a (data, model) mesh of ranks,
    `parallel/mesh.create_mesh`): every rank runs this same engine on the
    same submissions. The weights are split over `model`
    (`parallel.shard_params`) and the slots over `data`: a rank keeps its
    data block of the slot state (its slots' rows, its kv heads), checked
    by `constrain_decode_state` at every insert. Decode runs through the
    sharded `decode_step`, whose tokens and logits are global, so every
    rank's scheduler sees every token and makes the same decisions (stop
    reasons, prefix hits, slot choice; a sampled engine's generator is
    seeded alike on every rank). The admission prefill runs with its rows
    whole on every data rank (`ShardLayout.rows_whole`: weights still
    split over `model`, K1 over the rank's heads), and each data rank
    inserts the rows of the slots it owns: an admission of fewer rows than
    the data axis needs no padding, and its batch-wide stats are those of
    the whole batch, as in JAX, where GSPMD replicates such a batch. With
    more than one rank, admission is synchronous: a rank's readiness
    signal must not decide when a collective issues (JAX turns async
    admission off over processes for the same reason). A registered
    prefix is prefilled, and a partial hit extended (`extend_prefill`
    over the rank's heads), with the rows whole in the same way.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..compression.compressor import summarize_layer_stats_per_row
from ..config import CompressionConfig, ModelConfig
from ..models import llama, speculative
from ..models.quantized_params import params_num_weights
from ..ops.sampling import SamplingParams, sample_logits
from ..parallel.mesh import DATA_AXIS
from ..utils.data import truncate_middle

# Effective throughput of the analytic prefill estimate below, measured:
# TinyLlama-1.1B's one-shot 4096-token prefill (bf16, fused weights, K1,
# B=1) counts 9.080 TFLOP by this formula and took a median 194.7 ms on
# an NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py,
# phase_serving_path; 173.0 ms in an earlier run on the same card model).
EFFECTIVE_TF_S = 46.6


@dataclasses.dataclass
class Request:
    rid: int
    input_ids: List[int]
    max_new_tokens: int
    submitted_at: float = dataclasses.field(default_factory=time.time)
    prefill_stats: Optional[Dict] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    finished: bool = False
    ttft: Optional[float] = None
    finished_at: Optional[float] = None
    # Request-level generation controls (see ServingEngine.submit):
    stop_sequences: List[List[int]] = dataclasses.field(default_factory=list)
    eos_token_id: Optional[int] = None  # None -> engine default
    on_token: Optional[Any] = None      # streaming callback(req, new_tokens)
    logprobs: List[float] = dataclasses.field(default_factory=list)
    stop_reason: Optional[str] = None   # "eos" | "stop" | "length"


def estimate_prefill_seconds(params, mcfg: ModelConfig, context_len: int,
                             effective_tf_s: float = EFFECTIVE_TF_S) -> float:
    """Analytic one-shot prefill wall estimate (batch 1) for the chunking
    heuristic: weight FLOPs 2·N·S plus causal attention 2·Hq·S²·D, over an
    effective throughput (default: EFFECTIVE_TF_S, measured on the card).
    An order-of-magnitude gate, not a timing."""
    n = params_num_weights(params)
    s = context_len
    flops = 2.0 * n * s + 2.0 * mcfg.num_heads * s * s * mcfg.head_dim
    return flops / (effective_tf_s * 1e12)


def resolve_prefill_chunk(params, mcfg: ModelConfig, context_len: int,
                          hol_budget_s: float = 0.5) -> Optional[int]:
    """prefill_chunk="auto" resolution: chunk only when the one-shot
    prefill would block head-of-line longer than `hol_budget_s`.

    A short one-shot prefill already pipelines with decode and chunk steps
    serialize on the driver, so chunking pays only where the one-shot
    prefill would hold the device stream longer than the budget. The chunk
    size targets ~hol_budget_s per chunk (power of two, >= 512, at most
    4096, dividing context_len; else None).
    """
    est = estimate_prefill_seconds(params, mcfg, context_len)
    if est <= hol_budget_s:
        return None
    target = max(int(context_len * hol_budget_s / est), 512)
    chunk = 512
    while chunk * 2 <= target:
        chunk *= 2
    # Cap at 4096: later chunks attend over the whole buffer, so a larger
    # chunk turns estimator error straight into head-of-line time.
    chunk = min(chunk, 4096)
    if context_len % chunk or chunk >= context_len:
        return None  # non-pow2 context: stay unchunked rather than crash
    return chunk


def _tree_insert_row(batched: llama.DecodeState, multi: llama.DecodeState,
                     row: int, slot: int) -> llama.DecodeState:
    """Copy row `row` of `multi` into slot `slot` of `batched` in place:
    every tensor of the tier caches, rings and decode pools, and the
    position. Returns `batched` with the slot's host ring fill taken from
    the row. Raises ValueError where the layouts differ: a tensor's
    trailing shape or dtype, or a static field (a tier's packing chunk, a
    pool's block count, block size or bits)."""
    dst, src = llama.decode_state_parts(batched), \
        llama.decode_state_parts(multi)
    if [type(p) for p in dst] != [type(p) for p in src]:
        raise ValueError("decode states of different structure")
    pairs = [(batched.position, multi.position, "position")]
    for d, s in zip(dst, src):
        for f in dataclasses.fields(d):
            a, b = getattr(d, f.name), getattr(s, f.name)
            name = f"{type(d).__name__}.{f.name}"
            if isinstance(a, torch.Tensor):
                pairs.append((a, b, name))
            elif a != b:
                raise ValueError(f"{name}: {b!r} into a slot state of {a!r}")
    for a, b, name in pairs:
        if a.shape[1:] != b.shape[1:] or a.dtype != b.dtype:
            raise ValueError(f"{name}: row {tuple(b.shape[1:])} {b.dtype} "
                             f"into slots {tuple(a.shape[1:])} {a.dtype}")
    for a, b, _ in pairs:
        a[slot].copy_(b[row])
    fill = list(batched.ring_fill)
    fill[slot] = multi.ring_fill[row]
    return dataclasses.replace(batched, ring_fill=tuple(fill))


def _extract_row(state: llama.DecodeState, row: int) -> llama.DecodeState:
    """Row `row` of `state` as a single-row state owning its tensors."""
    return llama.map_decode_state(state, lambda t: t[row:row + 1].clone(),
                                  (state.ring_fill[row],))


class ServingEngine:
    """Greedy/sampled continuous-batching engine on one device, or on the
    ranks of a (data, model) mesh (`mesh=`)."""

    def __init__(self, params, mcfg: ModelConfig, ccfg: CompressionConfig,
                 num_slots: int = 4, context_len: int = 2048,
                 max_new_tokens: int = 128, decode_chunk: int = 8,
                 use_flash: Optional[bool] = None,
                 use_fused_decode: Optional[bool] = None,
                 eos_token_id: Optional[int] = None,
                 async_admission: bool = True,
                 temperature: float = 0.0,
                 sampling: Optional[SamplingParams] = None,
                 logprobs: bool = False,
                 prefix_cache_size: int = 0,
                 prefill_chunk=None,
                 prefix_continue_budget: int = 0,
                 seed: int = 0,
                 mesh=None):
        """use_flash / use_fused_decode None: K1 / K2 on CUDA params (the
        port's rule); the engine runs on the params' device and never
        moves them. With `mesh` the whole float `params` are cut to this
        rank's slice (`parallel.shard_params`); a tree sharded already
        (its layout's mesh `mesh`, or mesh None) is taken as it is, fused
        or not. Raises ValueError when the data axis does not divide
        `num_slots`."""
        if prefill_chunk == "auto":
            prefill_chunk = resolve_prefill_chunk(params, mcfg, context_len)
        layout = getattr(params, "layout", None)
        if layout is not None and mesh is not None and layout.mesh != mesh:
            raise ValueError("params sharded over another mesh than mesh=")
        if mesh is None and layout is not None:
            mesh = layout.mesh
        if mesh is not None and num_slots % mesh.shape[DATA_AXIS]:
            raise ValueError(f"num_slots={num_slots} must be a multiple of "
                             f"the data-axis size ({mesh.shape[DATA_AXIS]})")
        if mesh is not None and layout is None:
            from ..parallel.sharding import shard_params

            params = shard_params(params, mesh, mcfg)
            layout = params.layout
        self.layout = layout
        self._slot_lo, self._local_slots = 0, num_slots
        self._admit_params = params
        if layout is not None:
            self._local_slots = num_slots // layout.data_size
            self._slot_lo = mesh.coords[DATA_AXIS] * self._local_slots
            self._admit_params = layout.rows_whole().wrap(params)
            if any(n > 1 for n in layout.mesh.shape.values()):
                async_admission = False  # lockstep: see the module docstring
        self.mcfg = mcfg
        self.ccfg = ccfg
        self.num_slots = num_slots
        self.context_len = context_len
        self.max_new_tokens = max_new_tokens
        self.decode_chunk = decode_chunk
        self.eos_token_id = eos_token_id
        self.params = params
        embed = params["embed"]
        self.device = getattr(embed, "q", embed).device  # int8 embed: .q
        self.use_flash = use_flash
        self.use_fused_decode = use_fused_decode
        self.async_admission = async_admission
        self._pending: deque[Request] = deque()
        # Each entry: (pairs [(req, slot, key, row), ...], logits, state,
        # stats, ready event or None).
        self._inflight: List = []
        self._slots: List[Optional[Request]] = [None] * num_slots
        self._slot_budget = [0] * num_slots
        self._next_rid = 0
        self.completed: Dict[int, Request] = {}
        # O(1) lifetime aggregates: `summary()` reads these, so popping
        # resolved requests out of `completed` (see `release`) never loses
        # stats and a long-running server's memory stays bounded.
        self._agg = {"completed": 0, "ttft_sum": 0.0, "wall_sum": 0.0,
                     "tokens_sum": 0, "savings_sum": 0.0}

        # Longest-prefix continuation (prefix_continue_budget > 0): every
        # prefill allocates `budget` extra recent-ring slots so a cached
        # prefix state can absorb up to `budget` suffix tokens via
        # extend_prefill while every slot keeps identical tensor shapes
        # (required by the row insert).
        self.prefix_continue_budget = prefix_continue_budget
        self._ring_cap = max_new_tokens + prefix_continue_budget
        # Chunked prefill (prefill_chunk=c): admissions advance c prompt
        # tokens per engine step, so active slots' decode latency is bounded
        # by one chunk's time instead of a full-prompt prefill. "auto"
        # chunks only when the estimated one-shot prefill exceeds the
        # head-of-line budget (resolve_prefill_chunk).
        if prefill_chunk and context_len % prefill_chunk:
            raise ValueError(
                f"context_len={context_len} must be a multiple of "
                f"prefill_chunk={prefill_chunk}")
        self.prefill_chunk = prefill_chunk
        self._chunked: List[Dict[str, Any]] = []
        if sampling is None:
            sampling = SamplingParams(temperature=temperature)
        self.sampling = sampling
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        # Repetition/presence/frequency penalties need per-slot token
        # occurrence counts persisted ACROSS decode chunks (a fresh count
        # every chunk would forget earlier repeats); the loop returns the
        # updated counts alongside the state.
        self._track_counts = sampling.uses_penalties
        # logprobs=True: every decode chunk also returns the model's
        # log-probability of each emitted token (raw distribution, OpenAI
        # convention). Delivered on Request.logprobs.
        self.logprobs = logprobs

        # Prefix cache (prefix_cache_size > 0): completed prefills keyed by
        # the exact (truncated) prompt are kept as single-row decode states
        # (logits + compressed pools + ring) and re-admitted with zero
        # prefill work; a cached prefix holds packed sub-byte tier pools,
        # not a dense bf16 KV prefix. LRU-evicted beyond the size cap.
        self.prefix_cache_size = prefix_cache_size
        self._prefix_cache: Optional[OrderedDict] = (
            OrderedDict() if prefix_cache_size > 0 else None)
        self.prefix_hits = 0
        self.prefix_misses = 0
        # Registered prefixes (register_prefix): shared system prompts a
        # new prompt may EXTEND. A partial hit reuses the prefix's
        # compressed pools verbatim and runs extend_prefill over just the
        # suffix: prefill work proportional to the non-shared tail.
        self._registered: Dict[Tuple[int, ...], Any] = {}
        self.prefix_partial_hits = 0

        # Batched state, created lazily at first admission.
        self._state: Optional[llama.DecodeState] = None
        self._last_tokens: Optional[torch.Tensor] = None  # [num_slots]
        self._counts: Optional[torch.Tensor] = None  # [num_slots, vocab]
        self._active_mask = [False] * num_slots
        # Model calls so far, by kind: one-shot prefills (K1 mode (a) once
        # per layer on CUDA), chunk steps (mode (b) once per layer) and
        # decode chunks (K2 once per layer and step). Launch checks read
        # the engine's schedule here.
        self.model_calls = {"prefill": 0, "chunk_step": 0, "decode": 0}

    # -- model calls ----------------------------------------------------------

    def _prefill(self, ids: torch.Tensor, lengths: torch.Tensor):
        self.model_calls["prefill"] += 1
        return llama.prefill_compressed(
            self._admit_params, ids, self.mcfg, self.ccfg,
            max_decode_len=self._ring_cap, use_flash=self.use_flash,
            lengths=lengths)

    def _chunk_init(self, batch: int):
        return llama.prefill_chunked_init(
            batch, self.context_len, self.mcfg, self.ccfg,
            device=self.device, params=self._admit_params)

    def _chunk_step(self, chunk_ids, st, lengths):
        self.model_calls["chunk_step"] += 1
        return llama.prefill_chunked_step(
            self._admit_params, chunk_ids, st, self.mcfg, self.ccfg,
            lengths=lengths, use_flash=self.use_flash)

    def _chunk_finish(self, st, lengths):
        return llama.prefill_chunked_finish(
            self._admit_params, st, self.mcfg, self.ccfg,
            max_decode_len=self._ring_cap, lengths=lengths)

    def _decode(self):
        """One decode chunk over every slot: (tokens [num_slots, chunk],
        state[, counts][, logprobs])."""
        self.model_calls["decode"] += 1
        return llama.decode_loop(
            self.params, self._last_tokens, self._state, self.decode_chunk,
            self.mcfg, self.ccfg, use_fused=self.use_fused_decode,
            generator=self._gen, sampling=self.sampling,
            counts=self._counts, return_counts=self._track_counts,
            return_logprobs=self.logprobs)

    # -- public API ---------------------------------------------------------

    def submit(self, input_ids: List[int],
               max_new_tokens: Optional[int] = None,
               stop_sequences: Optional[List[List[int]]] = None,
               eos_token_id: Optional[int] = None,
               on_token=None) -> int:
        """Queue a request.

        stop_sequences: token-id sequences; generation stops when one
          appears (it stays in the output; matches may span decode chunks).
        eos_token_id: per-request EOS overriding the engine default.
        on_token: streaming callback `f(request, new_tokens: List[int])`,
          invoked from the host loop after each decode chunk with the tokens
          that survived EOS/stop/budget truncation.
        """
        rid = self._next_rid
        self._next_rid += 1
        self._pending.append(Request(
            rid=rid, input_ids=list(input_ids),
            max_new_tokens=min(max_new_tokens or self.max_new_tokens,
                               self.max_new_tokens),
            stop_sequences=[list(s) for s in (stop_sequences or [])],
            eos_token_id=eos_token_id, on_token=on_token))
        return rid

    def warmup(self) -> Dict[str, Any]:
        """Drive one admission at every reachable padded batch size before
        traffic: on the card this builds the kernels and warms cuBLAS and
        the allocator at every prefill shape the serving load can hit.

        Admission pads its prefill batch to a power of two, so N slots can
        hit batch sizes {1, 2, 4, ..}. The warmup prompts are DISTINCT:
        identical prompts in one admission share a single prefill row
        (in-batch dedupe) and later ones hit the prefix cache, so
        same-prompt warmups would never run the multi-row prefills.
        Nothing leaks into serving state: no request, aggregate or
        prefix-cache entry.

        Returns {"batch_sizes": [...], "wall_s": ...}.
        """
        t0 = time.time()
        agg_before = dict(self._agg)
        cache_before = (set(self._prefix_cache)
                        if self._prefix_cache is not None else set())
        sizes = sorted({1 << (k - 1).bit_length()
                        for k in range(1, self.num_slots + 1)})
        n, rids = 0, []
        for b in sizes:
            for _ in range(min(b, self.num_slots)):
                n += 1
                ids = [1] * 7 + [2 + (n % max(self.mcfg.vocab_size - 3, 1))]
                rids.append(self.submit(ids,
                                        max_new_tokens=self.decode_chunk + 1))
            self.run()
        for rid in rids:
            self.release(rid)
        self._agg = agg_before
        if self._prefix_cache is not None:
            for key in [k for k in self._prefix_cache
                        if k not in cache_before]:
                del self._prefix_cache[key]
            self.prefix_misses = 0
            self.prefix_hits = 0
        return {"batch_sizes": sizes, "wall_s": time.time() - t0}

    def register_prefix(self, input_ids: List[int]) -> None:
        """Prefill and pin a shared prefix (e.g. a system prompt).

        Later prompts that EXTEND it admit via a partial prefix-cache hit:
        the prefix's compressed pools are reused verbatim and only the
        suffix runs through `extend_prefill`, prefill work proportional to
        the non-shared tail (one system prompt, many questions). Requires
        `prefix_continue_budget` >= the longest expected suffix.
        """
        if not self.prefix_continue_budget:
            raise ValueError(
                "register_prefix requires prefix_continue_budget > 0 "
                "(ring headroom for the continuation suffix)")
        ids, length = self._bucket_ids(input_ids)
        key = tuple(ids[:length])
        if key in self._registered:
            return
        logits, state, stats = self._prefill(
            torch.as_tensor([ids], device=self.device),
            torch.as_tensor([length], dtype=torch.int32, device=self.device))
        row_stats = summarize_layer_stats_per_row(stats, 1)[0]
        self._registered[key] = (logits, state, row_stats)

    def _find_partial(self, key: Tuple[int, ...]):
        """Longest registered prefix that `key` strictly extends, within
        the continuation budget."""
        best = None
        for rkey in self._registered:
            if (len(rkey) < len(key) and key[:len(rkey)] == rkey
                    and len(key) - len(rkey) <= self.prefix_continue_budget
                    and (best is None or len(rkey) > len(best))):
                best = rkey
        return best

    def _continue_entry(self, rkey: Tuple[int, ...], key: Tuple[int, ...]):
        """An admission entry extending a registered prefix with the
        request's suffix (`extend_prefill` leaves the prefix's state as it
        was)."""
        _, state0, stats0 = self._registered[rkey]
        suffix = list(key[len(rkey):])
        logits, state = speculative.extend_prefill(
            self._admit_params, state0,
            torch.as_tensor([suffix], device=self.device),
            torch.as_tensor([len(suffix)], dtype=torch.int32,
                            device=self.device), self.mcfg, self.ccfg)
        stats = dict(stats0)
        stats["prefix_partial"] = True
        stats["suffix_tokens"] = len(suffix)
        return (logits, state, stats)

    def has_work(self) -> bool:
        return (bool(self._pending) or bool(self._inflight)
                or bool(self._chunked) or any(self._active_mask))

    def run(self, max_steps: int = 10_000) -> Dict[int, Request]:
        """Drive until all submitted requests complete."""
        steps = 0
        while self.has_work() and steps < max_steps:
            self.step()
            steps += 1
        return self.completed

    # -- internals ----------------------------------------------------------

    def _bucket_ids(self, ids: List[int]) -> Tuple[List[int], int]:
        """Right-pad to the serving bucket; true length rides along (ragged
        prefill never stores or attends padding)."""
        ids = truncate_middle(ids, self.context_len)
        length = len(ids)
        return ids + [0] * (self.context_len - length), length

    def _ready_event(self) -> Optional[torch.cuda.Event]:
        """An event after the work queued so far on the device's current
        stream (None on the CPU, where work is done when the call
        returns, and under synchronous admission, which polls nothing)."""
        if self.device.type != "cuda" or not self.async_admission:
            return None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return event

    def _start_admissions(self, pairs: List[Tuple[Request, int]]):
        """One batched prefill for every admitted request (padded to a
        power-of-two batch), completed later by `_poll_inflight` when its
        event is ready. Prefix-cache hits skip the prefill entirely: the
        cached single-row decode state is copied into the slot
        immediately."""
        hits = []
        rows, lengths = [], []   # unique prompts only
        row_of_key: Dict[Tuple[int, ...], int] = {}
        keyed = []               # (req, slot, key, prefill_row)
        for req, slot in pairs:
            ids, length = self._bucket_ids(req.input_ids)
            key = tuple(ids[:length])
            entry = (self._prefix_cache.get(key)
                     if self._prefix_cache is not None else None)
            if entry is None:
                entry = self._registered.get(key)  # exact registered hit
            if entry is not None:
                if self._prefix_cache is not None and key in self._prefix_cache:
                    self._prefix_cache.move_to_end(key)
                self.prefix_hits += 1
                hits.append((req, slot, entry))
                continue
            if self._registered:
                rkey = self._find_partial(key)
                if rkey is not None:
                    # Partial hit: reuse the registered prefix's compressed
                    # pools; prefill only the suffix (extend_prefill).
                    self.prefix_partial_hits += 1
                    hits.append((req, slot,
                                 self._continue_entry(rkey, key)))
                    continue
            # Identical prompts in the same admission batch share one
            # prefill row (their decode states diverge only after the slot
            # insert, so sharing is exact).
            row = row_of_key.get(key)
            if row is None:
                row = row_of_key[key] = len(rows)
                rows.append(ids)
                lengths.append(length)
                if self._prefix_cache is not None:
                    self.prefix_misses += 1
            elif self._prefix_cache is not None:
                self.prefix_hits += 1  # served without its own prefill row
            keyed.append((req, slot, key, row))
        for req, slot, entry in hits:
            self._slots[slot] = req
            self._complete_cached(req, slot, entry)
        if not keyed:
            return
        bsz = 1 << (len(rows) - 1).bit_length()
        while len(rows) < bsz:  # pad rows: prefilled but never inserted
            rows.append(rows[0])
            lengths.append(lengths[0])
        ids_arr = torch.as_tensor(rows, device=self.device)
        len_arr = torch.as_tensor(lengths, dtype=torch.int32,
                                  device=self.device)
        for req, slot, _key, _row in keyed:
            self._slots[slot] = req  # reserve; not active until ready
        if self.prefill_chunk:
            # Only the chunks covering the longest real prompt run; the
            # finish pass masks everything past each row's true length.
            n_chunks = -(-max(lengths) // self.prefill_chunk)
            rec = {"keyed": keyed, "ids": ids_arr, "lens": len_arr,
                   "st": self._chunk_init(len(rows)),
                   "end": n_chunks * self.prefill_chunk}
            if not self._advance_chunked(rec):  # dispatch the first chunk
                self._chunked.append(rec)
            return
        logits, state, stats = self._prefill(ids_arr, len_arr)
        self._inflight.append((keyed, logits, state, stats,
                               self._ready_event()))

    def _advance_chunked(self, rec) -> bool:
        """Dispatch one prefill chunk; on the last chunk, compress into the
        decode state and hand off to the normal admission-completion path.
        Returns True when the record is finished."""
        off = rec["st"].offset
        rec["st"] = self._chunk_step(
            rec["ids"][:, off:off + self.prefill_chunk], rec["st"],
            rec["lens"])
        if rec["st"].offset >= rec["end"]:
            logits, state, stats = self._chunk_finish(rec["st"], rec["lens"])
            self._inflight.append((rec["keyed"], logits, state, stats,
                                   self._ready_event()))
            return True
        return False

    def _first_token(self, logits: torch.Tensor
                     ) -> Tuple[List[int], Optional[List[float]]]:
        """The first token of each row of `logits` [N, V] (greedy or
        sampled from the engine's generator) and, with logprobs, its
        log-probability, on the host."""
        first = sample_logits(logits, self._gen, self.sampling)
        lp = None
        if self.logprobs:
            lp = torch.gather(torch.log_softmax(logits.float(), dim=-1), 1,
                              first[:, None])[:, 0].tolist()
        return first.tolist(), lp

    def _complete_admission(self, pairs, logits, state, stats):
        # Work in PAIR space: requests sharing a prefill row (in-batch
        # duplicates) still sample independent first tokens.
        rows_idx = torch.as_tensor([row for *_, row in pairs],
                                   device=logits.device)
        toks, lps = self._first_token(logits[rows_idx])
        n_rows = 1 + max(row for *_, row in pairs)
        row_stats = summarize_layer_stats_per_row(stats, n_rows)
        self._ensure_state(state)
        for i, (req, slot, key, row) in enumerate(pairs):
            req.ttft = time.time() - req.submitted_at
            req.prefill_stats = row_stats[row]
            self._insert(state, row, slot)
            if (self._prefix_cache is not None
                    and key not in self._prefix_cache):
                self._prefix_cache[key] = (
                    logits[row:row + 1].clone(),            # [1, V]
                    _extract_row(state, row),               # single-row state
                    dict(row_stats[row]))
                while len(self._prefix_cache) > self.prefix_cache_size:
                    self._prefix_cache.popitem(last=False)  # LRU
            self._activate(req, slot, toks[i], None if lps is None else lps[i])

    def _insert(self, multi: llama.DecodeState, row: int, slot: int):
        """Copy row `row` of `multi` into slot `slot` of the slot state,
        where this rank holds that slot (a sharded engine's data block),
        and check the slot state's layout."""
        local = slot - self._slot_lo
        if not 0 <= local < self._local_slots:
            return
        self._state = _tree_insert_row(self._state, multi, row, local)
        self._check_layout()

    def _check_layout(self):
        if self.layout is not None:
            from ..parallel.sharding import constrain_decode_state

            constrain_decode_state(self._state, self.layout, self.num_slots)

    def _ensure_state(self, template_state: llama.DecodeState):
        """Materialize the batched slot state (lazily, at first admission):
        every slot a copy of row 0 of `template_state`, in new tensors
        (this rank's slots over a mesh). The last tokens and counts are
        every slot's."""
        if self._state is not None:
            return
        n, local = self.num_slots, self._local_slots
        self._state = llama.map_decode_state(
            template_state,
            lambda t: t[:1].repeat(local, *(1,) * (t.dim() - 1)),
            (template_state.ring_fill[0],) * local)
        self._check_layout()
        self._last_tokens = torch.zeros((n,), dtype=torch.int64,
                                        device=self.device)
        if self._track_counts:
            self._counts = torch.zeros((n, self.mcfg.vocab_size),
                                       dtype=torch.int32, device=self.device)

    def _complete_cached(self, req: Request, slot: int, entry):
        """Admit a prefix-cache hit: no prefill. Take the first token from
        the cached logits and copy the cached single-row state into the
        slot."""
        logits_row, state_row, stats_row = entry
        self._ensure_state(state_row)
        toks, lps = self._first_token(logits_row)
        req.ttft = time.time() - req.submitted_at
        req.prefill_stats = dict(stats_row)
        self._insert(state_row, 0, slot)
        self._activate(req, slot, toks[0], None if lps is None else lps[0])

    def _activate(self, req: Request, slot: int, tok0: int,
                  lp0: Optional[float]):
        """Shared admission tail: arm the slot for decode and deliver the
        first token (EOS/stop/budget rules apply to it too)."""
        self._last_tokens[slot].fill_(tok0)
        if self._track_counts:  # fresh counts for the slot's new request
            self._counts[slot].zero_()
            self._counts[slot, tok0].fill_(1)
        self._slot_budget[slot] = req.max_new_tokens - 1
        self._active_mask[slot] = True
        _, reason = self._deliver(slot, [tok0],
                                  None if lp0 is None else [lp0])
        if reason is not None:
            self._finish(slot, reason)
        elif self._slot_budget[slot] <= 0:
            self._finish(slot, "length")

    def _deliver(self, slot: int, new: List[int],
                 lps: Optional[List[float]]
                 ) -> Tuple[int, Optional[str]]:
        """Append freshly decoded tokens to the slot's request, applying
        EOS then stop-sequence truncation; streams kept tokens via the
        request's on_token callback. Returns (n_kept, finish_reason)."""
        req = self._slots[slot]
        eos = (req.eos_token_id if req.eos_token_id is not None
               else self.eos_token_id)
        reason = None
        if eos is not None and eos in new:
            new = new[:new.index(eos) + 1]
            reason = "eos"
        start = len(req.tokens)
        req.tokens.extend(new)
        if lps is not None:
            req.logprobs.extend(lps[:len(new)])
        # Stop sequences may span decode-chunk boundaries: search for
        # matches ENDING in the newly appended region; earliest end wins
        # (and can pre-empt an EOS later in the same chunk).
        if req.stop_sequences:
            cut = None
            for s in req.stop_sequences:
                lo = max(len(s), start + 1)
                for end in range(lo, len(req.tokens) + 1):
                    if req.tokens[end - len(s):end] == s:
                        cut = end if cut is None else min(cut, end)
                        break
            if cut is not None:
                del req.tokens[cut:]
                del req.logprobs[cut:]
                new = req.tokens[start:]
                reason = "stop"
        if req.on_token is not None and new:
            req.on_token(req, list(new))
        return len(new), reason

    def _finish(self, slot: int, reason: str = "length"):
        req = self._slots[slot]
        if req is not None:
            req.stop_reason = req.stop_reason or reason
            req.finished = True
            req.finished_at = time.time()
            self.completed[req.rid] = req
            self._agg["completed"] += 1
            self._agg["ttft_sum"] += req.ttft or 0.0
            self._agg["wall_sum"] += req.finished_at - req.submitted_at
            self._agg["tokens_sum"] += len(req.tokens)
            self._agg["savings_sum"] += (req.prefill_stats or {}).get(
                "avg_memory_savings", 0.0)
        self._slots[slot] = None
        self._active_mask[slot] = False

    def _poll_inflight(self, force: bool = False):
        still = []
        for pairs, logits, state, stats, ready in self._inflight:
            if force or ready is None or ready.query():
                self._complete_admission(pairs, logits, state, stats)
            else:
                still.append((pairs, logits, state, stats, ready))
        self._inflight = still

    def step(self):
        # 1) Admit pending requests into free slots: one batched prefill.
        pairs = []
        for slot in range(self.num_slots):
            if self._slots[slot] is None and self._pending:
                pairs.append((self._pending.popleft(), slot))
        if pairs:
            self._start_admissions(pairs)
        # 1b) Advance in-progress chunked prefills: ONE chunk per engine
        # step while decode is active (that's the interleaving), to
        # completion when there is nothing to decode or admission is sync.
        if self._chunked:
            drain = not self.async_admission or not any(self._active_mask)
            still = []
            for rec in self._chunked:
                done = self._advance_chunked(rec)
                while drain and not done:
                    done = self._advance_chunked(rec)
                if not done:
                    still.append(rec)
            self._chunked = still
        if pairs and not self.async_admission:
            self._poll_inflight(force=True)
        if self.async_admission:
            # Nothing to decode yet → block on the oldest admission.
            self._poll_inflight(force=not any(self._active_mask))
        if not any(self._active_mask):
            return

        # 2) One decode chunk for the whole batch (idle slots included).
        res = self._decode()
        toks, self._state = res[0], res[1]
        if self._track_counts:
            self._counts = res[2]
        lps_host = res[-1].tolist() if self.logprobs else None
        toks_host = toks.tolist()  # [num_slots, decode_chunk]
        self._last_tokens = toks[:, -1].clone()

        # 3) Distribute tokens, finish slots.
        for slot in range(self.num_slots):
            if not self._active_mask[slot]:
                continue
            take = min(self.decode_chunk, self._slot_budget[slot])
            new = toks_host[slot][:take]
            lps = None if lps_host is None else lps_host[slot][:take]
            _, reason = self._deliver(slot, new, lps)
            self._slot_budget[slot] -= take
            if reason is not None:
                self._finish(slot, reason)
            elif self._slot_budget[slot] <= 0:
                self._finish(slot, "length")

    # -- stats --------------------------------------------------------------

    def release(self, rid: int):
        """Pop a resolved request out of `completed`. Callers that hold the
        result elsewhere (the HTTP server's jobs) must release, or a
        long-running server accumulates every request ever served; lifetime
        stats live in O(1) aggregates so `summary()` is unaffected."""
        return self.completed.pop(rid, None)

    def snapshot(self) -> Dict[str, Any]:
        """Cheap occupancy snapshot (for cross-thread /health-style reads:
        callers outside the engine's driver thread should consume a copy
        published by the driver rather than reading private fields)."""
        return {"pending": len(self._pending),
                "active_slots": int(sum(self._active_mask)),
                "num_slots": self.num_slots}

    def summary(self) -> Dict[str, Any]:
        n = self._agg["completed"]
        if not n:
            return {"completed": 0}
        out = {
            "completed": n,
            "avg_ttft_s": self._agg["ttft_sum"] / n,
            "avg_wall_s": self._agg["wall_sum"] / n,
            "total_tokens": self._agg["tokens_sum"],
            "avg_memory_savings": self._agg["savings_sum"] / n,
        }
        if self._prefix_cache is not None or self._registered:
            out["prefix_cache"] = {
                "hits": self.prefix_hits,
                "misses": self.prefix_misses,
                "partial_hits": self.prefix_partial_hits,
                "entries": (len(self._prefix_cache)
                            if self._prefix_cache is not None else 0),
                "registered": len(self._registered)}
        return out
