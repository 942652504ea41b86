"""LongBench evaluation harness.

Port of the JAX package's `eval/longbench.py`: task registry + prompt
templates + truncation policy (utils/data.py), generation with compression
stats and perf stats (TTFT, tokens/s), per-task metric routing (QA→F1/EM,
summarization→ROUGE, few-shot→accuracy/F1), per-task and overall
aggregation, JSON artifacts with the reference's key names
(`{task}_detailed_results.json`, `comprehensive_evaluation_results.json`).

As in the JAX package, prompts are middle-truncated to `max_length` and
right-padded to a power-of-two bucket, and evaluated ragged (`lengths`):
padding is never attended or stored. Nothing is compiled here, but the
first generation of each bucket is still a warm-up outside TTFT and the
decode timer: it keeps the kernels' first-use builds and the caching
allocator's growth out of the measurement. TTFT and decode walls end in a
host read of the result (utils/timing.py). With `use_flash=None` the
compressed arm runs K1 in prefill and K2 in decode on CUDA params, the
baseline arm K1 in prefill (its decode is plain attention over the padded
dense cache); `use_flash=False` runs the plain versions. `model_calls`
counts the runner's own schedule (prefill calls, warm-ups included, and
decode steps). Local JSONL or synthetic planted-answer data serve when the
HF hub is unreachable.
"""

from __future__ import annotations

import functools
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..compression.compressor import summarize_layer_stats
from ..config import CompressionConfig, ModelConfig
from ..models import llama
from ..utils.data import (CORE_TASKS, LONGBENCH_TASKS, TaskSpec,
                          extract_answers, format_prompt, load_task_data,
                          save_json, truncate_middle)
from ..utils.timing import readback
from ..utils.tokenizer import ByteTokenizer, decode_ids, encode_ids
from . import metrics as M


def pick_bucket(n: int, max_length: int, min_bucket: int = 256) -> int:
    """Smallest power-of-two bucket >= n, clamped to [min_bucket,
    max_length]. Sequences longer than max_length are middle-truncated;
    shorter ones are right-padded and evaluated ragged (exact — padding is
    never attended or stored)."""
    b = min_bucket
    while b < min(n, max_length):
        b *= 2
    return min(b, max_length)


def recorded_errors(results: Dict[str, Any]) -> List[Tuple[str, str]]:
    """(task, error) of every failure that `evaluate_all_tasks` recorded
    and went on past: a task that raised, or one of its samples. A caller
    that must not take a failed kernel for a low score raises on any."""
    out = []
    for task, t in results["per_task"].items():
        if "error" in t:
            out.append((task, t["error"]))
        out.extend((task, d["error"]) for d in t.get("details", [])
                   if "error" in d)
    return out


class ModelRunner:
    """Uniform generation interface for the compressed and baseline arms."""

    def __init__(self, params, mcfg: ModelConfig,
                 ccfg: Optional[CompressionConfig] = None,
                 use_flash: Optional[bool] = None, max_new_tokens: int = 64):
        self.params = params
        self.mcfg = mcfg
        self.ccfg = ccfg
        self.use_flash = use_flash
        self.max_new_tokens = max_new_tokens
        self._warmed: set = set()
        self.model_calls = {"prefill": 0, "decode_steps": 0}

    @property
    def compressed(self) -> bool:
        return self.ccfg is not None

    @property
    def device(self) -> torch.device:
        return self.params["final_norm"].device

    def _prefill(self, ids: torch.Tensor, lengths: torch.Tensor):
        self.model_calls["prefill"] += 1
        if self.compressed:
            return llama.prefill_compressed(
                self.params, ids, self.mcfg, self.ccfg,
                max_decode_len=self.max_new_tokens,
                use_flash=self.use_flash, lengths=lengths)
        return llama.prefill_uncompressed(self.params, ids, self.mcfg,
                                          lengths=lengths,
                                          use_flash=self.use_flash)

    def _decode(self, tok: torch.Tensor, out, lengths: torch.Tensor,
                bucket: int) -> torch.Tensor:
        """The greedy tokens after the first: [B, max_new_tokens - 1]."""
        n = self.max_new_tokens - 1
        self.model_calls["decode_steps"] += n
        if self.compressed:
            rest, _ = llama.decode_loop(self.params, tok, out[1], n,
                                        self.mcfg, self.ccfg,
                                        use_fused=self.use_flash)
            return rest
        # The dense [L, B, S, H, D] cache padded along S to bucket + the
        # new tokens; decode writes each step's K/V at its row's position.
        pad = bucket + self.max_new_tokens - out[1][0].shape[2]
        kv = tuple(torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad))
                   for a in out[1])
        rest, _, _ = llama.decode_loop_uncompressed(self.params, tok, kv,
                                                    lengths, n, self.mcfg)
        return rest

    def generate(self, ids: torch.Tensor, eos_token_id: Optional[int] = None,
                 lengths: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        """Greedy generation; returns tokens + perf + compression stats.

        `ids` is a [B, bucket] right-padded batch; `lengths` the true
        per-row lengths (defaults to full bucket).
        """
        bucket = ids.shape[1]
        if lengths is None:
            lengths = torch.full((ids.shape[0],), bucket, dtype=torch.int32,
                                 device=ids.device)
        sync = lambda x: readback(x[:, :8])  # noqa: E731

        # Warm-up once per bucket (excluded from TTFT *and* from the
        # decode timer).
        if bucket not in self._warmed:
            out = self._prefill(ids, lengths)
            sync(out[0])
            if self.max_new_tokens > 1:
                sync(self._decode(torch.argmax(out[0], dim=-1), out, lengths,
                                  bucket))
            del out
            self._warmed.add(bucket)

        t0 = time.perf_counter()
        out = self._prefill(ids, lengths)
        sync(out[0])
        ttft = time.perf_counter() - t0

        tok = torch.argmax(out[0], dim=-1)
        t0 = time.perf_counter()
        if self.max_new_tokens > 1:
            rest = self._decode(tok, out, lengths, bucket)
            out_tokens = torch.cat([tok[:, None], rest], dim=1)
        else:
            out_tokens = tok[:, None]
        out_tokens = out_tokens.cpu()
        decode_time = time.perf_counter() - t0
        if eos_token_id is not None:
            is_eos = (out_tokens == eos_token_id).to(torch.int32)
            hit = torch.cumsum(is_eos, dim=1)
            out_tokens = torch.where(hit - is_eos > 0,
                                     torch.full_like(out_tokens,
                                                     eos_token_id),
                                     out_tokens)
        n_new = out_tokens.shape[1]

        result = {
            "tokens": out_tokens,
            "ttft": ttft,
            "decode_time": decode_time,
            "new_tokens": n_new,
            "tokens_per_second": (n_new - 1) / decode_time
                                 if decode_time > 0 and n_new > 1 else 0.0,
            "context_length": bucket,
        }
        if self.compressed:
            result["compression"] = summarize_layer_stats(out[2])
        return result


class LongBenchEvaluator:
    """Evaluate a ModelRunner over LongBench tasks; write JSON artifacts."""

    def __init__(self, runner: ModelRunner, tokenizer=None,
                 output_dir: Optional[str] = None,
                 max_length: int = 4096, data_dir: Optional[str] = None,
                 synthetic_kwargs: Optional[Dict] = None,
                 reference_parity: bool = False):
        self.runner = runner
        self.tokenizer = tokenizer or ByteTokenizer()
        self.output_dir = output_dir
        self.max_length = max_length
        self.data_dir = data_dir
        self.synthetic_kwargs = synthetic_kwargs or {}
        # reference_parity=True scores F1/EM with the reference's exact
        # formulas (set-overlap F1, article-keeping normalize, empty->0.0 —
        # eval/metrics.py docstring) for BASELINE.md-comparable numbers.
        self.reference_parity = reference_parity

    # -- generation ---------------------------------------------------------

    def _ids(self, rows) -> torch.Tensor:
        """Token ids or lengths as an int32 tensor on the runner's device."""
        return torch.tensor(rows, dtype=torch.int32,
                            device=self.runner.device)

    def generate_response(self, prompt: str) -> Dict[str, Any]:
        ids = encode_ids(self.tokenizer, prompt)
        ids = truncate_middle(ids, self.max_length)
        bucket = pick_bucket(len(ids), self.max_length)
        length = len(ids)
        arr = self._ids([ids + [0] * (bucket - length)])
        eos = getattr(self.tokenizer, "eos_token_id", None)
        out = self.runner.generate(arr, eos_token_id=eos,
                                   lengths=self._ids([length]))
        out["context_length"] = length
        text = decode_ids(self.tokenizer, [int(t) for t in out["tokens"][0]])
        out["response"] = text.strip()
        return out

    # -- metrics routing (longbench_eval.py:236-262) ------------------------

    def _sample_metrics(self, task: TaskSpec, response: str,
                        answers: List[str]) -> Dict[str, float]:
        out: Dict[str, float] = {}
        parity = self.reference_parity
        f1_fn = functools.partial(M.f1_score, reference_parity=parity)
        em_fn = functools.partial(M.exact_match, reference_parity=parity)
        for m in task.metrics:
            if m == "f1":
                out["f1"] = M.best_over_ground_truths(f1_fn, response,
                                                      answers)
            elif m == "em":
                out["em"] = M.best_over_ground_truths(em_fn, response,
                                                      answers)
            elif m == "accuracy":
                out["accuracy"] = M.best_over_ground_truths(
                    M.accuracy_score, response, answers)
            elif m.startswith("rouge"):
                if "rouge1" not in out:
                    best = {"rouge1": 0.0, "rouge2": 0.0, "rougeL": 0.0}
                    for a in answers:
                        r = M.rouge_scores(response, a)
                        for k in best:
                            best[k] = max(best[k], r[k])
                    out.update(best)
        # Headline quality score: F1 where defined, else ROUGE-L, else acc.
        out["quality"] = out.get("f1", out.get("rougeL",
                                               out.get("accuracy", 0.0)))
        return out

    # -- task loop (longbench_eval.py:165-234) ------------------------------

    def _record(self, i, sample, task, gen) -> Dict[str, Any]:
        answers = extract_answers(sample, task)
        sm = self._sample_metrics(task, gen["response"], answers)
        rec = {
            "sample_idx": i,
            "response": gen["response"][:2000],
            "answers": answers[:4],
            "metrics": sm,
            "ttft": gen["ttft"],
            "tokens_per_second": gen["tokens_per_second"],
            "context_length": gen["context_length"],
        }
        if "compression" in gen:
            c = gen["compression"]
            rec["compression_ratio"] = c.get("avg_compression_ratio")
            rec["memory_savings"] = c.get("avg_memory_savings")
            rec["cumulative_compression"] = c.get("cumulative_compression")
            rec["precision_distribution"] = c.get("precision_distribution")
        return rec

    def _evaluate_batched(self, task, samples, batch_size) -> List[Dict]:
        """Group samples by padding bucket and run ragged batches — each
        batch is one prefill + one decode loop (the reference ran one
        sample at a time)."""
        eos = getattr(self.tokenizer, "eos_token_id", None)
        prepared = []  # (idx, bucket, length, ids)
        details: List[Dict] = []
        for i, sample in enumerate(samples):
            try:
                ids = encode_ids(self.tokenizer, format_prompt(task, sample))
                ids = truncate_middle(ids, self.max_length)
                bucket = pick_bucket(len(ids), self.max_length)
                prepared.append((i, bucket, len(ids), ids))
            except Exception as e:
                details.append({"sample_idx": i, "error": repr(e)})
        by_bucket: Dict[int, List] = {}
        for item in prepared:
            by_bucket.setdefault(item[1], []).append(item)
        for bucket, items in sorted(by_bucket.items()):
            for c0 in range(0, len(items), batch_size):
                chunk = items[c0:c0 + batch_size]
                try:
                    arr = self._ids([ids + [0] * (bucket - ln)
                                     for _, _, ln, ids in chunk])
                    lengths = self._ids([ln for _, _, ln, _ in chunk])
                    gen = self.runner.generate(arr, eos_token_id=eos,
                                               lengths=lengths)
                    for row, (i, _, ln, _) in enumerate(chunk):
                        text = decode_ids(self.tokenizer,
                                          [int(t) for t in
                                           gen["tokens"][row]])
                        g = dict(gen, response=text.strip(),
                                 context_length=ln)
                        details.append(self._record(i, samples[i], task, g))
                except Exception as e:
                    details.extend({"sample_idx": i, "error": repr(e)}
                                   for i, _, _, _ in chunk)
        details.sort(key=lambda d: d["sample_idx"])
        return details

    def evaluate_task(self, task_name: str, max_samples: int = 8,
                      batch_size: int = 1) -> Dict[str, Any]:
        task = LONGBENCH_TASKS[task_name]
        samples = load_task_data(task_name, self.data_dir, max_samples,
                                 synthetic_kwargs=self.synthetic_kwargs)
        if batch_size > 1:
            details = self._evaluate_batched(task, samples, batch_size)
        else:
            details = []
            for i, sample in enumerate(samples):
                try:
                    prompt = format_prompt(task, sample)
                    gen = self.generate_response(prompt)
                    details.append(self._record(i, sample, task, gen))
                except Exception as e:  # per-sample skip
                    details.append({"sample_idx": i, "error": repr(e)})

        ok = [d for d in details if "error" not in d]
        agg = M.aggregate_metrics([d["metrics"] for d in ok])
        result = {
            "task": task_name,
            "task_type": task.task_type,
            "num_samples": len(samples),
            "num_evaluated": len(ok),
            "metrics": agg,
            "avg_ttft": (sum(d["ttft"] for d in ok) / len(ok)) if ok else 0,
            "avg_tokens_per_second": (sum(d["tokens_per_second"]
                                          for d in ok) / len(ok)) if ok else 0,
            "details": details,
        }
        if ok and "compression_ratio" in ok[0]:
            result["avg_compression_ratio"] = sum(
                d["compression_ratio"] for d in ok) / len(ok)
            result["avg_memory_savings"] = sum(
                d["memory_savings"] for d in ok) / len(ok)
        if self.output_dir:
            save_json(os.path.join(self.output_dir,
                                   f"{task_name}_detailed_results.json"),
                      result)
        return result

    def evaluate_all_tasks(self, tasks: Optional[Sequence[str]] = None,
                           max_samples: int = 8,
                           batch_size: int = 1) -> Dict[str, Any]:
        tasks = list(tasks or CORE_TASKS)
        per_task: Dict[str, Any] = {}
        for t in tasks:
            try:
                per_task[t] = self.evaluate_task(t, max_samples, batch_size)
            except Exception as e:  # per-task skip (longbench_eval.py:337)
                per_task[t] = {"task": t, "error": repr(e)}
        ok = {k: v for k, v in per_task.items() if "error" not in v}
        overall = {
            "tasks_evaluated": len(ok),
            "overall_quality_score": (sum(v["metrics"].get("quality", 0.0)
                                          for v in ok.values()) / len(ok))
                                     if ok else 0.0,
            "avg_tokens_per_second": (sum(v["avg_tokens_per_second"]
                                          for v in ok.values()) / len(ok))
                                     if ok else 0.0,
            "avg_ttft": (sum(v["avg_ttft"] for v in ok.values()) / len(ok))
                        if ok else 0.0,
        }
        if ok and any("avg_compression_ratio" in v for v in ok.values()):
            cr = [v["avg_compression_ratio"] for v in ok.values()
                  if "avg_compression_ratio" in v]
            ms = [v["avg_memory_savings"] for v in ok.values()
                  if "avg_memory_savings" in v]
            overall["overall_avg_compression_ratio"] = sum(cr) / len(cr)
            overall["overall_avg_memory_savings"] = sum(ms) / len(ms)
        results = {"per_task": per_task, "overall": overall}
        if self.output_dir:
            save_json(os.path.join(self.output_dir,
                                   "comprehensive_evaluation_results.json"),
                      results)
        return results
