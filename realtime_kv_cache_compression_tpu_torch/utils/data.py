"""LongBench task registry, prompt formatting, truncation, and data loading.

A copy of the JAX package's `utils/data.py` (framework-free; that
package's `utils/__init__.py` imports JAX, so the port keeps its own):
  * per-task config table (type / answer keys / max lengths 4K-32K)
    → `LONGBENCH_TASKS`
  * HF hub loading with local-JSONL fallback → `load_task_data`, plus an
    offline synthetic generator so the full pipeline runs without a
    network (`datasets` need not be installed: without it the synthetic
    branch runs)
  * prompt formatting + middle truncation keeping head+tail of the context
    while preserving the question
  * synthetic long-context generator with fixed prompt prefix + seed
  * JSON/JSONL persistence

`synthetic_task_data` seeds with `hash(task_name)`, which Python salts per
process: its rows are the same in one process, not across processes.
"""

from __future__ import annotations

import csv
import json
import os
import random
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

# ---------------------------------------------------------------------------
# Task registry (data_utils.py:12-104 + longbench_eval.py:20-31)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TaskSpec:
    name: str
    task_type: str          # single_doc_qa / multi_doc_qa / summarization /
                            # few_shot / synthetic / code
    metrics: tuple          # metric names routed for this task
    max_length: int         # context budget (tokens)
    answer_key: str = "answers"


def _t(name, task_type, metrics, max_length):
    return TaskSpec(name, task_type, tuple(metrics), max_length)


LONGBENCH_TASKS: Dict[str, TaskSpec] = {s.name: s for s in [
    # Single-document QA
    _t("narrativeqa", "single_doc_qa", ("f1", "em"), 16384),
    _t("qasper", "single_doc_qa", ("f1", "em"), 8192),
    _t("multifieldqa_en", "single_doc_qa", ("f1", "em"), 8192),
    _t("multifieldqa_zh", "single_doc_qa", ("f1", "em"), 8192),
    # Multi-document QA
    _t("hotpotqa", "multi_doc_qa", ("f1", "em"), 8192),
    _t("2wikimqa", "multi_doc_qa", ("f1", "em"), 8192),
    _t("musique", "multi_doc_qa", ("f1", "em"), 16384),
    _t("dureader", "multi_doc_qa", ("rougeL",), 8192),
    # Summarization
    _t("gov_report", "summarization", ("rouge1", "rouge2", "rougeL"), 16384),
    _t("qmsum", "summarization", ("rouge1", "rouge2", "rougeL"), 16384),
    _t("multi_news", "summarization", ("rouge1", "rouge2", "rougeL"), 8192),
    _t("vcsum", "summarization", ("rouge1", "rouge2", "rougeL"), 16384),
    # Few-shot
    _t("trec", "few_shot", ("accuracy", "f1"), 4096),
    _t("triviaqa", "few_shot", ("accuracy", "f1"), 8192),
    _t("samsum", "few_shot", ("rouge1", "rouge2", "rougeL"), 8192),
    _t("lsht", "few_shot", ("accuracy",), 8192),
    # Synthetic
    _t("passage_count", "synthetic", ("accuracy",), 8192),
    _t("passage_retrieval_en", "synthetic", ("accuracy",), 8192),
]}

# The 13-task subset the reference README advertises (README.md:175-183).
CORE_TASKS = [
    "narrativeqa", "qasper", "multifieldqa_en", "hotpotqa", "2wikimqa",
    "musique", "gov_report", "qmsum", "multi_news", "trec", "triviaqa",
    "samsum", "passage_retrieval_en",
]


# ---------------------------------------------------------------------------
# Prompt templates (longbench_eval.py:68-103 parity)
# ---------------------------------------------------------------------------

PROMPT_TEMPLATES = {
    "single_doc_qa": ("Read the following text and answer the question.\n\n"
                      "{context}\n\nQuestion: {input}\nAnswer:"),
    "multi_doc_qa": ("Read the following passages and answer the "
                     "question.\n\n{context}\n\nQuestion: {input}\nAnswer:"),
    "summarization": ("Summarize the following text.\n\n{context}\n\n"
                      "Summary:"),
    "few_shot": "{context}\n{input}",
    "synthetic": "{context}\n\n{input}",
    "code": "{context}\n{input}",
}


def format_prompt(task: TaskSpec, sample: Dict[str, Any]) -> str:
    template = PROMPT_TEMPLATES.get(task.task_type,
                                    PROMPT_TEMPLATES["single_doc_qa"])
    return template.format(context=sample.get("context", ""),
                           input=sample.get("input", ""))


def truncate_middle(token_ids: List[int], max_length: int) -> List[int]:
    """Budget-exceeding contexts keep head + tail, dropping the middle
    (data_utils.py:154-168 policy — preserves instructions at the start and
    the question at the end)."""
    if len(token_ids) <= max_length:
        return list(token_ids)
    half = max_length // 2
    return list(token_ids[:half]) + list(token_ids[len(token_ids) - (max_length - half):])


# ---------------------------------------------------------------------------
# Loading: local JSONL → HF hub → synthetic fallback
# ---------------------------------------------------------------------------

_HUB_UNAVAILABLE = False


def load_jsonl(path: str, max_samples: Optional[int] = None) -> List[Dict]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
            if max_samples and len(out) >= max_samples:
                break
    return out


def save_jsonl(path: str, rows: List[Dict]):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


def save_json(path: str, obj: Any):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=2, default=str)


def save_csv(path: str, rows: List[Dict]):
    """Rows as CSV with the stdlib `csv` module, laid out as
    `pandas.DataFrame(rows).to_csv(index=False)` lays them: one column per
    key in order of first appearance, a key a row lacks left empty. The
    JAX package's experiment scripts write CSV through pandas, when it
    imports; the port writes it always (the card machine has no
    pandas)."""
    cols: Dict[str, None] = {}
    for r in rows:
        cols.update(dict.fromkeys(r))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(cols), lineterminator="\n")
        w.writeheader()
        w.writerows(rows)


def load_task_data(task_name: str, data_dir: Optional[str] = None,
                   max_samples: Optional[int] = None,
                   allow_synthetic: bool = True,
                   synthetic_kwargs: Optional[Dict] = None) -> List[Dict]:
    """Load LongBench samples for a task.

    Order: `{data_dir}/{task}.jsonl` → HF hub (THUDM/LongBench) → synthetic
    generator (offline default; clearly marked in the sample dicts).
    """
    if data_dir:
        path = os.path.join(data_dir, f"{task_name}.jsonl")
        if os.path.exists(path):
            return load_jsonl(path, max_samples)
    global _HUB_UNAVAILABLE
    if not _HUB_UNAVAILABLE:
        try:
            from datasets import load_dataset

            ds = load_dataset("THUDM/LongBench", task_name, split="test")
            rows = [dict(r) for r in ds]
            return rows[:max_samples] if max_samples else rows
        except Exception:
            _HUB_UNAVAILABLE = True  # don't re-probe DNS for every task
    if not allow_synthetic:
        raise FileNotFoundError(
            f"no data for task {task_name!r}: no local JSONL under "
            f"{data_dir!r} and the HF hub is unreachable")
    return synthetic_task_data(task_name, n_samples=max_samples or 8,
                               **(synthetic_kwargs or {}))


# ---------------------------------------------------------------------------
# Synthetic data (hermetic evaluation; planted answers make quality
# measurable without network access)
# ---------------------------------------------------------------------------

_WORDS = ("system model cache token layer tensor kernel memory compute "
          "gradient attention sequence batch query key value head block "
          "matrix vector scale index buffer stream device host compile "
          "schedule pipeline shard mesh collective fusion latency").split()


def synthetic_context(num_words: int, seed: int = 0,
                      planted: Optional[str] = None,
                      plant_frac: float = 0.35) -> str:
    """Word-salad context of ~num_words with an optional planted fact at
    `plant_frac` depth (`benchmark runner.py`:84-114 made pure salad; the
    planted fact makes QA quality measurable)."""
    rng = random.Random(seed)
    words = [rng.choice(_WORDS) for _ in range(num_words)]
    if planted is not None:
        pos = int(len(words) * plant_frac)
        words[pos:pos] = planted.split()
    return " ".join(words)


def synthetic_task_data(task_name: str, n_samples: int = 8,
                        context_words: int = 3000, seed: int = 0) -> List[Dict]:
    """Samples shaped like LongBench rows, with planted answers."""
    task = LONGBENCH_TASKS.get(task_name)
    ttype = task.task_type if task else "single_doc_qa"
    rows = []
    rng = random.Random(seed + hash(task_name) % 10000)
    for i in range(n_samples):
        secret = f"{rng.choice(_WORDS)}{rng.randrange(100, 999)}"
        if ttype == "summarization":
            fact = f"The document's key finding is {secret}."
            rows.append({
                "context": synthetic_context(context_words, seed + i, fact),
                "input": "",
                "answers": [fact],
                "_synthetic": True,
            })
        else:
            fact = f"The secret code is {secret}."
            rows.append({
                "context": synthetic_context(context_words, seed + i, fact),
                "input": "What is the secret code?",
                "answers": [secret],
                "_synthetic": True,
            })
    return rows


def extract_answers(sample: Dict[str, Any], task: TaskSpec) -> List[str]:
    ans = sample.get(task.answer_key) or sample.get("answers") or []
    if isinstance(ans, str):
        return [ans]
    return [str(a) for a in ans]
