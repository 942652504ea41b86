"""The port's experiment entry points, run as `python -m
realtime_kv_cache_compression_tpu_torch.experiments.<name>`:
`quality_demo` (train a mini Llama on payload recall with `models/train.py`,
then measure recall through the compressed path arm by arm),
`run_compression_experiment` (the LongBench harness, compressed and
baseline arms), `ablation_study` (five studies of compression configs,
each quick-evaluated on LongBench tasks), `hyperparameter_tuning` (grid,
random, Bayesian and genetic search over the compression space),
`chunked_prefix_quality` (recall through the compressed-prefix chunked
prefill against the one-shot and uncompressed arms),
`speculative_benchmark` (greedy against prompt-lookup speculative and
adaptive decoding on the trained recall model) and `serving_benchmark`
(continuous-batching throughput and TTFT). Counterparts of the
repository's `experiments/` scripts, which drive the JAX package; each
takes `--device` (cuda by default: K1 in every prefill and K2 in every
compressed decode; cpu: their plain versions)."""
