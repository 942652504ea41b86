"""The port's experiment entry points, run as `python -m`:
`quality_demo` (train a mini Llama on payload recall with `models/train.py`,
then measure recall through the compressed path arm by arm) and
`run_compression_experiment` (the LongBench harness, compressed and
baseline arms). Counterparts of the repository's `experiments/` scripts,
which drive the JAX package."""
