"""The port's multi-process driver (`parallel/multihost.py`) on the CPU.

Worker processes of the module are started with `subprocess` (not
`run_ranks`), each one rank, joined over a loopback TCP coordinator and
gloo, as JAX's `tests/test_multihost.py` starts its hosts. Each process
compares the mesh's tokens with the single-process path it computes
itself, at JAX's sizes (2 layers, 8 / 4 heads, d=16, hidden 128): a
compressed prefill of 4 x 96 tokens and 7 greedy steps, and continuous
batching of six prompts of 48-96 tokens over 4 slots. Process 0 prints
JAX's success line. About 13 s for both cases.
"""

from realtime_kv_cache_compression_tpu_torch.parallel.multihost import (
    launch_local_sim)


def test_two_process_spmd_and_serving_token_identity():
    out = launch_local_sim(num_processes=2, arm="both", device="cpu",
                           timeout=240)
    assert "MULTIHOST_SIM_OK" in out
    assert out.count("token match = True") == 2
    assert "mesh 2x1 over 2 process(es)" in out


def test_four_process_mesh():
    out = launch_local_sim(num_processes=4, data=2, arm="both",
                           device="cpu", timeout=240)
    assert "MULTIHOST_SIM_OK" in out
    assert out.count("token match = True") == 2
    assert "mesh 2x2 over 4 process(es)" in out
