"""The multi-process driver: the compressed model and the serving engine over
a mesh whose ranks are separate processes started on their own.

Port of the JAX package's `parallel/multihost.py`. The port runs one
process per rank everywhere, so what JAX needs this module for (a mesh
that spans processes) is every multi-rank mesh here; what this module adds
is the bring-up of processes that were not spawned by `run_ranks`:

  * `initialize(coordinator, num_processes, process_id)` — this process's
    `torch.distributed` group over a TCP rendezvous at HOST:PORT (gloo;
    NCCL where each process owns its own card).
  * `global_params(params, mesh, cfg)` — every process holds the same full
    tree and keeps its own slice (`sharding.shard_params`), so no weight
    crosses processes, as JAX's global arrays are built from each host's
    copy.
  * `run_spmd_check(data, model)` — one compressed prefill + greedy decode
    over the (data, model) mesh, token-identical to the single-process
    path that every process computes locally, with the tier caches' rows
    and kv heads checked.
  * `run_serving_check(data, model)` — continuous-batching serving over the
    mesh (`ServingEngine(mesh=)`: every process runs the same engine on
    the same submissions), token-identical to the single-process engine.
  * `launch_local_sim(num_processes, ...)` — starts `num_processes` worker
    processes of this module with `subprocess` on a free loopback port and
    runs the checks across them. JAX gives each worker several virtual
    devices (`local_devices`); the port has no counterpart, since each
    process is one rank, so the mesh has num_processes ranks.

Worker entry: `python -m realtime_kv_cache_compression_tpu_torch.parallel.multihost
--process-id I --num-processes N --coordinator HOST:PORT [--data D --model M
--arm spmd|serving|both --device cuda|cpu]`. Every process must run the
same arguments but for its id; process 0 prints `MULTIHOST_SIM_OK` when
every check passed on it.
"""

from __future__ import annotations

import argparse
import datetime
import os
import subprocess
import sys
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from .mesh import DATA_AXIS, MODEL_AXIS, create_mesh

Params = Dict[str, Any]

# The checks' model and compression settings: JAX's (2 layers, 8 / 4 heads,
# d=16, hidden 128; tiers 8 / 4 / 2 bits).
_CHECK_DIMS = dict(num_layers=2, num_heads=8, num_kv_heads=4, head_dim=16,
                   hidden_size=128)
_CHECK_BITS = dict(high_precision_bits=8, medium_precision_bits=4,
                   low_precision_bits=2)
# What process 0 prints when the coordinator's bind fails.
_ADDRESS_IN_USE = ("EADDRINUSE", "Address already in use")


def initialize(coordinator: str, num_processes: int, process_id: int,
               backend: str = "gloo", timeout: float = 600.0) -> None:
    """Joins this process to a group of `num_processes` over a TCP
    rendezvous at `coordinator` (HOST:PORT; process 0 listens there) as
    rank `process_id`. Call once per process, before any mesh. gloo
    serves processes that share a device (CUDA tensors are staged through
    the host, `comm.py`); NCCL needs a card per process."""
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}", world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout))


def global_params(params: Params, mesh, cfg):
    """This process's slice of the full float tree `params` on `mesh`
    (`sharding.shard_params`): every process passes the same full tree,
    and only its own blocks are kept."""
    from .sharding import shard_params

    return shard_params(params, mesh, cfg)


def _check_setup(device):
    from .. import CompressionConfig, tiny_test_model
    from ..models import llama

    mcfg = tiny_test_model(**_CHECK_DIMS)
    ccfg = CompressionConfig(num_layers=mcfg.num_layers, **_CHECK_BITS)
    return mcfg, ccfg, llama.init_params(0, mcfg, device=device)


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def run_spmd_check(data: int, model: int, batch: int = 4, seq_len: int = 96,
                   new_tokens: int = 8, device="cuda",
                   verbose: bool = True) -> bool:
    """Compressed prefill + greedy decode over the (data, model) mesh of
    the world's processes, against the single-process path that every
    process computes locally on the same weights (seed 0) and ids (a
    numpy draw from seed 1). Returns True when every token matches;
    raises when the tier caches do not hold this rank's rows and kv heads.
    Every process must call it with the same arguments."""
    from ..models import llama

    mcfg, ccfg, params = _check_setup(device)
    ids = torch.from_numpy(np.random.RandomState(1).randint(
        0, mcfg.vocab_size, (batch, seq_len))).to(device)
    n_steps = new_tokens - 1

    ref_logits, ref_state, _ = llama.prefill_compressed(
        params, ids, mcfg, ccfg, max_decode_len=new_tokens)
    ref_tok = torch.argmax(ref_logits, -1)
    ref_toks, _ = llama.decode_loop(params, ref_tok, ref_state, n_steps,
                                    mcfg, ccfg)
    ref = torch.cat([ref_tok[:, None], ref_toks], dim=1)

    mesh = create_mesh(data, model)
    gp = global_params(params, mesh, mcfg)
    logits, state, _ = llama.prefill_compressed(
        gp, ids, mcfg, ccfg, max_decode_len=new_tokens, mesh=mesh)
    tier = state.caches[0].tiers[0].k_stored
    want = (batch // data, mcfg.num_kv_heads // model)
    got = (tier.shape[0], tier.shape[2])
    if got != want:
        raise AssertionError(f"tier cache layout drifted: (rows, kv heads) "
                             f"{got} != {want}")
    tok = torch.argmax(logits, -1)
    toks, _ = llama.decode_loop(gp, tok, state, n_steps, mcfg, ccfg)
    full = torch.cat([tok[:, None], toks], dim=1)
    ok = bool(torch.equal(full.cpu(), ref.cpu()))
    if verbose:
        print(f"[p{_rank()}] mesh {data}x{model} over {_count()} "
              f"process(es): token match = {ok}; tier cache (rows, kv "
              f"heads) {got} on ({DATA_AXIS}, {MODEL_AXIS})", flush=True)
    return ok


def run_serving_check(data: int, model: int, device="cuda",
                      verbose: bool = True) -> bool:
    """Continuous-batching serving over the (data, model) mesh of the
    world's processes (every process runs the same engine on the same six
    prompts of 48-96 tokens from numpy's RandomState(7)), against the
    single-process engine that every process runs locally. Returns True
    when every request's tokens match."""
    from ..serving.engine import ServingEngine

    mcfg, ccfg, params = _check_setup(device)
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, mcfg.vocab_size, size=n).tolist()
               for n in (48, 64, 96, 56, 80, 72)]
    kw = dict(num_slots=4, context_len=96, max_new_tokens=8, decode_chunk=4)

    ref = ServingEngine(params, mcfg, ccfg, **kw)
    for p in prompts:
        ref.submit(p)
    ref_tokens = {r.rid: r.tokens for r in ref.run().values()}

    eng = ServingEngine(params, mcfg, ccfg, mesh=create_mesh(data, model),
                        **kw)
    for p in prompts:
        eng.submit(p)
    got_tokens = {r.rid: r.tokens for r in eng.run().values()}
    ok = got_tokens == ref_tokens
    if verbose:
        print(f"[p{_rank()}] serving over mesh {data}x{model}, {_count()} "
              f"process(es): {len(got_tokens)} requests, token match = "
              f"{ok}", flush=True)
    return ok


def _worker_main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--data", type=int, default=2)
    ap.add_argument("--model", type=int, default=None,
                    help="model-axis size (default: processes / data)")
    ap.add_argument("--arm", default="spmd",
                    choices=["spmd", "serving", "both"])
    ap.add_argument("--device", default="cuda",
                    help="torch device of every process (default cuda; "
                         "the processes share it over gloo)")
    args = ap.parse_args(argv)
    model = args.model or args.num_processes // args.data
    torch.set_num_threads(1)
    initialize(args.coordinator, args.num_processes, args.process_id)
    try:
        ok = True
        if args.arm in ("spmd", "both"):
            ok &= run_spmd_check(args.data, model, device=args.device)
        if args.arm in ("serving", "both"):
            ok &= run_serving_check(args.data, model, device=args.device)
        if ok and args.process_id == 0:
            print("MULTIHOST_SIM_OK", flush=True)
    finally:
        dist.destroy_process_group()
    return 0 if ok else 1


class _PortTaken(RuntimeError):
    """The coordinator could not bind its port: another program took it
    between its choice and the bind."""


def launch_local_sim(num_processes: int = 2, data: int = 2,
                     model: Optional[int] = None, arm: str = "spmd",
                     device: str = "cuda", timeout: float = 600.0) -> str:
    """Starts `num_processes` worker processes of this module on this
    machine (each one rank; a data x model mesh, model defaulting to
    num_processes / data) over a loopback TCP coordinator, and runs the
    `arm` checks across them on `device`. Returns process 0's output;
    raises RuntimeError when a worker fails or process 0 does not report
    success, TimeoutError when the workers run past `timeout`. One retry
    with a fresh port, only when the coordinator could not bind the port
    it was given (another program took it between its choice and the
    bind); the first attempt's output then goes to stderr."""
    try:
        return _launch_once(num_processes, data, model, arm, device, timeout)
    except _PortTaken as e:
        print(f"multihost: the coordinator's port was taken; retrying on "
              f"another. First attempt:\n{e}", file=sys.stderr, flush=True)
    return _launch_once(num_processes, data, model, arm, device, timeout)


def _launch_once(num_processes: int, data: int, model: Optional[int],
                 arm: str, device: str, timeout: float) -> str:
    import socket
    import tempfile
    import time

    if model is None:
        model = num_processes // data
    with socket.socket() as s:  # a free port for the coordinator
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    # The port is released before process 0 binds it: another program
    # could take it in the gap, which fails the workers (_PortTaken).
    repo_root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs, files = [], []
    deadline = time.monotonic() + timeout
    try:
        for i in range(num_processes):
            # Files, not pipes: a worker that fills a pipe mid-collective
            # would stall every process while the others are drained.
            f = tempfile.TemporaryFile(mode="w+", encoding="utf-8")
            files.append(f)
            procs.append(subprocess.Popen(
                [sys.executable, "-m",
                 "realtime_kv_cache_compression_tpu_torch.parallel.multihost",
                 "--coordinator", f"127.0.0.1:{port}",
                 "--num-processes", str(num_processes),
                 "--process-id", str(i), "--data", str(data),
                 "--model", str(model), "--arm", arm, "--device", device],
                cwd=repo_root, env=env, stdout=f, stderr=f, text=True))
        # Until every worker has exited, or one has failed: its peers would
        # wait for it until their rendezvous or collective timed out.
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"multihost workers had not finished "
                                   f"after {timeout} s")
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for f in files:
        f.seek(0)
        outs.append(f.read())
        f.close()
    # A worker that failed on its own is reported before those killed
    # after it (negative return codes).
    failed = sorted((p.returncode < 0, i) for i, p in enumerate(procs)
                    if p.returncode != 0)
    if failed:
        i = failed[0][1]
        taken = any(m in outs[0] for m in _ADDRESS_IN_USE)
        raise (_PortTaken if taken else RuntimeError)(
            f"multihost worker {i} failed (rc={procs[i].returncode}):\n"
            f"{outs[i]}")
    if "MULTIHOST_SIM_OK" not in outs[0]:
        raise RuntimeError(f"process 0 did not report OK:\n{outs[0]}")
    return outs[0]


if __name__ == "__main__":
    sys.exit(_worker_main())
