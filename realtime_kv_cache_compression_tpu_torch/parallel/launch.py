"""Run a function on N ranks, one spawned process each, over one group.

    results = run_ranks(fn, 4, args=(seed,))

Each rank runs `fn(rank, world_size, group, *args)` in its own process
(the `spawn` start method, safe once CUDA is initialised in the parent)
after `torch.distributed.init_process_group("gloo")` over a `file://`
rendezvous in a temporary directory (no network), with
`torch.set_num_threads(1)`. Gloo lets every rank share one device (NCCL
refuses two ranks on one), at the cost of staging CUDA tensors through
the host (`comm.py`).
`fn` must be a module-level function (it is pickled by import path) and
its return value must pickle through `torch.save`; move CUDA results to
the host before returning them. The parent returns every rank's result in
rank order.

No fallback, no hang: a rank that raises fails the call with its
traceback; the parent then kills the other ranks at once (they may be
waiting in a collective the failed rank never joins). The whole call has a
deadline (`timeout` seconds, also the group's own timeout for each
collective); reaching it kills every rank and raises TimeoutError.
"""

from __future__ import annotations

import datetime
import multiprocessing
import multiprocessing.connection
import os
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist


def _rank_main(fn, rank: int, world_size: int, tmp: str, timeout: float,
               args: Sequence[Any]) -> None:
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
            world_size=world_size, rank=rank,
            timeout=datetime.timedelta(seconds=timeout))
        result = fn(rank, world_size, dist.group.WORLD, *args)
        torch.save(result, os.path.join(tmp, f"rank{rank}.pt"))
    except BaseException:
        # Written before the group goes down: a peer learns of the failure
        # only then, so the first failure's traceback is always on disk.
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, world_size: int, args: Sequence[Any] = (),
              timeout: float = 300.0) -> List[Any]:
    """fn(rank, world_size, group, *args) on world_size spawned ranks;
    returns their results in rank order. Raises RuntimeError if a rank
    fails (with every failed rank's traceback) and TimeoutError if the
    ranks have not all finished after `timeout` seconds."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="ranks_") as tmp:
        procs = [ctx.Process(target=_rank_main, args=(
            fn, rank, world_size, tmp, timeout, tuple(args)))
            for rank in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        failed = []
        try:
            running = list(procs)
            while running and not failed and time.monotonic() < deadline:
                multiprocessing.connection.wait(
                    [p.sentinel for p in running],
                    max(0.0, deadline - time.monotonic()))
                running = [p for p in running if p.exitcode is None]
                failed = [(r, p.exitcode) for r, p in enumerate(procs)
                          if p.exitcode not in (None, 0)]
        finally:
            for p in procs:
                if p.exitcode is None:
                    p.kill()
                p.join()
        if failed:
            # Every rank that left a traceback (the first failure and the
            # peers it broke), and those that failed without one.
            codes = dict(failed)
            errors = []
            for rank, p in enumerate(procs):
                err = os.path.join(tmp, f"rank{rank}.err")
                if os.path.exists(err):
                    with open(err) as f:
                        text = f.read()
                elif rank in codes:
                    text = "(no traceback: it failed before its function ran)"
                else:
                    continue
                errors.append(f"rank {rank} (exit code {p.exitcode}):\n{text}")
            raise RuntimeError("ranks failed:\n" + "\n".join(errors))
        if running:
            raise TimeoutError(f"{len(running)} of {world_size} ranks had "
                               f"not finished after {timeout} s")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False)
                for r in range(world_size)]
