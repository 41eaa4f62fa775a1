"""Spawned gloo ranks for the port's multi-rank tests
(``tests/test_torch_parallel*.py``).

:func:`start_ranks` starts ``n`` processes (``torch.multiprocessing``,
spawn), each on one thread, joined into a gloo group on 127.0.0.1 at a free
port, and each runs ``target(rank, *args)``, a function of an importable
module that imports no JAX. The caller may do other work (its JAX side)
before :meth:`Ranks.results` collects what each rank returned. The ranks
have a deadline of their own: past it, or as soon as one rank fails, every
rank is killed and the call raises, so a hang fails the test file instead
of eating the suite's time.
"""

from __future__ import annotations

import os
import queue as queue_mod
import socket
import time
import traceback
from typing import Any, Callable, List

import torch
import torch.multiprocessing as mp

DEADLINE_S = 120.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(target: Callable, rank: int, n: int, port: int, queue, args) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(n), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    import torch.distributed as dist

    from vista_tpu_torch.parallel.mesh import init_distributed

    try:
        init_distributed("cpu")
        queue.put((rank, True, target(rank, *args)))
    except BaseException:  # noqa: BLE001 - reported to the parent, which raises
        queue.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class Ranks:
    def __init__(self, target: Callable, n: int, args: tuple, deadline_s: float):
        ctx = mp.get_context("spawn")
        self.queue = ctx.Queue()
        self.deadline = time.monotonic() + deadline_s
        port = _free_port()
        self.procs = [ctx.Process(target=_rank_main, args=(target, r, n, port, self.queue, args),
                                  daemon=True) for r in range(n)]
        for p in self.procs:
            p.start()

    def results(self) -> List[Any]:
        """What each rank's target returned, in rank order."""
        out, failed = {}, True
        try:
            while len(out) < len(self.procs):
                left = self.deadline - time.monotonic()
                try:  # a result already sent counts, however late it is read
                    rank, ok, payload = self.queue.get(timeout=min(max(left, 0.01), 1.0))
                except queue_mod.Empty:  # check that no rank died silently
                    if left <= 0:
                        raise TimeoutError(f"ranks {sorted(set(range(len(self.procs))) - set(out))}"
                                           f" did not finish within the deadline")
                    dead = [r for r, p in enumerate(self.procs)
                            if r not in out and not p.is_alive() and p.exitcode != 0]
                    if dead:
                        raise RuntimeError(f"ranks {dead} died (exit codes "
                                           f"{[self.procs[r].exitcode for r in dead]})")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{payload}")
                out[rank] = payload
            failed = False
        finally:
            for p in self.procs:
                p.join(timeout=1.0 if failed else max(self.deadline - time.monotonic(), 1.0))
                if p.is_alive():
                    p.kill()
                    p.join()
        return [out[r] for r in range(len(self.procs))]


def start_ranks(target: Callable, n: int = 2, args: tuple = (),
                deadline_s: float = DEADLINE_S) -> Ranks:
    """Start ``target(rank, *args)`` on ``n`` gloo ranks (see the module)."""
    return Ranks(target, n, args, deadline_s)
