"""`spawn` (port of `paddle_tpu/distributed/extras.py:142`): run a
function in N fresh processes with the launcher's environment set.

Each child gets `PADDLE_MASTER` (127.0.0.1 and a free port),
`PADDLE_TRAINERS_NUM` and `PADDLE_TRAINER_ID`, the contract
`env.init_parallel_env` reads. Children start with the `spawn` method
(a fresh interpreter: CUDA cannot be forked), so `func` must be
importable by name, a module-level function.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import socket
import time
from multiprocessing.connection import wait

__all__ = ["spawn", "SpawnContext"]


def free_port() -> int:
    """A TCP port on 127.0.0.1 free at the time of asking."""
    s = socket.socket()
    try:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
    finally:
        s.close()


def _spawn_entry(func, args, env):
    os.environ.update(env)
    func(*args)


class SpawnContext:
    """The spawned processes (`.processes`, rank order) and `join`."""

    def __init__(self, processes):
        self.processes = processes

    def join(self, timeout=None):
        """Wait for every rank. As soon as one exits non-zero, or when
        `timeout` seconds pass, the others are killed and RuntimeError /
        TimeoutError is raised, so a failed or stuck rank fails the run
        instead of hanging it."""
        deadline = None if timeout is None else time.monotonic() + timeout
        live = list(self.processes)
        while live:
            left = (None if deadline is None
                    else max(0.0, deadline - time.monotonic()))
            ready = wait([p.sentinel for p in live], left)
            if not ready:
                self.kill()
                raise TimeoutError(f"spawn: ranks still running after "
                                   f"{timeout} s were killed")
            for p in [p for p in live if p.sentinel in ready]:
                p.join()
                live.remove(p)
                if p.exitcode:
                    self.kill()
                    codes = [q.exitcode for q in self.processes]
                    raise RuntimeError(f"spawn: a rank failed, exit codes "
                                       f"{codes}")

    def kill(self):
        for p in self.processes:
            if p.is_alive():
                p.kill()
        for p in self.processes:
            p.join()


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """Parity: dist.spawn — start `func(*args)` in `nprocs` processes
    (default `PADDLE_TRAINERS_NUM`), each with the trainer environment
    for its rank. `join=True` waits (`SpawnContext.join`, with
    `options["timeout"]` seconds if given); else the context is
    returned."""
    if nprocs <= 0:
        nprocs = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    master = f"127.0.0.1:{free_port()}"
    ctx = mp.get_context("spawn")
    procs = []
    for rank in range(nprocs):
        env = {"PADDLE_MASTER": master, "PADDLE_TRAINERS_NUM": str(nprocs),
               "PADDLE_TRAINER_ID": str(rank)}
        p = ctx.Process(target=_spawn_entry, args=(func, args, env),
                        daemon=daemon)
        p.start()
        procs.append(p)
    c = SpawnContext(procs)
    if join:
        c.join(options.get("timeout"))
    return c
