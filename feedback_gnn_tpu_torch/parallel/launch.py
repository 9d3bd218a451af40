"""Start the ranks of a grid on this machine: ``world`` worker processes
(``spawn`` start method), each joined to one process group, each running
``fn(*args)``; the parent collects every rank's return value.

    results = launch(fn, world=2, args=(cfg,), device="cpu")

The counterpart of ``torchrun --nproc-per-node=world`` for one machine, used
by the CLIs' ``--data-shards``/``--edge-shards`` and the tests.  ``fn`` must
be importable by name (a module-level function of this package), since a
spawned child starts from a fresh interpreter.  The group meets in a
``FileStore`` under a fresh temporary directory (``store_dir``), so no port
is chosen and concurrent launches never meet.  ``fn`` and ``args`` reach the
ranks as a pickle file in that directory, not through the start pipe: the
parent blocks writing a start pipe that a dead child leaves full.

Safety: every collective has ``timeout_s``, and the parent waits at most
``join_timeout_s`` in all.  A rank that raises reports its traceback; on
any failure or at the deadline the parent kills every rank it started and
raises, so a deadlocked collective can never hang the caller.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback

__all__ = ["launch", "LaunchError"]


class LaunchError(RuntimeError):
    """A rank failed, died or outlived the deadline."""


def _child(job, rank, world, device, timeout_s, threads, store, results):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    try:
        with open(job, "rb") as f:
            fn, args = pickle.load(f)
        import torch
        import torch.distributed as dist

        from .mesh import init_distributed

        if threads:
            torch.set_num_threads(threads)
        init_distributed(timeout_s=timeout_s, device=device, init_method=f"file://{store}")
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which fails the launch
        results.put((rank, False, traceback.format_exc()))
        raise


def launch(fn, world: int, args=(), device=None, timeout_s: float = 60.0,
           join_timeout_s: float | None = 600.0, threads: int | None = 1,
           store_dir: str | None = None) -> list:
    """Run ``fn(*args)`` on ``world`` ranks and return their results in
    rank order.  ``device`` "cpu" puts every rank on the CPU; None on the
    cards (``LOCAL_RANK % device_count``), the backend chosen by
    ``mesh.choose_backend``.  ``threads`` sets each rank's torch
    threads (None leaves torch's default).  ``join_timeout_s`` None waits
    as long as the ranks run (a Monte-Carlo sweep), each collective still
    bounded by ``timeout_s``."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="fgt_launch_", dir=store_dir)
    store, job = os.path.join(tmp, "store"), os.path.join(tmp, "job.pkl")
    with open(job, "wb") as f:
        pickle.dump((fn, args), f)
    procs = [ctx.Process(target=_child, args=(job, r, world, device, timeout_s, threads, store, results),
                         daemon=True)
             for r in range(world)]
    out, errors = {}, {}
    deadline = None if join_timeout_s is None else time.monotonic() + join_timeout_s
    try:
        for p in procs:
            p.start()
        while len(out) < world and not errors:
            try:
                rank, ok, value = results.get(timeout=0.5)
                (out if ok else errors)[rank] = value
                continue
            except queue.Empty:
                pass
            dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
            if dead:
                errors.update({r: f"rank {r} exited with code {procs[r].exitcode}" for r in dead})
            elif deadline is not None and time.monotonic() > deadline:
                errors[-1] = f"no result within {join_timeout_s} s"
        if errors:  # the failed ranks' tracebacks, where they got to send them
            try:
                while True:
                    rank, ok, value = results.get(timeout=1.0)
                    if not ok:
                        errors[rank] = value
            except queue.Empty:
                pass
    finally:
        for p in procs:
            if p.is_alive() and (errors or len(out) < world):
                p.kill()
        for p in procs:
            p.join(timeout=30)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if errors:
        raise LaunchError("launch of %d ranks failed:\n%s" % (
            world, "\n".join(f"[{r}] {e}" for r, e in sorted(errors.items()))))
    return [out[r] for r in range(world)]
