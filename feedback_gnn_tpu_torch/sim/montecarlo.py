"""Monte-Carlo logical-error-rate harness.

The port of ``feedback_gnn_tpu/sim/montecarlo.py``, with its accounting and
stopping semantics:

* per p-point: run batches until ``num_target_block_errors`` logical errors
  or ``max_mc_iter`` batches (status codes: max-iter / early-stop /
  target-reached);
* flagged errors (any unsatisfied check) are tracked beside logical errors;
* ``early_stop`` ends the sweep after the first error-free point;
* KeyboardInterrupt returns partial results;
* an optional third step output counts compaction overflows, reported
  loudly;
* the MC state (counts per point) is checkpointed to JSON with the JAX
  package's keys, so each package resumes from the other's file.

Every batch gets its own ``torch.Generator`` seed, derived from (seed,
process index, point, iteration) by ``numpy.random.SeedSequence``, so any
batch is reproducible in isolation (the JAX package folds the same four
into its key).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import obs, resolve_device

__all__ = ["SimResult", "sim_ler", "batch_seed"]


@dataclass
class SimResult:
    ps: np.ndarray
    flagged_rate: np.ndarray
    ler: np.ndarray  # logical (block) error rate
    flagged_errors: np.ndarray
    logical_errors: np.ndarray
    num_blocks: np.ndarray
    runtime: np.ndarray
    status: np.ndarray  # 0 not simulated, 1 max-iter, 2 early-stop, 4 target reached
    throughput: np.ndarray = field(default=None)  # blocks/s per point
    overflow: np.ndarray = field(default=None)  # compaction overflows per point

    def summary(self) -> str:
        status_txt = {
            0: "not simulated",
            1: "reached max iter",
            2: "no errors - early stop",
            4: "reached target block errors",
        }
        lines = [
            f"{'p':>8} | {'flagged':>10} | {'LER':>10} | {'log errs':>9} | "
            f"{'blocks':>12} | {'runtime[s]':>10} | {'blk/s':>9} | status"
        ]
        for i in range(len(self.ps)):
            lines.append(
                f"{self.ps[i]:>8.4g} | {self.flagged_rate[i]:>10.4g} | "
                f"{self.ler[i]:>10.4g} | {self.logical_errors[i]:>9d} | "
                f"{self.num_blocks[i]:>12d} | {self.runtime[i]:>10.1f} | "
                f"{self.throughput[i]:>9.3g} | {status_txt.get(int(self.status[i]), '?')}"
            )
        return "\n".join(lines)


def batch_seed(seed: int, process: int, point: int, iteration: int) -> int:
    """The generator seed of one batch: a 64-bit word of
    ``SeedSequence([seed, process, point, iteration])``."""
    return int(np.random.SeedSequence([seed, process, point, iteration]).generate_state(1, np.uint64)[0])


def _process_index() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def sim_ler(
    step_fn,
    ps,
    batch_size: int,
    max_mc_iter: int,
    num_target_block_errors: int | None = 100,
    early_stop: bool = True,
    seed: int = 0,
    verbose: bool = True,
    checkpoint_path: str | None = None,
    checkpoint_every_s: float = 60.0,
    write_checkpoint: bool = True,
    fold_process_key: bool = True,
    device=None,
) -> SimResult:
    """Simulate each p in ``ps`` until the stop condition.

    ``step_fn(generator, p) -> (flagged_count, logical_count)`` returns 0-d
    tensors (or ints) for one batch of ``batch_size`` samples (see
    ``decoders.cascade.sandwich_eval_step``); the generator lies on
    ``device`` (the card unless the caller passes "cpu") and is reseeded
    for every batch with ``batch_seed(seed, process, point, iteration)``.  An optional third
    output is the compaction-overflow count; any nonzero total is reported,
    since overflowed samples keep an earlier estimate.

    ``fold_process_key`` folds the process index (the
    ``torch.distributed`` rank when it is initialised, else 0) into every
    seed, for independent per-process sweeps; ``write_checkpoint`` lets
    only one process of several write the shared checkpoint.

    A sharded sweep (parallel/api.py's step, one process per rank) passes
    ``fold_process_key=False``, so every rank seeds the same batch and the
    step derives each data rank's stream from it; the same
    ``checkpoint_path`` to every rank, with ``write_checkpoint`` on rank 0
    only.  The step sums the counts over the ranks, so the restored state
    and every stop decision agree on all ranks, as their collectives need.
    """
    ps = np.asarray(ps, np.float64)
    npts = len(ps)
    state = {
        "flagged": np.zeros(npts, np.int64),
        "logical": np.zeros(npts, np.int64),
        "blocks": np.zeros(npts, np.int64),
        "iters": np.zeros(npts, np.int64),
        "runtime": np.zeros(npts, np.float64),
        "status": np.zeros(npts, np.int64),
        "overflow": np.zeros(npts, np.int64),
    }
    if checkpoint_path and os.path.exists(checkpoint_path):
        with open(checkpoint_path) as f:
            saved = json.load(f)
        if saved.get("ps") == list(ps) and saved.get("batch_size") == batch_size:
            for k in state:
                if k in saved:  # tolerate checkpoints from older versions
                    state[k] = np.asarray(saved[k], dtype=state[k].dtype)
            if verbose:
                print(f"resumed MC state from {checkpoint_path}")

    process = _process_index() if fold_process_key else 0
    generator = torch.Generator(device=resolve_device(device))
    last_ckpt = time.perf_counter()

    def save_ckpt():
        if not checkpoint_path or not write_checkpoint:
            return
        payload = {k: v.tolist() for k, v in state.items()}
        payload["ps"] = list(ps)
        payload["batch_size"] = batch_size
        tmp = f"{checkpoint_path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, checkpoint_path)

    header = (
        f"{'p':>8} | {'flagged':>10} | {'LER':>10} | {'log errs':>9} | "
        f"{'blocks':>12} | {'runtime[s]':>10}"
    )
    if verbose:
        print(header)
        print("-" * len(header))

    # spans between two batches (tracing on only): ``sim.between_batches``
    # from the end of one step's enqueue to the next step's call (its device
    # time: the stream's idle stretch), ``sim.host_gap`` from the first count
    # on the host to that call (the host's work between the batches)
    between = host_gap = obs.NULL
    try:
        for i in range(npts):
            if state["status"][i] != 0:
                continue  # restored, already finished
            t0 = time.perf_counter() - state["runtime"][i]
            for it in range(int(state["iters"][i]), int(max_mc_iter)):
                generator.manual_seed(batch_seed(seed, process, i, it))
                host_gap.close()
                between.close()
                out = step_fn(generator, ps[i])
                between = obs.begin("sim.between_batches")
                state["flagged"][i] += int(out[0])
                host_gap = obs.begin("sim.host_gap")
                if len(out) > 2:
                    state["overflow"][i] += int(out[2])
                state["logical"][i] += int(out[1])
                state["blocks"][i] += batch_size
                state["iters"][i] = it + 1
                state["runtime"][i] = time.perf_counter() - t0

                if verbose:
                    print(
                        f"\r{ps[i]:>8.4g} | "
                        f"{state['flagged'][i] / state['blocks'][i]:>10.4g} | "
                        f"{state['logical'][i] / state['blocks'][i]:>10.4g} | "
                        f"{state['logical'][i]:>9d} | {state['blocks'][i]:>12d} | "
                        f"{state['runtime'][i]:>10.1f}",
                        end="",
                        flush=True,
                    )
                if checkpoint_path and time.perf_counter() - last_ckpt > checkpoint_every_s:
                    save_ckpt()
                    last_ckpt = time.perf_counter()

                if (
                    num_target_block_errors is not None
                    and state["logical"][i] >= num_target_block_errors
                ):
                    state["status"][i] = 4
                    break
            else:
                state["status"][i] = 1
            if verbose:
                print()
            if state["overflow"][i] and verbose:
                print(
                    f"WARNING: {state['overflow'][i]} compaction-capacity "
                    f"overflows at p={ps[i]:.4g} — results are pessimistic; "
                    "raise --compact/--rounds-cap or disable compaction"
                )
            if early_stop and state["logical"][i] == 0:
                state["status"][i] = 2
                if verbose:
                    print(f"\nsimulation stopped: no errors at p={ps[i]:.4g}\n")
                break
    except KeyboardInterrupt:
        if verbose:
            print("\nsimulation interrupted — returning partial results")
    finally:
        host_gap.close()
        between.close()
        save_ckpt()

    blocks = np.maximum(state["blocks"], 1)
    return SimResult(
        ps=ps,
        flagged_rate=state["flagged"] / blocks,
        ler=state["logical"] / blocks,
        flagged_errors=state["flagged"],
        logical_errors=state["logical"],
        num_blocks=state["blocks"],
        runtime=state["runtime"],
        status=state["status"],
        throughput=state["blocks"] / np.maximum(state["runtime"], 1e-9),
        overflow=state["overflow"],
    )
