"""The port's multi-device entry points on the CPU: cli/evaluate.py with
``--data-shards 2`` (spawned by the CLI, and started torchrun-style as two
processes joining one env:// group), and the launcher's safety (parallel/launch.py): a rank that raises, a rank that
never returns and ranks that cannot start each fail the launch within its
deadline, with every rank it started stopped.
"""

import os
import socket
import subprocess
import sys
import time

import pytest
import torch

from feedback_gnn_tpu_torch.decoders.cascade import data_seed
from feedback_gnn_tpu_torch.parallel.launch import LaunchError, launch
from feedback_gnn_tpu_torch.parallel.workers import run_tasks

from test_torch_cascade import one_torch_thread  # noqa: F401  (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH = dict(device="cpu", timeout_s=60.0, join_timeout_s=240.0)


# ---- the evaluate CLI ------------------------------------------------------------------------

CLI = ["-c", "n882", "-p", "0.06", "-bs", "32", "--iters1", "8", "--iters2", "4", "-nG", "1",
       "--max-mc-iter", "2", "--target-errors", "1000", "--seed", "3", "--device", "cpu"]


@pytest.fixture(scope="module")
def cli_reference():
    """The counts the sharded CLI must print: per batch, the sum over both
    data ranks of the unsharded step on each rank's generator."""
    from feedback_gnn_tpu_torch.cli import evaluate
    from feedback_gnn_tpu_torch.config import config_from_args, make_eval_parser
    from feedback_gnn_tpu_torch.sim.montecarlo import batch_seed

    cfg = config_from_args(make_eval_parser().parse_args(CLI + ["-bs", "16"]))
    _, step = evaluate.make_step(cfg, torch.device("cpu"))
    flagged = logical = 0
    for it in range(2):
        for d in range(2):
            gen = torch.Generator().manual_seed(data_seed(batch_seed(3, 0, 0, it), d))
            f, lg = step(gen, 0.06)
            flagged, logical = flagged + int(f), logical + int(lg)
    return flagged, logical


def test_evaluate_cli_data_shards_spawned(cli_reference, capfd):
    """``cli.evaluate`` with --data-shards 2 spawns two ranks; rank 0's
    result counts the unsharded per-rank batches."""
    from feedback_gnn_tpu_torch.cli import evaluate

    res = evaluate.main(CLI + ["--data-shards", "2"])
    assert (int(res.flagged_errors[0]), int(res.logical_errors[0])) == cli_reference
    assert int(res.num_blocks[0]) == 64 and int(res.status[0]) == 1
    assert 0 < cli_reference[1] <= cli_reference[0] < 64
    assert "backend gloo, world 2" in capfd.readouterr().out


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_evaluate_cli_torchrun_style(cli_reference, tmp_path):
    """Two processes started as torchrun starts them (RANK, WORLD_SIZE,
    MASTER_ADDR/PORT; --multihost joins env://) count as the spawned ranks."""
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()), WORLD_SIZE="2",
               OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-m", "feedback_gnn_tpu_torch.cli.evaluate", *CLI,
                               "--data-shards", "2", "--multihost"],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=tmp_path,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    flagged, logical = cli_reference
    rows = [line.split("|") for line in outs[0].splitlines() if line.strip().startswith("0.06 |")]
    assert rows, outs[0]
    assert float(rows[-1][1]) == pytest.approx(flagged / 64, rel=1e-3)
    assert int(rows[-1][3]) == logical and int(rows[-1][4]) == 64
    assert "resumed" not in outs[1] and "| status" not in outs[1]  # only rank 0 prints


# ---- the launcher's safety ------------------------------------------------------------------------


def test_launch_fails_on_a_raising_rank(tmp_path):
    """A rank that raises fails the launch with its traceback, quickly."""
    t0 = time.perf_counter()
    with pytest.raises(LaunchError, match="KeyError"):
        launch(run_tasks, 1, args=([("no_such_task", {})], "cpu"), store_dir=str(tmp_path), **LAUNCH)
    assert time.perf_counter() - t0 < 60


def test_launch_kills_ranks_at_the_deadline(tmp_path):
    """A rank that never returns is killed at the deadline, and the launch
    fails: a hung collective cannot hang the caller."""
    t0 = time.perf_counter()
    with pytest.raises(LaunchError, match="no result within"):
        launch(time.sleep, 1, args=(600,), device="cpu", join_timeout_s=3.0, store_dir=str(tmp_path))
    assert time.perf_counter() - t0 < 60


def test_launch_fails_fast_when_ranks_cannot_start(tmp_path):
    """Ranks that die while starting (here: a parent whose main module a
    spawned child cannot re-import) fail the launch at once, even with
    large arguments: those travel in a file, so no start pipe is left full
    with its writer blocked."""
    script = (
        "import numpy as np\n"
        "from feedback_gnn_tpu_torch.parallel.launch import launch\n"
        "from feedback_gnn_tpu_torch.parallel.workers import run_tasks\n"
        "launch(run_tasks, 2, args=([('bp4', {'x': np.zeros(4_000_000, np.float32)})], 'cpu'),\n"
        f"       device='cpu', join_timeout_s=60, store_dir={str(tmp_path)!r})\n"
    )
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-"], input=script, capture_output=True, text=True, timeout=120,
                         cwd=tmp_path, env=dict(os.environ, PYTHONPATH=REPO))
    assert run.returncode != 0 and "LaunchError" in run.stderr, run.stderr[-2000:]
    assert "exited with code" in run.stderr
    assert time.perf_counter() - t0 < 60
