"""The controls on the card, at the cells' own sizes: the program's
bfloat16 message carry fails the Monte-Carlo cells' check, and the
reference computed in TF32 fails the training kind's (run through a
manifest that adds its cell, which BENCHMARK.json does not hold yet).
Marked ``gpu``; run on the card from the checkout's root:

    python3 -m pytest --noconftest -m gpu benchmark/tests/test_bench_card.py
"""

import time

import pytest
import torch

pytestmark = pytest.mark.gpu
SEEDS = (3000000131, 3000000137, 3000000139)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("workload", ["n1270_nG5.mc_p05", "n882_nG3.mc_p08"])
@pytest.mark.parametrize("seed", SEEDS)
def test_mc_control_fails(card, workload, seed):
    from benchmark.run import run_cell

    res, _ = run_cell(workload, seed, 1e-6, False, control="bf16", t_start=time.perf_counter())
    assert res["correct"] is False
    assert res["checks"]["llr_gap"]["value"] > res["checks"]["llr_gap"]["limit"]


@pytest.mark.parametrize("seed", SEEDS)
def test_train_control_fails(card, seed):
    from benchmark import train
    from benchmark.run import load_run
    from benchmark.tests.test_bench_check import TRAIN, with_train_cell

    r = load_run(TRAIN, seed, 0.0, False, t_start=time.perf_counter(), manifest=with_train_cell())
    got = train.readings(r, control="tf32")
    assert any(got[k] > r.limits[k] for k in r.limits if k in got)
