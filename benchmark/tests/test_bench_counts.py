"""The frozen operation counts: K1's bound pinned to the port's kernel
table (PERF.md), the GNN's and the GF(2) products' counts by hand."""

import os

import pytest

from benchmark import counts
from benchmark.harness import load_json
from benchmark.reference.codes import build_code


@pytest.fixture(scope="module")
def codes():
    return {name: build_code(load_json(f"benchmark/configs/{name}.json")["code"])
            for name in ("n1270_nG5", "n882_nG3")}


@pytest.mark.parametrize("name,batch,iters,ms", [
    ("n1270_nG5", 20480, 12, 1.09861),
    ("n1270_nG5", 3072, 64, 0.87637),
    ("n1270_nG5", 1024, 16, 0.07318),
    ("n882_nG3", 8192, 64, 1.62301),
    ("n882_nG3", 1664, 16, 0.08258),
    ("n882_nG3", 20480, 12, 0.76297),
])
def test_k1_bound_matches_the_kernel_table(codes, name, batch, iters, ms):
    c = codes[name]
    got, by = counts.k1_bound_ms(c.qx, c.qz, batch, iters)
    assert round(got, 5) == ms and by == "operations"


def test_k1_carry_and_phi_forms_cost_more(codes):
    c = codes["n882_nG3"]
    base = counts.k1_ops(c.qx, c.qz, 512, 64)
    assert counts.k1_ops(c.qx, c.qz, 512, 64, msg_dtype="bfloat16") > base
    assert round(counts.k1_bound_ms(c.qx, c.qz, 512, 64, phi_impl="tf")[0], 5) == 0.13250
    assert round(counts.k1_bound_ms(c.qx, c.qz, 512, 16, phi_impl="accurate")[0], 5) == 0.02800


def test_gnn_ops_by_hand():
    # one VN, no edges, hidden 1, msg 1, one embed layer: per side 6+1+1+2+1 = 11,
    # embed 2*5*1 + 2 = 12, out 2*3 + 3 = 9
    assert counts.gnn_ops(1, 0, 0, 1, 1, 1, 1) == 2 * 11 + 12 + 9
    assert counts.gnn_ops(1, 3, 4, 1, 1, 1, 2) == 2 * (2 * 11 + 12 + 9 + 5 * 7)


def test_gf2_ops_are_nonzeros_times_batch(codes):
    c = codes["n882_nG3"]
    assert counts.gf2_ops(int(c.hx.sum()), 100) == 100 * c.qx.num_edges


def test_the_tests_run_from_the_checkout_root():
    assert os.path.exists("BENCHMARK.json")


def test_k2_bound_matches_the_kernel_table(codes):
    # K2 on [[882,24]]'s hx, B=20480 x 100 iterations, min-sum: 1.39061 ms (operations)
    got, by = counts.k2_bound_ms(codes["n882_nG3"].qx, 20480, 100, "minsum")
    assert round(got, 5) == 1.39061 and by == "operations"
