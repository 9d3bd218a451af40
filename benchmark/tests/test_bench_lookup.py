"""A configuration with a traffic kind and a code family of its own enters
as new files: the harness finds the kind's module, its calibration and the
code's builder by name, refuses a name that no module declares, and holds
any family's code to the same checks.  The stand-ins here live in
``sys.modules`` and in memory, so nothing is written under ``benchmark/``."""

import copy
import os
import sys
import time
import types

import numpy as np
import pytest

from benchmark import calibrate, mc, run
from benchmark.harness import Check, Outcome, load_json
from benchmark.reference import codes
from benchmark.trace import TraceData

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KIND, FAMILY = "stub_eval", "stub_hgp"
CELL, TRAFFIC, CONFIG = "stub_hgp.stub_p10", "stub_p10", "stub_hgp"
SEED = 2**33 + 12345
REP3 = [[1, 1, 0], [0, 1, 1]]  # the [3,1] repetition code: its hypergraph product is [[13,1]]


def hgp(spec):
    """(hx, hz, None): the hypergraph product of a classical check matrix."""
    h = np.asarray(spec["classical"], np.int64)
    m, n = h.shape
    hx = np.hstack([np.kron(h, np.eye(n, dtype=np.int64)), np.kron(np.eye(m, dtype=np.int64), h.T)])
    hz = np.hstack([np.kron(np.eye(n, dtype=np.int64), h), np.kron(h.T, np.eye(m, dtype=np.int64))])
    return hx, hz, None


def _module(name, **attrs):
    mod = types.ModuleType(name)
    mod.__dict__.update(attrs)
    return mod


FILES = {
    f"benchmark/configs/{CONFIG}.json": {"name": CONFIG, "reduced": [],
                                        "code": {"family": FAMILY, "n": 13, "k": 1, "classical": REP3}},
    os.path.join("benchmark", "traffic", f"{TRAFFIC}.json"): {"kind": KIND, "p": 0.1, "batch": 32},
    os.path.join("benchmark", "limits", f"{CELL}.json"): {"syndrome_mismatches": 0},
}


def stub_manifest():
    """BENCHMARK.json with the stand-in's configuration and cell, which
    reports the Monte-Carlo rate and the eval idle share."""
    m = load_json("BENCHMARK.json")
    m["configs"].append({"name": CONFIG, "source": "arXiv:0903.0566", "file": f"benchmark/configs/{CONFIG}.json",
                         "reduced": [], "why": "a code with no lift and a decoder with no weights"})
    m["workloads"].append({"name": CELL, "config": CONFIG, "traffic": TRAFFIC, "chips": 1, "why": "a stand-in"})
    for metric in m["end_to_end"] + m["per_layer"]:
        if metric["name"] in ("syndromes_per_s", "device_idle_share.eval"):
            metric["workloads"].append(CELL)
    return m


class StubKind:
    """A Monte-Carlo kind with no weights: the syndromes of seeded noise on
    the code its configuration's family builds, checked against numpy."""

    def __init__(self):
        self.calls = []

    def run(self, r):
        import torch

        code = codes.build_code(r.config["code"])
        rng = np.random.default_rng([r.seed, 7])
        batch = r.batch or int(r.traffic["batch"])
        noise = (rng.random((code.n, batch)) < r.traffic["p"]).astype(np.int64)
        syn = torch.from_numpy(code.hz).to(r.device) @ torch.from_numpy(noise).to(r.device) % 2
        mismatches = int((syn.cpu().numpy() != code.hz @ noise % 2).sum())
        checks = [Check(k, mismatches, v) for k, v in r.limits.items()]
        trace = TraceData((0.0, 1.0), 2, [("stub_kernel", 0.0, 0.25)]) if r.trace else None
        return Outcome({"syndromes_per_s": float(batch), "setup_s": time.perf_counter() - r.t_start}, batch, 0,
                       checks, 0, trace, {"kind": KIND, "loop": "eval"}, [f"[[{code.n},{code.k}]]"])

    def readings(self, r, fault=None, control=None):
        self.calls.append((r.cell["name"], r.seed, fault, control))
        return {"syndrome_mismatches": 0}

    def module(self, declared=KIND):
        return _module(f"benchmark.{KIND}", KIND=declared, run=self.run, readings=self.readings)


@pytest.fixture
def stub(monkeypatch):
    """The stand-in kind and family found by name, its files served from
    memory."""
    kind = StubKind()
    monkeypatch.setitem(sys.modules, f"benchmark.{KIND}", kind.module())
    monkeypatch.setitem(sys.modules, f"benchmark.reference.family_{FAMILY}",
                        _module(f"benchmark.reference.family_{FAMILY}", build=hgp))
    load = run.load_json
    files = dict(FILES, **{"BENCHMARK.json": stub_manifest()})
    monkeypatch.setattr(run, "load_json", lambda p: copy.deepcopy(files[p]) if p in files else load(p))
    return kind


def _tree():
    return sorted(os.path.join(d, f) for d, dirs, fs in os.walk(BENCH) if "__pycache__" not in d for f in fs)


@pytest.mark.parametrize("kind", ["no_such_kind", "harness", "trace", "counts", "calibrate", "run", "reference",
                                  "reference.codes", "MC", "mc.nope", "mc-p08", "../mc", ""])
def test_unknown_kind_exits_2_without_a_result(stub, monkeypatch, capsys, kind):
    files = dict(FILES)
    files[os.path.join("benchmark", "traffic", f"{TRAFFIC}.json")] = {"kind": kind}
    files["BENCHMARK.json"] = stub_manifest()
    monkeypatch.setattr(run, "load_json", lambda p: copy.deepcopy(files[p]))
    assert run.main(["--workload", CELL, "--seed", str(SEED), "--seconds", "1"]) == 2
    out, err = capsys.readouterr()
    assert out == ""
    assert err.count("\n") == 1 and "kind" in err and repr(kind) in err


def test_a_declared_kind_gets_past_the_lookup_to_the_card_check(stub, monkeypatch, capsys):
    monkeypatch.setattr(run.torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", CELL, "--seed", str(SEED), "--seconds", "1"]) == 2
    out, err = capsys.readouterr()
    assert out == "" and "CUDA card" in err and "kind" not in err


@pytest.mark.parametrize("declared,with_run", [("other", True), (None, True), (KIND, False)])
def test_a_module_that_does_not_declare_the_kind_is_refused(stub, monkeypatch, declared, with_run):
    mod = stub.module(declared)
    if declared is None:
        del mod.KIND
    if not with_run:
        del mod.run
    monkeypatch.setitem(sys.modules, f"benchmark.{KIND}", mod)
    with pytest.raises(run.UnknownKind):
        run.find_kind(KIND)


@pytest.mark.parametrize("kind", ["mc", "train"])
def test_the_kinds_declare_themselves(kind):
    mod = run.find_kind(kind)
    assert mod.KIND == kind and callable(mod.run) and callable(mod.readings)


@pytest.mark.parametrize("trace", [False, True])
def test_a_stand_in_kind_runs_through_run_cell(stub, trace):
    before = _tree()
    res, out = run.run_cell(CELL, SEED, 1e-6, trace, device="cpu", t_start=time.perf_counter(),
                            manifest=stub_manifest())
    assert _tree() == before
    assert res["correct"] is True and res["attempted"] == 32 and res["failed"] == 0
    assert out.notes == ["[[13,1]]"]
    assert res["checks"] == {"syndrome_mismatches": {"value": 0, "limit": 0}}
    assert res["device"]["count"] == 1
    if trace:
        assert res["metrics"] == {"device_idle_share.eval": {"value": 75.0, "unit": "%"}}
        assert res["breakdown"]["device_ops"] == [["stub_kernel", 0.25]]
    else:
        assert set(res["metrics"]) == {"syndromes_per_s", "setup_s"}
        assert res["metrics"]["syndromes_per_s"]["value"] == 32.0


def test_calibrate_reaches_the_kinds_readings(stub):
    lines = list(calibrate.readings(CELL, [5, SEED], control="ctl", faults=["f1", "f2"], control_seeds=1,
                                    manifest=stub_manifest()))
    assert stub.calls == [(CELL, 5, None, None), (CELL, 5, None, "ctl"), (CELL, 5, "f1", None),
                          (CELL, 5, "f2", None), (CELL, SEED, None, None)]
    assert [(x["seed"], x["mode"], x["what"]) for x in lines] == [
        (5, "program", None), (5, "control", "ctl"), (5, "fault", "f1"), (5, "fault", "f2"), (SEED, "program", None)]
    assert all(list(x) == ["seed", "mode", "what", "s", "syndrome_mismatches"] for x in lines)


@pytest.mark.parametrize("fault,control", [("half_batch", None), (None, "tf32")])
def test_the_mc_kind_refuses_what_it_cannot_read(fault, control):
    r = run.load_run("n882_nG3.mc_p08", SEED, 0.0, False, device="cpu")
    with pytest.raises(ValueError):
        mc.readings(r, fault=fault, control=control)


def test_a_stand_in_family_is_found_and_checked(monkeypatch):
    monkeypatch.setitem(sys.modules, f"benchmark.reference.family_{FAMILY}",
                        _module(f"benchmark.reference.family_{FAMILY}", build=hgp))
    c = codes.build_code(FILES[f"benchmark/configs/{CONFIG}.json"]["code"])
    assert (c.n, c.k, c.l, c.qx, c.qz) == (13, 1, None, None, None)
    assert c.hx.shape == (6, 13) and c.hz.shape == (6, 13)
    with pytest.raises(ValueError, match=r"\[\[13,1\]\]"):
        codes.build_code({"family": FAMILY, "n": 13, "k": 2, "classical": REP3})


def test_a_family_with_a_lift_gets_its_block_circulant_layout(monkeypatch):
    monkeypatch.setitem(sys.modules, "benchmark.reference.family_stub_ghp",
                        _module("benchmark.reference.family_stub_ghp", build=codes.qc_ghp))
    spec = load_json("benchmark/configs/n882_nG3.json")["code"]
    got, want = codes.build_code(dict(spec, family="stub_ghp")), codes.build_code(spec)
    assert got.l == want.l == 63 and got.qx == want.qx and got.qz == want.qz
    assert np.array_equal(got.hx, want.hx) and np.array_equal(got.ker_hz, want.ker_hz)


@pytest.mark.parametrize("hx,hz,why", [
    ([[1, 0], [0, 1]], [[1, 0]], "not a CSS code"),  # hx hz^T != 0
    ([[1, 1]], [[2, 0]], "not binary"),
    ([[1, 1, 0]], [[1, 1]], "not binary"),  # two widths
])
def test_a_family_that_is_not_a_css_code_is_refused(monkeypatch, hx, hz, why):
    monkeypatch.setitem(sys.modules, "benchmark.reference.family_stub_bad",
                        _module("benchmark.reference.family_stub_bad", build=lambda spec: (hx, hz, None)))
    with pytest.raises(ValueError, match=why):
        codes.build_code({"family": "stub_bad", "n": 2, "k": 0})


@pytest.mark.parametrize("family", ["no_such_family", "qc-ghp", "a.b", "", None])
def test_an_unknown_family_raises(family):
    with pytest.raises(ValueError, match="unknown code family"):
        codes.build_code({"family": family, "n": 13, "k": 1})
