"""The port's probes (feedback_gnn_tpu_torch/probes.py, their plain
versions) against the Pallas probes of scripts/probe_pallas.py and
scripts/probe_pallas2.py, run as they are in interpret mode on the CPU.

The scripts are loaded from their files and their ``main()`` run with
``pallas_call`` wrapped so that it adds ``interpret=True`` and records each
kernel's inputs and output (through a debug callback, since three of the
calls run under ``jax.jit``).  Each recorded call's numpy inputs then go
through the port's plain version of that probe.

Tolerances: the gathers, shifts, the circulant copy and the three
64-iteration loops must be equal bit for bit (each loop iteration is one
float32 multiply, in the same order).  The three phi forms are held at
rtol = atol = 1e-5: XLA's and PyTorch's math libraries round differently,
and the forms amplify it where they cancel (softplus(a) - log(expm1(a))
near a = 5 leaves ~1e-6 of absolute float32 noise; exp(a) - 1 near
a = 1e-3 keeps ~4 significant digits, a few 1e-5 on phi ~ 7.6).  The CUDA kernels are held against the plain versions
in tests/test_torch_gpu.py.
"""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from feedback_gnn_tpu_torch import probes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = ("probe_pallas", "probe_pallas2")
PHI_TOL = dict(rtol=1e-5, atol=1e-5)

# Pallas kernel -> the port's plain version (with its default arguments,
# the scripts' constants)
PORT = {
    "k1": probes.take_rows_plain,
    "k2": probes.take_lanes_plain,
    "k2b": probes.take_along_lanes_plain,
    "k3": probes.roll_rows_plain,
    "k4": probes.circulant_copy_plain,
    "k5": probes.phi_softplus_expm1_plain,
    "k6": probes.gather_loop_plain,
    "ka": probes.take_along_rows_plain,
    "kb": probes.index_rows_plain,
    "kc": probes.phi_log_tanh_plain,
    "kd": probes.phi_exp_log1p_plain,
    "ke": probes.take_along_loop_plain,
    "kf": probes.roll_loop_plain,
}
PHI = {"k5", "kc", "kd"}


@pytest.fixture(scope="module")
def recorded():
    """{kernel name: (numpy inputs, numpy output)} of both scripts' first
    call of each Pallas kernel, in interpret mode."""
    rec = {}
    orig = pl.pallas_call

    def pallas_call(kernel, *args, **kwargs):
        call = orig(kernel, *args, interpret=True, **kwargs)
        name = kernel.__name__

        def run(*xs):
            out = call(*xs)

            def keep(*arrays):  # copies: the callback's arrays may alias buffers JAX reuses
                if name not in rec:
                    rec[name] = ([np.array(a) for a in arrays[:-1]], np.array(arrays[-1]))

            jax.debug.callback(keep, *xs, out)
            return out

        return run

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", pallas_call)
        for script in SCRIPTS:
            spec = importlib.util.spec_from_file_location(
                script, os.path.join(REPO, "scripts", f"{script}.py"))
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            mod.main()
    return rec


def test_every_pallas_probe_ran(recorded):
    assert sorted(recorded) == sorted(PORT)


@pytest.mark.parametrize("kernel", sorted(PORT))
def test_plain_matches_pallas_probe(recorded, kernel):
    inputs, ref = recorded[kernel]
    before = dict(probes.launches)
    out = PORT[kernel](*(torch.from_numpy(a) for a in inputs)).numpy()
    assert probes.launches == before
    assert out.shape == ref.shape and out.dtype == ref.dtype
    if kernel in PHI:
        np.testing.assert_allclose(out, ref, **PHI_TOL)
    else:
        np.testing.assert_array_equal(out, ref)


def test_probe_inputs_are_the_scripts(recorded):
    """probe_inputs rebuilds the scripts' arrays from the same seed."""
    inp = {k: v.numpy() for k, v in probes.probe_inputs("cpu").items()}
    np.testing.assert_array_equal(inp["x_sub"], recorded["k1"][0][0])
    np.testing.assert_array_equal(inp["perm"], recorded["k1"][0][1])
    np.testing.assert_array_equal(inp["x_lane"], recorded["k2"][0][0])
    np.testing.assert_array_equal(inp["idx2"], recorded["k2b"][0][1])
    np.testing.assert_array_equal(inp["idx_full"], recorded["ka"][0][1])


@pytest.mark.parametrize("probe", probes.probe_cases(probes.probe_inputs("cpu")), ids=lambda p: p.key)
def test_wrapper_takes_plain_on_cpu(probe):
    """On CPU tensors each wrapper returns its plain version's result and
    launches nothing."""
    before = dict(probes.launches)
    out = probe.fn(*probe.args)
    assert probes.launches == before
    assert probes.compare(probe, out, probe.plain(*probe.args)) == 0.0


@pytest.mark.parametrize("probe", probes.probe_cases(probes.probe_inputs("cpu")), ids=lambda p: p.key)
def test_wrapper_rejects_bad_inputs(probe):
    x, rest = probe.args[0], probe.args[1:]
    with pytest.raises(TypeError):
        probe.fn(x.double(), *rest)
    with pytest.raises(ValueError):
        probe.fn(x[None], *rest)
    if rest:
        with pytest.raises(TypeError):
            probe.fn(x, rest[0].long())
        with pytest.raises(ValueError):
            probe.fn(x, rest[0][:-1])


def test_phi_fast_mode_is_card_only():
    x = probes.probe_inputs("cpu")["x_sub"]
    for fn in (probes.phi_softplus_expm1, probes.phi_log_tanh, probes.phi_exp_log1p):
        with pytest.raises(ValueError, match="only in the CUDA kernel"):
            fn(x, fast=True)


def test_main_on_cpu(capsys):
    errs = probes.main("cpu", reps=1)
    assert sorted(errs) == sorted(PORT)
    lines = capsys.readouterr().out.splitlines()
    assert sum(line.startswith("PASS ") for line in lines) == len(PORT)
    assert sum(line.startswith("TIME ") for line in lines) == 3


def test_cols_per_block():
    """One column per block: a single pass takes a thread per element, a
    loop a block per column with its rows in shared memory."""
    assert probes._launch_shape(3840, 1, 3) == (0, probes.DIRECT_THREADS, 0)
    # the scripts' [3840, 128]: two buffers and the table of 3840 rows
    assert probes._launch_shape(3840, 64, 3) == (1, 1024, 4 * 3 * 3840)
    # a short, wide column: one warp
    assert probes._launch_shape(2, 2, 2) == (1, 32, 4 * 2 * 2)
    assert probes._launch_shape(33, 2, 2) == (1, 64, 4 * 2 * 33)
    with pytest.raises(ValueError, match="does not fit"):
        probes._launch_shape(20000, 64, 3)


def test_circulant_copy_needs_its_rows():
    x = probes.probe_inputs("cpu")["x_sub"]
    assert probes.circulant_copy(x[:probes.CIRC_LEN]).shape == (probes.CIRC_LEN, probes.B)
    with pytest.raises(ValueError, match="fewer than"):
        probes.circulant_copy(x[:probes.CIRC_LEN - 1])


@pytest.mark.parametrize("fn,args", [
    (probes.gather_loop, ("x", "perm")),
    (probes.take_along_loop, ("x", "idx_full")),
    (probes.roll_loop, ("x",)),
], ids=lambda v: getattr(v, "__name__", ""))
def test_loops_reject_no_iterations(fn, args):
    inp = dict(probes.probe_inputs("cpu"), x=probes.probe_inputs("cpu")["x_sub"])
    with pytest.raises(ValueError, match="iteration count"):
        fn(*(inp[a] for a in args), iters=0)
