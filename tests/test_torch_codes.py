"""The port's code layer (feedback_gnn_tpu_torch.codes) against the JAX
package's: every array of QuantumGraph and QCPair equal bit for bit."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import feedback_gnn_tpu.codes as jc
from feedback_gnn_tpu.codes.graph import QuantumGraph as JQuantumGraph
from feedback_gnn_tpu.codes.qc import qc_pair_from_code as j_qc_pair

import feedback_gnn_tpu_torch.codes as tc


def _builders(name):
    if name == "surface3":
        return jc.create_surface_codes(3), tc.create_surface_codes(3)
    if name == "gb48":
        args = (24, [0, 2, 8, 15], [0, 2, 12, 17])
        return jc.create_generalized_bicycle_codes(*args), tc.create_generalized_bicycle_codes(*args)
    if name == "ghp882":
        return jc.ghp_882_24(), tc.ghp_882_24()
    return jc.ghp_1270_28(), tc.ghp_1270_28()


def _assert_same_fields(a, b, path):
    assert type(a).__name__ == type(b).__name__, path
    for f in dataclasses.fields(b):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(vb):
            _assert_same_fields(va, vb, f"{path}.{f.name}")
        elif isinstance(vb, np.ndarray):
            assert va.dtype == vb.dtype, f"{path}.{f.name}"
            np.testing.assert_array_equal(va, vb, err_msg=f"{path}.{f.name}")
        else:
            assert va == vb, f"{path}.{f.name}"


@pytest.mark.parametrize("name", ["surface3", "gb48", "ghp882", "ghp1270"])
def test_code_and_graph_equal_jax(name):
    jcode, tcode = _builders(name)
    for attr in ("hx", "hz", "hx_perp", "hz_perp", "lx", "lz"):
        np.testing.assert_array_equal(getattr(jcode, attr), getattr(tcode, attr), err_msg=attr)
    assert (jcode.N, jcode.K, jcode.D, jcode.name) == (tcode.N, tcode.K, tcode.D, tcode.name)
    for stage_mode in (True, False):
        _assert_same_fields(
            JQuantumGraph.from_code(jcode, stage_mode=stage_mode),
            tc.QuantumGraph.from_code(tcode, stage_mode=stage_mode),
            "QuantumGraph",
        )


@pytest.mark.parametrize("name", ["gb48", "ghp882", "ghp1270"])
def test_qc_pair_equal_jax(name):
    jcode, tcode = _builders(name)
    jq, tq = j_qc_pair(jcode), tc.qc_pair_from_code(tcode)
    assert tq is not None
    assert (jq.l, jq.n, jq.name) == (tq.l, tq.n, tq.name)
    for side in ("qx", "qz"):
        js, ts = getattr(jq, side), getattr(tq, side)
        assert (js.l, js.mb, js.nb, js.groups, js.cn_groups, js.vn_groups) == (
            ts.l, ts.mb, ts.nb, ts.groups, ts.cn_groups, ts.vn_groups)


def test_surface_code_has_no_qc_structure():
    assert tc.qc_pair_from_code(tc.create_surface_codes(3)) is None


def test_graph_to_device_makes_tensors():
    g = tc.QuantumGraph.from_code(tc.create_surface_codes(3)).to("cpu")
    assert g.hx.dtype == torch.float32 and g.gx.edge_cn_byslot.dtype == torch.int64
    assert g.logit_rows_x.vn_idx.dtype == torch.int64 and g.gz.vn_mask.dtype == torch.float32
    assert g.n_pad == g.gx.n_pad and isinstance(g.n_pad, int)


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import feedback_gnn_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in ['entry', 'models', 'sim.metrics', 'channels.bsc', 'decoders.bp2',\n"
        "             'decoders.bp2_qc', 'decoders.graph_ops', 'decoders.bp4', 'probes',\n"
        "             'config', 'sim.montecarlo', 'sim.plotting', 'decoders.osd',\n"
        "             'cli.evaluate', 'cli.osd_eval', 'cli.bench']:\n"
        "    assert pkg.__name__ + '.' + name in mods, name\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'feedback_gnn_tpu' or m.startswith('feedback_gnn_tpu.')]\n"
        "assert not bad, bad\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=repo)


def test_resolve_device_never_falls_back():
    from feedback_gnn_tpu_torch import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device()
