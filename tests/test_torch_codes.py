"""The port's code layer (feedback_gnn_tpu_torch.codes) against the JAX
package's: every array of QuantumGraph and QCPair equal bit for bit, every
constructor's matrices and parameters, and the GF(2) helpers."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import feedback_gnn_tpu.codes as jc
from feedback_gnn_tpu.codes import gf2 as jgf2
from feedback_gnn_tpu.codes.graph import QuantumGraph as JQuantumGraph
from feedback_gnn_tpu.codes.qc import qc_pair_from_code as j_qc_pair

import feedback_gnn_tpu_torch.codes as tc
from feedback_gnn_tpu_torch.codes import gf2 as tgf2


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
        "             'cli.evaluate', 'cli.osd_eval', 'cli.bench', 'train.loss', 'train.trainer',\n"
        "             'train.data', 'io.checkpoint', 'cli.train', 'cli.train_from_scratch',\n"
        "             'cli.generate_dataset', 'decoders.gnn_full', 'channels.discrete',\n"
        "             'cli.train_gnn_bp4', 'cli.qldpc_codes', 'cli.n882', 'cli.n1270']:\n"
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


# ---- the constructors ported with the code zoo ------------------------------------

NEW_CODES = {
    "steane": lambda m: m.CSSCode(m.hamming_code(3), m.hamming_code(3), name="Steane"),
    "hamming4": lambda m: m.CSSCode(m.hamming_code(4), m.hamming_code(4)),
    "rotated3": lambda m: m.create_rotated_surface_codes(3),
    "rotated5": lambda m: m.create_rotated_surface_codes(5),
    "toric4": lambda m: m.create_checkerboard_toric_codes(4),
    "toric6": lambda m: m.create_checkerboard_toric_codes(6),
    "bivariate72": lambda m: m.create_bivariate_QC_codes(6, 6, [3], [1, 2], [1, 2], [3]),
    "gb48_oc": lambda m: m.gb_n48_k6_d8_oc(),
    "gb46_oc": lambda m: m.gb_n46_k2_d9_oc(),
}


@pytest.mark.parametrize("name", list(NEW_CODES))
def test_new_constructors_equal_jax(name):
    jcode, tcode = NEW_CODES[name](jc), NEW_CODES[name](tc)
    for attr in ("hx", "hz", "hx_perp", "hz_perp", "lx", "lz", "pivot_hx", "pivot_hz"):
        np.testing.assert_array_equal(np.asarray(getattr(jcode, attr)), np.asarray(getattr(tcode, attr)),
                                      err_msg=attr)
    assert (jcode.N, jcode.K, jcode.D, jcode.L, jcode.Q, jcode.name) == (
        tcode.N, tcode.K, tcode.D, tcode.L, tcode.Q, tcode.name)


@pytest.mark.parametrize("name", ["steane", "toric4", "bivariate72"])
def test_canonical_logicals_equal_jax(name):
    jcode, tcode = NEW_CODES[name](jc), NEW_CODES[name](tc)
    jcode.canonical_logicals()
    tcode.canonical_logicals()
    np.testing.assert_array_equal(jcode.lx, tcode.lx)
    np.testing.assert_array_equal(tcode.lx @ tcode.lz.T % 2, np.eye(tcode.K, dtype=int))


def _full_rank(rng, rows, cols):
    while True:
        m = rng.integers(0, 2, (rows, cols))
        if jgf2.rank(m) == min(rows, cols):
            return m


@pytest.mark.parametrize("shape", [(9, 9), (12, 7), (30, 40)])
def test_gf2_rank_and_inverse_equal_jax(shape):
    rng = np.random.default_rng(sum(shape))
    m = rng.integers(0, 2, shape)
    assert tgf2.rank(m) == jgf2.rank(m)
    if shape[0] >= shape[1]:
        a = _full_rank(rng, *shape)
        inv = tgf2.inverse(a)
        np.testing.assert_array_equal(inv, jgf2.inverse(a))
        np.testing.assert_array_equal(inv @ a % 2, np.eye(shape[1], dtype=int))
    else:
        with pytest.raises(ValueError, match="not invertible"):
            tgf2.inverse(m)


@pytest.mark.parametrize("num,length", [(0, 3), (5, 3), (6, 4), (13, 4), (9, 2), (1, 0)])
def test_int2bin_equals_jax(num, length):
    assert tgf2.int2bin(num, length) == jgf2.int2bin(num, length)


@pytest.mark.parametrize("with_degrees", [True, False])
def test_read_alist_equals_jax(tmp_path, with_degrees):
    """An alist file of a random PCM, with and without the per-column and
    per-row degree lines."""
    pcm = np.random.default_rng(4).integers(0, 2, (5, 8))
    pcm[:, 0] = 1  # no empty column
    cols = [list(np.nonzero(pcm[:, c])[0] + 1) for c in range(8)]
    rows = [list(np.nonzero(pcm[r])[0] + 1) for r in range(5)]
    width = max(map(len, cols))
    lines = [f"8 5", f"{width} {max(map(len, rows))}"]
    if with_degrees:
        lines += [" ".join(str(len(c)) for c in cols), " ".join(str(len(r)) for r in rows)]
    lines += [" ".join(str(v) for v in c + [0] * (width - len(c))) for c in cols]
    path = tmp_path / "h.alist"
    path.write_text("\n".join(lines) + "\n")
    out = tc.read_alist(str(path))
    np.testing.assert_array_equal(out, jc.read_alist(str(path)))
    np.testing.assert_array_equal(out, pcm)
