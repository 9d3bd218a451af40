"""No module of the benchmark imports JAX, Flax or the JAX package, and the
reference imports nothing of the program; names compared whole, by the part
before the first dot."""

import ast
import os

from benchmark.run import forbidden_modules

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_NAMES = {"jax", "jaxlib", "flax", "feedback_gnn_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


def _top(name):
    return name.split(".")[0]


def _sources(root):
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_imports_jax_or_the_jax_package():
    bad = [(p, m) for p in _sources(BENCH) if "/tests/" not in p for m in _imports(p) if _top(m) in JAX_NAMES]
    assert bad == []


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    bad = [(p, m) for p in _sources(ref) for m in _imports(p)
           if _top(m) in JAX_NAMES | {"feedback_gnn_tpu_torch"}]
    assert bad == []
    assert len(list(_sources(ref))) >= 4


def test_the_scan_sees_imports(tmp_path):
    path = tmp_path / "probe.py"
    path.write_text("import jax.numpy as jnp\nfrom feedback_gnn_tpu.codes import x\nimport feedback_gnn_tpu_torch\n")
    tops = [_top(m) for m in _imports(str(path))]
    assert tops == ["jax", "feedback_gnn_tpu", "feedback_gnn_tpu_torch"]


def test_the_port_does_not_trip_the_jax_rule():
    assert forbidden_modules(["feedback_gnn_tpu_torch", "feedback_gnn_tpu_torch.decoders.cascade",
                              "torch", "jaxtyping", "flaxen"]) == []
    assert forbidden_modules(["feedback_gnn_tpu.codes", "jax", "jaxlib.xla_client", "flax.linen"]) == [
        "feedback_gnn_tpu.codes", "flax.linen", "jax", "jaxlib.xla_client"]
