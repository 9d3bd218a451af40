"""The port's checkpoints (io/checkpoint.py) and reference weight pickles
(decoders/gnn_feedback.py) against the JAX package's: each package loads
what the other writes, with equal arrays.  The robustness cases mirror
tests/test_checkpoint.py."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from feedback_gnn_tpu.decoders import gnn_feedback as jgnn
from feedback_gnn_tpu.io import checkpoint as jck

from feedback_gnn_tpu_torch import REPO_ROOT
from feedback_gnn_tpu_torch.decoders import gnn_feedback as tgnn
from feedback_gnn_tpu_torch.io import checkpoint as tck

WEIGHTS_DIR = os.path.join(REPO_ROOT, "feedback_gnn_tpu", "weights")
SHIPPED = sorted(f for f in os.listdir(WEIGHTS_DIR) if f.endswith(".npz"))


def _tree():
    return {
        "a": {"kernel": torch.arange(6.0).reshape(2, 3), "bias": torch.ones(3)},
        "b": [torch.full((4,), 2.0), torch.full((2, 2), 7.0)],
    }


def _zeros_like(tree):
    return jax.tree_util.tree_map(torch.zeros_like, tree)


def _assert_equal_trees(out, ref):
    flat_o, flat_r = tck.flatten_with_paths(out), tck.flatten_with_paths(ref)
    assert list(flat_o) == list(flat_r)
    for key in flat_r:
        np.testing.assert_array_equal(np.asarray(flat_o[key]), np.asarray(flat_r[key]), err_msg=key)


def _jax_flat(tree):
    """{key: array} of a JAX pytree, keyed as the JAX package keys it."""
    return jck._flatten_with_paths(tree)


def test_roundtrip(tmp_path):
    t = _tree()
    path = str(tmp_path / "ck.npz")
    tck.save_pytree(t, path)
    out = tck.load_pytree(path, like=_zeros_like(t))
    _assert_equal_trees(out, t)
    assert all(isinstance(v, torch.Tensor) for v in tck.flatten_with_paths(out).values())
    assert os.listdir(tmp_path) == ["ck.npz"]  # no temporary file left


def test_load_is_order_independent(tmp_path):
    t = _tree()
    path = str(tmp_path / "ck.npz")
    tck.save_pytree(t, path)
    data = dict(np.load(path))
    shuffled = str(tmp_path / "ck_shuffled.npz")
    np.savez(shuffled, **{k: data[k] for k in reversed(list(data))})
    _assert_equal_trees(tck.load_pytree(shuffled, like=_zeros_like(t)), t)


def test_load_rejects_missing_leaf(tmp_path):
    t = _tree()
    path = str(tmp_path / "ck.npz")
    tck.save_pytree(t, path)
    data = dict(np.load(path))
    data.pop(list(data)[0])
    pruned = str(tmp_path / "ck_pruned.npz")
    np.savez(pruned, **data)
    with pytest.raises(KeyError):
        tck.load_pytree(pruned, like=t)


def test_keys_and_order_are_jax_s():
    params = jgnn.init_feedback_gnn(jax.random.PRNGKey(0))
    tparams = tgnn.params_from_numpy(jax.tree_util.tree_map(np.asarray, params))
    assert list(tck.flatten_with_paths(tparams)) == list(_jax_flat(params))


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    params = jgnn.init_feedback_gnn(jax.random.PRNGKey(3))
    path = str(tmp_path / "jax.npz")
    jck.save_pytree(params, path)
    like = tgnn.init_feedback_gnn(torch.Generator().manual_seed(0))
    out = tck.load_pytree(path, like=like)
    _assert_equal_trees(out, tgnn.params_from_numpy(jax.tree_util.tree_map(np.asarray, params)))


def test_port_checkpoint_loads_in_jax(tmp_path):
    params = tgnn.init_feedback_gnn(torch.Generator().manual_seed(4))
    path = str(tmp_path / "port.npz")
    tck.save_pytree(params, path)
    out = jck.load_pytree(path, like=jgnn.init_feedback_gnn(jax.random.PRNGKey(0)))
    ref = tck.flatten_with_paths(params)
    for key, leaf in _jax_flat(out).items():
        np.testing.assert_array_equal(leaf, ref[key].numpy(), err_msg=key)
    # and through the JAX package's weight loader
    loaded = jgnn.load_weights(path)
    for key, leaf in _jax_flat(loaded).items():
        np.testing.assert_array_equal(leaf, ref[key].numpy(), err_msg=key)


def test_jax_pickle_loads_in_the_port(tmp_path):
    params = jgnn.init_feedback_gnn(jax.random.PRNGKey(5))
    params = jax.tree_util.tree_map(lambda a: a + 0.25, params)  # no zero kernel
    path = str(tmp_path / "ref.pkl")
    jgnn.save_reference_weights(params, path)
    out = tgnn.load_weights(path)
    ref = _jax_flat(params)
    for key, leaf in tck.flatten_with_paths(out).items():
        assert leaf.dtype == torch.float32
        np.testing.assert_array_equal(leaf.numpy(), ref[key], err_msg=key)


def test_port_pickle_loads_in_jax(tmp_path):
    params = tgnn.init_feedback_gnn(torch.Generator().manual_seed(6))
    path = str(tmp_path / "port.pkl")
    tgnn.save_reference_weights(params, path)
    with open(path, "rb") as f:
        raw = f.read()
    jpath = str(tmp_path / "jax.pkl")
    jgnn.save_reference_weights(jgnn.load_reference_weights(path), jpath)
    with open(jpath, "rb") as f:
        assert f.read() == raw  # the same 12-array pickle, byte for byte
    ref = tck.flatten_with_paths(params)
    for key, leaf in _jax_flat(jgnn.load_weights(path)).items():
        np.testing.assert_array_equal(leaf, ref[key].numpy(), err_msg=key)


@pytest.mark.parametrize("name", SHIPPED)
def test_shipped_weights_and_their_pickle_load_equal(tmp_path, name):
    """A shipped npz, its reference-pickle export and JAX's load of it give
    equal parameters."""
    path = os.path.join(WEIGHTS_DIR, name)
    params = tgnn.load_weights(path)
    pkl = str(tmp_path / "w.pkl")
    tgnn.save_reference_weights(params, pkl)
    again = tgnn.load_weights(pkl)
    _assert_equal_trees(again, params)
    ref = _jax_flat(jgnn.load_weights(path))
    for key, leaf in tck.flatten_with_paths(params).items():
        np.testing.assert_array_equal(leaf.numpy(), ref[key], err_msg=key)


def test_load_pytree_device_and_dtype(tmp_path):
    t = {"w": torch.arange(4, dtype=torch.float64), "n": np.arange(3, dtype=np.int32)}
    path = str(tmp_path / "ck.npz")
    tck.save_pytree(t, path)
    out = tck.load_pytree(path, like={"w": torch.zeros(4, dtype=torch.float64), "n": np.zeros(3, np.int32)},
                          device="cpu")
    assert out["w"].dtype == torch.float64 and isinstance(out["n"], np.ndarray)
    np.testing.assert_array_equal(out["n"], t["n"])
    assert torch.equal(out["w"], t["w"])
    # JAX reads it too
    jout = jck.load_pytree(path, like={"w": jnp.zeros(4), "n": jnp.zeros(3)})
    np.testing.assert_array_equal(np.asarray(jout["w"]), np.arange(4.0))
