"""The port's device ops and channels: mod2_matmul exactness, Pauli
sampler statistics (torch and JAX streams differ, so only distributions
are compared)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from feedback_gnn_tpu.ops.gf2mat import mod2_matmul as j_mod2_matmul
from feedback_gnn_tpu.ops.dense import dense_bl as j_dense_bl

from feedback_gnn_tpu_torch.channels import depolarizing_probs, pauli_fixed_weight, pauli_iid
from feedback_gnn_tpu_torch.ops import dense_bl, mod2_matmul


@pytest.mark.parametrize("m,n,b,density", [(40, 1300, 16, 0.5), (24, 48, 8, 0.3)])
def test_mod2_matmul_exact(m, n, b, density):
    """Exact parity, including row sums far above 256 (where a bfloat16
    result would round) — the n=1300 case has sums around 325."""
    rng = np.random.default_rng(0)
    h = (rng.random((m, n)) < density).astype(np.float32)
    v = (rng.random((n, b)) < density).astype(np.int32)
    sums = h.astype(np.int64) @ v
    if n > 1000:
        assert sums.max() > 256
    out = mod2_matmul(torch.as_tensor(h), torch.as_tensor(v))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), sums % 2)
    np.testing.assert_array_equal(out.numpy(), np.asarray(j_mod2_matmul(jnp.asarray(h), jnp.asarray(v))))


def test_dense_bl_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5, 7, 3)).astype(np.float32)
    k = rng.standard_normal((5, 4)).astype(np.float32)
    bias = rng.standard_normal(4).astype(np.float32)
    ref = j_dense_bl(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias), jnp.tanh)
    out = dense_bl(torch.as_tensor(x), torch.as_tensor(k), torch.as_tensor(bias), torch.tanh)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_pauli_iid_rates():
    """Per-Pauli rates within 5 sigma of p/3 each (pure X, Y, Z)."""
    p, n, b = 0.12, 200, 2000
    g = torch.Generator().manual_seed(0)
    nx, nz = pauli_iid(g, *depolarizing_probs(p), n, b)
    assert nx.shape == (n, b) and nx.dtype == torch.bool
    total = n * b
    for got in ((nx & ~nz).sum(), (nx & nz).sum(), (~nx & nz).sum()):
        sigma = np.sqrt(total * (p / 3) * (1 - p / 3))
        assert abs(int(got) - total * p / 3) < 5 * sigma


def test_pauli_fixed_weight_exact_weight():
    wt, n, b = 7, 50, 300
    g = torch.Generator().manual_seed(1)
    nx, nz = pauli_fixed_weight(g, wt, n, b)
    assert nx.shape == (n, b)
    np.testing.assert_array_equal((nx | nz).sum(dim=0).numpy(), np.full(b, wt))
    # each error is X, Y or Z with probability 1/3
    y = int((nx & nz).sum())
    sigma = np.sqrt(wt * b / 3 * (2 / 3))
    assert abs(y - wt * b / 3) < 5 * sigma
