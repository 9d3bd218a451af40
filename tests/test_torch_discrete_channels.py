"""The port's discrete channels (channels/discrete.py) against the JAX
package's, on JAX's own uniforms: each channel's output in both input
conventions and both output modes exactly, the straight-through
gradients with respect to the error probabilities at rtol 1e-5."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from feedback_gnn_tpu.channels import discrete as jd

from feedback_gnn_tpu_torch.channels import discrete as td

from test_torch_cascade import one_torch_thread  # noqa: F401  (autouse fixture)

SHAPE = (6, 50)
# (JAX channel, its pb, the port's (pb0, pb1) of the DMC core)
CHANNELS = {
    "bsc": (jd.binary_symmetric_channel, 0.2, lambda pb: (pb, pb)),
    "z": (jd.binary_z_channel, 0.3, lambda pb: (torch.zeros_like(pb), pb)),
    "dmc": (jd.binary_memoryless_channel, (0.1, 0.35), lambda pb: pb),
}


def _inputs(bipolar, seed=0):
    x = np.random.default_rng(seed).integers(0, 2, SHAPE).astype(np.float32)
    return 2.0 * x - 1.0 if bipolar else x


def _dmc_uniforms(key):
    """The two uniform draws binary_memoryless_channel makes from ``key``."""
    k0, k1 = jax.random.split(key)
    return [torch.tensor(np.asarray(jax.random.uniform(k, SHAPE + (2,), jnp.float32))) for k in (k0, k1)]


def _bec_uniforms(key):
    return torch.tensor(np.asarray(jax.random.uniform(key, SHAPE + (2,), jnp.float32)))


def _as_torch_pb(pb):
    if isinstance(pb, tuple):
        return tuple(torch.tensor(v, dtype=torch.float32) for v in pb)
    return torch.tensor(pb, dtype=torch.float32)


@pytest.mark.parametrize("return_llrs", [False, True])
@pytest.mark.parametrize("bipolar", [False, True])
@pytest.mark.parametrize("channel", list(CHANNELS))
def test_memoryless_channels_match_jax(channel, bipolar, return_llrs):
    fn, pb, core_pb = CHANNELS[channel]
    key = jax.random.PRNGKey(11)
    x = _inputs(bipolar)
    ref = np.asarray(fn(key, jnp.asarray(x), pb, bipolar_input=bipolar, return_llrs=return_llrs))
    u0, u1 = _dmc_uniforms(key)
    out = td.memoryless_from_uniforms(u0, u1, torch.tensor(x), core_pb(_as_torch_pb(pb)),
                                      bipolar_input=bipolar, return_llrs=return_llrs)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=0)
    assert 0 < int((out.numpy() != (x if not return_llrs else 0)).sum())  # some flips or LLRs


@pytest.mark.parametrize("return_llrs", [False, True])
@pytest.mark.parametrize("bipolar", [False, True])
def test_erasure_channel_matches_jax(bipolar, return_llrs):
    key = jax.random.PRNGKey(12)
    x = _inputs(bipolar)
    ref = np.asarray(jd.binary_erasure_channel(key, jnp.asarray(x), 0.25, bipolar_input=bipolar,
                                               return_llrs=return_llrs))
    out = td.erasure_from_uniforms(_bec_uniforms(key), torch.tensor(x), 0.25, bipolar_input=bipolar,
                                   return_llrs=return_llrs)
    np.testing.assert_array_equal(out.numpy(), ref)
    erased = 0.0 if (bipolar or return_llrs) else -1.0
    assert 0 < int((out.numpy() == erased).sum()) < x.size


@pytest.mark.parametrize("return_llrs", [False, True])
@pytest.mark.parametrize("channel", ["bsc", "z", "dmc"])
def test_straight_through_gradients_match_jax(channel, return_llrs):
    """d/dpb of a weighted sum of the output, through the Gumbel softmax,
    the binarizer and the XOR (both straight-through).  (The BEC's output
    selects between its inputs and constants: no gradient reaches pb.)"""
    key = jax.random.PRNGKey(13)
    x = _inputs(False, seed=1)
    w = np.random.default_rng(2).normal(size=SHAPE).astype(np.float32)
    pb = np.array([0.15, 0.3], np.float32) if channel == "dmc" else np.float32(0.2)

    def jax_out(pb_):
        pbs = (pb_[0], pb_[1]) if channel == "dmc" else pb_
        return jnp.sum(CHANNELS[channel][0](key, jnp.asarray(x), pbs, return_llrs=return_llrs) * w)

    ref = np.asarray(jax.grad(jax_out)(jnp.asarray(pb)))
    tpb = torch.tensor(pb, requires_grad=True)
    core = (tpb[0], tpb[1]) if channel == "dmc" else CHANNELS[channel][2](tpb)
    y = td.memoryless_from_uniforms(*_dmc_uniforms(key), torch.tensor(x), core, return_llrs=return_llrs)
    (y * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(tpb.grad.numpy(), ref, rtol=1e-5, atol=1e-6)
    assert np.all(ref != 0)


def test_ste_primitives_forward_and_identity_gradients():
    a = torch.tensor([0.0, 1.0, 1.0, 0.0], requires_grad=True)
    b = torch.tensor([0.0, 0.0, 1.0, 1.0], requires_grad=True)
    y = td.xor_ste(a, b)
    (y * torch.arange(1.0, 5.0)).sum().backward()
    ja, jb = jnp.asarray(a.detach().numpy()), jnp.asarray(b.detach().numpy())
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jd.xor_ste(ja, jb)))
    ga, gb = jax.grad(lambda u, v: jnp.sum(jd.xor_ste(u, v) * jnp.arange(1.0, 5.0)), (0, 1))(ja, jb)
    np.testing.assert_array_equal(a.grad.numpy(), np.asarray(ga))
    np.testing.assert_array_equal(b.grad.numpy(), np.asarray(gb))
    x = torch.tensor([0.2, 0.5, 0.7], requires_grad=True)
    z = td.ste_binarize(x)
    z.sum().backward()
    np.testing.assert_array_equal(z.detach().numpy(), np.asarray(jd.ste_binarize(jnp.asarray([0.2, 0.5, 0.7]))))
    np.testing.assert_array_equal(x.grad.numpy(), np.ones(3, np.float32))


def test_channels_draw_from_the_generator():
    """Sampled channels: the error rate of a BSC and a BEC near pb, the
    Z-channel never flipping a 0, and a generator's seed repeating its draw."""
    x = torch.zeros((200, 500))
    x[:100] = 1.0

    def gen():
        return torch.Generator().manual_seed(5)

    flips = td.binary_symmetric_channel(gen(), x, 0.1) != x
    assert abs(float(flips.float().mean()) - 0.1) < 0.01
    assert torch.equal(td.binary_symmetric_channel(gen(), x, 0.1), td.binary_symmetric_channel(gen(), x, 0.1))
    z = td.binary_z_channel(gen(), x, 0.3)
    assert not z[100:].any() and abs(float((z[:100] == 0).float().mean()) - 0.3) < 0.02
    erased = td.binary_erasure_channel(gen(), x, 0.2) == -1.0
    assert abs(float(erased.float().mean()) - 0.2) < 0.01
    e = td.sample_errors_gumbel(gen(), 0.05, (400, 500))
    assert e.shape == (400, 500) and abs(float(e.mean()) - 0.05) < 0.005
