"""PyTorch port, gossip kernels on the CPU: the plain versions of
``gossip_mix_flat`` and ``gossip_mix_fused_dp`` against the JAX Pallas
kernels (interpret mode) and ``kernels/ref.gossip_mix_ref``, at 1e-5 (the
tolerance tests/test_kernels.py uses for mixes); the Eq. (1) weight matrix
(1e-6) and the comm accounting (exact) against core/gossip. The CUDA
kernels themselves are held against these plain versions on the card in
tests/test_torch_gpu.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.gossip import GossipSpec as JSpec
from repro.core.gossip import fedspd_weight_matrix as j_weights
from repro.core.gossip import round_comm_bytes as j_comm
from repro.graphs.topology import make_graph as j_graph
from repro.kernels.gossip_mix import gossip_mix_flat as j_flat
from repro.kernels.gossip_mix import gossip_mix_fused_dp as j_fused
from repro.kernels.ref import gossip_mix_ref
from repro_torch.core.gossip import GossipSpec, fedspd_weight_matrix, make_mix_fn
from repro_torch.core.gossip import round_comm_bytes
from repro_torch.graphs.topology import make_graph
from repro_torch.kernels.gossip_mix import (
    gossip_mix_flat,
    gossip_mix_flat_ref,
    gossip_mix_fused_dp,
    gossip_mix_fused_dp_ref,
    reset_launch_counts,
)

TOL = 1e-5
# (N, X): the tests' plane, an odd X, N not a power of two, N above one
# 32-row chunk of the CUDA kernel
SHAPES = [(8, 10692), (5, 1001), (20, 333), (37, 129)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tensors are tiny: torch's intra-op thread pool only spins on
    them and takes CPU from the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _operands(n, x, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.random((n, n)).astype(np.float32)
    w /= w.sum(axis=1, keepdims=True)
    c_old = rng.standard_normal((n, x)).astype(np.float32)
    c_new = (c_old + 0.3 * rng.standard_normal((n, x))).astype(np.float32)
    scale = rng.uniform(0.2, 1.0, (n, 1)).astype(np.float32)
    noise = rng.standard_normal((n, x)).astype(np.float32)
    return w, c_old, c_new, scale, noise


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("n,x", SHAPES)
def test_flat_ref_matches_pallas_and_jnp_reference(n, x):
    w, c, *_ = _operands(n, x)
    got = gossip_mix_flat_ref(*_t(w, c)).numpy()
    np.testing.assert_allclose(got, np.asarray(j_flat(jnp.asarray(w), jnp.asarray(c),
                                                      interpret=True)), atol=TOL, rtol=0)
    np.testing.assert_allclose(got, np.asarray(gossip_mix_ref(jnp.asarray(w),
                                                              jnp.asarray(c))),
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("sigma", [0.0, 0.5])
@pytest.mark.parametrize("n,x", SHAPES)
def test_fused_dp_ref_matches_pallas(n, x, sigma):
    w, co, cn, sc, nz = _operands(n, x, seed=1)
    noise = nz if sigma > 0 else None
    got = gossip_mix_fused_dp_ref(*_t(w, co, cn, sc),
                                  torch.as_tensor(noise) if sigma > 0 else None,
                                  sigma).numpy()
    want = j_fused(jnp.asarray(w), jnp.asarray(co), jnp.asarray(cn),
                   jnp.asarray(sc), None if noise is None else jnp.asarray(noise),
                   sigma, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=0)
    # and the unfused composition: sanitize, then the flat mix
    c_sel = co + sc * (cn - co) + (sigma * nz if sigma > 0 else 0.0)
    np.testing.assert_allclose(got, np.asarray(gossip_mix_ref(jnp.asarray(w),
                                                              jnp.asarray(c_sel))),
                               atol=TOL, rtol=0)


def test_wrappers_take_the_plain_version_on_cpu_and_count_no_launch():
    reset_launch_counts()
    w, co, cn, sc, nz = _operands(8, 300)
    tw, tco, tcn, tsc, tnz = _t(w, co, cn, sc, nz)
    assert torch.equal(gossip_mix_flat(tw, tco), gossip_mix_flat_ref(tw, tco))
    assert torch.equal(gossip_mix_fused_dp(tw, tco, tcn, tsc, tnz, 0.5),
                       gossip_mix_fused_dp_ref(tw, tco, tcn, tsc, tnz, 0.5))
    assert torch.equal(gossip_mix_fused_dp(tw, tco, tcn, tsc, None, 0.0),
                       gossip_mix_fused_dp_ref(tw, tco, tcn, tsc, None, 0.0))
    assert gossip_mix_flat.launches == 0
    assert gossip_mix_fused_dp.launches == 0
    with pytest.raises(ValueError, match="sigma"):
        gossip_mix_fused_dp(tw, tco, tcn, tsc, None, 0.5)


def _weighted_adj(n, seed):
    rng = np.random.default_rng(seed)
    adj = make_graph("er", n, 3.0, seed=seed).adj.copy()
    decay = rng.uniform(0.2, 1.0, (n,)).astype(np.float32)
    adj = adj * decay[None, :]                 # stale senders' columns
    off = int(rng.integers(n))
    adj[off, :] = 0.0                          # an unavailable client
    adj[:, off] = 0.0
    return adj


@pytest.mark.parametrize("n,seed", [(8, 0), (20, 3), (13, 5)])
def test_weight_matrix_and_comm_bytes_match_jax(n, seed):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 2, (n,))
    g = make_graph("er", n, 3.0, seed=seed)
    assert np.array_equal(g.adj, j_graph("er", n, 3.0, seed=seed).adj)
    spec, jspec = GossipSpec.from_graph(g), JSpec.from_graph(g)
    ts = torch.as_tensor(s)
    model_bytes = 42768
    adj = _weighted_adj(n, seed)
    for a in (None, adj):
        ta = None if a is None else torch.as_tensor(a)
        ja = None if a is None else jnp.asarray(a)
        w = fedspd_weight_matrix(spec, ts, adj=ta)
        np.testing.assert_allclose(w.numpy(), np.asarray(j_weights(jspec, jnp.asarray(s),
                                                                   adj=ja)),
                                   atol=1e-6, rtol=0)
        assert torch.allclose(w.sum(dim=1), torch.ones(n))
        for p2p in (True, False):
            got = round_comm_bytes(spec, ts, model_bytes, point_to_point=p2p, adj=ta)
            want = j_comm(jspec, jnp.asarray(s), model_bytes,
                          point_to_point=p2p, adj=ja)
            assert got.dtype == torch.float32
            assert float(got) == float(want)


def test_cuda_backend_mix_on_cpu_equals_reference_backend():
    """"reference" names the same path as "cuda": on CPU tensors both run
    the kernels' plain versions and launch nothing."""
    g = make_graph("er", 8, 3.0, seed=1)
    spec = GossipSpec.from_graph(g)
    _, c, cn, sc, nz = _t(*_operands(8, 500))
    s = torch.tensor([0, 1, 1, 0, 0, 1, 0, 1])
    reset_launch_counts()
    cuda_mix, ref_mix = make_mix_fn(spec, "cuda"), make_mix_fn(spec, "reference")
    w = fedspd_weight_matrix(spec, s)
    assert torch.equal(cuda_mix(c, s), ref_mix(c, s))
    assert torch.equal(cuda_mix(c, s), gossip_mix_flat_ref(w, c))
    assert torch.allclose(cuda_mix(c, s), w @ c, atol=TOL, rtol=0)
    fused = cuda_mix.fused_dp(c, cn, sc, nz, 0.5, s)
    assert torch.equal(fused, ref_mix.fused_dp(c, cn, sc, nz, 0.5, s))
    assert torch.allclose(fused, cuda_mix(c + sc * (cn - c) + 0.5 * nz, s),
                          atol=TOL, rtol=0)
    assert gossip_mix_flat.launches == 0 and gossip_mix_fused_dp.launches == 0
    with pytest.raises(ValueError, match="pallas"):
        make_mix_fn(spec, "pallas")
