"""PyTorch port, model substrate: the batched MLP/linear forward, the fp32
cross entropy and the per-client gradients of an (N, X) slab, from
JAX-initialised parameters (tolerance 1e-5: fp32, one op each)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.packing import make_pack_spec as j_make_pack_spec
from repro.core.packing import pack as j_pack
from repro.models.layers import softmax_xent as j_xent
from repro.models.smallnets import make_classifier as j_classifier
from repro_torch.core.clustering import cluster_all_clients
from repro_torch.core.packing import flat_grad, make_pack_spec, unpack
from repro_torch.interop import params_from_numpy
from repro_torch.models.layers import softmax_xent
from repro_torch.models.smallnets import make_classifier

N, B, DIM, C = 8, 32, 16, 4
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tensors are tiny: torch's intra-op thread pool only spins on
    them and takes CPU from the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(kind):
    keys = jax.random.split(jax.random.PRNGKey(3), N)
    _, j_apply, j_loss, j_pel, j_acc = j_classifier(kind, keys[0], DIM, C)
    init = jax.vmap(lambda k: j_classifier(kind, k, DIM, C)[0])
    jparams = init(keys)                                   # leaves (N, ...)
    one = jax.tree.map(lambda l: l[0], jparams)
    jspec = j_make_pack_spec(one)
    slab = np.array(j_pack(jparams, jspec))                # (N, X)
    spec = make_pack_spec(params_from_numpy(jax.tree.map(np.asarray, one), device="cpu"))
    _, t_apply, t_loss, t_pel, t_acc = make_classifier(
        kind, torch.Generator().manual_seed(0), DIM, C)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((N, B, DIM)).astype(np.float32)
    y = rng.integers(0, C, (N, B))
    return (jparams, j_apply, j_loss, j_pel, j_acc, jspec, slab,
            spec, t_apply, t_loss, t_pel, t_acc, x, y)


@pytest.mark.parametrize("kind", ["mlp", "linear"])
def test_batched_forward_loss_and_accuracy_match_jax(kind):
    (jparams, j_apply, j_loss, j_pel, j_acc, _, slab,
     spec, t_apply, t_loss, t_pel, t_acc, x, y) = _setup(kind)
    tparams = unpack(torch.as_tensor(slab), spec)
    jb = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    tb = {"x": torch.as_tensor(x), "y": torch.as_tensor(y)}
    np.testing.assert_allclose(t_apply(tparams, tb["x"]).numpy(),
                               np.asarray(jax.vmap(j_apply)(jparams, jb["x"])),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(t_pel(tparams, tb).numpy(),
                               np.asarray(jax.vmap(j_pel)(jparams, jb)),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(t_loss(tparams, tb).numpy(),
                               np.asarray(jax.vmap(j_loss)(jparams, jb)),
                               atol=TOL, rtol=0)
    np.testing.assert_array_equal(t_acc(tparams, tb).numpy(),
                                  np.asarray(jax.vmap(j_acc)(jparams, jb)))


def test_softmax_xent_matches_jax_including_large_logits():
    rng = np.random.default_rng(2)
    logits = (rng.standard_normal((3, 7, 10)) * 30).astype(np.float32)
    labels = rng.integers(0, 10, (3, 7))
    np.testing.assert_allclose(
        softmax_xent(torch.as_tensor(logits), torch.as_tensor(labels)).numpy(),
        np.asarray(j_xent(jnp.asarray(logits), jnp.asarray(labels))),
        atol=TOL, rtol=1e-6)


@pytest.mark.parametrize("kind", ["mlp", "linear"])
def test_per_client_gradients_of_the_slab_match_jax(kind):
    (jparams, _, j_loss, _, _, jspec, slab,
     spec, _, t_loss, _, _, x, y) = _setup(kind)
    jg = jax.vmap(jax.grad(j_loss))(jparams,
                                    {"x": jnp.asarray(x), "y": jnp.asarray(y)})
    want = np.asarray(j_pack(jg, jspec))
    got = flat_grad(t_loss, torch.as_tensor(slab),
                    {"x": torch.as_tensor(x), "y": torch.as_tensor(y)}, spec)
    assert got.shape == (N, spec.size)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_clustering_forward_batched_over_clusters_matches_per_client():
    """The (S, N, ...) × (N, M, d) broadcast forward equals evaluating each
    client's S centers on its own points one by one."""
    (_, _, _, _, _, _, slab, spec, _, _, t_pel, _, x, y) = _setup("mlp")
    plane = torch.as_tensor(np.stack([slab, slab[::-1].copy()]))  # (2, N, X)
    tx, ty = torch.as_tensor(x), torch.as_tensor(y)
    z, u = cluster_all_clients(t_pel, unpack(plane, spec),
                               {"x": tx, "y": ty}, 2)
    for i in range(N):
        losses = torch.stack([
            t_pel(unpack(plane[s, i], spec), {"x": tx[i], "y": ty[i]})
            for s in range(2)])
        assert torch.equal(z[i], losses.argmin(dim=0))
    assert torch.allclose(u.sum(dim=1), torch.ones(N))
    assert bool((u >= 1e-3 / (1 + 2e-3)).all())
