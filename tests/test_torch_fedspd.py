"""PyTorch port, FedSPD Algorithm 1 against the JAX package with injected
draws: ``seeded_init`` (1e-4: 45 sequential SGD steps reorder fp32 sums),
one round of ``step_full_packed`` with DP off and on (plane and u 1e-5,
comm bytes exact, z equal wherever the JAX loss margin between the two
centers is at least 1e-4), and ``final_phase`` (1e-4).

The draws are made in JAX the way the JAX code splits its keys, then fed
to both packages: the JAX step draws them itself, the port takes them as
overrides. The JAX round runs the Pallas kernels in interpret mode
(``gossip_backend="pallas"`` on the packed plane); the port runs both its
backends on the CPU (``cuda`` takes the kernels' plain versions there)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.fedspd import FedSPDConfig as JCfg
from repro.core.fedspd import final_phase as j_final_phase
from repro.core.fedspd import make_round_step as j_make_round_step
from repro.core.fedspd import personalize as j_personalize
from repro.core.fedspd import seeded_init as j_seeded_init
from repro.core.fedspd import select_clusters as j_select
from repro.core.gossip import GossipSpec as JSpec
from repro.core.gossip import make_mix_fn as j_make_mix_fn
from repro.core.packing import make_pack_spec as j_make_pack_spec
from repro.core.packing import pack as j_pack
from repro.core.packing import pack_state as j_pack_state
from repro.core.packing import unpack as j_unpack
from repro.data.pipeline import sample_cluster_batch_indices
from repro.data.synthetic import make_mixture_classification as j_data
from repro.graphs.topology import make_graph as j_graph
from repro.models.smallnets import make_classifier as j_classifier
from repro_torch.core.fedspd import (
    FedSPDConfig,
    final_phase,
    init_state,
    make_round_step,
    personalize,
    seeded_init,
)
from repro_torch.core.gossip import GossipSpec, make_mix_fn
from repro_torch.core.packing import make_pack_spec, pack
from repro_torch.interop import params_from_numpy, state_from_numpy
from repro_torch.kernels.gossip_mix import gossip_mix_flat, reset_launch_counts
from repro_torch.models.smallnets import make_classifier

N, S, DIM, C, M, BATCH, TAU = 8, 2, 16, 4, 96, 32, 5
DP = {"off": (0.0, 0.0), "on": (1.0, 0.5)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tensors are tiny: torch's intra-op thread pool only spins on
    them and takes CPU from the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    data = j_data(n_clients=N, n_clusters=S, n_per_client=M, n_classes=C,
                  dim=DIM, seed=0)
    graph = j_graph("er", N, 3.0, seed=0)
    _, _, j_loss, j_pel, _ = j_classifier("mlp", jax.random.PRNGKey(0), DIM, C)

    def j_init(k):
        return j_classifier("mlp", k, DIM, C)[0]

    jps = j_make_pack_spec(jax.eval_shape(j_init, jax.random.PRNGKey(0)))
    _, _, t_loss, t_pel, _ = make_classifier("mlp", torch.Generator(), DIM, C)
    tps = make_pack_spec(params_from_numpy(
        jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0))), device="cpu"))
    jtrain = {"inputs": jnp.asarray(data.x), "targets": jnp.asarray(data.y)}
    ttrain = {"inputs": torch.as_tensor(data.x), "targets": torch.as_tensor(data.y)}
    return dict(data=data, graph=graph, j_loss=j_loss, j_pel=j_pel,
                j_init=j_init, jps=jps, t_loss=t_loss, t_pel=t_pel, tps=tps,
                jtrain=jtrain, ttrain=ttrain)


def _cfgs(dp):
    clip, mult = DP[dp]
    kw = dict(n_clients=N, n_clusters=S, tau=TAU, batch=BATCH,
              dp_clip=clip, dp_noise_multiplier=mult)
    return JCfg(**kw), FedSPDConfig(**kw)


def _seeded_init_draws(key, world):
    """seeded_init's draws, split as core/fedspd.seeded_init splits them."""
    k_pick, k_run = jax.random.split(jax.random.fold_in(key, 1))
    seeds = jax.random.choice(k_pick, N, (S,), replace=False)
    steps = 15 * max(1, M // BATCH)
    inits, tapes = [], []
    for s in range(S):
        k_model, k_scan = jax.random.split(jax.random.fold_in(k_run, s))
        inits.append(np.asarray(j_pack(world["j_init"](k_model), world["jps"])))
        tapes.append([np.asarray(jax.random.randint(k, (BATCH,), 0, M))
                      for k in jax.random.split(k_scan, steps)])
    return np.array(seeds), np.stack(inits), np.array(tapes)


def _round_draws(state, x_width, sigma):
    """One round's draws, split as core/fedspd.step_full_packed splits them:
    selections, the (τ, N, B) cluster-conditional batch indices, and the
    DP noise."""
    key, k_sel, k_local = jax.random.split(state.key, 3)
    s = j_select(k_sel, state.u)
    idx = []
    for k in jax.random.split(k_local, TAU):
        ks = jax.random.split(k, N)
        idx.append(jax.vmap(
            lambda kk, zi, si: sample_cluster_batch_indices(kk, zi, si, BATCH)
        )(ks, state.z, s))
    _, k_dp = jax.random.split(key)
    noise = jax.random.normal(k_dp, (N, x_width), jnp.float32) if sigma > 0 else None
    return (np.array(s), np.stack([np.asarray(i) for i in idx]),
            None if noise is None else np.array(noise))


@pytest.fixture(scope="module")
def jax_rounds(world):
    """Per DP setting: the JAX state entering round 2 (after seeded_init and
    one JAX round), its round-2 draws, and the JAX state after round 2."""
    out = {}
    spec = JSpec.from_graph(world["graph"])
    for dp in DP:
        jcfg, _ = _cfgs(dp)
        step = jax.jit(j_make_round_step(
            world["j_loss"], world["j_pel"], spec, jcfg, pack_spec=world["jps"],
            mix_fn=j_make_mix_fn(spec, "pallas", plane=True)))
        st0 = j_pack_state(j_seeded_init(jax.random.PRNGKey(7), world["j_init"],
                                         jcfg, world["j_loss"], world["jtrain"]),
                           world["jps"])
        st1, _ = step(st0, world["jtrain"])
        draws = _round_draws(st1, world["jps"].size,
                             jcfg.dp_clip * jcfg.dp_noise_multiplier)
        st2, _ = step(st1, world["jtrain"])
        out[dp] = (jax.tree.map(np.asarray, st1), draws,
                   jax.tree.map(np.asarray, st2))
    return out


def test_seeded_init_matches_jax_with_injected_draws(world):
    jcfg, tcfg = _cfgs("off")
    key = jax.random.PRNGKey(11)
    want = j_pack(j_seeded_init(key, world["j_init"], jcfg, world["j_loss"],
                                world["jtrain"]).centers, world["jps"])
    seeds, inits, tapes = _seeded_init_draws(key, world)
    assert tapes.shape == (S, 45, BATCH)
    got = seeded_init(torch.Generator(), None, tcfg, world["t_loss"],
                      world["ttrain"], world["tps"], seeds=torch.as_tensor(seeds),
                      init_params=torch.as_tensor(inits),
                      idx_tape=torch.as_tensor(tapes))
    assert got.centers.shape == (S, N, world["tps"].size)
    np.testing.assert_allclose(got.centers.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    assert torch.equal(got.u, torch.full((N, S), 0.5))
    assert got.round == 0 and float(got.comm_bytes) == 0.0


@pytest.mark.parametrize("backend", ["cuda", "reference"])
@pytest.mark.parametrize("dp", ["off", "on"])
def test_one_round_matches_jax_with_injected_draws(world, jax_rounds, dp, backend):
    st1, (s, idx, noise), st2 = jax_rounds[dp]
    _, tcfg = _cfgs(dp)
    spec = GossipSpec.from_graph(world["graph"])
    step = make_round_step(world["t_loss"], world["t_pel"], spec, tcfg,
                           pack_spec=world["tps"], mix_fn=make_mix_fn(spec, backend))
    state = state_from_numpy(st1, device="cpu")
    new, metrics = step(state, world["ttrain"], s=torch.as_tensor(s),
                        idx=torch.as_tensor(idx),
                        noise=None if noise is None else torch.as_tensor(noise))
    np.testing.assert_allclose(new.centers.numpy(), st2.centers, atol=1e-5, rtol=0)
    np.testing.assert_allclose(new.u.numpy(), st2.u, atol=1e-5, rtol=0)
    assert float(new.comm_bytes) == float(st2.comm_bytes)
    assert new.round == int(st2.round) == 2
    assert torch.equal(metrics["selected"], torch.as_tensor(s))
    # z: equal wherever the two centers' JAX losses are not a near tie
    jtree = j_unpack(jnp.asarray(st2.centers), world["jps"])
    batch = {"x": world["jtrain"]["inputs"], "y": world["jtrain"]["targets"]}
    losses = jax.vmap(lambda c: jax.vmap(world["j_pel"])(c, batch))(jtree)
    margin = np.abs(np.asarray(losses[0] - losses[1]))
    clear = margin >= 1e-4
    assert clear.mean() > 0.9
    assert np.array_equal(new.z.numpy()[clear], st2.z[clear])
    # the scatter wrote the state's plane in place (donation)
    assert new.centers.data_ptr() == state.centers.data_ptr()


def test_final_phase_matches_jax_with_injected_tape(world, jax_rounds):
    st1 = jax_rounds["off"][0]
    jcfg, tcfg = _cfgs("off")
    jst = jax.tree.map(jnp.asarray, st1)
    want = j_pack(j_final_phase(jst, world["j_loss"], world["jtrain"], jcfg,
                                pack_spec=world["jps"]), world["jps"])
    steps = jcfg.tau_final * max(1, M // BATCH)
    tape = np.stack([
        np.stack([np.asarray(jax.random.randint(ki, (BATCH,), 0, M))
                  for ki in jax.random.split(k, N)])
        for k in jax.random.split(jst.key, steps)])
    got = final_phase(state_from_numpy(st1, device="cpu"), world["t_loss"], world["ttrain"],
                      tcfg, world["tps"], idx_tape=torch.as_tensor(tape))
    np.testing.assert_allclose(pack(got, world["tps"]).numpy(), np.asarray(want),
                               atol=1e-4, rtol=0)


def test_personalize_matches_jax_eq2(world, jax_rounds):
    st1 = jax_rounds["on"][0]
    want = j_pack(j_personalize(jax.tree.map(jnp.asarray, st1), world["jps"]),
                  world["jps"])
    got = pack(personalize(state_from_numpy(st1, device="cpu"), world["tps"]), world["tps"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_init_state_draws_one_model_per_cluster_and_client(world):
    _, tcfg = _cfgs("off")
    gen = torch.Generator().manual_seed(5)
    model_init = lambda g: make_classifier("mlp", g, DIM, C)[0]  # noqa: E731
    st = init_state(gen, model_init, tcfg, M, world["tps"])
    flat = st.centers.reshape(S * N, -1)
    assert st.centers.shape == (S, N, world["tps"].size)
    assert len({tuple(r[-8:].tolist()) for r in flat}) == S * N
    assert torch.equal(st.u, torch.full((N, S), 1.0 / S))
    assert st.z.shape == (N, M) and not st.z.any()
    assert st.gen is not gen and st.round == 0


def test_default_mix_is_the_kernel_path_and_scatters_in_place(world, jax_rounds):
    """Without a ``mix_fn`` the round step takes ``make_mix_fn``'s (the
    kernels' plain versions on CPU tensors), and writes the mixed rows into
    the state's own plane."""
    st1, (s, idx, _), st2 = jax_rounds["off"]
    _, tcfg = _cfgs("off")
    spec = GossipSpec.from_graph(world["graph"])
    step = make_round_step(world["t_loss"], world["t_pel"], spec, tcfg,
                           pack_spec=world["tps"])
    state = state_from_numpy(st1, device="cpu")
    before = state.centers.clone()
    reset_launch_counts()
    new, _ = step(state, world["ttrain"], s=torch.as_tensor(s),
                  idx=torch.as_tensor(idx))
    assert gossip_mix_flat.launches == 0
    assert new.centers is state.centers
    assert not torch.equal(state.centers, before)
    np.testing.assert_allclose(new.centers.numpy(), st2.centers, atol=1e-5, rtol=0)


def test_stream_regime_is_refused(world):
    """The stream regime, refused until its slice, now makes a step
    (tests/test_torch_variants.py holds it against JAX's); a regime the
    port does not have is refused, naming itself."""
    spec = GossipSpec.from_graph(world["graph"])
    cfg = FedSPDConfig(n_clients=N, n_clusters=S, regime="stream")
    step = make_round_step(world["t_loss"], world["t_pel"], spec, cfg,
                           pack_spec=world["tps"])
    assert step.__name__ == "step_stream_packed"
    with pytest.raises(ValueError, match="online"):
        make_round_step(world["t_loss"], world["t_pel"], spec,
                        FedSPDConfig(n_clients=N, n_clusters=S, regime="online"),
                        pack_spec=world["tps"])
