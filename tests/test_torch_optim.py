"""PyTorch port, the optimizers and learning-rate schedules against the JAX
package, live in one process (JAX on the CPU, the port with device="cpu").

- ``sgd``, ``momentum`` (nesterov off and on) and ``adamw`` (weight decay
  0 and 0.01): 5 updates of an ``(N, X)`` slab, JAX's update vmapped over
  the clients, params and state at 1e-6 relative. AdamW's count is a 0-d
  int32 tensor on the slab's device.
  The JAX updates run op by op: under jit XLA contracts ``p - lr * s``
  into one FMA, where the port rounds the product first.
- ``clip_by_global_norm`` on a slab and on a dict of leaves, clipping and
  not: within 2 fp32 ulps of JAX (the squared norm sums in another order,
  and the scale, an ulp off, multiplies every element).
- Every schedule at steps 0-60, from an int and from an integer tensor:
  ``constant`` and ``exponential`` equal to JAX's; ``cosine`` within 3
  ulps (XLA's cos and torch's differ by an ulp, and 1 + cos cancels near
  the end of the decay).
- ``local_sgd`` with ``momentum`` and ``adamw``, ``extra_grad`` on and
  off, against JAX's ``local_sgd`` with the batch indices made in JAX:
  1e-5.
- One FedSPD round with ``adamw`` and a cosine ``lr_schedule``, and
  ``final_phase`` with ``momentum()``, against JAX's ``make_round_step``
  (Pallas in interpret mode) and ``final_phase`` with injected draws:
  1e-5.

AdamW in a training step runs at eps 1e-3 (``ADAM_EPS``): its step
m / (sqrt(v) + eps) magnifies a difference dg between the two packages'
gradients (their summation orders; a ReLU at its kink) by up to
lr / (sqrt(v) + eps), which on the coordinates with the smallest
gradients takes a few of 10^5 past 1e-5 at the default eps 1e-8. Eps 1e-3
bounds the magnification to 50·dg at lr 0.05. The update test holds the
default eps on gradients drawn away from 0.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim as J
import repro_torch.optim as T
from repro.baselines.common import local_sgd as j_local_sgd
from repro.configs.paper_cnn import PaperExpConfig as JExp
from repro.core.fedspd import FedSPDConfig as JCfg
from repro.core.fedspd import FedSPDState as JFedSPDState
from repro.core.fedspd import final_phase as j_final_phase
from repro.core.fedspd import make_round_step as j_make_round_step
from repro.core.fedspd import select_clusters as j_select
from repro.core.gossip import GossipSpec as JSpec
from repro.core.gossip import make_mix_fn as j_make_mix_fn
from repro.core.packing import pack as j_pack
from repro.data.pipeline import sample_cluster_batch_indices
from repro.data.synthetic import make_mixture_classification as j_data
from repro.experiments.registry import build_context as j_build_context
from repro.experiments.registry import get_method as j_get_method
from repro_torch.baselines.common import local_sgd
from repro_torch.configs.paper_cnn import PaperExpConfig
from repro_torch.core.fedspd import FedSPDConfig, final_phase, make_round_step
from repro_torch.core.gossip import GossipSpec
from repro_torch.core.packing import pack
from repro_torch.data.synthetic import make_mixture_classification
from repro_torch.experiments.registry import build_context
from repro_torch.interop import state_from_numpy

N, S, X = 8, 2, 301
DATA = dict(n_clients=N, n_clusters=S, n_per_client=96, n_classes=4, dim=16)
TAU, BATCH = 3, 32
ADAM_EPS = 1e-3   # see the module docstring
OPTIMIZERS = {"sgd": {}, "momentum": {}, "momentum-nesterov": {"nesterov": True},
              "adamw": {}, "adamw-wd": {"weight_decay": 0.01}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tensors are tiny: torch's intra-op thread pool only spins on
    them and takes CPU from the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(name: str):
    """The JAX and the port optimizer of one ``OPTIMIZERS`` case."""
    base = name.split("-")[0]
    return (J.make_optimizer(base, **OPTIMIZERS[name]),
            T.make_optimizer(base, **OPTIMIZERS[name]))


def _ulps(got: np.ndarray, want: np.ndarray) -> int:
    """The largest distance between two fp32 arrays in units in the last
    place."""
    a = np.asarray(got, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(want, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


# --------------------------------------------------------------------------
# the optimizers, clipping and the schedules
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_updates_match_jax(name):
    rng = np.random.default_rng(len(name))
    p0 = rng.standard_normal((N, X)).astype(np.float32)
    grads = rng.standard_normal((5, N, X)).astype(np.float32)
    lr = np.float32(0.05)
    jopt, topt = _pair(name)
    jp, js = jnp.asarray(p0), jax.vmap(jopt.init)(jnp.asarray(p0))
    tp = torch.as_tensor(p0)
    ts = topt.init(tp)
    # op by op: under jit XLA contracts p - lr * s into one FMA, the port
    # (and the JAX ops one by one) round the product first
    jupd = jax.vmap(lambda g, o, p: jopt.update(g, o, p, lr))
    for g in grads:
        jp, js = jupd(jnp.asarray(g), js, jp)
        tp, ts = topt.update(torch.as_tensor(g), ts, tp, float(lr))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6, atol=0)
    if name.startswith("momentum"):
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=0)
    if name.startswith("adamw"):
        np.testing.assert_allclose(ts.mu.numpy(), np.asarray(js.mu), rtol=1e-6, atol=0)
        np.testing.assert_allclose(ts.nu.numpy(), np.asarray(js.nu), rtol=1e-6, atol=0)
        assert ts.count.dtype == torch.int32 and ts.count.dim() == 0
        assert int(ts.count) == 5 and np.all(np.asarray(js.count) == 5)


def test_make_optimizer_refuses_an_unknown_name():
    for m in (J, T):
        with pytest.raises(ValueError, match="lion"):
            m.make_optimizer("lion")
        with pytest.raises(ValueError, match="linear"):
            m.make_schedule("linear", lr=0.1)


@pytest.mark.parametrize("max_norm", [0.5, 1e4])
def test_clip_by_global_norm_within_two_ulps_of_jax(max_norm):
    rng = np.random.default_rng(3)
    slab = rng.standard_normal((N, X)).astype(np.float32)
    tree = {"a": {"w": slab[:, :100], "b": slab[:, 100:110]}, "c": slab[:, 110:]}
    for arg in (slab, tree):
        want = J.clip_by_global_norm(jax.tree.map(jnp.asarray, arg), max_norm)
        got = T.clip_by_global_norm(jax.tree.map(torch.as_tensor, arg), max_norm)
        for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(jax.tree.map(
                np.asarray, got, is_leaf=lambda v: isinstance(v, torch.Tensor)))):
            assert _ulps(g, w) <= 2
    if max_norm > 1e3:
        assert torch.equal(T.clip_by_global_norm(torch.as_tensor(slab), max_norm),
                           torch.as_tensor(slab))


SCHEDULES = {
    "constant": dict(lr=0.05),
    "exponential": dict(lr0=0.05, decay=0.8),
    "exponential-3": dict(lr0=0.05, decay=0.8, steps_per_decay=3),
    "cosine": dict(lr0=0.05, warmup=10, total=60),
    "cosine-floor": dict(lr0=0.3, warmup=0, total=40, floor=0.2),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_match_jax(name):
    jfn = J.make_schedule(name.split("-")[0], **SCHEDULES[name])
    tfn = T.make_schedule(name.split("-")[0], **SCHEDULES[name])
    want = np.array([np.asarray(jfn(t)) for t in range(61)], np.float32)
    got = np.array([tfn(t).numpy() for t in range(61)], np.float32)
    on_tensor = np.array([tfn(torch.tensor(t)).numpy() for t in range(61)], np.float32)
    assert tfn(7).dtype == torch.float32 and tfn(7).dim() == 0
    assert _ulps(got, want) <= (3 if name.startswith("cosine") else 0)
    assert np.array_equal(got, on_tensor)


# --------------------------------------------------------------------------
# local_sgd with a stateful optimizer
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small():
    """Both packages' contexts, and random weights of the classifier's
    packed plane, drawn with numpy (a JAX init would compile its ops)."""
    jexp = JExp(**dict(DATA, avg_degree=3.0))
    jctx = j_build_context(j_data(**DATA), jexp, options={"param_plane": True})
    jps = j_get_method("local")._pack_spec(jctx)
    ctx = build_context(make_mixture_classification(**DATA), PaperExpConfig(**DATA),
                        torch.device("cpu"))
    rng = np.random.default_rng(5)
    plane = (0.1 * rng.standard_normal((N, jps.size))).astype(np.float32)
    centers = (0.1 * rng.standard_normal((S, N, jps.size))).astype(np.float32)
    return dict(jctx=jctx, jps=jps, plane=plane, centers=centers, ctx=ctx)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _client_randint(keys, batch: int, m: int):
    """One randint of ``(batch,)`` in [0, m) per key: a client's batch."""
    return jax.vmap(lambda kk: jax.random.randint(kk, (batch,), 0, m))(keys)


def _uniform_idx(key, steps: int, n: int, m: int, batch: int) -> np.ndarray:
    """``local_sgd``'s (and ``final_phase``'s) draws: ``split(key, steps)``,
    then per step one randint per client of ``split(k, n)``. Returns
    ``(steps, n, batch)``."""
    return np.stack([np.asarray(_client_randint(jax.random.split(k, n), batch, m))
                     for k in jax.random.split(key, steps)])


@pytest.mark.parametrize("extra", [False, True])
@pytest.mark.parametrize("name", ["momentum", "adamw"])
def test_local_sgd_with_an_optimizer_matches_jax(small, name, extra):
    jopt, topt = ((J.adamw(eps=ADAM_EPS), T.adamw(eps=ADAM_EPS)) if name == "adamw"
                  else _pair(name))
    center = (0.5 * small["plane"][::-1]).copy()
    key, lr = jax.random.PRNGKey(9), np.float32(0.05)
    want = j_local_sgd(small["jctx"].loss_fn, jnp.asarray(small["plane"]),
                       small["jctx"].train, key, TAU, BATCH, lr, optimizer=jopt,
                       extra_grad=(lambda p: 0.1 * (p - jnp.asarray(center))) if extra
                       else None, pack_spec=small["jps"])
    ctx = small["ctx"]
    idx = torch.as_tensor(_uniform_idx(key, TAU, N, DATA["n_per_client"], BATCH))
    got = local_sgd(ctx.loss_fn, torch.tensor(small["plane"]), ctx.train, None, TAU,
                    BATCH, float(lr), pack_spec=ctx.pack_spec, optimizer=topt,
                    extra_grad=(lambda p: 0.1 * (p - torch.as_tensor(center))) if extra
                    else None, idx=idx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


# --------------------------------------------------------------------------
# FedSPD driven by an optimizer and a schedule
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fedspd(small):
    """A JAX FedSPD state at round 3 on the packed plane, random centers and
    assignments, and both packages' configs."""
    jctx, ctx = small["jctx"], small["ctx"]
    cfg = dict(n_clients=N, n_clusters=S, tau=TAU, batch=BATCH)
    z = np.random.default_rng(4).integers(0, S, (N, DATA["n_per_client"]))
    st = JFedSPDState(centers=jnp.asarray(small["centers"]),
                      u=jnp.full((N, S), 1.0 / S, jnp.float32), z=jnp.asarray(z, jnp.int32),
                      round=jnp.int32(3), key=jax.random.PRNGKey(4),
                      comm_bytes=jnp.zeros((), jnp.float32))
    return dict(st=st, jcfg=JCfg(**cfg), tcfg=FedSPDConfig(**cfg),
                graph=jctx.graph, jctx=jctx, ctx=ctx)


def test_fedspd_round_with_adamw_and_a_cosine_schedule_matches_jax(small, fedspd):
    st, jctx, ctx = fedspd["st"], fedspd["jctx"], fedspd["ctx"]
    sched = dict(lr0=0.05, warmup=2, total=6)   # round 3: a quarter down the cosine
    jspec = JSpec.from_graph(fedspd["graph"])
    jstep = jax.jit(j_make_round_step(
        jctx.loss_fn, jctx.pel_fn, jspec, fedspd["jcfg"], optimizer=J.adamw(eps=ADAM_EPS),
        lr_schedule=J.cosine_with_warmup(**sched), pack_spec=small["jps"],
        mix_fn=j_make_mix_fn(jspec, "pallas", plane=True)))
    want, metrics = jstep(st, jctx.train)
    # the round's draws, split as the JAX step splits them
    _, k_sel, k_local = jax.random.split(st.key, 3)
    s = j_select(k_sel, st.u)
    idx = np.stack([np.asarray(jax.vmap(
        lambda kk, zi, si: sample_cluster_batch_indices(kk, zi, si, BATCH)
    )(jax.random.split(k, N), st.z, s)) for k in jax.random.split(k_local, TAU)])

    tspec = GossipSpec.from_graph(fedspd["graph"])
    step = make_round_step(ctx.loss_fn, ctx.pel_fn, tspec, fedspd["tcfg"],
                           pack_spec=ctx.pack_spec, optimizer=T.adamw(eps=ADAM_EPS),
                           lr_schedule=T.cosine_with_warmup(**sched))
    got, tmetrics = step(state_from_numpy(jax.tree.map(np.asarray, st), device="cpu"),
                         ctx.train, s=torch.tensor(np.asarray(s)),
                         idx=torch.as_tensor(idx))
    assert _ulps(tmetrics["lr"].numpy(), np.asarray(metrics["lr"])) <= 1
    assert float(tmetrics["lr"]) < 0.05
    np.testing.assert_allclose(got.centers.numpy(), np.asarray(want.centers), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got.u.numpy(), np.asarray(want.u), atol=1e-5, rtol=0)
    assert float(got.comm_bytes) == float(want.comm_bytes) and got.round == 4


def test_final_phase_with_momentum_matches_jax(small, fedspd):
    st, jctx, ctx = fedspd["st"], fedspd["jctx"], fedspd["ctx"]
    want = j_pack(j_final_phase(st, jctx.loss_fn, jctx.train, fedspd["jcfg"],
                                optimizer=J.momentum(), pack_spec=small["jps"]),
                  small["jps"])
    steps = fedspd["jcfg"].tau_final * max(1, DATA["n_per_client"] // BATCH)
    tape = _uniform_idx(st.key, steps, N, DATA["n_per_client"], BATCH)
    got = final_phase(state_from_numpy(jax.tree.map(np.asarray, st), device="cpu"),
                      ctx.loss_fn, ctx.train, fedspd["tcfg"], ctx.pack_spec,
                      idx_tape=torch.as_tensor(tape), optimizer=T.momentum())
    np.testing.assert_allclose(pack(got, ctx.pack_spec).numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)
