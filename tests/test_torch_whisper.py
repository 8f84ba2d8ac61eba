"""The port's whisper (``models/encdec.py``, the registry's ``audio``
family) against the live JAX package on the CPU, at smoke width (JAX
compiled least optimized, caches cleared after; one module fixture holds
JAX's params and runs):

- ``sinusoidal_positions`` (an int and a device-tensor offset);
- ``encode``, ``encdec_forward`` (JAX's ``"blocked"``; the port's kernel 8
  takes its plain version on the CPU), ``encdec_prefill_cross`` and
  ``encdec_decode_step`` teacher-forced token by token, with JAX's params
  carried across by ``interop.params_from_numpy``; the decode against
  the port's own forward (JAX's ``test_decode_consistency`` invariant);
- a ragged encoder (``encoder_frames = 100``: kernel 8 at a length 128
  does not divide) against JAX's ``"blocked"``;
- kernel 8's plain version at ragged and cross lengths against JAX's
  ``blocked_attention`` and ``ref_attention``;
- one FedSPD stream round of whisper through
  ``launch/steps.make_fedspd_train_step`` with JAX's draws injected, and
  ``launch/train.main`` on whisper's smoke config, loop = replay closure;
- the parameter tree at smoke and full width (meta) equal to JAX's
  ``init_encdec`` tree, key for key, in shape and dtype.

Tolerances as ``tests/test_torch_lm.py``'s: logits 1e-4, attention 2e-5,
the round's plane 1e-5 and u 1e-6.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core.fedspd import FedSPDConfig as JCfg
from repro.core.fedspd import init_state as j_init_state
from repro.core.fedspd import select_clusters as j_select
from repro.core.gossip import GossipSpec as JSpec
from repro.core.gossip import make_mix_fn as j_make_mix_fn
from repro.core.packing import make_pack_spec as j_make_pack_spec
from repro.core.packing import pack_state as j_pack_state
from repro.graphs.topology import make_graph as j_graph
from repro.launch import steps as jsteps
from repro.models import attention as jattn
from repro.models import encdec as jed
from repro.models import registry as jregistry
from repro_torch.configs import base as tbase
from repro_torch.core.fedspd import FedSPDConfig
from repro_torch.core.gossip import GossipSpec
from repro_torch.core.packing import make_pack_spec
from repro_torch.graphs.topology import make_graph
from repro_torch.interop import params_from_numpy, state_from_numpy
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import encdec as ted
from repro_torch.models import registry as tregistry

ARCH = "whisper-base"
B, L = 2, 12


@contextlib.contextmanager
def _jax_least_optimized():
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        yield
    finally:
        jax.config.update("jax_disable_most_optimizations", False)
        jax.clear_caches()


@pytest.fixture(scope="module", autouse=True)
def least_optimized():
    with _jax_least_optimized():
        yield


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one thread: the launcher's smoke rounds take 3 s
    so, and over a minute on a loaded host's default thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    d_enc = cfg.encoder_d_model or cfg.d_model
    frames = (rng.standard_normal((B, cfg.encoder_frames, d_enc)) * 0.1).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, (B, L)).astype(np.int32)
    return frames, toks


def _world(**overrides):
    jc = jbase.get_smoke_config(ARCH).with_overrides(**overrides)
    tc = tbase.get_smoke_config(ARCH).with_overrides(**overrides)
    jb = jregistry.build_model(jc, attn_mode="blocked")
    tb = tregistry.build_model(tc)
    params = jax.jit(jb.init)(jax.random.PRNGKey(7))
    tp = params_from_numpy(_tree_np(params), device="cpu")
    frames, toks = _inputs(jc)
    jl, _ = jax.jit(jb.forward)(params, {"tokens": jnp.asarray(toks),
                                         "frames": jnp.asarray(frames)})
    return dict(jc=jc, tc=tc, jb=jb, tb=tb, params=params, tp=tp, frames=frames,
                toks=toks, jlogits=np.asarray(jl))


@pytest.fixture(scope="module")
def smoke():
    return _world()


@pytest.mark.parametrize("length,dim,offset", [(64, 128, 0), (100, 64, 7), (1, 128, 33)])
def test_sinusoidal_positions_match_jax(length, dim, offset):
    want = np.asarray(jed.sinusoidal_positions(length, dim, offset))
    # sin/cos of fp32 arguments up to ~100: the two libraries round a few
    # values one ulp of the argument apart
    np.testing.assert_allclose(ted.sinusoidal_positions(length, dim, offset).numpy(), want,
                               atol=1e-5)
    got = ted.sinusoidal_positions(length, dim, torch.tensor(offset))   # a device offset
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_encode_matches_jax(smoke):
    want = jax.jit(lambda p, f: jed.encode(p, f, smoke["jc"]))(smoke["params"],
                                                              jnp.asarray(smoke["frames"]))
    got = ted.encode(smoke["tp"], torch.as_tensor(smoke["frames"]), smoke["tc"])
    assert got.shape == (B, smoke["tc"].encoder_frames, smoke["tc"].d_model)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-4)


def test_forward_matches_jax(smoke):
    got, aux = smoke["tb"].forward(smoke["tp"], {"tokens": torch.as_tensor(smoke["toks"]),
                                                 "frames": torch.as_tensor(smoke["frames"])})
    assert float(aux) == 0.0
    np.testing.assert_allclose(_np(got), smoke["jlogits"], atol=1e-4)


def test_prefill_cross_and_decode_match_jax(smoke):
    jb, tb, params, tp = smoke["jb"], smoke["tb"], smoke["params"], smoke["tp"]
    frames, toks = smoke["frames"], smoke["toks"]
    jcache = jax.jit(jb.prefill)(params, {"frames": jnp.asarray(frames)},
                                 jb.init_cache(B, L + 4))
    tcache = tb.prefill(tp, {"frames": torch.as_tensor(frames)},
                        tb.init_cache(B, L + 4, device="cpu"))
    assert int(tcache["pos"]) == int(jcache["pos"]) == 0
    for key in ("xk", "xv"):
        np.testing.assert_allclose(_np(tcache[key]), np.asarray(jcache[key]), atol=1e-4)
    jstep = jax.jit(jb.decode_step)
    for t in range(L):
        jd, jcache = jstep(params, jcache, jnp.asarray(toks[:, t:t + 1]))
        td, tcache = tb.decode_step(tp, tcache, torch.as_tensor(toks[:, t:t + 1]))
        np.testing.assert_allclose(_np(td), np.asarray(jd), atol=1e-4)
        # the teacher-forced decode is the forward at the same position
        np.testing.assert_allclose(_np(td[:, 0]), smoke["jlogits"][:, t], atol=1e-4)
    assert int(tcache["pos"]) == L
    np.testing.assert_allclose(_np(tcache["k"]), np.asarray(jcache["k"]), atol=1e-4)


def test_ragged_encoder_matches_jax_blocked():
    """encoder_frames = 100: kernel 8 (its plain version on the CPU) at a
    length min(128, L) does not divide, as whisper's 1,500 frames."""
    w = _world(encoder_frames=100)
    got, _ = w["tb"].forward(w["tp"], {"tokens": torch.as_tensor(w["toks"]),
                                       "frames": torch.as_tensor(w["frames"])})
    np.testing.assert_allclose(_np(got), w["jlogits"], atol=1e-4)


@pytest.mark.parametrize("b,lq,lkv,hq,hkv,hd,causal", [
    (2, 77, 77, 2, 1, 80, True),       # an odd length, GQA
    (1, 77, 77, 2, 2, 256, True),
    (1, 77, 77, 2, 2, 80, False),
    (2, 64, 1500, 2, 2, 64, False),   # whisper's cross attention
    (1, 200, 200, 4, 2, 32, False),    # past one 128 tile, bidirectional
    (1, 1500, 1500, 1, 1, 16, True),   # the encoder's length, causal
])
def test_flash_plain_at_ragged_lengths_matches_jax(b, lq, lkv, hq, hkv, hd, causal):
    rng = np.random.default_rng(lq + lkv + hd)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in [(b, lq, hq, hd), (b, lkv, hkv, hd), (b, lkv, hkv, hd)])
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    before = flash_attention.launches
    got = flash_attention(*(torch.as_tensor(a) for a in (q, k, v)), causal=causal)
    assert flash_attention.launches == before and got.shape == (b, lq, hq, hd)
    blocked = jattn.blocked_attention(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(_np(got), np.asarray(blocked), atol=2e-5)
    ref = jattn.ref_attention(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=2e-5)


def test_fedspd_round_matches_jax_with_injected_draws():
    n, s = 4, 2
    small = dict(n_layers=1, encoder_layers=1, encoder_frames=16)   # JAX's eager init
    jc = jbase.get_smoke_config(ARCH).with_overrides(**small)
    jb = jregistry.build_model(jc, attn_mode="ref")
    tb = tregistry.build_model(tbase.get_smoke_config(ARCH).with_overrides(**small),
                               train=True)
    jps = j_make_pack_spec(jax.eval_shape(jb.init, jax.random.PRNGKey(0)))
    tps = make_pack_spec(tb.init(None))
    assert tps.size == jps.size
    graph, tgraph = j_graph("er", n, 2.0, seed=0), make_graph("er", n, 2.0, seed=0)
    kw = dict(n_clients=n, n_clusters=s, tau=1, batch=B, regime="stream")
    jspec, tspec = JSpec.from_graph(graph), GossipSpec.from_graph(tgraph)
    jstep = jax.jit(jsteps.make_fedspd_train_step(
        jb, jspec, JCfg(**kw), mix_fn=j_make_mix_fn(jspec, "reference", plane=True),
        pack_spec=jps))
    st = j_pack_state(j_init_state(jax.random.PRNGKey(3), jb.init, JCfg(**kw), data_m=1), jps)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 512, (n, B, L)).astype(np.int32)
    frames = (rng.standard_normal((n, B, jc.encoder_frames, jc.encoder_d_model))
              * 0.1).astype(np.float32)
    jbatch = {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}
    st, _ = jstep(st, jbatch)   # round 1, so that u and the plane moved
    _, k_sel, _ = jax.random.split(st.key, 3)
    s_draw = torch.as_tensor(np.array(j_select(k_sel, st.u)))
    want = _tree_np(jstep(st, jbatch)[0])
    tstep = tsteps.make_fedspd_train_step(tb, tspec, FedSPDConfig(**kw), pack_spec=tps)
    got, metrics = tstep(state_from_numpy(_tree_np(st), device="cpu"),
                         {"tokens": torch.as_tensor(toks), "frames": torch.as_tensor(frames)},
                         s=s_draw)
    np.testing.assert_allclose(got.centers.numpy(), want.centers, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.u.numpy(), want.u, atol=1e-6, rtol=0)
    assert float(got.comm_bytes) == float(want.comm_bytes)
    assert torch.isfinite(metrics["consensus"]).all()


def test_train_main_runs_whisper_and_the_replay_closure_equals_the_loop():
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--rounds", "2", "--clients", "2",
            "--batch", "2", "--seq", "8", "--avg-degree", "1", "--eval-every", "100"]
    loop = ttrain.main(argv)
    replay = ttrain.main(argv + ["--scan-rounds"])
    assert np.isfinite(loop["final_loss"])
    assert torch.equal(loop["state"].centers, replay["state"].centers)
    assert loop["final_loss"] == replay["final_loss"]


def _shapes(tree, prefix=()):
    """{path: (shape, dtype name)} of a nested dict of tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, prefix + (k,)))
        return out
    return {"/".join(prefix): (tuple(tree.shape), str(tree.dtype).removeprefix("torch."))}


def _jax_shapes(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(p.key for p in path): (tuple(a.shape), str(np.dtype(a.dtype)))
            for path, a in leaves}


@pytest.mark.parametrize("smoke_width", [True, False])
def test_param_tree_equals_jax_init_encdec(smoke_width):
    """JAX's ``init_encdec`` tree carries across unchanged: the port's tree
    (meta at full width) has its keys, shapes and dtypes, JAX's params
    carried by ``interop`` keep them, and ``count_params`` counts every
    leaf but the norm scales (JAX's analytic count)."""
    get_j = jbase.get_smoke_config if smoke_width else jbase.get_config
    get_t = tbase.get_smoke_config if smoke_width else tbase.get_config
    jinit = jregistry.build_model(get_j(ARCH)).init
    want = _jax_shapes(jax.eval_shape(jinit, jax.random.PRNGKey(0)))
    assert _shapes(tregistry.build_model(get_t(ARCH)).init(None)) == want
    if smoke_width:
        carried = params_from_numpy(_tree_np(jax.jit(jinit)(jax.random.PRNGKey(0))),
                                    device="cpu")
        assert _shapes(carried) == want
    n = sum(int(np.prod(s)) for k, (s, _) in want.items() if not k.endswith("/scale"))
    assert tregistry.count_params(get_t(ARCH)) == n
