"""The port's hybrid family (zamba2-1.2b: ``models/hybrid.py``, Mamba2
layers with one shared attention block) against the JAX package on the
CPU, weights from JAX inits carried across as numpy arrays.

Two configs: zamba2's smoke config (2 Mamba2 layers, the shared block
after each) and ``with_overrides(n_layers=3, attn_every=2)``, whose last
Mamba2 layer has no attention after it, as zamba2-1.2b's last two
(segments ``[6, 6, 6, 6, 6, 6, 2]``). Tolerances, as
``tests/test_torch_lm.py`` states them for the dense family: forward
logits, every cache tensor after the prefill and after one decode step
at 1e-4 (a few fp32 layers); tokens equal.

The decode step is held against the JAX package's step on the same cache
(the JAX prefill's). The JAX programs compile once per module where they
can (module-scoped fixtures), at smoke width.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core.packing import make_pack_spec as jax_make_pack_spec
from repro.core.packing import pack as jax_pack
from repro.models import hybrid as jhybrid
from repro.models import registry as jregistry
from repro.serve import ClusterPlaneServer as JaxServer
from repro.serve import load_servable as jax_load_servable
from repro.serve import save_servable as jax_save_servable
from repro_torch.configs import base as tbase
from repro_torch.core.packing import make_pack_spec, pack, unpack
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve as launch_serve
from repro_torch.models import hybrid as thybrid
from repro_torch.models import registry as tregistry
from repro_torch.models.layers import cast_params_for_compute
from repro_torch.serve import ClusterPlaneServer, load_servable
from repro_torch.serve.server import decode_eager


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one thread: the test workers share the host's
    cores, and torch's default thread count in each oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCH = "zamba2-1.2b"
CONFIGS = {"smoke": {}, "trailing": {"n_layers": 3, "attn_every": 2}}
CACHE_KEYS = ("ssm", "conv", "attn_k", "attn_v")
U = np.array([[0.7, 0.3], [0.5, 0.5], [0.0, 1.0], [0.2, 0.8]], np.float32)
GEN = 6


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


@pytest.mark.parametrize("n_layers,attn_every", [(38, 6), (2, 1), (3, 2), (7, 3), (4, 4),
                                                 (5, 6)])
def test_segments_and_invocations_equal_jax(n_layers, attn_every):
    jc = jbase.get_config(ARCH).with_overrides(n_layers=n_layers, attn_every=attn_every)
    tc = tbase.get_config(ARCH).with_overrides(n_layers=n_layers, attn_every=attn_every)
    assert thybrid.segment_sizes(tc) == jhybrid.segment_sizes(jc)
    assert thybrid.n_attn_invocations(tc) == jhybrid.n_attn_invocations(jc)
    after = thybrid._invocation_after(tc)
    assert sorted(after.values()) == list(range(thybrid.n_attn_invocations(tc)))
    if (n_layers, attn_every) == (38, 6):
        assert thybrid.segment_sizes(tc) == [6, 6, 6, 6, 6, 6, 2]
        assert after == {5: 0, 11: 1, 17: 2, 23: 3, 29: 4, 35: 5}   # none after 36, 37


@pytest.fixture(scope="module")
def models():
    """Per config: (JAX config, JAX bundle on the Pallas flash kernel, JAX
    params, the port's bundle, the same params in the port)."""
    out = {}
    for name, kw in CONFIGS.items():
        jc = jbase.get_smoke_config(ARCH).with_overrides(**kw)
        jb = jregistry.build_model(jc, attn_mode="pallas")
        jp = jax.jit(jb.init)(jax.random.PRNGKey(7))
        tb = tregistry.build_model(tbase.get_smoke_config(ARCH).with_overrides(**kw))
        out[name] = (jc, jb, jp, tb,
                     params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu"))
    return out


def _cache_to_torch(cache) -> dict:
    out = params_from_numpy(jax.tree.map(np.asarray, cache), device="cpu")
    out["pos"] = out["pos"].to(torch.int64)
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_prefill_and_one_decode_step_match_jax(models, name):
    """Logits (aux 0), the prefill's SSD states, conv tails and each
    invocation's k/v rows, then one decode step from the JAX package's
    own prefill cache: logits, every cache tensor, pos."""
    jc, jb, jp, tb, tp = models[name]
    toks = np.random.default_rng(11).integers(0, jc.vocab, (2, 33)).astype(np.int32)
    prompt, nxt, max_len = toks[:, :32], toks[:, 32:], 40

    @jax.jit
    def jax_side(p, prompt, nxt):
        logits, aux = jb.forward(p, {"tokens": prompt})
        cache = jb.prefill(p, {"tokens": prompt}, jb.init_cache(2, max_len))
        dec, after = jb.decode_step(p, cache, nxt)
        return logits, aux, cache, dec, after

    lj, aj, cj, dj, cj2 = jax_side(jp, jnp.asarray(prompt), jnp.asarray(nxt))
    lt, at = tb.forward(tp, {"tokens": torch.as_tensor(prompt)})
    np.testing.assert_allclose(_np(lt), _np(lj), atol=1e-4)
    assert float(at) == float(aj) == 0.0
    ct = tb.init_cache(2, max_len, device="cpu")
    assert set(ct) == set(cj) == set(CACHE_KEYS) | {"pos"}
    assert tb.prefill(tp, {"tokens": torch.as_tensor(prompt)}, ct) is ct
    assert int(ct["pos"]) == int(cj["pos"]) == 32
    for key in CACHE_KEYS:
        assert tuple(ct[key].shape) == cj[key].shape and ct[key].dtype == \
            getattr(torch, str(cj[key].dtype))
        np.testing.assert_allclose(_np(ct[key]), _np(cj[key]), atol=1e-4)
    assert ct["attn_k"].shape[0] == {"smoke": 2, "trailing": 1}[name]
    assert not ct["attn_k"][:, :, 32:].any()   # rows past the prompt stay zero
    cache = _cache_to_torch(cj)
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    dt_, out = tb.decode_step(tp, cache, torch.as_tensor(nxt, dtype=torch.int64))
    assert out is cache and {k: v.data_ptr() for k, v in cache.items()} == ptrs
    assert int(cache["pos"]) == int(cj2["pos"]) == 33
    np.testing.assert_allclose(_np(dt_), _np(dj), atol=1e-4)
    for key in CACHE_KEYS:
        np.testing.assert_allclose(_np(cache[key]), _np(cj2[key]), atol=1e-4)
    # the hybrid has no capacity drops: the decoded logits are the forward's
    np.testing.assert_allclose(
        _np(dt_[:, 0]), _np(tb.forward(tp, {"tokens": torch.as_tensor(toks)})[0][:, 32]),
        atol=1e-4)


def test_request_batched_params_equal_one_request_at_a_time(models):
    """The server's batched forward and decode: each request through its
    own weights (leaves with a leading (B,) axis), the shared block's
    weights one set a request."""
    _, _, _, tb, _ = models["trailing"]
    ps = [tb.init(torch.Generator().manual_seed(s)) for s in range(2)]
    spec = make_pack_spec(ps[0])
    batched = unpack(torch.stack([pack(p, spec) for p in ps]), spec)
    toks = torch.randint(0, tb.cfg.vocab, (2, 16), generator=torch.Generator().manual_seed(1))
    got, _ = tb.forward(batched, {"tokens": toks})
    cache = tb.prefill(batched, {"tokens": toks[:, :15]}, tb.init_cache(2, 20, device="cpu"))
    dec, _ = tb.decode_step(batched, cache, toks[:, 15:])
    for i in range(2):
        want, _ = tb.forward(ps[i], {"tokens": toks[i:i + 1]})
        torch.testing.assert_close(got[i:i + 1], want, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(dec[i:i + 1, 0], want[:, 15], atol=1e-4, rtol=1e-4)


def test_a_jax_init_tree_carries_across_and_packs_float_for_float(models):
    """``params_from_numpy`` carries the JAX tree (the stacked Mamba2
    layers, the one shared block); it packs to the JAX plane, and the
    PackSpec digest and size equal JAX's at smoke width and, from the
    meta-device init against ``jax.eval_shape``, at full width."""
    _, _, jp, tb, tp = models["smoke"]
    jspec = jax_make_pack_spec(jp)
    spec = make_pack_spec(tp)
    assert spec.digest == jspec.digest == make_pack_spec(tb.init(None)).digest
    np.testing.assert_array_equal(pack(tp, spec).numpy(), np.asarray(jax_pack(jp, jspec)))
    assert tp["shared"]["attn"]["wq"].dim() == 2 and tp["mamba"]["in_proj"].shape[0] == 2
    full = tregistry.build_model(tbase.get_config(ARCH)).init(None)
    jfull = jax.eval_shape(jregistry.build_model(jbase.get_config(ARCH)).init,
                           jax.random.PRNGKey(0))
    spec, jspec = make_pack_spec(full), jax_make_pack_spec(jfull)
    assert spec.digest == jspec.digest and spec.size == jspec.size == 1_170_473_856


# --------------------------------------------------------------------------
# generation
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_plane():
    """(JAX bundle, JAX spec, the (2, X) plane of bundle.init at keys 0 and
    1, prompts) at the trailing-segment config."""
    cfg = jbase.get_smoke_config(ARCH).with_overrides(**CONFIGS["trailing"])
    bundle = jregistry.build_model(cfg, attn_mode="ref")
    init = jax.jit(bundle.init)
    spec = jax_make_pack_spec(jax.eval_shape(bundle.init, jax.random.PRNGKey(0)))
    plane = np.stack([np.asarray(jax_pack(init(jax.random.PRNGKey(s)), spec))
                      for s in range(2)])
    prompts = np.random.default_rng(3).integers(0, cfg.vocab, (4, 16)).astype(np.int32)
    return bundle, spec, plane, prompts


@pytest.mark.parametrize("codec", ["int8", "int4"])
def test_greedy_generate_gives_the_jax_servers_tokens(jax_plane, tmp_path, codec):
    """Both servers from one JAX-exported artifact (fp32, at the smoke
    config, in ``tests/test_torch_lm_serve.py``)."""
    jbundle, jspec, plane, prompts = jax_plane
    path = str(tmp_path / f"zamba2_{codec}.npz")
    jax_save_servable(path, plane, jspec, arch=ARCH, codec=codec)
    jsrv = JaxServer.from_artifact(jax_load_servable(path, jspec), jspec, bundle=jbundle)
    bundle = tregistry.build_model(tbase.get_smoke_config(ARCH).with_overrides(
        **CONFIGS["trailing"]))
    spec = make_pack_spec(bundle.init(None))
    tsrv = ClusterPlaneServer.from_artifact(load_servable(path, spec, device="cpu"), spec,
                                            bundle=bundle, device="cpu")
    want = np.asarray(jsrv.generate(U, prompts, gen=GEN))
    np.testing.assert_array_equal(tsrv.generate(U, prompts, gen=GEN).numpy(), want)
    assert tsrv.plane_bytes == jsrv.plane_bytes


@pytest.mark.parametrize("temperature", [0.0, 0.7])
@pytest.mark.parametrize("name,codec", [("smoke", "int8"), ("trailing", "fp32")])
def test_the_engine_equals_the_eager_decode_bit_for_bit(name, codec, temperature):
    """The decode engine (the closure the card captures, called directly
    here) against ``decode_eager``: tokens and the last logits equal; the
    engine's cache holds every hybrid buffer and is zeroed each call (two
    calls give a fresh server's tokens)."""
    cfg = tbase.get_smoke_config(ARCH).with_overrides(**CONFIGS[name])
    bundle = tregistry.build_model(cfg)
    spec = make_pack_spec(bundle.init(None))
    planes = launch_serve.random_server_plane(bundle, spec, seed=0, codec=codec, device="cpu")
    server = ClusterPlaneServer(spec, codec=codec, bundle=bundle, device="cpu", **planes)
    prompts = torch.randint(0, cfg.vocab, (4, 12), generator=torch.Generator().manual_seed(1))
    gen = 5
    noise = (torch.randn((gen, 4, cfg.vocab), generator=torch.Generator().manual_seed(2))
             if temperature > 0 else None)
    first = server.generate(U, prompts, gen=gen, temperature=temperature, noise=noise)
    other = server.generate(U[::-1].copy(), prompts.flip(0), gen=gen, temperature=temperature,
                            noise=noise)
    got = server.generate(U, prompts, gen=gen, temperature=temperature, noise=noise)
    assert torch.equal(got, first) and server.n_compiles == 1
    assert not torch.equal(other, first)
    engine = server.engines[(4, 12, gen, temperature)]
    assert set(engine.cache) == set(CACHE_KEYS) | {"pos"}
    params = cast_params_for_compute(server.personalized(U), cfg.compute_dtype_torch())
    want, last = decode_eager(bundle, params, prompts, gen=gen, temperature=temperature,
                              noise=noise)
    assert torch.equal(got, want) and torch.equal(engine.logits, last)


def test_launch_serve_runs_zamba2_on_the_cpu(capsys):
    toks = launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--codec", "int4",
                              "--gen", "4", "--batch", "2", "--mixture", "0.6,0.4"])
    assert tuple(toks.shape) == (2, 4) and int(toks.max()) < tbase.get_smoke_config(ARCH).vocab
    assert "generated 4 tokens × 2 requests" in capsys.readouterr().out
