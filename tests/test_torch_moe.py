"""The port's MoE family (olmoe-1b-7b, phi3.5-moe: ``models/moe.py`` and
the MoE layers of ``models/transformer.py``) against the JAX package on the
CPU, weights from JAX inits carried across as numpy arrays.

Tolerances, as ``tests/test_torch_lm.py`` states them for the dense
family: one fp32 MoE layer (``apply_moe``) at 1e-5 (the same products,
summed in other orders); whole smoke models (two fp32 layers) at 1e-4
for logits and caches, 1e-5 for the summed aux. Slot positions, drop
counts, the expert choice at a tie and generated tokens are equal.

The decode step is held against the JAX package's step on the same cache,
never prefill + decode against the forward: with capacity drops the
reference itself fails that for olmoe (``test_decode_consistency.py``).
The JAX programs compile once per module where they can (module-scoped
fixtures), at smoke width.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core.packing import make_pack_spec as jax_make_pack_spec
from repro.core.packing import pack as jax_pack
from repro.models import moe as jmoe
from repro.models import registry as jregistry
from repro.serve import ClusterPlaneServer as JaxServer
from repro.serve import load_servable as jax_load_servable
from repro.serve import save_servable as jax_save_servable
from repro_torch.comm.codecs import Channel, CommConfig, int4_unpack
from repro_torch.configs import base as tbase
from repro_torch.core.packing import make_pack_spec, pack
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve as launch_serve
from repro_torch.models import moe as tmoe
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


ARCHS = ["olmoe-1b-7b", "phi3.5-moe-42b-a6.6b"]
U = np.array([[0.7, 0.3], [0.5, 0.5], [0.0, 1.0], [0.2, 0.8]], np.float32)
GEN = 6


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def _tree(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


# --------------------------------------------------------------------------
# routing
# --------------------------------------------------------------------------


@pytest.mark.parametrize("tk,e,skew", [(64, 4, False), (40, 8, True), (512, 64, False),
                                       (1, 4, False)])
def test_slot_positions_cumsum_equal_sort_equal_jax(tk, e, skew):
    """Each (token, slot)'s place in its expert's queue, by both of the
    port's methods and both of JAX's; many tokens share an expert (ranks
    tie on the expert and go in token order)."""
    rng = np.random.default_rng(tk + e)
    p = np.array([0.7] + [0.3 / (e - 1)] * (e - 1)) if skew else None
    flat = rng.choice(e, size=(2, tk), p=p)
    ported = tmoe._slot_positions_cumsum(torch.as_tensor(flat), e)
    assert torch.equal(ported, tmoe._slot_positions_sort(torch.as_tensor(flat), e))
    for row in range(2):
        j = jnp.asarray(flat[row], jnp.int32)
        want = np.asarray(jmoe._slot_positions_cumsum(j, e))
        np.testing.assert_array_equal(np.asarray(jmoe._slot_positions_sort(j, e)), want)
        np.testing.assert_array_equal(ported[row].numpy(), want)


def _jax_drops(params, x, *, top_k, capacity_factor, dispatch):
    """The (token, expert) pairs the JAX package's ``_moe_core`` drops,
    from its own routing functions: per sequence under "grouped", over
    the batch otherwise."""
    e = params["w_in"].shape[0]
    groups = [x[i:i + 1] for i in range(x.shape[0])] if dispatch == "grouped" else [x]
    total = 0
    for xg in groups:
        b, l, d = xg.shape
        t = b * l
        probs = jax.nn.softmax(xg.reshape(t, d).astype(jnp.float32) @ params["router"], -1)
        _, idx = jax.lax.top_k(probs, top_k)
        cap = t if l == 1 else int(max(1, capacity_factor * top_k * t / e))
        cap = min(cap, t)
        pos = jmoe._slot_positions_sort(idx.reshape(-1), e)
        total += int(jnp.sum(pos >= cap))
    return total


class _Drops:
    """The port's dropped pairs per ``_slots`` call, within the block."""

    def __init__(self, monkeypatch):
        self.calls, real = [], tmoe._slots

        def slots(fe, e, cap, mode):
            keep, slot = real(fe, e, cap, mode)
            self.calls.append(int((~keep).sum()))
            return keep, slot

        monkeypatch.setattr(tmoe, "_slots", slots)


def _moe_inputs(seed, b, l, d=32, f=48, e=8, act="silu"):
    params = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(seed), d, f, e, act,
                                                    jnp.float32))
    x = np.random.default_rng(seed).standard_normal((b, l, d)).astype(np.float32)
    return params, x


@pytest.mark.parametrize("dispatch", ["cumsum", "sort", "grouped"])
@pytest.mark.parametrize("b,l,act,cf", [(2, 24, "silu", 1.0), (3, 1, "gelu", 1.25),
                                        (1, 16, "silu", 1.25)])
def test_apply_moe_matches_jax(monkeypatch, dispatch, b, l, act, cf):
    """out and aux within 1e-5 and the same drops: capacity factor 1.0
    over 48 tokens drops some; one decode token (l = 1) at B = 3 drops
    none (capacity = t)."""
    params, x = _moe_inputs(b * 10 + l, b, l, act=act)
    want, aux = jax.jit(lambda p, x: jmoe.apply_moe(
        p, x, top_k=2, capacity_factor=cf, act=act, dispatch=dispatch))(params, x)
    drops = _Drops(monkeypatch)
    got, got_aux = tmoe.apply_moe(params_from_numpy(params, device="cpu"), torch.as_tensor(x),
                                  top_k=2, capacity_factor=cf, act=act, dispatch=dispatch)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)
    np.testing.assert_allclose(float(got_aux), float(aux), atol=1e-5)
    jd = _jax_drops(jax.tree.map(jnp.asarray, params), jnp.asarray(x), top_k=2,
                    capacity_factor=cf, dispatch=dispatch)
    assert sum(drops.calls) == jd
    if (b, l) == (2, 24):
        assert jd > 0
    if l == 1:
        assert jd == 0


def test_a_top_k_tie_goes_to_the_lower_index_as_in_jax():
    """Experts 1 and 2 have equal router columns, and a constant input
    feature lifts both far above the rest: every token ties between them
    at top-1, and both packages take expert 1 (the experts' weights
    differ, so the other choice would move the output)."""
    params, x = _moe_inputs(5, 2, 8, e=4)
    x[..., 0] = 1.0
    router = params["router"].copy()
    router[0, 1] = 50.0
    router[:, 2] = router[:, 1]
    params = dict(params, router=router)
    probs = jax.nn.softmax(jnp.asarray(x).reshape(16, -1) @ router, -1)
    _, jidx = jax.lax.top_k(probs, 1)
    _, tidx = tmoe._top_k(torch.tensor(np.asarray(probs)), 1)
    assert (np.asarray(jidx) == 1).all() and (tidx.numpy() == 1).all()
    for dispatch in ("cumsum", "sort"):
        want, _ = jax.jit(lambda p, x: jmoe.apply_moe(
            p, x, top_k=1, capacity_factor=4.0, act="silu", dispatch=dispatch))(params, x)
        got, _ = tmoe.apply_moe(params_from_numpy(params, device="cpu"), torch.as_tensor(x),
                                top_k=1, capacity_factor=4.0, act="silu", dispatch=dispatch)
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)


@pytest.mark.parametrize("dispatch", ["cumsum", "sort", "grouped"])
@pytest.mark.parametrize("l", [24, 1])
def test_request_batched_leaves_route_each_request_alone_as_jax_vmap(monkeypatch, dispatch, l):
    """Leaves with the request axis (the server's): each request through
    its own experts and routed alone, its own capacity and drops, as the
    JAX server's ``vmap`` of ``apply_moe`` over requests; aux per
    request."""
    reqs = [_moe_inputs(20 + i, 1, l) for i in range(3)]
    params = jax.tree.map(lambda *a: np.stack(a), *[p for p, _ in reqs])
    x = np.concatenate([xi for _, xi in reqs])

    @jax.jit
    def jax_side(p, x):
        return jax.vmap(lambda pr, xr: jmoe.apply_moe(
            pr, xr[None], top_k=2, capacity_factor=1.0, act="silu", dispatch=dispatch))(p, x)

    want, aux = jax_side(params, x)
    drops = _Drops(monkeypatch)
    got, got_aux = tmoe.apply_moe(params_from_numpy(params, device="cpu"), torch.as_tensor(x),
                                  top_k=2, capacity_factor=1.0, act="silu", dispatch=dispatch)
    assert got.shape == x.shape and got_aux.shape == (3,)
    np.testing.assert_allclose(_np(got), _np(want)[:, 0], atol=1e-5)
    np.testing.assert_allclose(_np(got_aux), _np(aux), atol=1e-5)
    jd = sum(_jax_drops(jax.tree.map(lambda a: jnp.asarray(a[i]), params),
                        jnp.asarray(x[i:i + 1]), top_k=2, capacity_factor=1.0,
                        dispatch=dispatch) for i in range(3))
    assert sum(drops.calls) == jd
    assert (jd > 0) == (l > 1)


def test_unknown_dispatch_raises():
    params, x = _moe_inputs(0, 1, 4)
    with pytest.raises(ValueError, match="dispatch"):
        tmoe.apply_moe(params_from_numpy(params, device="cpu"), torch.as_tensor(x), top_k=2,
                       capacity_factor=1.0, act="silu", dispatch="einsum")


# --------------------------------------------------------------------------
# whole models at smoke width
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    """Per arch: (JAX config, JAX bundle on the Pallas flash kernel, JAX
    params, the port's bundle, the same params in the port)."""
    out = {}
    for arch in ARCHS:
        jc = jbase.get_smoke_config(arch)
        jb = jregistry.build_model(jc, attn_mode="pallas")
        jp = jax.jit(jb.init)(jax.random.PRNGKey(7))
        out[arch] = (jc, jb, jp, tregistry.build_model(tbase.get_smoke_config(arch)), _tree(jp))
    return out


def _cache_to_torch(cache) -> dict:
    out = params_from_numpy(jax.tree.map(np.asarray, cache), device="cpu")
    out["pos"] = out["pos"].to(torch.int64)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_and_one_decode_step_match_jax(models, arch):
    """olmoe (MHA 4/4) and phi3.5-moe (GQA 8/2): logits and the summed
    aux of the forward, the prefill's k/v rows, and one decode step from
    the JAX package's own prefill cache (logits, the written row, pos)."""
    jc, jb, jp, tb, tp = models[arch]
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
    assert float(aj) > 0
    np.testing.assert_allclose(float(at), float(aj), atol=1e-5)
    ct = tb.prefill(tp, {"tokens": torch.as_tensor(prompt)},
                    tb.init_cache(2, max_len, device="cpu"))
    assert int(ct["pos"]) == int(cj["pos"]) == 32
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(ct[key]), _np(cj[key]), atol=1e-4)
    cache = _cache_to_torch(cj)
    dt_, out = tb.decode_step(tp, cache, torch.as_tensor(nxt, dtype=torch.int64))
    assert out is cache and int(cache["pos"]) == int(cj2["pos"]) == 33
    np.testing.assert_allclose(_np(dt_), _np(dj), atol=1e-4)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(cache[key]), _np(cj2[key]), atol=1e-4)


def test_losses_match_jax(models):
    """``loss`` adds 0.01 · aux to the mean next-token loss, as JAX's."""
    jc, jb, jp, tb, tp = models["olmoe-1b-7b"]
    toks = np.random.default_rng(13).integers(0, jc.vocab, (2, 32)).astype(np.int32)
    loss, per_example = jax.jit(lambda p, b: (jb.loss(p, b), jb.per_example_loss(p, b)))(
        jp, {"tokens": jnp.asarray(toks)})
    batch = {"tokens": torch.as_tensor(toks)}
    np.testing.assert_allclose(float(tb.loss(tp, batch)), float(loss), atol=1e-5)
    np.testing.assert_allclose(_np(tb.per_example_loss(tp, batch)), _np(per_example),
                               atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_a_jax_init_tree_carries_across_and_packs_float_for_float(models, arch):
    """``params_from_numpy`` carries the JAX tree (the fp32 router beside
    the experts); it packs to the JAX plane, and the PackSpec digest and
    size equal JAX's at smoke width and, from the meta-device init
    against ``jax.eval_shape``, at full width."""
    _, _, jp, tb, tp = models[arch]
    jspec = jax_make_pack_spec(jp)
    spec = make_pack_spec(tp)
    assert spec.digest == jspec.digest == make_pack_spec(tb.init(None)).digest
    np.testing.assert_array_equal(pack(tp, spec).numpy(), np.asarray(jax_pack(jp, jspec)))
    assert tp["layers"]["moe"]["router"].dtype == torch.float32
    full = tregistry.build_model(tbase.get_config(arch)).init(None)
    jfull = jax.eval_shape(jregistry.build_model(jbase.get_config(arch)).init,
                           jax.random.PRNGKey(0))
    spec, jspec = make_pack_spec(full), jax_make_pack_spec(jfull)
    assert spec.digest == jspec.digest and spec.size == jspec.size
    assert spec.size == {"olmoe-1b-7b": 6_919_620_608,
                         "phi3.5-moe-42b-a6.6b": 41_874_100_224}[arch]


# --------------------------------------------------------------------------
# generation
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """``servers(arch, codec)``: the JAX server and the port's, each loaded
    from one JAX-exported artifact of a 2-cluster plane (built once)."""
    made = {}

    def get(arch, codec):
        if (arch, codec) not in made:
            cfg = jbase.get_smoke_config(arch)
            jbundle = jregistry.build_model(cfg, attn_mode="ref")
            init = jax.jit(jbundle.init)
            jspec = jax_make_pack_spec(jax.eval_shape(jbundle.init, jax.random.PRNGKey(0)))
            plane = np.stack([np.asarray(jax_pack(init(jax.random.PRNGKey(s)), jspec))
                              for s in range(2)])
            path = str(tmp_path_factory.mktemp("art") / f"{arch}_{codec}.npz")
            jax_save_servable(path, plane, jspec, arch=arch, codec=codec)
            jsrv = JaxServer.from_artifact(jax_load_servable(path, jspec), jspec,
                                           bundle=jbundle)
            bundle = tregistry.build_model(tbase.get_smoke_config(arch))
            spec = make_pack_spec(bundle.init(None))
            tsrv = ClusterPlaneServer.from_artifact(load_servable(path, spec, device="cpu"),
                                                    spec, bundle=bundle, device="cpu")
            prompts = np.random.default_rng(len(arch)).integers(0, cfg.vocab, (4, 16))
            made[arch, codec] = (jsrv, tsrv, prompts.astype(np.int32))
        return made[arch, codec]

    return get


@pytest.mark.parametrize("arch,codec", [("olmoe-1b-7b", "int8"), ("olmoe-1b-7b", "int4")])
def test_greedy_generate_gives_the_jax_servers_tokens(servers, arch, codec):
    """Each request routed alone in its prefill and decode, as the JAX
    server's ``vmap`` routes it (fp32, and phi3.5-moe, in
    ``tests/test_torch_lm_serve.py``)."""
    jsrv, tsrv, prompts = servers(arch, codec)
    want = np.asarray(jsrv.generate(U, prompts, gen=GEN))
    got = tsrv.generate(U, prompts, gen=GEN)
    np.testing.assert_array_equal(got.numpy(), want)
    assert tsrv.plane_bytes == jsrv.plane_bytes


def test_sampling_with_the_jax_gumbel_draws_gives_its_tokens(servers):
    jsrv, tsrv, prompts = servers("olmoe-1b-7b", "int8")
    key, temp = jax.random.PRNGKey(5), 0.7
    want = np.asarray(jsrv.generate(U, prompts, gen=GEN, temperature=temp, key=key))
    vocab = tbase.get_smoke_config("olmoe-1b-7b").vocab
    noise = np.stack([np.asarray(jax.random.gumbel(k, (4, vocab), jnp.float32))
                      for k in jax.random.split(key, GEN)])
    got = tsrv.generate(U, prompts, gen=GEN, temperature=temp, noise=noise)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("temperature", [0.0, 0.7])
@pytest.mark.parametrize("arch,codec", [("olmoe-1b-7b", "int8"),
                                        ("phi3.5-moe-42b-a6.6b", "int4")])
def test_the_engine_equals_the_eager_decode_bit_for_bit(arch, codec, temperature):
    """The decode engine (the closure the card captures, called directly
    here) against ``decode_eager``: tokens and the last logits equal."""
    cfg = tbase.get_smoke_config(arch)
    bundle = tregistry.build_model(cfg)
    spec = make_pack_spec(bundle.init(None))
    server = ClusterPlaneServer(spec, codec=codec, bundle=bundle, device="cpu",
                                **launch_serve.random_server_plane(bundle, spec, seed=0,
                                                                   codec=codec, device="cpu"))
    prompts = torch.randint(0, cfg.vocab, (4, 12), generator=torch.Generator().manual_seed(1))
    gen = 5
    noise = (torch.randn((gen, 4, cfg.vocab), generator=torch.Generator().manual_seed(2))
             if temperature > 0 else None)
    got = server.generate(U, prompts, gen=gen, temperature=temperature, noise=noise)
    engine = server.engines[(4, 12, gen, temperature)]
    params = cast_params_for_compute(server.personalized(U), cfg.compute_dtype_torch())
    want, last = decode_eager(bundle, params, prompts, gen=gen, temperature=temperature,
                              noise=noise)
    assert torch.equal(got, want) and torch.equal(engine.logits, last)


@pytest.mark.parametrize("codec,qblock", [("int8", 64), ("int4", 64), ("int8", 33)])
def test_the_random_plane_encoded_row_by_row_is_encode_plane_of_it(monkeypatch, codec,
                                                                   qblock):
    """``random_server_plane`` (each cluster drawn, packed and encoded in
    chunks of whole blocks, never the fp32 plane) gives ``encode_plane``
    of ``random_plane`` byte for byte; so does ``encode_plane`` in chunks
    against one ``Channel.encode`` of the whole row."""
    bundle = tregistry.build_model(tbase.get_smoke_config("olmoe-1b-7b"))
    spec = make_pack_spec(bundle.init(None))
    plane = launch_serve.random_plane(bundle, spec, seed=4, device="cpu")
    whole = launch_serve.encode_plane(plane, codec, qblock)
    monkeypatch.setattr(launch_serve, "ENCODE_COLUMNS", 1000)   # many chunks, a ragged last
    rows = launch_serve.random_server_plane(bundle, spec, seed=4, codec=codec, qblock=qblock,
                                            device="cpu")
    assert set(rows) == set(whole)
    for k in rows:
        assert rows[k].dtype == whole[k].dtype and torch.equal(rows[k], whole[k])
    ch = Channel(CommConfig(codec=codec, block=qblock), spec.size)
    one = ch.encode(plane[1:], rounding="nearest")
    q = rows["plane_q"] if codec == "int8" else int4_unpack(
        rows["plane_packed"], rows["plane_packed"].shape[1] * 2)
    assert torch.equal(q[1:], one["q"]) and torch.equal(rows["plane_scale"][1:], one["scale"])


def test_launch_serve_runs_olmoe_on_the_cpu(capsys):
    toks = launch_serve.main(["--arch", "olmoe-1b-7b", "--smoke", "--device", "cpu",
                              "--codec", "int8", "--batch", "1", "--gen", "4"])
    assert tuple(toks.shape) == (1, 4)
    assert int(toks.max()) < tbase.get_smoke_config("olmoe-1b-7b").vocab
    assert "generated 4 tokens × 1 requests" in capsys.readouterr().out
