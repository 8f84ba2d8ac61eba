"""The decode path on a device position and ``generate``'s decode engine,
on the CPU (~15 s in one process; three JAX compiles, at smoke width).

- ``decode_step`` against the JAX package's ``dynamic_update_slice`` path
  on the olmo-1b, gemma3-1b, mamba2-370m, olmoe-1b-7b, phi3.5-moe and
  zamba2-1.2b smoke configs: two steps after a prefill give JAX's logits
  and caches (k/v rows, the SSD state and conv tail, the shared block's
  k/v rows) at 1e-4 (two fp32 layers), the position advances in place,
  every cache tensor keeps its storage (``data_ptr``), and no op of a
  step reads a device value on the host (what a CUDA-graph capture
  refuses);
- the engine (the closure the card captures, called directly here)
  against ``decode_eager``, the same steps launched one by one: tokens and
  the last logits equal bit for bit, greedy and with Gumbel noise;
- ``n_compiles`` counts one engine per shape key, the keys of one B share
  its leaves, and back-to-back calls on one server each give what a fresh
  server gives.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import profile

from repro.configs import base as jbase
from repro.models import registry as jregistry
from repro_torch.configs.base import get_smoke_config
from repro_torch.core.packing import make_pack_spec
from repro_torch.interop import params_from_numpy
from repro_torch.launch.serve import encode_plane, random_plane
from repro_torch.models.layers import cast_params_for_compute
from repro_torch.models.registry import build_model
from repro_torch.serve import ClusterPlaneServer
from repro_torch.serve.server import decode_eager


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one thread: the test workers share the host's
    cores, and torch's default thread count in each oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCHS = ["olmo-1b", "gemma3-1b", "mamba2-370m", "olmoe-1b-7b", "phi3.5-moe-42b-a6.6b",
         "zamba2-1.2b"]
U = np.array([[0.7, 0.3], [0.5, 0.5], [0.0, 1.0], [0.2, 0.8]], np.float32)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_on_a_device_position_match_jax_in_place(arch):
    jc = jbase.get_smoke_config(arch)
    jb = jregistry.build_model(jc, attn_mode="ref")
    tb = build_model(get_smoke_config(arch))
    jp = jax.jit(jb.init)(jax.random.PRNGKey(3))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(4).integers(0, jc.vocab, (2, 18)).astype(np.int32)
    prompt, steps, max_len = toks[:, :16], (toks[:, 16:17], toks[:, 17:18]), 24

    @jax.jit
    def jax_side(p, prompt, a, b):
        cache = jb.prefill(p, {"tokens": prompt}, jb.init_cache(2, max_len))
        la, cache = jb.decode_step(p, cache, a)
        lb, cache = jb.decode_step(p, cache, b)
        return la, lb, cache

    la, lb, cj = jax_side(jp, jnp.asarray(prompt), *map(jnp.asarray, steps))

    cache = tb.init_cache(2, max_len, device="cpu")
    pos = cache["pos"]
    assert pos.dim() == 0 and pos.dtype == torch.int64 and int(pos) == 0
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    assert tb.prefill(tp, {"tokens": torch.as_tensor(prompt)}, cache) is cache
    assert int(pos) == 16
    logits = []
    for i, nxt in enumerate(steps):
        with profile() as prof:
            lg, out = tb.decode_step(tp, cache, torch.as_tensor(nxt, dtype=torch.int64))
        assert out is cache and cache["pos"] is pos and int(pos) == 17 + i
        reads = {e.key for e in prof.key_averages()} & {"aten::item", "aten::_local_scalar_dense"}
        assert not reads, f"the decode step reads a device value on the host: {reads}"
        logits.append(lg)
    assert {k: v.data_ptr() for k, v in cache.items()} == ptrs
    np.testing.assert_allclose(_np(logits[0]), _np(la), atol=1e-4)
    np.testing.assert_allclose(_np(logits[1]), _np(lb), atol=1e-4)
    assert int(cj["pos"]) == int(pos) == 18
    assert set(cache) == set(cj)
    for key in set(cj) - {"pos"}:
        assert tuple(cache[key].shape) == cj[key].shape
        np.testing.assert_allclose(_np(cache[key]), _np(cj[key]), atol=1e-4)


def _server(arch, codec="fp32"):
    cfg = get_smoke_config(arch)
    bundle = build_model(cfg)
    spec = make_pack_spec(bundle.init(None))
    plane = random_plane(bundle, spec, seed=0, device="cpu")
    return ClusterPlaneServer(spec, codec=codec, bundle=bundle, device="cpu",
                              **encode_plane(plane, codec)), cfg


def _prompts(cfg, b=4, lp=12, seed=1):
    return torch.randint(0, cfg.vocab, (b, lp), generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("temperature", [0.0, 0.7])
@pytest.mark.parametrize("arch,codec", [("olmo-1b", "int8"), ("gemma3-1b", "fp32"),
                                        ("mamba2-370m", "int4")])
def test_the_engine_equals_the_eager_decode_bit_for_bit(arch, codec, temperature):
    server, cfg = _server(arch, codec)
    prompts, gen = _prompts(cfg), 5
    noise = (torch.randn((gen, 4, cfg.vocab), generator=torch.Generator().manual_seed(2))
             if temperature > 0 else None)
    got = server.generate(U, prompts, gen=gen, temperature=temperature, noise=noise)
    engine = server.engines[(4, prompts.shape[1], gen, temperature)]
    params = cast_params_for_compute(server.personalized(U), cfg.compute_dtype_torch())
    want, last = decode_eager(server.bundle, params, prompts, gen=gen,
                              temperature=temperature, noise=noise)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(engine.logits, last)
    assert int(engine.step) == gen and engine.graph is None   # the CPU runs the closure


def test_n_compiles_counts_one_engine_per_shape_key():
    server, cfg = _server("olmo-1b")
    prompts = _prompts(cfg)
    assert server.n_compiles == 0
    a = server.generate(U, prompts, gen=4)
    leaves = server.leaves[4]
    ptrs = [v.data_ptr() for v in server.engines[(4, 12, 4, 0.0)].cache.values()]
    b = server.generate(U, prompts, gen=4)
    assert torch.equal(a, b) and server.n_compiles == 1
    assert [v.data_ptr() for v in server.engines[(4, 12, 4, 0.0)].cache.values()] == ptrs
    server.generate(U, prompts, gen=3)                       # a second gen
    assert server.n_compiles == 2 and server.engines[(4, 12, 3, 0.0)].params is leaves
    server.generate(U[:2], prompts[:2], gen=4)               # a second B
    assert server.n_compiles == 3 and set(server.leaves) == {4, 2}
    server.generate(U, prompts, gen=4, temperature=0.5, key=1)
    assert server.n_compiles == 4
    assert server.telemetry_snapshot()["n_compiles"] == 4 and server.n_dispatches == 5
    with pytest.raises(ValueError, match="gen=0"):
        server.generate(U, prompts, gen=0)


@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-370m"])
def test_back_to_back_calls_give_what_a_fresh_server_gives(arch):
    server, cfg = _server(arch, "int8")
    u2 = U[::-1].copy()
    p1, p2 = _prompts(cfg, seed=5), _prompts(cfg, seed=6)
    first = server.generate(U, p1, gen=5)
    second = server.generate(u2, p2, gen=5)
    assert server.n_compiles == 1
    assert torch.equal(second, _server(arch, "int8")[0].generate(u2, p2, gen=5))
    assert torch.equal(first, _server(arch, "int8")[0].generate(U, p1, gen=5))
    assert torch.equal(server.generate(U, p1, gen=5), first)
    assert not torch.equal(first, second)
