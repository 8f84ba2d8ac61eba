"""LM generation from the cluster plane: the port's ``ClusterPlaneServer``
(``generate``, ``serve_client``), ``ServeConfig`` and ``launch/serve``
against the JAX package on the CPU.

Planes and artifacts come from the JAX package (``bundle.init`` with JAX
keys, ``save_servable``) and are served by both servers: greedy tokens
equal in fp32 at every ported smoke arch (the MoE and hybrid ones
included), and in int8 and int4 on olmo-1b and mamba2-370m (after the mix,
generation is the fp32 path's; ``tests/test_torch_moe.py`` and
``tests/test_torch_hybrid.py`` serve olmoe and zamba2 in int8 and int4); at temperature > 0 the port takes the JAX server's Gumbel
draws (``jax.random.gumbel`` over ``split(key, gen)``) as ``noise=`` and
gives its tokens. Each JAX server compiles its generate program once, so
the pairs are built once per module. Configs resolve with the JAX
package's messages; audio and the surfaces not ported raise.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.core.packing import make_pack_spec as jax_make_pack_spec
from repro.core.packing import pack as jax_pack
from repro.models.registry import build_model as jax_build_model
from repro.serve import ClusterPlaneServer as JaxServer
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import load_servable as jax_load_servable
from repro.serve import save_servable as jax_save_servable
from repro_torch.configs.base import get_smoke_config
from repro_torch.core.packing import make_pack_spec
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.launch import serve as launch_serve
from repro_torch.models.registry import build_model
from repro_torch.serve import ClusterPlaneServer, ServeConfig, load_servable


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one thread: the test workers share the host's
    cores, and torch's default thread count in each oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCHS = ["olmo-1b", "h2o-danube-1.8b", "gemma3-1b", "granite-3-8b", "chameleon-34b",
         "mamba2-370m", "olmoe-1b-7b", "phi3.5-moe-42b-a6.6b", "zamba2-1.2b"]
U = np.array([[0.7, 0.3], [0.5, 0.5], [0.0, 1.0], [0.2, 0.8]], np.float32)
GEN = 6


@pytest.fixture(scope="module")
def jax_planes():
    """Per arch: (JAX bundle, JAX spec, the (2, X) plane of bundle.init at
    keys 0 and 1, prompts)."""
    out = {}
    for arch in ARCHS:
        cfg = jax_smoke_config(arch)
        bundle = jax_build_model(cfg, attn_mode="ref")
        init = jax.jit(bundle.init)
        spec = jax_make_pack_spec(jax.eval_shape(bundle.init, jax.random.PRNGKey(0)))
        plane = np.stack([np.asarray(jax_pack(init(jax.random.PRNGKey(s)), spec))
                          for s in range(2)])
        prompts = np.random.default_rng(len(arch)).integers(0, cfg.vocab, (4, 16))
        out[arch] = (bundle, spec, plane, prompts.astype(np.int32))
    return out


@pytest.fixture(scope="module")
def servers(jax_planes, tmp_path_factory):
    """``servers(arch, codec)``: the JAX server and the port's, each loaded
    from one JAX-exported artifact of the plane (built once per pair)."""
    made = {}

    def get(arch, codec):
        if (arch, codec) not in made:
            jbundle, jspec, plane, prompts = jax_planes[arch]
            path = str(tmp_path_factory.mktemp("art") / f"{arch}_{codec}.npz")
            u_table = np.random.default_rng(0).dirichlet(np.ones(2), size=5)
            jax_save_servable(path, plane, jspec, arch=arch, u=u_table.astype(np.float32),
                              codec=codec)
            jsrv = JaxServer.from_artifact(jax_load_servable(path, jspec), jspec,
                                           bundle=jbundle)
            bundle = build_model(get_smoke_config(arch))
            spec = make_pack_spec(bundle.init(None))
            assert spec.digest == jspec.digest
            tsrv = ClusterPlaneServer.from_artifact(load_servable(path, spec, device="cpu"),
                                                    spec, bundle=bundle, device="cpu")
            made[arch, codec] = (jsrv, tsrv, prompts)
        return made[arch, codec]

    return get


@pytest.mark.parametrize("arch,codec", [(a, "fp32") for a in ARCHS] + [
    (a, c) for a in ("olmo-1b", "mamba2-370m") for c in ("int8", "int4")])
def test_greedy_generate_gives_the_jax_servers_tokens(servers, arch, codec):
    jsrv, tsrv, prompts = servers(arch, codec)
    want = np.asarray(jsrv.generate(U, prompts, gen=GEN))
    flash_attention.launches = ssd_scan.launches = 0
    calls = tsrv.n_dispatches
    got = tsrv.generate(U, prompts, gen=GEN)
    assert got.dtype == torch.int32 and tuple(got.shape) == (4, GEN)
    np.testing.assert_array_equal(got.numpy(), want)
    assert flash_attention.launches == ssd_scan.launches == 0   # CPU: plain versions
    assert tsrv.n_dispatches == calls + 1
    assert tsrv.dequant_calls == (tsrv.n_dispatches if codec != "fp32" else 0)
    assert tsrv.plane_bytes == jsrv.plane_bytes


@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-370m"])
def test_sampling_with_the_jax_gumbel_draws_gives_its_tokens(servers, arch):
    jsrv, tsrv, prompts = servers(arch, "fp32")
    key, temp = jax.random.PRNGKey(5), 0.7
    want = np.asarray(jsrv.generate(U, prompts, gen=GEN, temperature=temp, key=key))
    vocab = get_smoke_config(arch).vocab
    noise = np.stack([np.asarray(jax.random.gumbel(k, (4, vocab), jnp.float32))
                      for k in jax.random.split(key, GEN)])
    got = tsrv.generate(U, prompts, gen=GEN, temperature=temp, noise=noise)
    np.testing.assert_array_equal(got.numpy(), want)
    greedy = tsrv.generate(U, prompts, gen=GEN)
    assert not torch.equal(got, greedy)   # the draws moved some token
    # without noise= the draws come from key (a seed or a torch.Generator)
    a = tsrv.generate(U, prompts, gen=GEN, temperature=temp, key=3)
    b = tsrv.generate(U, prompts, gen=GEN, temperature=temp,
                      key=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="noise"):
        tsrv.generate(U, prompts, gen=GEN, temperature=temp, noise=noise[:2])


def test_serve_client_matches_the_jax_server(servers):
    jsrv, tsrv, prompts = servers("mamba2-370m", "int8")
    want = np.asarray(jsrv.serve_client(3, prompts, gen=GEN))
    np.testing.assert_array_equal(tsrv.serve_client(3, prompts, gen=GEN).numpy(), want)


def test_generate_needs_a_bundle_and_serve_client_a_u_table():
    bundle = build_model(get_smoke_config("olmo-1b"))
    spec = make_pack_spec(bundle.init(None))
    plane = torch.zeros((2, spec.size))
    with pytest.raises(ValueError, match="bundle"):
        ClusterPlaneServer(spec, plane=plane, device="cpu").generate(U, np.zeros((4, 8)), gen=2)
    with pytest.raises(ValueError, match="u_table"):
        ClusterPlaneServer(spec, plane=plane, bundle=bundle, device="cpu").serve_client(
            0, np.zeros((4, 8)), gen=2)


# --------------------------------------------------------------------------
# ServeConfig
# --------------------------------------------------------------------------


BAD_CONFIGS = [
    dict(arch="gpt-2"), dict(batch=0), dict(prompt_len=-1), dict(gen=1.5),
    dict(qblock=0), dict(temperature=-0.1), dict(codec="fp16"),
    dict(codec="int4", qblock=33), dict(client=0, mixture=[0.5, 0.5]),
    dict(client=-1), dict(mixture=np.ones((2, 2, 2))), dict(mixture=np.ones((3, 2))),
    dict(mixture=[-1.0, 2.0]), dict(mixture=[0.0, 0.0]),
]


@pytest.mark.parametrize("bad", BAD_CONFIGS, ids=lambda d: ",".join(d))
def test_serve_config_resolve_raises_the_jax_packages_messages(bad):
    with pytest.raises(ValueError) as want:
        JaxServeConfig(**bad).resolve()
    with pytest.raises(ValueError) as got:
        ServeConfig(**bad).resolve()
    assert str(got.value) == str(want.value)


def test_serve_config_resolves_and_builds_mixtures_as_the_jax_package():
    for kw in (dict(mixture=[3.0, 1.0]), dict(mixture=np.ones((4, 2))), dict(client=1),
               dict(arch="mamba2-370m", smoke=False)):
        t, j = ServeConfig(**kw).resolve(), JaxServeConfig(**kw).resolve()
        tm = None if t.mixture is None else np.asarray(t.mixture)
        jm = None if j.mixture is None else np.asarray(j.mixture)
        np.testing.assert_array_equal(tm, jm)
        assert dataclasses.asdict(t.arch_config()) == dataclasses.asdict(j.arch_config())
        u_table = np.random.default_rng(1).dirichlet(np.ones(2), size=3).astype(np.float32)
        np.testing.assert_array_equal(t.request_mixture(2, u_table),
                                      j.request_mixture(2, u_table))
    for cfg in (ServeConfig(client=5).resolve(), ServeConfig(mixture=[1.0, 0, 0]).resolve()):
        with pytest.raises(ValueError) as got:
            cfg.request_mixture(2, np.ones((3, 2), np.float32))
        jcfg = JaxServeConfig(client=cfg.client, mixture=cfg.mixture).resolve()
        with pytest.raises(ValueError) as want:
            jcfg.request_mixture(2, np.ones((3, 2), np.float32))
        assert str(got.value) == str(want.value)
    with pytest.raises(NotImplementedError, match="audio serving"):
        ServeConfig(arch="whisper-base").resolve()


# --------------------------------------------------------------------------
# launch/serve
# --------------------------------------------------------------------------


def test_launch_serve_runs_a_smoke_arch_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "serve.jsonl"
    toks = launch_serve.main(["--arch", "gemma3-1b", "--smoke", "--device", "cpu",
                              "--codec", "int4", "--gen", "5", "--batch", "3",
                              "--mixture", "0.6,0.4", "--telemetry-out", str(out)])
    assert tuple(toks.shape) == (3, 5) and int(toks.max()) < get_smoke_config("gemma3-1b").vocab
    printed = capsys.readouterr().out
    assert "randomly initialized 2-cluster int4 plane" in printed
    assert "generated 5 tokens × 3 requests" in printed
    events = [json.loads(line) for line in out.read_text().splitlines()]
    assert [e["event"] for e in events] == ["serve_meta", "serve_batch", "serve_summary"]
    assert events[2]["codec"] == "int4" and events[2]["dequant_calls"] == 1


def test_launch_serve_serves_a_jax_exported_artifact(jax_planes, tmp_path, capsys):
    """``--artifact`` with a JAX-exported plane and ``--client``: the port's
    launcher loads it through the same PackSpec digest."""
    jbundle, jspec, plane, _ = jax_planes["mamba2-370m"]
    path = str(tmp_path / "mamba.npz")
    jax_save_servable(path, plane, jspec, arch="mamba2-370m",
                      u=np.full((4, 2), 0.5, np.float32), codec="int8")
    toks = launch_serve.main(["--arch", "mamba2-370m", "--smoke", "--device", "cpu",
                              "--codec", "int8", "--artifact", path, "--client", "2",
                              "--gen", "4"])
    assert tuple(toks.shape) == (4, 4)
    assert f"serving 2-cluster int8 plane from {path}" in capsys.readouterr().out
    with pytest.raises(ValueError, match="codec"):   # the manifest is checked
        launch_serve.main(["--arch", "mamba2-370m", "--smoke", "--device", "cpu",
                           "--codec", "fp32", "--artifact", path])


def test_launch_serve_random_plane_is_the_jax_launchers_plane():
    """Without ``--artifact`` both launchers serve ``bundle.init`` at seeds
    ``seed + s``: the port's plane has the JAX plane's layout and init
    distribution (the generators differ)."""
    bundle = build_model(get_smoke_config("olmo-1b"))
    spec = make_pack_spec(bundle.init(None))
    plane = launch_serve.random_plane(bundle, spec, seed=3, device="cpu")
    again = launch_serve.random_plane(bundle, spec, seed=3, device="cpu")
    assert plane.shape == (2, spec.size) and torch.equal(plane, again)
    assert not torch.equal(plane[0], plane[1])
    enc = launch_serve.encode_plane(plane, "int4")
    assert set(enc) == {"plane_packed", "plane_scale"} and enc["plane_packed"].dtype == torch.uint8


@pytest.mark.parametrize("argv,match", [
    (["--ckpt", "runs/ckpt"], "--ckpt"),
])
def test_launch_serve_refusals(argv, match):
    with pytest.raises(ValueError, match=match):
        launch_serve.main(argv + ["--device", "cpu"])


def test_the_deprecated_module_level_generate_raises():
    with pytest.raises(ValueError, match="launch.serve.generate"):
        launch_serve.generate(None, None, None, gen_len=2, max_len=4)
    with pytest.raises(NotImplementedError, match="audio"):
        launch_serve.main(["--arch", "whisper-base", "--smoke", "--device", "cpu"])
