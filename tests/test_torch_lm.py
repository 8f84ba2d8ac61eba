"""The port's LM model zoo (dense, VLM and SSM families) against the JAX
package on the CPU, inputs and weights from seeded numpy or carried across
from JAX as numpy arrays.

- kernel 8's plain version against ``repro.kernels.ops.flash_attention``
  (Pallas, interpret mode) and ``ref.flash_attention_ref``: 2e-5 fp32,
  2e-2 bf16 (tests/test_kernels.py's bounds);
- kernel 9's plain version (``ssd_chunked``) against ``ops.ssd_scan``
  and ``ref.ssd_scan_ref``: 2e-3;
- norms, RoPE, the gelu and silu MLPs, next_token_loss: 1e-5 (one fp32
  layer, sums in other orders);
- each ported arch's smoke config (the MoE and hybrid ones too): forward
  logits and aux, the prefill cache and one decode step at 1e-4 (two fp32
  layers; aux 1e-5); one bf16-compute smoke at the
  reference's bf16 bound, 2e-2 at unit magnitude, scaled by the largest
  logit (bf16 rounds at other places in the two frameworks, a few steps
  of 2^-8 to 2^-7 of the value each);
- configs, parameter counts and PackSpec digests equal; the families and
  features not ported raise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core.packing import make_pack_spec as jax_make_pack_spec
from repro.core.packing import pack as jax_pack
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro.models import registry as jregistry
from repro.models import ssm as jssm
from repro_torch.configs import base as tbase
from repro_torch.core.packing import make_pack_spec, pack
from repro_torch.interop import params_from_numpy
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_scan
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import registry as tregistry
from repro_torch.models import transformer as ttfm


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one thread: the test workers share the host's
    cores, and torch's default thread count in each oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DENSE = ["olmo-1b", "h2o-danube-1.8b", "gemma3-1b", "granite-3-8b", "chameleon-34b"]
PORTED = DENSE + ["mamba2-370m", "olmoe-1b-7b", "phi3.5-moe-42b-a6.6b", "zamba2-1.2b"]


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a, dtype=np.float32 if dtype is None else dtype))
    return t


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


# --------------------------------------------------------------------------
# kernel 8: the plain version against the Pallas kernel (interpret mode)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("b,lq,lkv,hq,hkv,hd,window,dtype", [
    (2, 128, 128, 4, 2, 32, None, "float32"),     # GQA causal
    (2, 128, 128, 4, 2, 32, None, "bfloat16"),
    (1, 128, 128, 4, 4, 16, 64, "float32"),       # MHA window, danube's smoke hd
    (1, 128, 256, 4, 2, 32, None, "bfloat16"),    # Lq < Lkv
    (1, 256, 128, 2, 1, 32, 96, "float32"),       # Lq > Lkv with a window
])
def test_flash_plain_matches_the_pallas_kernel(b, lq, lkv, hq, hkv, hd, window, dtype):
    rng = np.random.default_rng(lq + lkv + hd)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in [(b, lq, hq, hd), (b, lkv, hkv, hd), (b, lkv, hkv, hd)])
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(a, jd) for a in (q, k, v))
    want = jops.flash_attention(jq, jk, jv, causal=True, window=window)
    tq, tk, tv = (_t(a).to(td) for a in (q, k, v))
    before = flash_attention.launches
    got = flash_attention(tq, tk, tv, causal=True, window=window)   # CPU: the plain version
    assert flash_attention.launches == before and got.dtype == td
    atol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(got), _np(want), atol=atol)
    if lq <= lkv:   # every row sees a key: the JAX oracle is the same function
        oracle = jref.flash_attention_ref(jq, jk, jv, causal=True, window=window)
        np.testing.assert_allclose(_np(flash_attention_ref(tq, tk, tv, window=window)),
                                   _np(oracle), atol=atol)


def test_flash_wrapper_accepts_exactly_what_ops_flash_attention_accepts():
    """Since the ragged lengths of whisper's slice: every Lq, Lkv >= 1
    (JAX's "blocked" mode's lengths, wider than ops.flash_attention's
    multiples of min(128, L)); the window and the lengths stay checked."""
    rng = np.random.default_rng(3)
    q = _t(rng.standard_normal((1, 200, 2, 16)))
    kv = _t(rng.standard_normal((1, 77, 1, 16)))
    for causal in (True, False):
        got = flash_attention(q, kv, kv, causal=causal)
        torch.testing.assert_close(got, tattn.ref_attention(q, kv, kv, causal=causal)
                                   if not causal else flash_attention_ref(q, kv, kv),
                                   atol=2e-5, rtol=0)
    for l in (1, 96, 128, 200, 1500):
        x = torch.zeros((1, l, 2, 16))
        assert flash_attention(x, x, x).shape == x.shape
    with pytest.raises(ValueError, match="window"):
        flash_attention(q[:, :128], q[:, :128], q[:, :128], window=0)
    with pytest.raises(ValueError, match=">= 1"):
        flash_attention(q[:, :0], kv, kv)


def test_attention_modes():
    rng = np.random.default_rng(5)
    q, k, v = (_t(rng.standard_normal((2, 64, 4, 32))) for _ in range(3))
    ref = tattn.ref_attention(q, k, v, window=16)
    for mode in ("cuda", "pallas", "blocked"):
        torch.testing.assert_close(tattn.attention(q, k, v, mode=mode, window=16), ref,
                                   atol=2e-5, rtol=0)
    with pytest.raises(ValueError, match="unknown attention mode"):
        tattn.attention(q, k, v, mode="splash")


def test_decode_attention_matches_jax_and_refuses_a_mesh_axis():
    rng = np.random.default_rng(6)
    q = rng.standard_normal((2, 1, 8, 16)).astype(np.float32)
    kc, vc = (rng.standard_normal((2, 40, 2, 16)).astype(np.float32) for _ in range(2))
    from repro.models import attention as jattn
    for window in (None, 8):
        want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                      jnp.int32(30), window=window)
        got = tattn.decode_attention(_t(q), _t(kc), _t(vc), 30, window=window)
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)
    # a mesh axis needs a current mesh (launch/mesh.use_mesh); over a
    # mesh it is held in tests/test_torch_mesh.py
    with pytest.raises(RuntimeError, match="no current mesh"):
        tattn.decode_attention(_t(q), _t(kc), _t(vc), 30, axis_name="seq")


# --------------------------------------------------------------------------
# kernel 9: the plain version against ops.ssd_scan and the recurrence
# --------------------------------------------------------------------------


@pytest.mark.parametrize("b,l,h,g,p,n,chunk,state", [
    (1, 64, 4, 2, 16, 16, 32, False),     # groups < heads
    (2, 64, 2, 1, 16, 32, 32, True),      # initial state
    (1, 32, 2, 2, 8, 16, 128, True),      # chunk = L
])
def test_ssd_plain_matches_the_pallas_kernel_and_the_recurrence(b, l, h, g, p, n, chunk, state):
    rng = np.random.default_rng(l + h + n)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((b, l, h)))) * 0.1).astype(np.float32)
    a = -np.exp(rng.uniform(size=(h,))).astype(np.float32)
    bm, cm = (rng.standard_normal((b, l, g, n)).astype(np.float32) for _ in range(2))
    s0 = rng.standard_normal((b, h, p, n)).astype(np.float32) if state else None
    j = [jnp.asarray(v) for v in (x, dt, a, bm, cm)]
    js0 = None if s0 is None else jnp.asarray(s0)

    @jax.jit
    def jax_side(x, dt, a, bm, cm, s0):
        rep = h // g
        return (jops.ssd_scan(x, dt, a, bm, cm, chunk=chunk, initial_state=s0),
                jref.ssd_scan_ref(x, dt, a, jnp.repeat(bm, rep, axis=2),
                                  jnp.repeat(cm, rep, axis=2), initial_state=s0),
                jssm.ssd_chunked(x, dt, a, bm, cm, chunk=min(chunk, l), initial_state=s0))

    (y_k, s_k), (y_r, s_r), (yj, sj) = jax_side(*j, js0)
    ts0 = None if s0 is None else _t(s0)
    before = ssd_scan.launches
    y, s = ssd_scan(_t(x), _t(dt), _t(a), _t(bm), _t(cm), chunk=chunk, initial_state=ts0)
    assert ssd_scan.launches == before
    for want_y, want_s in ((y_k, s_k), (y_r, s_r)):
        np.testing.assert_allclose(_np(y), _np(want_y), atol=2e-3, rtol=2e-3)
        np.testing.assert_allclose(_np(s), _np(want_s), atol=2e-3, rtol=2e-3)
    # the port's ssd_chunked is the JAX package's ssd_chunked
    yt, st = ssd_chunked(_t(x), _t(dt), _t(a), _t(bm), _t(cm), min(chunk, l), ts0)
    np.testing.assert_allclose(_np(yt), _np(yj), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(_np(st), _np(sj), atol=2e-5, rtol=2e-5)


def test_ssd_wrapper_refuses_bad_shapes_and_takes_per_request_decay():
    x, bm = torch.zeros((2, 96, 4, 8)), torch.zeros((2, 96, 2, 8))
    dt = torch.full((2, 96, 4), 0.05)
    with pytest.raises(ValueError, match="not divisible"):
        ssd_scan(x, dt, -torch.ones(4), bm, bm, chunk=64)
    with pytest.raises(ValueError, match="A"):
        ssd_scan(x, dt, -torch.ones(3), bm, bm, chunk=32)
    rng = np.random.default_rng(9)
    x, bm, cm = (_t(rng.standard_normal(s)) for s in [(2, 64, 4, 8), (2, 64, 2, 8),
                                                       (2, 64, 2, 8)])
    dt = _t(rng.uniform(0.01, 0.1, (2, 64, 4)))
    a = -_t(rng.uniform(1, 2, (2, 4)))
    y, s = ssd_scan(x, dt, a, bm, cm, chunk=32)
    for i in range(2):   # row i of a per-request A is request i's shared A
        yi, si = ssd_scan(x[i:i + 1], dt[i:i + 1], a[i], bm[i:i + 1], cm[i:i + 1], chunk=32)
        torch.testing.assert_close(y[i:i + 1], yi, atol=1e-6, rtol=1e-6)
        torch.testing.assert_close(s[i:i + 1], si, atol=1e-6, rtol=1e-6)


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------


def test_norms_rope_mlps_and_loss_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 4, 16)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(16).astype(np.float32)
    pos = np.arange(8) + 3
    h = rng.standard_normal((2, 8, 16)).astype(np.float32)
    mlps = {act: jax.tree.map(np.asarray, jlayers.init_mlp(jax.random.PRNGKey(1), 16, 32, act,
                                                           jnp.float32))
            for act in ("silu", "gelu")}
    logits = rng.standard_normal((2, 8, 50)).astype(np.float32)
    toks = rng.integers(0, 50, (2, 8))

    @jax.jit
    def jax_side(x, scale, pos, h, mlps, logits, toks):
        return (jlayers.rmsnorm({"scale": scale}, x), jlayers.layernorm_np(x),
                jlayers.apply_rope(x, pos, 1e4),
                {a: jlayers.apply_mlp(m, h, a) for a, m in mlps.items()},
                jlayers.next_token_loss(logits, toks))

    rms, ln, rope, mlp, loss = jax_side(x, scale, pos, h, mlps, logits, toks)
    np.testing.assert_allclose(_np(tlayers.rmsnorm({"scale": _t(scale)}, _t(x))), _np(rms),
                               atol=1e-5)
    np.testing.assert_allclose(_np(tlayers.layernorm_np(_t(x))), _np(ln), atol=1e-5)
    assert tlayers.apply_norm("layernorm_np", None, _t(x)).shape == x.shape
    np.testing.assert_allclose(
        _np(tlayers.apply_rope(_t(x), torch.as_tensor(pos), 1e4)), _np(rope), atol=1e-5)
    for act, m in mlps.items():
        np.testing.assert_allclose(
            _np(tlayers.apply_mlp(params_from_numpy(m, device="cpu"), _t(h), act)),
            _np(mlp[act]), atol=1e-5)
    np.testing.assert_allclose(
        _np(tlayers.next_token_loss(_t(logits), torch.as_tensor(toks))), _np(loss), atol=1e-5)


def test_linear_and_norms_take_per_request_weights():
    rng = np.random.default_rng(1)
    x = _t(rng.standard_normal((3, 5, 8)))
    w = _t(rng.standard_normal((3, 8, 6)))
    s = _t(rng.standard_normal((3, 8)))
    got = tlayers.linear(x, w)
    normed = tlayers.rmsnorm({"scale": s}, x)
    for i in range(3):
        torch.testing.assert_close(got[i], x[i] @ w[i])
        torch.testing.assert_close(normed[i], tlayers.rmsnorm({"scale": s[i]}, x[i:i + 1])[0])


# --------------------------------------------------------------------------
# configs, registry, packing
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(jbase.ARCH_ALIASES))
def test_configs_equal_the_jax_package(arch):
    assert dataclasses.asdict(tbase.get_config(arch)) == \
        dataclasses.asdict(jbase.get_config(arch))
    tc, jc = tbase.get_smoke_config(arch), jbase.get_smoke_config(arch)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    for prop in ("vocab_padded", "q_per_kv", "d_inner", "ssm_heads",
                 "supports_long_context"):
        assert getattr(tc, prop) == getattr(jc, prop)
    assert tc.compute_dtype_torch() == getattr(torch, jc.compute_dtype)
    assert tregistry.count_params(tbase.get_config(arch)) == \
        jregistry.count_params(jbase.get_config(arch))


def test_arch_tables_equal_the_jax_package():
    assert tbase.ASSIGNED_ARCHS == jbase.ASSIGNED_ARCHS
    assert tbase.ARCH_ALIASES == jbase.ARCH_ALIASES
    assert {k: dataclasses.asdict(v) for k, v in tbase.INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.INPUT_SHAPES.items()}
    with pytest.raises(ValueError, match="unknown arch"):
        tbase.get_config("gpt-2")


@pytest.mark.parametrize("arch", PORTED)
def test_pack_spec_digest_equals_the_jax_package(arch):
    """Smoke width from real inits, full width from the meta-device init
    (no storage) against ``jax.eval_shape``."""
    for tget, jget in ((tbase.get_smoke_config, jbase.get_smoke_config),
                       (tbase.get_config, jbase.get_config)):
        tb = tregistry.build_model(tget(arch))
        jb = jregistry.build_model(jget(arch))
        spec = make_pack_spec(tb.init(None))
        jspec = jax_make_pack_spec(jax.eval_shape(jb.init, jax.random.PRNGKey(0)))
        assert spec.digest == jspec.digest and spec.size == jspec.size
    if arch == "olmo-1b":
        assert spec.size == 1_280_311_296
    if arch == "mamba2-370m":
        assert spec.size == 420_136_448


@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-370m"])
def test_a_jax_init_tree_carries_across_and_packs_float_for_float(arch):
    """``interop.params_from_numpy`` carries a JAX ``bundle.init`` tree
    (olmo's empty norm dicts included); it packs to the JAX plane, and
    after ``unpack`` the empty dicts are gone."""
    jb = jregistry.build_model(jbase.get_smoke_config(arch))
    tree = jax.jit(jb.init)(jax.random.PRNGKey(3))
    jspec = jax_make_pack_spec(tree)
    ported = params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")
    spec = make_pack_spec(ported)
    assert spec.digest == jspec.digest
    np.testing.assert_array_equal(pack(ported, spec).numpy(),
                                  np.asarray(jax_pack(tree, jspec)))
    if arch == "olmo-1b":
        assert ported["ln_f"] == {} and ported["layers"]["ln1"] == {}
        assert all(p[0] != "ln_f" for p in spec.paths)
        assert ported["layers"]["attn"]["wq"].shape[0] == 2   # the stacked (L, ...) axis


@pytest.mark.parametrize("arch", sorted(set(tbase.ARCH_ALIASES.values())))
def test_every_family_builds(arch):
    """Every arch's bundle builds (the audio family since its slice), on
    both routes, and its meta-device tree has the analytic count of
    parameters less the norm scales."""
    arch = next(a for a, m in tbase.ARCH_ALIASES.items() if m == arch)
    cfg = tbase.get_config(arch)
    for train in (False, True):
        bundle = tregistry.build_model(cfg, train=train)
        assert bundle.cfg is cfg
    leaves = []

    def walk(node, key=""):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, k)
        elif key != "scale":
            leaves.append(node.numel())

    walk(tregistry.build_model(cfg).init(None))
    if cfg.family in ("dense", "vlm", "audio") and not cfg.qk_norm:
        assert sum(leaves) == tregistry.count_params(cfg)


# --------------------------------------------------------------------------
# whole models at smoke width: forward, prefill, decode
# --------------------------------------------------------------------------


def _jax_mode(arch: str) -> str:
    """The JAX package's flash kernel where its ``"pallas"`` mode allows it
    (static windows); gemma3's per-layer windows run ``"ref"``."""
    return "ref" if arch.startswith("gemma3") else "pallas"


def _models(arch, jax_mode=None, **overrides):
    jc = jbase.get_smoke_config(arch).with_overrides(**overrides)
    tc = tbase.get_smoke_config(arch).with_overrides(**overrides)
    jb = jregistry.build_model(jc, attn_mode=jax_mode or _jax_mode(arch))
    tb = tregistry.build_model(tc, attn_mode="cuda")
    params = jax.jit(jb.init)(jax.random.PRNGKey(7))
    return jc, jb, tb, params, params_from_numpy(jax.tree.map(np.asarray, params),
                                                 device="cpu")


def _jax_reference(arch, jb, jc, jp, prompt, nxt, max_len):
    """JAX logits and aux, the prefill cache (padded to ``max_len``) and
    one decode step after it, in one program (one compile of the Pallas
    kernel)."""

    @jax.jit
    def run(p, toks, nxt):
        logits, aux = jb.forward(p, {"tokens": toks})
        cache = jb.prefill(p, {"tokens": toks}, jb.init_cache(toks.shape[0], max_len))
        dec, _ = jb.decode_step(p, cache, nxt)
        return logits, aux, cache, dec

    return run(jp, prompt, nxt)


@pytest.mark.parametrize("arch", PORTED)
def test_forward_prefill_and_decode_match_jax(arch):
    cfg, jb, tb, jp, tp = _models(arch)
    toks = np.random.default_rng(11).integers(0, cfg.vocab, (2, 33)).astype(np.int32)
    prompt, nxt = toks[:, :32], toks[:, 32:]
    lj, aj, cj, dj = _jax_reference(arch, jb, cfg, jp, jnp.asarray(prompt),
                                    jnp.asarray(nxt), 40)
    lt, aux = tb.forward(tp, {"tokens": torch.as_tensor(prompt)})
    np.testing.assert_allclose(_np(lt), _np(lj), atol=1e-4)
    if cfg.n_experts > 0:
        assert float(aj) > 0
        np.testing.assert_allclose(float(aux), float(aj), atol=1e-5)
    else:
        assert float(aux) == float(aj) == 0.0

    ct = tb.prefill(tp, {"tokens": torch.as_tensor(prompt)},
                    tb.init_cache(2, 40, device="cpu"))
    assert ct["pos"].dim() == 0 and int(ct["pos"]) == int(cj["pos"]) == 32
    assert set(ct) == set(cj)
    for key in set(cj) - {"pos"}:
        assert tuple(ct[key].shape) == cj[key].shape
        np.testing.assert_allclose(_np(ct[key]), _np(cj[key]), atol=1e-4)
    dt_, ct = tb.decode_step(tp, ct, torch.as_tensor(nxt))
    np.testing.assert_allclose(_np(dt_), _np(dj), atol=1e-4)
    assert int(ct["pos"]) == 33
    if cfg.n_experts == 0:
        # the decoded logits are the forward's at that position (not so for
        # MoE: the forward's capacity drops differ from the prefill's and
        # the drop-free decode token's, in the JAX package as here)
        np.testing.assert_allclose(
            _np(dt_[:, 0]), _np(tb.forward(tp, {"tokens": torch.as_tensor(toks)})[0][:, 32]),
            atol=1e-4)


def test_per_request_weights_equal_one_request_at_a_time():
    """The server's batched forward: each request through its own weights
    (leaves with a leading (B,) axis) equals each request alone."""
    for arch in ("gemma3-1b", "mamba2-370m"):
        tc = tbase.get_smoke_config(arch)
        tb = tregistry.build_model(tc)
        ps = [tb.init(torch.Generator().manual_seed(s)) for s in range(2)]
        spec = make_pack_spec(ps[0])
        from repro_torch.core.packing import unpack
        batched = unpack(torch.stack([pack(p, spec) for p in ps]), spec)
        toks = torch.randint(0, tc.vocab, (2, 16), generator=torch.Generator().manual_seed(1))
        got, _ = tb.forward(batched, {"tokens": toks})
        for i in range(2):
            want, _ = tb.forward(ps[i], {"tokens": toks[i:i + 1]})
            torch.testing.assert_close(got[i:i + 1], want, atol=1e-5, rtol=1e-5)


def test_bf16_compute_matches_jax_at_the_bf16_bound():
    cfg, jb, tb, jp, tp = _models("olmo-1b", compute_dtype="bfloat16")
    toks = np.random.default_rng(12).integers(0, cfg.vocab, (2, 32)).astype(np.int32)
    lj, _ = jax.jit(jb.forward)(jp, {"tokens": jnp.asarray(toks)})
    lt, _ = tb.forward(tp, {"tokens": torch.as_tensor(toks)})
    assert lt.dtype == torch.bfloat16
    # the reference's bf16 bound, 2e-2 at unit magnitude, at the logits'
    bound = 2e-2 * max(1.0, float(np.abs(_np(lj)).max()))
    np.testing.assert_allclose(_np(lt), _np(lj), atol=bound)


def test_losses_match_jax():
    cfg, jb, tb, jp, tp = _models("h2o-danube-1.8b", jax_mode="ref")
    toks = np.random.default_rng(13).integers(0, cfg.vocab, (2, 32)).astype(np.int32)
    batch_j, batch_t = {"tokens": jnp.asarray(toks)}, {"tokens": torch.as_tensor(toks)}
    loss, per_example = jax.jit(lambda p, b: (jb.loss(p, b), jb.per_example_loss(p, b)))(
        jp, batch_j)
    np.testing.assert_allclose(float(tb.loss(tp, batch_t)), float(loss), atol=1e-5)
    np.testing.assert_allclose(_np(tb.per_example_loss(tp, batch_t)), _np(per_example),
                               atol=1e-5)
    tc = tbase.get_smoke_config("h2o-danube-1.8b")
    np.testing.assert_allclose(float(ttfm.lm_loss(tp, batch_t, tc)),
                               float(tb.loss(tp, batch_t)), atol=1e-6)
    assert ttfm.lm_per_example_loss(tp, batch_t, tc).shape == (2,)
