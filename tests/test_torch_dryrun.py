"""The port's dry-run and roofline (``launch/specs.py``,
``launch/dryrun.py``, ``roofline/analysis.py``) against the live JAX
package on the CPU, on the meta device (no compile on either side):

- ``model_flops_for``, ``scan_trip_ratio`` and ``two_point`` equal to
  JAX's for the 10 canonical archs × 4 input shapes (the canonical list
  equal to JAX's, read from its source: importing JAX's dry-run module
  would set ``XLA_FLAGS`` in this process);
- ``build_dryrun(...).args`` against JAX's ``build_dryrun`` on a
  one-device JAX mesh (``eval_shape`` only), leaf for leaf in global shape
  and dtype (the port's integers are int64 where JAX's are int32), for
  whisper-base, mamba2-370m and olmo-1b at every shape; the FedSPD state's
  packed plane as wide as JAX's center leaves together, and the pytree
  form of ``fedspd_state_specs`` equal to JAX's centers leaf for leaf;
- a meta-device count of a training-route forward equal to
  ``FlopCounterMode`` on the CPU run of the same forward;
- the mirror of JAX's ``test_two_point_correction_matches_full_unroll``:
  the FedSPD step of a 6-layer model counts exactly ``two_point`` of its
  1- and 2-layer counts at r = 5 (FLOPs, bytes and collective bytes);
- ``kernel_bound`` (the one reckoning behind ``chip_smoke.py``'s bounds)
  giving PERF.md's bound column at its shapes, and the kernels' meta
  routes and the collective stand-in's contracts;
- ``dryrun.main`` for whisper-base × prefill_32k writing its row, and
  its refusal of ``--layout dpc``.
"""
import ast
import json
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.configs import base as tbase
from repro_torch.core.fedspd import FedSPDConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.gossip_mix import gossip_mix_flat
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import specs as tspecs
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import registry as tregistry
from repro_torch.roofline import analysis as trl


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one thread: the test workers share the host's
    cores, and torch's default thread count in each oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = pathlib.Path(__file__).resolve().parents[1]
ARGS_ARCHS = ("whisper-base", "mamba2-370m", "olmo-1b")


def _jax_canonical_archs():
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == \
                "CANONICAL_ARCHS":
            return ast.literal_eval(node.value)
    raise AssertionError("no CANONICAL_ARCHS in JAX's dryrun.py")


def test_model_flops_scan_ratio_and_two_point_equal_jax():
    from repro.configs import base as jbase
    from repro.launch.steps import arch_for_shape as j_arch_for_shape
    from repro.models.registry import active_params as j_active_params
    from repro.roofline import analysis as jrl

    assert tdry.CANONICAL_ARCHS == _jax_canonical_archs()
    for arch in tdry.CANONICAL_ARCHS:
        assert trl.scan_trip_ratio(tbase.get_config(arch)) == \
            jrl.scan_trip_ratio(jbase.get_config(arch))
        assert tregistry.active_params(tbase.get_config(arch)) == \
            j_active_params(jbase.get_config(arch))
        for shape in tbase.INPUT_SHAPES:
            jc, _ = j_arch_for_shape(jbase.get_config(arch), shape)
            tc, _ = tdry.arch_for_shape(tbase.get_config(arch), shape)
            for kind in ("fedspd", "plain", "prefill", "decode"):
                assert trl.model_flops_for(tc, tbase.INPUT_SHAPES[shape], kind) == \
                    jrl.model_flops_for(jc, jbase.INPUT_SHAPES[shape], kind)
            assert trl.scan_trip_ratio(tc) == jrl.scan_trip_ratio(jc)
    for v1, v2, r in ((1.0, 3.0, 5.0), (7.0, 2.0, 4.0), (0.0, 0.0, 0.5), (2.5, 4.0, 0.0)):
        assert trl.two_point(v1, v2, r) == jrl.two_point(v1, v2, r)


def _port_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_port_leaves(tree[k], prefix + (str(k),)))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for k, v in zip(tree._fields, tree):
            out.update(_port_leaves(v, prefix + (k,)))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_port_leaves(v, prefix + (str(i),)))
        return out
    if isinstance(tree, torch.Tensor):
        return {"/".join(prefix): (tuple(tree.shape), str(tree.dtype).removeprefix("torch."))}
    return {}


def _jax_leaves(tree, skip=("key", "round")):
    import jax

    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        names = [str(getattr(p, "key", getattr(p, "name", getattr(p, "idx", p))))
                 for p in path]
        if names[-1] in skip:
            continue
        dtype = str(np.dtype(leaf.dtype))
        out["/".join(names)] = (tuple(leaf.shape), "int64" if dtype == "int32" else dtype)
    return out


@pytest.mark.parametrize("arch", ARGS_ARCHS)
def test_build_dryrun_args_equal_jax_leaf_for_leaf(arch):
    import jax
    from jax.sharding import Mesh

    from repro.launch.specs import build_dryrun as j_build

    jmesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    tmesh = MeshShape.of((1, 1), ("data", "model"))
    for shape in tbase.INPUT_SHAPES:
        ok, _ = tdry.supports_shape(tbase.get_config(arch), shape)
        if not ok:
            continue
        jcase = j_build(arch, shape, jmesh)
        tcase = tspecs.build_dryrun(arch, shape, tmesh)
        assert tcase.step_kind == jcase.step_kind
        jargs, targs = jcase.args, tcase.args
        if tcase.step_kind == "fedspd":
            (jstate, jbatch), (tstate, tbatch) = jargs, targs
            jcent = _jax_leaves(jstate.centers)
            x = sum(int(np.prod(s[2:])) for s, _ in jcent.values())
            assert tuple(tstate.centers.shape) == (2, 1, x)
            tree, _ = tspecs.fedspd_state_specs(tregistry.build_model(tbase.get_config(arch)),
                                                FedSPDConfig(n_clients=1, n_clusters=2),
                                                tmesh)
            assert _port_leaves(tree.centers) == jcent
            assert _port_leaves(tstate._replace(centers=None)) == \
                _jax_leaves(jstate._replace(centers=None))
            assert _port_leaves(tbatch) == _jax_leaves(jbatch)
        else:
            assert _port_leaves(targs) == _jax_leaves(jargs)


@pytest.mark.parametrize("arch", ["olmo-1b", "whisper-base", "mamba2-370m"])
def test_meta_count_equals_flop_counter_on_the_cpu(arch):
    """The training route (attention "ref", the SSD chunked) runs no
    kernel: its meta-device count is FlopCounterMode's on the CPU."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = tbase.get_smoke_config(arch)
    bundle = tregistry.build_model(cfg, train=True)
    d_enc = cfg.encoder_d_model or cfg.d_model

    def batch(dev):
        out = {"tokens": torch.zeros((2, 16), dtype=torch.int64, device=dev)}
        if cfg.family == "audio":
            out["frames"] = torch.zeros((2, cfg.encoder_frames, d_enc), device=dev)
        return out

    params = bundle.init(torch.Generator().manual_seed(0))
    with FlopCounterMode(display=False) as fc:
        bundle.forward(params, batch("cpu"))
    with trl.count_work() as w:
        bundle.forward(bundle.init(None), batch("meta"))
    assert w.kernels == {} and w.flops == fc.get_total_flops() > 0


def test_six_layer_count_equals_two_point_of_one_and_two(monkeypatch):
    monkeypatch.setitem(tbase.INPUT_SHAPES, "train_4k", tbase.InputShape(
        "train_4k", 256, 4, "train"))
    mesh = MeshShape.of((2, 4), ("data", "model"))
    base = tbase.get_smoke_config("olmo-1b").with_overrides(
        d_model=256, n_heads=4, n_kv_heads=4, d_ff=512, vocab=1024)
    vals = {}
    for n in (1, 2, 6):
        roof, _ = tdry.run_case("olmo-1b", "train_4k", mesh, "2x4", verbose=False,
                                cfg_override=base.with_overrides(n_layers=n))
        vals[n] = (roof.flops_per_chip, roof.bytes_per_chip, roof.coll_bytes_per_chip)
    assert all(v > 0 for v in vals[6])
    for i in range(3):
        assert trl.two_point(vals[1][i], vals[2][i], 5.0) == vals[6][i]


@pytest.mark.parametrize("kernel,shape,want,by", [
    ("gossip_mix_flat", dict(n=20, x=17226), 0.000823, "bytes"),
    ("gossip_mix_flat", dict(n=20, x=4194304), 0.200, "bytes"),
    ("gossip_mix_stack", dict(s=2, n=20, x=17226), 0.00165, "bytes"),
    ("gossip_mix_fused_dp", dict(n=20, x=17226, noise=True), 0.00165, "bytes"),
    ("gossip_mix_dequant", dict(m=20, n=2, xp=17280, qblock=64), 0.000424, "bytes"),
    ("mixture_mix_dequant4", dict(m=20, n=2, xp=17280, qblock=64), 0.000419, "bytes"),
    ("flash_attention", dict(b=4, lq=512, lkv=512, hq=16, hkv=16, hd=128, dtype="bfloat16"),
     0.0100, "bytes"),
    ("flash_attention", dict(b=4, lq=512, lkv=512, hq=16, hkv=16, hd=128, dtype="float32"),
     0.0642, "operations"),
    ("flash_attention", dict(b=4, lq=512, lkv=512, hq=32, hkv=8, hd=80, window=256,
                             dtype="bfloat16"), 0.00783, "bytes"),
    ("ssd_scan", dict(b=4, l=512, h=32, g=1, p=64, n=128, chunk=128, dtype="bfloat16"),
     0.00665, "bytes"),
    ("ssd_scan", dict(b=4, l=512, h=32, g=1, p=64, n=128, chunk=128, dtype="float32"),
     0.0563, "operations"),
    # whisper's encoder layer and cross attention (kernel 8 at ragged lengths)
    ("flash_attention", dict(b=4, lq=1500, lkv=1500, hq=8, hkv=8, hd=64, causal=False,
                             dtype="bfloat16"), 0.0186, "operations"),
    ("flash_attention", dict(b=4, lq=64, lkv=1500, hq=8, hkv=8, hd=64, causal=False,
                             dtype="bfloat16"), 0.00382, "bytes"),
])
def test_kernel_bound_gives_perf_md_bounds(kernel, shape, want, by):
    ms, got_by = trl.kernel_bound(kernel, **shape)
    assert float(f"{ms:.3g}") == want and got_by == by


def test_live_pairs_count_every_mask():
    for lq, lkv, causal, window in ((7, 7, True, None), (5, 9, False, 3), (9, 5, True, 4),
                                    (1, 1500, False, None), (64, 1500, True, None)):
        q = np.arange(lq)[:, None]
        k = np.arange(lkv)[None, :]
        live = np.ones((lq, lkv), bool)
        if causal:
            live &= q >= k
        if window:
            live &= q - k < window
        assert trl.live_pairs(lq, lkv, causal, window) == int(live.sum())


def test_meta_routes_count_their_kernels_and_devices_do_not_mix():
    m = torch.device("meta")
    with trl.count_work() as w:
        out = gossip_mix_flat(torch.empty((4, 4), device=m), torch.empty((4, 10), device=m))
        q = torch.empty((1, 77, 2, 16), device=m, dtype=torch.bfloat16)
        att = flash_attention(q, q, q, causal=False)
    assert out.shape == (4, 10) and out.device.type == "meta"
    assert att.shape == q.shape and att.dtype == torch.bfloat16
    assert w.kernels["gossip_mix_flat"] == (1, *trl.kernel_work("gossip_mix_flat", n=4, x=10))
    assert w.kernels["flash_attention"][0] == 1
    assert w.flops == sum(f for _, f, _ in w.kernels.values())
    with pytest.raises(ValueError, match="mixed"):
        gossip_mix_flat(torch.empty((4, 4), device=m), torch.zeros((4, 10)))
    assert gossip_mix_flat(torch.eye(4), torch.ones((4, 10))).device.type == "cpu"


def test_collective_stand_in_counts_and_refuses_real_tensors():
    import torch.distributed as dist

    m = torch.device("meta")
    saved = dist.all_reduce
    with trl.count_work() as w, trl.counting_collectives(w, 16):
        assert dist.get_world_size() == 16 and dist.get_rank() == 0
        dist.all_reduce(torch.empty((3, 5), device=m))
        parts = [torch.empty(4, device=m) for _ in range(4)]
        dist.all_gather(parts, torch.empty(4, device=m))
        a, b = torch.empty(8, device=m), torch.empty(8, device=m)
        for r in dist.batch_isend_irecv([dist.P2POp(dist.isend, a, 1),
                                         dist.P2POp(dist.irecv, b, 1)]):
            r.wait()
        with pytest.raises(RuntimeError, match="meta"):
            dist.all_reduce(torch.zeros(3))
    assert dist.all_reduce is saved
    assert {k: w.coll[k] for k in ("all-reduce", "all-gather", "collective-permute")} == \
        {"all-reduce": 60, "all-gather": 64, "collective-permute": 32}
    assert w.coll_total == 156


def test_dryrun_main_writes_a_whisper_prefill_row(tmp_path, capsys):
    rows = tdry.main(["--arch", "whisper-base", "--shape", "prefill_32k",
                      "--out", str(tmp_path)])
    (path,) = tmp_path.glob("*.json")
    row = json.loads(path.read_text())
    assert path.name == "whisper-base__prefill_32k__pod16x16.json"
    assert row == rows[0].to_json() and row["step_kind"] == "prefill"
    assert row["chips"] == 256 and row["coll_bytes_per_chip"] == 0
    assert row["flops_per_chip"] > 0 and row["bottleneck"] in ("compute", "memory")
    assert "flash_attention" in capsys.readouterr().out   # the encoder's 6 kernel-8 calls
    with pytest.raises(SystemExit, match="replicates the model axis"):
        tdry.main(["--arch", "olmo-1b", "--shape", "train_4k", "--layout", "dpc"])
