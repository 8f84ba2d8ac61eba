#!/usr/bin/env python3
"""Time variants of the gossip mix side by side on one GPU.

    python3 tools/mix_variants.py [wide] [narrow] [crossover] [masked] [square] [dp] [serving]

Builds ``tools/mix_variants.cu`` (which includes the shipped
``src/repro_torch/kernels/csrc/gossip_mix.cu``) with ``nvcc``
(``sm_90a``) into ``build/mix_variants/`` and prints the card's name and
power limit, then one JSON line per shape. Needs a CUDA device.

``wide`` (past 32 rows, ``SHAPES``): each variant at the (S, N, X)
shapes below, timed with CUDA events (mean of 30 back-to-back calls
after 3 warm-ups) beside one ``torch.matmul(w, c)`` before and after
them; ``src/repro_torch/kernels/csrc/gossip_mix.cu`` takes the design
that wins past 32 rows.

``narrow`` (N <= 32, ``NARROW``): at the main path's (N, X) = (20,
17,226) and at wider X, the candidates for the narrow plane beside
``mix_kernel`` as shipped (``first_flat``, ``first_sparse``),
``mix_kernel_narrow`` (``narrow_flat``, ``narrow_sparse``: launched
whatever the width), the shipped entry points (``gossip_mix_flat``,
``gossip_mix_sparse``), one ``torch.matmul(w, c)`` and an empty kernel
(one block, the least a launch costs; also once as
``launch_floor_ms``). ``crossover`` (``CROSSOVER``): ``mix_kernel``
against ``mix_kernel_narrow`` (and, up to X = 262,144, other splits of a
column's rows) at N = 1 to 32 and X from 17,226 to 4,194,304, which
places the crossover width ``kNarrowMaxX``. Every call
is timed by CUDA-graph replay (100 calls captured, 20 past 32 MiB, the
graph replayed 20 times), twice, in turns (forward, then reversed), and
each entry holds both times. The sparse entries run on density-0.2 masks
drawn as the sparse exchange draws them (``random``) and on one shared
20 % band (``band``); ``bound_ms`` is the flat mix's byte bound.

``masked`` (``MASKED``): the masked dequant mix (kernel 6) on those masks,
the plane encoded as the int8 exchange encodes it (block 256): at the
main path's width the shipped entry (``gossip_mix_dequant_masked``)
beside ``mix_kernel`` as it took kernel 6 before (``first_masked``) and
``mix_kernel_narrow`` (``narrow_masked``); past it the shipped entry
beside ``first_masked``, ``mix_kernel_masked_vec`` (``vec_masked``) and
its candidates (``dq_*``, see ``tools/mix_variants.cu``), with one
``torch.matmul`` of W by the decoded masked plane (``decoded_matmul``);
``bound_ms`` is the masked dequant mix's byte bound on these masks. At
the main path's width the narrow plane's other splits (``nq_*``: threads
a block and a column) are timed too; ``square`` times them the same way
for the dequant mix on the square W (kernel 4; ``nd_*``) beside its
shipped route (``narrow_dequant``) and ``torch.matmul`` of W by the
decoded plane.

``dp`` (``DP``, ``DP_CROSSOVER``): the fused DP mix (kernel 2),
W·(c_old + scale ⊙ (c_new − c_old) [+ σ·noise]), at σ = 0 and 0.5: at
the main path's (20, 17,226) the shipped entry (``gossip_mix_fused_dp``)
beside ``mix_kernel`` as it took kernel 2 before (``first_dp``),
``mix_kernel_narrow`` (``narrow_dp``) and the narrow plane's other
splits (``ndp_*``); at (20, 1,000,000) and (20, 4,194,304) beside
``first_dp``, ``mix_kernel_dp_vec`` as shipped (``vec_dp``) and at 1, 2
and 4 columns a thread in row groups of 2 and 4 (``dpv_*``); then, at σ
= 0.5, ``first_dp``, ``narrow_dp`` and (X even) ``vec_dp`` at N = 1 to
32 and X from 17,226 to 1,048,576, which places ``kDpVecMinX``, the
width from which kernel 2 at an even X takes the vector kernel. Each row has one ``torch.matmul`` of W by the plane sanitized
beforehand (``sanitized_matmul``, a yardstick) and ``bound_ms``, kernel
2's byte bound; the shipped entry is also held bit for bit against
``gossip_mix_stack`` (``mix_kernel``) of that sanitized plane.

``serving`` (``SERVING``): the serving template behind kernels 4 and 7
(``src/repro_torch/kernels/csrc/gossip_mix_dequant.cu``), built from
``tools/mix_variants_serving.cu`` (which includes that source) into its
own library: at M requests over S = 2 clusters and Xp columns (qblock
64), int8 (``gossip_mix_dequant``) and int4 (``mixture_mix_dequant4``),
the shipped entry point beside the template as it stood before
``mix_dequant_stream`` (``parent``); ``mix_dequant_stream`` generalised
(rows a block, column groups a thread, threads a block, a persistent
grid, a prefetch of the next tile: ``s_r<R>_u<U>_t<T>[_np][_full]``),
with its warps held in step (``ls_*``) and, at M = 1, with its stores
written by a 1-D bulk copy a warp (``bulk_u<U>``); the template with one
division a thread (``pdiv1``). Each is timed by CUDA-graph replay (the
output allocated once), by CUDA events over 5 calls at the LM mixes'
widths, twice in turns. The parent is held within 1e-5 of the plain
version (in 2^26-column chunks), every other entry bit for bit against
the parent.
First it prints each dequant kernel's registers (``ptxas -v``) and its
``CALL`` instructions in ``cuobjdump -sass`` (``sass …``; the template's
only calls are to the 64-bit division routine), with the first such line.

Every variant is held against ``torch.matmul`` within 1e-5 (TF32 off)
and, bit for bit (``torch.equal``), against the shipped kernel's
output; the script prints every row first and exits non-zero if any
variant differed.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPES = {
    (3, 37, 100003): ["nb40_first", "nb40_rows_split2", "nb40_rows_split4_4col", "nb40_group8",
                      "nb40_prefetch", "nb40_prefetch_2col", "nb40_prefetch_2col_nobranch"],
    (3, 44, 100003): ["nb48_first", "nb48_prefetch", "nb48_prefetch_2col", "nb48_prefetch_cap5",
                      "nb48_prefetch_cap5_nobranch"],
    (3, 64, 100003): ["nb64_first", "nb64_prefetch", "nb64_prefetch_2col", "nb64_prefetch_cap4",
                      "nb64_prefetch_cap4_nobranch"],
    (2, 20, 4194304): ["nb24_first", "nb24_prefetch", "nb24_prefetch_2col"],
}
_N20 = ["n24_t128_s1", "n24_t64_s1", "n24_t32_s1", "n20_t128_s1", "n20_t64_s1", "n24_t128_s2",
        "n24_t128_s4", "n24_t256_s4", "n24_t96_s3", "n20_t128_s4", "n20_t160_s5",
        "n20_t128_s2"]
_N20_EVEN = ["n24_t128_s4_f2", "n20_t160_s5_f2"]   # float2 tiles: X even only
_N20_SPARSE = ["n24_t128_s1_sp1", "n24_t128_s1_sp2", "n24_t64_s1_sp1", "n24_t128_s4_sp1",
               "n24_t128_s4_sp2", "n20_t128_s4_sp1", "n20_t128_s4_sp2"]
# (N, X, layout): layout None is the dense mix (kernel 1), else the sparse
# mix (kernel 5) on that mask; the main path's width first, then wider X
# to place the narrow kernel's crossover width
NARROW = {
    (20, 17226, None): ["first_flat", "gossip_mix_flat", "narrow_flat"] + _N20 + _N20_EVEN,
    (20, 17226, "random"): ["first_sparse", "gossip_mix_sparse", "narrow_sparse"] + _N20_SPARSE,
    (20, 17226, "band"): ["first_sparse", "gossip_mix_sparse", "narrow_sparse"] + _N20_SPARSE,
    (8, 17226, None): ["first_flat", "gossip_mix_flat", "narrow_flat", "n8_t128_s1", "n8_t128_s2",
                       "n8_t64_s1"],
    (32, 17226, None): ["first_flat", "gossip_mix_flat", "narrow_flat", "n32_t128_s1",
                        "n32_t128_s4", "n32_t64_s1"],
    (20, 33792, None): ["first_flat", "gossip_mix_flat", "narrow_flat"] + _N20 + _N20_EVEN,
    (20, 100003, None): ["first_flat", "gossip_mix_flat", "narrow_flat"] + _N20,
    (20, 100003, "random"): ["first_sparse", "gossip_mix_sparse", "narrow_sparse"] + _N20_SPARSE,
    (20, 1000000, None): ["first_flat", "gossip_mix_flat", "narrow_flat"] + _N20 + _N20_EVEN,
}
# the crossover: mix_kernel as shipped against mix_kernel_narrow at N
# across the narrow chunk sizes and X up to past L2
_SPLITS = {1: ["n4_t128_s1", "n4_t128_s2"], 4: ["n4_t128_s1", "n4_t128_s2"],
           8: ["n8_t128_s1", "n8_t128_s2"], 20: ["n20_t128_s2"], 24: ["n24_t128_s2"],
           32: ["n32_t128_s1", "n32_t128_s2"]}   # other splits of a column's rows
CROSSOVER = {(n, x, None): ["first_flat", "narrow_flat"]
             + (_SPLITS.get(n, []) if x <= 262144 else [])
             for n in (1, 4, 8, 12, 16, 20, 24, 28, 32)
             for x in (17226, 32768, 65536, 65537, 100003, 131072, 163840, 196608, 262144,
                       524288, 1048576, 2097152, 4194304)}
# kernel 6, (N, X, mask layout): the main path's width, then past the
# narrow plane (X % 4 == 0: mix_kernel_masked_vec's shapes)
_DQ = ["dq_v4_nb20_g4", "dq_v4_nb20_g2", "dq_v4_nb20_g4_pf", "dq_v4_nb20_g4_cs",
       "dq_v4_nb24_g4", "dq_v4_nb24_g8", "dq_v2_nb20_g4", "dq_v2_nb20_g4_pf"]
_NQ = ["nq_20_t128_s4", "nq_20_t256_s4", "nq_20_t128_s2", "nq_20_t160_s5", "nq_20_t320_s5",
       "nq_24_t256_s8", "nq_20_t128_s1"]
MASKED = {
    (20, 17226, "random"): ["first_masked", "narrow_masked"] + _NQ,
    (20, 17226, "band"): ["first_masked", "narrow_masked"] + _NQ,
    (20, 1000000, "random"): ["first_masked", "vec_masked"] + _DQ,
    (20, 4194304, "random"): ["first_masked", "vec_masked"] + _DQ,
    (20, 4194304, "band"): ["first_masked", "vec_masked"] + _DQ,
}
# kernel 4 on the square W, (N, X): the main path's exchange (int8, block
# 256), the shipped route beside the narrow plane's other splits
SQUARE = {(20, 17226): ["nd_20_t128_s4", "nd_20_t256_s4", "nd_20_t128_s2", "nd_20_t160_s5",
                        "nd_24_t256_s8"]}
# kernel 2, (N, X): the main path's width (narrow splits), then past the
# narrow plane (X % 4 == 0: mix_kernel_dp_vec's candidates)
_NDP = ["ndp_20_t128_s4", "ndp_20_t256_s4", "ndp_20_t128_s2", "ndp_20_t160_s5", "ndp_20_t320_s5",
        "ndp_24_t256_s8", "ndp_20_t128_s1"]
_DPV = ["dpv_v1_g2", "dpv_v1_g4", "dpv_v2_g2", "dpv_v2_g4", "dpv_v4_g2", "dpv_v4_g4"]
DP = {(20, 17226): ["first_dp", "narrow_dp"] + _NDP,
      (20, 1000000): ["first_dp", "vec_dp"] + _DPV,
      (20, 4194304): ["first_dp", "vec_dp"] + _DPV}
DP_CROSSOVER = {(n, x): ["first_dp", "narrow_dp"] + (["vec_dp"] if x % 2 == 0 else [])
                for n in (1, 4, 8, 12, 16, 20, 24, 28, 32)
                for x in (17226, 32768, 49152, 65535, 65536, 100000, 131072, 262144, 524288,
                          1048576)}
QBLOCK = 256   # the exchange's int8 block
TOL = 1e-5
# the serving template (kernels 4 and 7), (M, S, Xp) -> variants: one
# request at the mlp's width, one past the 50 MB L2 and four, the serving
# batches, and the LM mixes of olmoe-1b-7b (one request) and olmo-1b (four)
_SV1 = ["s_r1_u1_t128_full_np", "s_r1_u1_t64_full_np", "s_r1_u1_t256_full_np",
        "s_r1_u2_t128_full_np", "s_r1_u1_t128_full", "s_r1_u1_t128", "s_r1_u2_t128",
        "s_r1_u4_t128", "s_r1_u4_t128_np", "ls_r1_sync", "pdiv1", "bulk_u2", "bulk_u4"]
_SV4 = ["s_r4_u1_t128_full_np", "s_r2_u1_t128_full_np", "s_r1_u1_t128_full_np",
        "s_r4_u2_t128_full_np", "s_r4_u1_t128_full", "s_r4_u1_t128", "s_r4_u2_t128",
        "s_r4_u4_t128", "ls_r4_sync", "ls_r4_wlate", "ls_r4_sync_wlate", "pdiv1"]
_SVB = ["s_r8_u1_t128_full_np", "s_r4_u1_t128_full_np", "s_r16_u1_t128_full_np",
        "s_r8_u1_t256_full_np", "s_r8_u1_t128_full", "s_r8_u1_t128", "s_r4_u1_t128",
        "s_r8_u4_t128", "ls_r4_sync", "pdiv1"]
SERVING = {(1, 2, 17280): _SV1, (1, 2, 4194304): _SV1, (4, 2, 4194304): _SV4,
           (20, 2, 17280): _SVB, (256, 2, 17280): _SVB, (1024, 2, 17280): _SVB,
           (1, 2, 6919620608): _SV1, (4, 2, 1280311296): _SV4,
           # the parent and the shipped entry alone: the conv artifact's
           # serving batch and the LM mixes of mamba2-370m and zamba2-1.2b
           (20, 2, 14720): [], (4, 2, 420136448): ["ls_r4_sync", "pdiv1"],
           (4, 2, 1170473856): ["ls_r4_sync", "pdiv1"]}
SERVE_QBLOCK = 64   # the serving plane's block


def build(sources=("tools/mix_variants.cu",), name: str = "libmix_variants.so",
          kernels=("mixn", "mix_kernel", "mixdq")) -> pathlib.Path:
    """Compile ``sources`` (paths from the repository's root) into one
    shared library under ``build/mix_variants/``; print the registers and
    spills ``ptxas -v`` reports for kernels whose mangled name holds one of
    ``kernels``."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.build import NVCC_FLAGS, find_nvcc

    out = ROOT / "build" / "mix_variants"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / name
    r = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(lib),
                        *(str(ROOT / src) for src in sources)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        sys.exit(f"nvcc failed:\n{r.stdout}{r.stderr}")
    # ptxas -v: each kernel's registers and spills, after its mangled name
    fn = ""
    for line in r.stderr.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1] if "'" in line else line
        elif "registers" in line and any(k in fn for k in kernels):
            print(f"ptxas {fn}: {line.split(':', 1)[-1].strip()}", flush=True)
    return lib


def time_ms(torch, fn, iters: int = 30) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, reps: int = 100, iters: int = 20) -> float:
    """Device ms per call: ``reps`` calls captured in one CUDA graph,
    replayed ``iters`` times (as chip_smoke.py's ``graph_ms``)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def stream(torch) -> int:
    """The current stream, read at each call: inside a graph capture it is
    the capturing stream."""
    return torch.cuda.current_stream().cuda_stream


def wide(torch, lib, dev, bad: list) -> None:
    for (s, n, x), names in SHAPES.items():
        g = torch.Generator(device=dev).manual_seed(s * 7 + n + x)
        w = torch.rand((n, n), generator=g, device=dev)
        w = w / w.sum(dim=1, keepdim=True)
        c = torch.randn((s, n, x), generator=g, device=dev)
        want = torch.matmul(w, c)
        shipped = torch.empty_like(c)
        lib.gossip_mix_stack(w.data_ptr(), c.data_ptr(), shipped.data_ptr(), s, n, x,
                             stream(torch))
        row = {"s": s, "n": n, "x": x, "matmul_ms": time_ms(torch, lambda: torch.matmul(w, c))}
        for name in names:
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                                                   ctypes.c_void_p]
            out = torch.empty_like(c)

            def call():
                return fn(w.data_ptr(), c.data_ptr(), out.data_ptr(), s, n, x, stream(torch))

            if call() != 0:
                sys.exit(f"{name}: launch failed")
            torch.cuda.synchronize()
            err = float((out - want).abs().max())
            if err > TOL:
                sys.exit(f"{name} at {(s, n, x)}: max abs err {err} > {TOL}")
            if not torch.equal(out, shipped):
                bad.append(f"{name} at {(s, n, x)}")
            row[name + "_ms"] = time_ms(torch, call)
        row["matmul_again_ms"] = time_ms(torch, lambda: torch.matmul(w, c))
        print(json.dumps(row), flush=True)


def narrow_operands(torch, dev, n: int, x: int, layout):
    from repro_torch.core.sparse import SparseConfig, column_activity, init_masks

    g = torch.Generator(device=dev).manual_seed(n * 7 + x)
    w = torch.rand((n, n), generator=g, device=dev)
    w = w / w.sum(dim=1, keepdim=True)
    c = torch.randn((n, x), generator=g, device=dev)
    if layout is None:
        return w, c, torch.ones(x, device=dev), None, g
    sp = SparseConfig(density=0.2)
    if layout == "random":
        mask = init_masks(g, n, x, sp)
    else:
        k = sp.k_active(x)
        mask = torch.zeros((n, x), device=dev)
        mask[:, (x - k) // 2:(x - k) // 2 + k] = 1.0
    return w, c * mask, column_activity(mask), mask, g


def narrow(torch, lib, dev, bad: list, shapes: dict) -> None:
    floor = [graph_ms(torch, lambda: lib.empty(stream(torch))) for _ in range(2)]
    print(json.dumps({"launch_floor_ms": floor}), flush=True)
    sig = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    for (n, x, layout), names in shapes.items():
        w, c, act, _, _ = narrow_operands(torch, dev, n, x, layout)
        want = torch.matmul(w, c)
        calls = {"matmul": lambda: torch.matmul(w, c),
                 "empty": lambda: lib.empty(stream(torch))}
        shipped = None
        for name in ["gossip_mix_flat" if layout is None else "gossip_mix_sparse"] + names:
            out = torch.empty_like(c)
            fn = getattr(lib, name)
            if name == "gossip_mix_flat":   # the only entry point without the activity
                args = (w.data_ptr(), c.data_ptr(), out.data_ptr(), n, x)
            else:
                if name != "gossip_mix_sparse":
                    fn.argtypes = sig
                args = (w.data_ptr(), c.data_ptr(), act.data_ptr(), out.data_ptr(), n, x)

            def call(fn=fn, args=args, out=out):   # out: kept alive with its pointer
                return fn(*args, stream(torch))

            if call() != 0:
                sys.exit(f"{name}: launch failed")
            torch.cuda.synchronize()
            err = float((out - want).abs().max())
            if err > TOL:
                sys.exit(f"{name} at {(n, x, layout)}: max abs err {err} > {TOL}")
            if shipped is None:
                shipped = out   # the shipped entry point, run first
                continue
            if not torch.equal(out, shipped):
                bad.append(f"{name} at {(n, x, layout)}")
            calls[name] = call
        order = list(calls)
        times = {k: [] for k in order}
        for seq in (order, order[::-1]):
            for k in seq:
                reps = 100 if 4 * n * x < 32 * 2**20 else 20
                times[k].append(graph_ms(torch, calls[k], reps=reps))
        row = {"n": n, "x": x, "layout": layout,
               "bound_ms": 4 * (n * n + 2 * n * x) / 3.35e12 * 1e3}
        row.update({k + "_ms": v for k, v in times.items()})
        print(json.dumps(row), flush=True)
        del w, c, act, want, shipped, calls
        torch.cuda.empty_cache()


def masked(torch, lib, dev, bad: list) -> None:
    from repro_torch.comm.codecs import Channel, CommConfig
    from repro_torch.kernels.gossip_mix import gossip_mix_dequant_masked_ref

    P = ctypes.c_void_p
    sig = [P] * 6 + [ctypes.c_int, ctypes.c_int] + [ctypes.c_longlong] * 3 + [P]
    for (n, x, layout), names in MASKED.items():
        w, c, act, mask, g = narrow_operands(torch, dev, n, x, layout)
        enc = Channel(CommConfig(codec="int8", block=QBLOCK), x).encode(c, g)
        q, sc = enc["q"], enc["scale"]
        xp = q.shape[1]
        want = gossip_mix_dequant_masked_ref(w, q, sc, mask, act, qblock=QBLOCK)
        decoded = (q.float() * sc.repeat_interleave(QBLOCK, dim=1))[:, :x] * mask
        calls = {"decoded_matmul": lambda: torch.matmul(w, decoded),
                 "empty": lambda: lib.empty(stream(torch))}
        shipped = None
        for name in ["gossip_mix_dequant_masked"] + names:
            out = torch.empty((n, xp), device=dev)
            fn = getattr(lib, name)
            fn.argtypes = sig
            args = (w.data_ptr(), q.data_ptr(), sc.data_ptr(), mask.data_ptr(), act.data_ptr(),
                    out.data_ptr(), n, n, x, xp, QBLOCK)

            def call(fn=fn, args=args, out=out):   # out: kept alive with its pointer
                return fn(*args, stream(torch))

            if call() != 0:
                sys.exit(f"{name}: launch failed")
            torch.cuda.synchronize()
            err = float((out - want).abs().max())
            if err > TOL:
                sys.exit(f"{name} at {(n, x, layout)}: max abs err {err} > {TOL}")
            if not bool((out[:, :x][:, act == 0] == 0).all()) or not bool((out[:, x:] == 0).all()):
                sys.exit(f"{name} at {(n, x, layout)}: dead columns not exact zeros")
            if shipped is None:
                shipped = out
            elif not torch.equal(out, shipped):
                bad.append(f"{name} at {(n, x, layout)}")
            calls[name] = call
        order = list(calls)
        times = {k: [] for k in order}
        for seq in (order, order[::-1]):
            for k in seq:
                reps = 100 if 4 * n * x < 32 * 2**20 else 20
                times[k].append(graph_ms(torch, calls[k], reps=reps))
        live = int(act.sum())
        nbytes = (4 * n * n + n * live + 4 * n * live // QBLOCK + 4 * n * live + 4 * x
                  + 4 * n * xp)
        row = {"n": n, "x": x, "xp": xp, "layout": layout, "x_live": live,
               "bound_ms": nbytes / 3.35e12 * 1e3}
        row.update({k + "_ms": v for k, v in times.items()})
        print(json.dumps(row), flush=True)
        del w, c, act, mask, q, sc, enc, want, decoded, shipped, calls
        torch.cuda.empty_cache()


def square(torch, lib, dev, bad: list) -> None:
    from repro_torch.comm.codecs import Channel, CommConfig
    from repro_torch.kernels.gossip_mix import gossip_mix_dequant_ref

    P = ctypes.c_void_p
    sig = [P] * 4 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, P]
    for (n, x), names in SQUARE.items():
        w, c, _, _, g = narrow_operands(torch, dev, n, x, None)
        enc = Channel(CommConfig(codec="int8", block=QBLOCK), x).encode(c, g)
        q, sc = enc["q"], enc["scale"]
        xp = q.shape[1]
        want = gossip_mix_dequant_ref(w, q, sc, qblock=QBLOCK)
        decoded = (q.float() * sc.repeat_interleave(QBLOCK, dim=1))[:, :x].contiguous()
        calls = {"decoded_matmul": lambda: torch.matmul(w, decoded),
                 "empty": lambda: lib.empty(stream(torch))}
        shipped = None
        for name in ["narrow_dequant"] + names:
            out = torch.empty((n, xp), device=dev)
            fn = getattr(lib, name)
            fn.argtypes = sig
            args = (w.data_ptr(), q.data_ptr(), sc.data_ptr(), out.data_ptr(), n, xp, QBLOCK)

            def call(fn=fn, args=args, out=out):   # out: kept alive with its pointer
                return fn(*args, stream(torch))

            if call() != 0:
                sys.exit(f"{name}: launch failed")
            torch.cuda.synchronize()
            err = float((out - want).abs().max())
            if err > TOL:
                sys.exit(f"{name} at {(n, x)}: max abs err {err} > {TOL}")
            if shipped is None:
                shipped = out
            elif not torch.equal(out, shipped):
                bad.append(f"{name} at {(n, x)}")
            calls[name] = call
        order = list(calls)
        times = {k: [] for k in order}
        for seq in (order, order[::-1]):
            for k in seq:
                times[k].append(graph_ms(torch, calls[k]))
        nbytes = 4 * n * n + n * xp + 4 * n * xp // QBLOCK + 4 * n * xp
        row = {"n": n, "x": x, "xp": xp, "bound_ms": nbytes / 3.35e12 * 1e3}
        row.update({k + "_ms": v for k, v in times.items()})
        print(json.dumps(row), flush=True)


def dp(torch, lib, dev, bad: list, shapes: dict, sigmas) -> None:
    P = ctypes.c_void_p
    sig = [P] * 5 + [ctypes.c_float, P, ctypes.c_int, ctypes.c_longlong, P]
    for (n, x), names in shapes.items():
        g = torch.Generator(device=dev).manual_seed(n * 7 + x)
        w = torch.rand((n, n), generator=g, device=dev)
        w = w / w.sum(dim=1, keepdim=True)
        c_old = torch.randn((n, x), generator=g, device=dev)
        c_new = c_old + 0.1 * torch.randn((n, x), generator=g, device=dev)
        scale = 0.2 + 0.8 * torch.rand((n, 1), generator=g, device=dev)
        noise = torch.randn((n, x), generator=g, device=dev)
        for sigma in sigmas:
            # the plane sanitized by torch, a step an op as the kernel rounds it
            san = c_old + scale * (c_new - c_old)
            if sigma > 0:
                san = san + sigma * noise
            want = torch.matmul(w, san)
            witness = torch.empty_like(san)
            lib.gossip_mix_stack(w.data_ptr(), san.data_ptr(), witness.data_ptr(), 1, n, x,
                                 stream(torch))
            nz = noise.data_ptr() if sigma > 0 else None
            calls = {"sanitized_matmul": lambda: torch.matmul(w, san),
                     "empty": lambda: lib.empty(stream(torch))}
            shipped = None
            for name in ["gossip_mix_fused_dp"] + names:
                out = torch.empty_like(c_old)
                fn = getattr(lib, name)
                fn.argtypes = sig
                args = (w.data_ptr(), c_old.data_ptr(), c_new.data_ptr(), scale.data_ptr(), nz,
                        sigma, out.data_ptr(), n, x)

                def call(fn=fn, args=args, out=out):   # out: kept alive with its pointer
                    return fn(*args, stream(torch))

                if call() != 0:
                    sys.exit(f"{name}: launch failed")
                torch.cuda.synchronize()
                err = float((out - want).abs().max())
                if err > TOL:
                    sys.exit(f"{name} at {(n, x, sigma)}: max abs err {err} > {TOL}")
                if shipped is None:
                    shipped = out
                    if not torch.equal(out, witness):
                        bad.append(f"gossip_mix_fused_dp vs mix_kernel at {(n, x, sigma)}")
                elif not torch.equal(out, shipped):
                    bad.append(f"{name} at {(n, x, sigma)}")
                calls[name] = call
            order = list(calls)
            times = {k: [] for k in order}
            for seq in (order, order[::-1]):
                for k in seq:
                    reps = 100 if 4 * n * x < 32 * 2**20 else 20
                    times[k].append(graph_ms(torch, calls[k], reps=reps))
            nbytes = 4 * (n * n + n + 3 * n * x + (n * x if sigma > 0 else 0))
            row = {"n": n, "x": x, "sigma": sigma, "bound_ms": nbytes / 3.35e12 * 1e3}
            row.update({k + "_ms": v for k, v in times.items()})
            print(json.dumps(row), flush=True)
            del san, want, witness, shipped, calls
        del w, c_old, c_new, scale, noise
        torch.cuda.empty_cache()


def sass_calls(lib_path: pathlib.Path) -> tuple[dict, str]:
    """({kernel: CALL instructions}, the first CALL line) from ``cuobjdump
    -sass`` of the library, for every kernel whose name holds
    ``mix_dequant`` (demangled by ``cu++filt`` where the toolkit has it).
    The template's only calls are to the 64-bit division routine."""
    from repro_torch.kernels.build import find_nvcc

    bin_dir = pathlib.Path(find_nvcc()).parent
    r = subprocess.run([str(bin_dir / "cuobjdump"), "-sass", str(lib_path)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        sys.exit(f"cuobjdump -sass failed: {r.stderr.strip()[-500:]}")
    counts, fn, example = {}, None, ""
    for line in r.stdout.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            fn = found.group(1) if "mix_dequant" in found.group(1) else None
            if fn:
                counts[fn] = 0
        elif fn and re.search(r"\bCALL\b", line):
            counts[fn] += 1
            example = example or line.strip()
    filt = bin_dir / "cu++filt"
    if filt.is_file() and counts:
        names = subprocess.run([str(filt)], input="\n".join(counts), capture_output=True,
                               text=True).stdout.split("\n")
        if len(names) >= len(counts):
            counts = dict(zip(names, counts.values()))
    return counts, example


def _equal_chunked(torch, a, b, cols: int = 1 << 28) -> bool:
    return all(torch.equal(a[:, c:c + cols], b[:, c:c + cols])
               for c in range(0, a.shape[1], cols))


def serving_shape(torch, lib, dev, bad: list, codec: str, m: int, s: int, xp: int,
                  names: list) -> None:
    """One row of the serving mode: the parent, the shipped entry point and
    ``names`` at (M, S, Xp) in ``codec``."""
    from repro_torch.kernels.gossip_mix import gossip_mix_dequant_ref, mixture_mix_dequant4_ref

    entry, sfx, plain = (("gossip_mix_dequant", "_i8", gossip_mix_dequant_ref) if codec == "int8"
                         else ("mixture_mix_dequant4", "_i4", mixture_mix_dequant4_ref))
    qb = SERVE_QBLOCK
    sig = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                                   ctypes.c_longlong, ctypes.c_void_p]
    g = torch.Generator(device=dev).manual_seed(m * 7 + xp)
    w = torch.rand((m, s), generator=g, device=dev)
    w = w / w.sum(dim=1, keepdim=True)
    if codec == "int8":
        plane = torch.randint(-127, 128, (s, xp), generator=g, device=dev, dtype=torch.int8)
    else:
        plane = torch.randint(0, 256, (s, xp // 2), generator=g, device=dev, dtype=torch.uint8)
    sc = torch.rand((s, xp // qb), generator=g, device=dev) / 64
    ref = torch.empty((m, xp), device=dev)
    out = torch.empty_like(ref)
    args = (w.data_ptr(), plane.data_ptr(), sc.data_ptr())
    tag = f"{codec} (M, S, Xp) = {(m, s, xp)}"
    calls = {}
    for name in ["parent", entry] + names:
        fn = getattr(lib, name if name == entry else name + sfx)
        fn.argtypes, fn.restype = sig, ctypes.c_int
        dst = ref if name == "parent" else out

        def call(fn=fn, dst=dst):
            return fn(*args, dst.data_ptr(), m, s, xp, qb, stream(torch))

        if call() != 0:
            sys.exit(f"{name} at {tag}: launch failed")
        torch.cuda.synchronize()
        if name == "parent":
            step, err = (1 << 26) // qb * qb, 0.0
            for c0 in range(0, xp, step):
                c1 = min(c0 + step, xp)
                part = plane[:, c0:c1] if codec == "int8" else plane[:, c0 // 2:c1 // 2]
                want = plain(w, part, sc[:, c0 // qb:c1 // qb], qblock=qb)
                err = max(err, float((ref[:, c0:c1] - want).abs().max()))
            if err > TOL:
                sys.exit(f"parent at {tag}: max abs err {err} > {TOL}")
        elif not _equal_chunked(torch, out, ref):
            bad.append(f"{name} at {tag}")
        calls[name] = call
    lm = xp > 10**8   # an LM mix: milliseconds a call, so CUDA events suffice
    times = {k: [] for k in calls}
    for seq in (list(calls), list(calls)[::-1]):
        for k in seq:
            times[k].append(time_ms(torch, calls[k], 5) if lm else graph_ms(torch, calls[k]))
    nbytes = (4 * m * s + (s * xp if codec == "int8" else s * xp // 2) + 4 * s * xp // qb
              + 4 * m * xp)
    row = {"codec": codec, "m": m, "s": s, "xp": xp, "qblock": qb,
           "bound_ms": nbytes / 3.35e12 * 1e3}
    row.update({k + "_ms": v for k, v in times.items()})
    print(json.dumps(row), flush=True)


def serving(torch, dev, bad: list) -> None:
    lib_path = build(("tools/mix_variants_serving.cu",
                      "src/repro_torch/kernels/csrc/gossip_mix.cu"),
                     "libmix_serving.so", ("mix_dequant",))
    counts, example = sass_calls(lib_path)
    for fn, calls in counts.items():
        print("sass " + json.dumps({"kernel": fn, "calls": calls}), flush=True)
    print("sass " + json.dumps({"first_call": example}), flush=True)
    lib = ctypes.CDLL(str(lib_path))
    for codec in ("int8", "int4"):
        for (m, s, xp), names in SERVING.items():
            serving_shape(torch, lib, dev, bad, codec, m, s, xp, names)
            torch.cuda.empty_cache()


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("mix_variants: needs a CUDA device")
    which = sys.argv[1:] or ["wide", "narrow", "crossover", "masked", "square", "dp", "serving"]
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda")
    bad: list = []
    if "serving" in which:
        serving(torch, dev, bad)
        which = [w for w in which if w != "serving"]
    if not which:
        if bad:
            sys.exit("not the parent template's bits: " + ", ".join(bad))
        return
    lib = ctypes.CDLL(str(build()))
    P = ctypes.c_void_p
    lib.gossip_mix_flat.argtypes = [P, P, P, ctypes.c_int, ctypes.c_longlong, P]
    lib.gossip_mix_sparse.argtypes = [P, P, P, P, ctypes.c_int, ctypes.c_longlong, P]
    lib.gossip_mix_stack.argtypes = [P, P, P, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, P]
    lib.empty.argtypes = [P]
    if "wide" in which:
        wide(torch, lib, dev, bad)
    if "narrow" in which:
        narrow(torch, lib, dev, bad, NARROW)
    if "crossover" in which:
        narrow(torch, lib, dev, bad, CROSSOVER)
    if "masked" in which:
        masked(torch, lib, dev, bad)
    if "square" in which:
        square(torch, lib, dev, bad)
    if "dp" in which:
        dp(torch, lib, dev, bad, DP, (0.0, 0.5))
        dp(torch, lib, dev, bad, DP_CROSSOVER, (0.5,))
    if bad:
        sys.exit("not the shipped kernel's (serving: the parent template's) bits: "
                 + ", ".join(bad))


if __name__ == "__main__":
    main()
