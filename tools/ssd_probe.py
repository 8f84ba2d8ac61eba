#!/usr/bin/env python3
"""Kernel 9's rows of ``chip_smoke.py`` alone, then its kernels block by block.

    python3 tools/ssd_probe.py [--hb N] [--cols 64|128] [--blocks-only]
                               [--out chiprun_out/ssd_probe.json]

Builds the CUDA kernels from this checkout, prints the card's name and
power limit (``nvidia-smi``), torch's versions and the ptxas report of
kernel 9's kernels, counts and checks their tensor-core instructions
(``cuobjdump -sass``: HGMMA in both bf16 kernels, HMMA or HGMMA in both
fp32 ones), then runs every kernel-9 row of ``chip_smoke.py``
(``SSD_SHAPES``: against its plain version, its route, its two kernels'
device ms, its time beside bound and plain times).

Then it builds ``tools/ssd_probe.cu`` (the shipped
``src/repro_torch/kernels/csrc/ssd_scan.cu`` with its phase marks on) with
``nvcc`` (``sm_90a``, the shipped flags) into ``build/ssd_probe/`` and,
for each row and each of its route's two kernels, prints one JSON line:

- ``ms``: ms per launch by CUDA events over 50 launches from the host
  (marks off, after 3 warm-ups: the host's launch time included);
  ``graph_ms``: the same over 100 launches replayed from CUDA graphs (no
  host time between them); ``span_us``: first block's start to last
  block's end by the global timer (marks on, one launch);
- ``blocks``, ``waves`` (blocks over the most blocks one SM held at once
  times the SMs), ``resident_per_sm``, ``block_us`` (median and 90th
  percentile of a block's life);
- ``phases_us``: median µs between consecutive marks of a block (SM cycle
  counter over the SM clock that the same block's global timer gives).
  ``ssd_state_wgmma``: 0→1 barriers set, the first chunk's parameters and
  token tile landed; 1→2 the walk; 2→3 the final state stored.
  ``ssd_out_wgmma``: 0→1 C and the key tiles of B landed; 1→2 the shared
  scores formed and stored, the first head's slot landed; 2→3 the heads
  (warpgroup 0's view: the warpgroups swap query tiles head by head).
  ``ssd_state_tf32``: 0→1 the first chunk's dt, cum and w; 1→2 the walk;
  2→3 the final state. ``ssd_out_tf32``: 0→1 C, key tile 0, S_in, cum and
  dt landed; 1→2 the carried term; 2→3 the key tiles; 3→4 y stored.

``--hb`` sets the heads a block of ``ssd_out_wgmma`` takes and ``--cols``
the state columns a block of ``ssd_state_wgmma`` walks in the probe's
launches (defaults: the wrapper's ``heads_per_block`` and ``walk_cols``),
to weigh the plans; ``--blocks-only`` skips the build's report and the
rows.
The marks are written by thread 0 alone (a consumer thread), so a phase is
its warp's view. Needs a CUDA device; the numbers are device time on the
card it runs on.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
# marks each marked kernel sets (the CUDA-core route has none)
N_MARKS = {"ssd_state_wgmma": 4, "ssd_out_wgmma": 4, "ssd_state_tf32": 4, "ssd_out_tf32": 5}


def build_probe() -> ctypes.CDLL:
    from repro_torch.kernels.build import NVCC_FLAGS, SIGNATURES, find_nvcc

    out = ROOT / "build" / "ssd_probe"
    out.mkdir(parents=True, exist_ok=True)
    path = out / "libssd_probe.so"
    r = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(path),
                        str(ROOT / "tools" / "ssd_probe.cu")], capture_output=True, text=True)
    if r.returncode != 0:
        sys.exit(f"nvcc failed:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(str(path))
    lib.ssd_scan_stage.argtypes, lib.ssd_scan_stage.restype = SIGNATURES["ssd_scan_stage"]
    lib.probe_set_marks.argtypes, lib.probe_set_marks.restype = [ctypes.c_void_p], ctypes.c_int
    return lib


def analyse(marks, n_marks: int) -> dict:
    """Per-block phases and residency from the (blocks, 16) marks."""
    m = marks.tolist()
    blocks = len(m)
    start = [r[8] for r in m]
    end = [r[8 + n_marks - 1] for r in m]
    t0 = min(start)
    # SM cycles per ns from each block's own marks
    rate = [(r[n_marks - 1] - r[0]) / max(r[8 + n_marks - 1] - r[8], 1) for r in m]
    ghz = statistics.median(rate)
    phases = {}
    for i in range(n_marks - 1):
        d = [(r[i + 1] - r[i]) / ghz / 1e3 for r in m if r[i] and r[i + 1]]
        if d:
            phases[f"{i}->{i + 1}"] = round(statistics.median(d), 3)
    life = sorted((e - s) / 1e3 for s, e in zip(start, end))
    per_sm = {}
    for r, s, e in zip(m, start, end):
        per_sm.setdefault(r[15], []).append((s, e))
    resident = 0
    for iv in per_sm.values():
        events = sorted([(s, 1) for s, _ in iv] + [(e, -1) for _, e in iv],
                        key=lambda x: (x[0], x[1]))
        cur = 0
        for _, dlt in events:
            cur += dlt
            resident = max(resident, cur)
    return dict(blocks=blocks, sms=len(per_sm), span_us=round((max(end) - t0) / 1e3, 3),
                resident_per_sm=resident,
                waves=round(blocks / (resident * len(per_sm)), 2),
                block_us=[round(statistics.median(life), 3),
                          round(life[int(0.9 * (len(life) - 1))], 3)],
                sm_ghz=round(ghz, 3), phases_us=phases)


def probe_row(torch, lib, shape, hb_override, cols_override) -> list:
    """Both kernels of one ``SSD_SHAPES`` row, timed and marked."""
    from repro_torch.kernels.ssd_scan import (ROUTE_KERNELS, ROUTES, heads_per_block, route,
                                              sm_count, walk_cols)

    b, l, h, g, p, n, chunk, dt, state = shape
    dev = torch.device("cuda")
    dtype = getattr(torch, dt)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((b, l, h, p), generator=gen, device=dev).to(dtype)
    dts = torch.nn.functional.softplus(torch.randn((b, l, h), generator=gen, device=dev)) * 0.1
    a = -torch.exp(torch.rand((b, h), generator=gen, device=dev))
    bm, cm = (torch.randn((b, l, g, n), generator=gen, device=dev).to(dtype) for _ in range(2))
    s0 = torch.randn((b, h, p, n), generator=gen, device=dev) if state else None
    c = l // chunk
    y = torch.empty_like(x)
    s_final = torch.empty((b, h, p, n), device=dev)
    states = torch.empty((b, c, h, p, n), device=dev)
    cum, dtt = (torch.empty((b, h, l), device=dev) for _ in range(2))
    rt = route(dt, p, n)
    hb, cols = 1, 64
    if rt == "ssd_wgmma":
        hb = hb_override or heads_per_block(b, l, h, g, chunk, sm_count(dev))
        cols = cols_override or walk_cols(b, h, n, sm_count(dev))
    stream = torch.cuda.current_stream().cuda_stream

    def stage_on(i, on_stream):
        rc = lib.ssd_scan_stage(x.data_ptr(), dts.data_ptr(), a.data_ptr(), bm.data_ptr(),
                                cm.data_ptr(), None if s0 is None else s0.data_ptr(),
                                y.data_ptr(), s_final.data_ptr(), states.data_ptr(),
                                cum.data_ptr(), dtt.data_ptr(), b, l, h, g, p, n, chunk,
                                int(dt == "bfloat16"), ROUTES.index(rt), hb, cols, i, on_stream)
        if rc:
            sys.exit(f"{ROUTE_KERNELS[rt][i]}: cudaError {rc}")

    def stage(i):
        stage_on(i, stream)

    for _ in range(3):
        for i in range(2):
            stage(i)
    torch.cuda.synchronize()
    out = []
    for i, name in enumerate(ROUTE_KERNELS[rt]):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(50):
            stage(i)
        ev[1].record()
        torch.cuda.synchronize()
        events_ms = ev[0].elapsed_time(ev[1]) / 50
        # the same 20 launches replayed from a CUDA graph: no host time between them
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            with torch.cuda.graph(graph, stream=side):
                for _ in range(20):
                    stage_on(i, side.cuda_stream)
        torch.cuda.current_stream().wait_stream(side)
        graph.replay()
        torch.cuda.synchronize()
        ev[0].record()
        for _ in range(5):
            graph.replay()
        ev[1].record()
        torch.cuda.synchronize()
        graph_ms = ev[0].elapsed_time(ev[1]) / 100
        row = dict(kernel=name, shape=list(shape), heads_per_block=hb, walk_cols=cols,
                   ms=round(events_ms, 5), graph_ms=round(graph_ms, 5))
        if name in N_MARKS:
            if i == 0:
                blocks = -(-p // 64) * (n // cols if rt == "ssd_wgmma" else -(-n // 64)) * h * b
            elif rt == "ssd_wgmma":
                blocks = -(-(-(-chunk // 64)) // 2) * c * (h // hb) * b
            else:
                blocks = -(-chunk // 64) * c * h * b
            marks = torch.zeros((blocks, 16), dtype=torch.int64, device=dev)
            lib.probe_set_marks(marks.data_ptr())
            stage(i)
            torch.cuda.synchronize()
            lib.probe_set_marks(None)
            row.update(analyse(marks.cpu(), N_MARKS[name]))
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hb", type=int, default=0,
                    help="heads a block of ssd_out_wgmma takes in the probe's launches")
    ap.add_argument("--cols", type=int, default=0,
                    help="state columns a block of ssd_state_wgmma walks in the probe's launches")
    ap.add_argument("--blocks-only", action="store_true",
                    help="skip the build's checks and chip_smoke.py's rows")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "ssd_probe.json"))
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is False: this script needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    rows = []
    if not args.blocks_only:
        rows = shipped_rows(torch, chip_smoke, build)
    lib = build_probe()
    probes = []
    for shape in chip_smoke.SSD_SHAPES:
        probes.extend(probe_row(torch, lib, shape, args.hb, args.cols))
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "rows": rows, "probes": probes}, indent=1))


def shipped_rows(torch, chip_smoke, build) -> list:
    """The build's report and checks, then chip_smoke.py's kernel-9 rows."""
    t = time.perf_counter()
    lib_path = build.build()
    build.load_library()
    print(f"built in {time.perf_counter() - t:.1f} s", flush=True)
    log = lib_path.with_suffix(".log").read_text().splitlines()
    for i, line in enumerate(log):
        if "Compiling entry function" in line and "ssd_" in line:
            print("ptxas " + " | ".join(x.strip() for x in log[i:i + 4]), flush=True)
    counts = chip_smoke.tensor_core_counts(build, lib_path)
    chip_smoke.check_tensor_cores(counts)
    t = time.perf_counter()
    rows = chip_smoke.ssd_shape_rows(torch, counts)
    print(f"ssd rows: {len(rows)} in {time.perf_counter() - t:.1f} s", flush=True)
    print(f"{'row':<34} {'dtype':<8} {'route':<13} {'ms':>9} {'bound':>9} {'plain':>9} "
          f"{'err':>9}  stages")
    for r in rows:
        label = (f"B={r['b']} L={r['l']} H={r['h']} P={r['p']} N={r['n']} "
                 f"s0={int(r['initial_state'])}")
        print(f"{label:<34} {r['dtype']:<8} {r['route']:<13} {r['ms']:>9.5f} "
              f"{r['bound_ms']:>9.5f} {r['plain_ms']:>9.4f} {r['max_abs_err']:>9.2e}  "
              + json.dumps({k: round(v, 5) for k, v in r["stage_ms"].items()}), flush=True)
    return rows


if __name__ == "__main__":
    main()
