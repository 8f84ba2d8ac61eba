#!/usr/bin/env python3
"""Where kernel 9's tensor-core kernels spend their time, block by block.

    python3 tools/ssd_probe.py [B L H G P N CHUNK]

Builds ``tools/ssd_probe.cu`` (the shipped
``src/repro_torch/kernels/csrc/ssd_scan.cu`` with its phase marks on) with
``nvcc`` (``sm_90a``, the shipped flags) into ``build/ssd_probe/``, runs
the three stages at a bf16 shape (default mamba2-370m's prefill layer, (4,
512, 32, 1, 64, 128, chunk 128)), and prints the card's name and power
limit, then one JSON line per tensor-core kernel:

- ``ms``: device ms per launch by CUDA events (marks off, 50 launches after
  3 warm-ups); ``span_us``: first block's start to last block's end by the
  global timer (marks on, one launch);
- ``blocks``, ``waves`` (blocks over the most blocks one SM held at once
  times the SMs), ``resident_per_sm`` (the most blocks an SM held at once),
  ``block_us`` (median and 90th percentile of a block's life);
- ``phases_us``: median µs between consecutive marks of a block (SM cycle
  counter over the SM clock that the same block's global timer gives).
  ``ssd_chunk_state_mma``: 0→1 A and dt read, the x and B copies issued,
  cum scanned; 1→2 w, the copies landed; 2→3 the products and the
  state's stores. ``ssd_chunk_out_mma``: 0→1 A and dt read, the C and
  first key tile copies and the state fragments' loads issued, cum
  scanned; 1→2 the copies landed (blocks with a carried state only); 2→3
  the carried state's term, through shared memory to the row layout; 3→4
  the key tiles; 4→5 y stored.

Then the rate of ``mma.sync`` m16n8k16 bf16 alone (8 independent
accumulators a warp, operands in registers) at 4 to 16 warps an SM, in
TFLOP/s and in cycles of an SM sub-partition per instruction at the
kernels' measured SM clock: what the products can reach at best.

The marks are written by thread 0 alone, so a phase is warp 0's view.
Needs a CUDA device; the numbers are device time on the card it runs on.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def build() -> ctypes.CDLL:
    sys.path.insert(0, str(ROOT / "src"))
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
    lib.probe_mma_rate.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.probe_mma_rate.restype = ctypes.c_int
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


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    b, l, h, g, p, n, chunk = (int(v) for v in sys.argv[1:8]) if len(sys.argv) >= 8 \
        else (4, 512, 32, 1, 64, 128, 128)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    lib = build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((b, l, h, p), generator=gen, device=dev).bfloat16()
    dt = torch.nn.functional.softplus(torch.randn((b, l, h), generator=gen, device=dev)) * 0.1
    a = -torch.exp(torch.rand((b, h), generator=gen, device=dev))
    bm, cm = (torch.randn((b, l, g, n), generator=gen, device=dev).bfloat16() for _ in range(2))
    c = l // chunk
    y = torch.empty_like(x)
    s_final = torch.empty((b, h, p, n), device=dev)
    states = torch.empty((b, c, h, p, n), device=dev)
    cum_last = torch.empty((b, c, h), device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def stage(i):
        rc = lib.ssd_scan_stage(x.data_ptr(), dt.data_ptr(), a.data_ptr(), bm.data_ptr(),
                                cm.data_ptr(), None, y.data_ptr(), s_final.data_ptr(),
                                states.data_ptr(), cum_last.data_ptr(), b, l, h, g, p, n,
                                chunk, 1, i, stream)
        if rc:
            sys.exit(f"stage {i}: cudaError {rc}")

    for _ in range(3):
        for i in range(3):
            stage(i)
    torch.cuda.synchronize()
    q64 = -(-chunk // 64)
    for i, name, blocks, n_marks in ((0, "ssd_chunk_state_mma", c * h * b, 4),
                                     (2, "ssd_chunk_out_mma", q64 * c * h * b, 6)):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(50):
            stage(i)
        ev[1].record()
        torch.cuda.synchronize()
        ms = ev[0].elapsed_time(ev[1]) / 50
        marks = torch.zeros((blocks, 16), dtype=torch.int64, device=dev)
        lib.probe_set_marks(marks.data_ptr())
        stage(i)
        torch.cuda.synchronize()
        lib.probe_set_marks(None)
        row = dict(kernel=name, shape=[b, l, h, g, p, n, chunk], ms=round(ms, 5))
        row.update(analyse(marks.cpu(), n_marks))
        print(json.dumps(row), flush=True)
        ghz = row["sm_ghz"]
    # the mma.sync rate at 1-4 blocks of 4 warps an SM (registers only)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 4 * 128, device=dev)
    for per_sm in (1, 2, 3, 4):
        blocks, iters = sms * per_sm, 4096
        lib.probe_mma_rate(out.data_ptr(), blocks, iters, stream)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        lib.probe_mma_rate(out.data_ptr(), blocks, iters, stream)
        ev[1].record()
        torch.cuda.synchronize()
        ms = ev[0].elapsed_time(ev[1])
        mmas = blocks * 4 * 8 * iters
        # the SM clock of the kernels above: cycles an SM sub-partition
        # (one of 4) spends per mma
        print(json.dumps(dict(probe="mma.sync m16n8k16 bf16", warps_per_sm=4 * per_sm,
                              tflops=round(mmas * 4096 / ms / 1e9, 1),
                              cycles_per_mma_per_smsp=round(
                                  ms * 1e6 * ghz / (mmas / (sms * 4)), 2))), flush=True)


if __name__ == "__main__":
    main()
