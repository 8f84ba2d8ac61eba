#!/usr/bin/env python3
"""Kernel 8's rows of ``chip_smoke.py`` alone, after the kernels' build.

    python3 tools/flash_phase.py [--out chiprun_out/flash_phase.json]

Builds the CUDA kernels from this checkout, prints the card's name and
power limit (``nvidia-smi``), torch's versions and the ptxas report of
kernel 8's kernels, counts and checks their tensor-core instructions
(``cuobjdump -sass``: HGMMA in each ``wgmma``-route instantiation, HMMA in
the ``mma.sync`` and 3xTF32 ones), then runs every kernel-8 row: the LM
shapes and the split rows (``FLASH_SHAPES``, ``SPLIT_FLASH``) and
whisper's ragged lengths (``RAGGED_FLASH``), each against its plain
version and timed beside its bound, plain and SDPA times. The rows go to
``--out`` as JSON and, one line each, to the output. Needs a CUDA device;
exits non-zero on the first row that disagrees.
"""
import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "flash_phase.json"))
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is False: this script needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    lib_path = build.build()
    build.load_library()
    print(f"built in {time.perf_counter() - t:.1f} s", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    log = lib_path.with_suffix(".log").read_text().splitlines()
    for i, line in enumerate(log):
        if "Compiling entry function" in line and "flash" in line:
            print("ptxas " + " | ".join(x.strip() for x in log[i:i + 4]), flush=True)
    counts = chip_smoke.tensor_core_counts(build, lib_path)
    chip_smoke.check_tensor_cores(counts)
    t = time.perf_counter()
    rows = chip_smoke.flash_shape_rows(torch, counts) + chip_smoke._ragged_flash_rows(
        torch, counts)
    print(f"flash phase: {len(rows)} rows in {time.perf_counter() - t:.1f} s", flush=True)
    print(f"{'row':<46} {'dtype':<8} {'route':<19} {'split':>5} {'ms':>9} {'sdpa':>9} "
          f"{'bound':>9} {'err':>9}")
    for r in rows:
        print(f"{r['variant'][:46]:<46} {r['dtype']:<8} {r['route']:<19} {r['split']:>5} "
              f"{r['ms']:>9.5f} {r['library_ms']:>9.5f} {r['bound_ms']:>9.5f} "
              f"{r['max_abs_err']:>9.2e}", flush=True)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "rows": rows}, indent=1))


if __name__ == "__main__":
    main()
