#!/usr/bin/env python3
"""Time variants of the gossip mix template side by side on one GPU.

    python3 tools/mix_variants.py

Builds ``tools/mix_variants.cu`` with ``nvcc`` (``sm_90a``) into
``build/mix_variants/`` and times each variant at the (S, N, X) shapes
below with CUDA events (mean of 30 back-to-back calls after 3 warm-ups),
beside one ``torch.matmul(w, c)`` before and after them, and checks each
against that matmul (TF32 off). Prints the card's name and power limit
first, then one JSON line per shape. The variants differ in how a thread
reads its column (see the .cu); ``src/repro_torch/kernels/csrc/
gossip_mix.cu`` takes the design that wins past 32 rows. Needs a CUDA
device.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
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
TOL = 1e-5


def build() -> pathlib.Path:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.build import NVCC_FLAGS, find_nvcc

    out = ROOT / "build" / "mix_variants"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libmix_variants.so"
    r = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(lib),
                        str(ROOT / "tools" / "mix_variants.cu")],
                       capture_output=True, text=True)
    if r.returncode != 0:
        sys.exit(f"nvcc failed:\n{r.stdout}{r.stderr}")
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


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("mix_variants: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    lib = ctypes.CDLL(str(build()))
    dev = torch.device("cuda")
    for (s, n, x), names in SHAPES.items():
        g = torch.Generator(device=dev).manual_seed(s * 7 + n + x)
        w = torch.rand((n, n), generator=g, device=dev)
        w = w / w.sum(dim=1, keepdim=True)
        c = torch.randn((s, n, x), generator=g, device=dev)
        want = torch.matmul(w, c)
        stream = torch.cuda.current_stream().cuda_stream
        row = {"s": s, "n": n, "x": x, "matmul_ms": time_ms(torch, lambda: torch.matmul(w, c))}
        for name in names:
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                                                   ctypes.c_void_p]
            out = torch.empty_like(c)

            def call():
                return fn(w.data_ptr(), c.data_ptr(), out.data_ptr(), s, n, x, stream)

            if call() != 0:
                sys.exit(f"{name}: launch failed")
            torch.cuda.synchronize()
            err = float((out - want).abs().max())
            if err > TOL:
                sys.exit(f"{name} at {(s, n, x)}: max abs err {err} > {TOL}")
            row[name + "_ms"] = time_ms(torch, call)
        row["matmul_again_ms"] = time_ms(torch, lambda: torch.matmul(w, c))
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
