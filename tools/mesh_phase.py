#!/usr/bin/env python3
"""``chip_smoke.py``'s phase "mesh" alone, after the kernels' build.

    python3 tools/mesh_phase.py

Builds the CUDA kernels from this checkout (the one-device runs beside
the mesh mix through kernel 1), prints the card's name and power limit
(``nvidia-smi``) and torch's versions, then runs ``phase_mesh``: M1 and
M2 at a world of one rank over NCCL, each against the one-device step
bit for bit, with their round ms and peak memory. Needs a CUDA device.
"""
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> None:
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
    build.build()
    build.load_library()
    print(f"built in {time.perf_counter() - t:.1f} s", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    chip_smoke.phase_mesh(torch, card)


if __name__ == "__main__":
    main()
