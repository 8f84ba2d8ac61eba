#!/usr/bin/env python3
"""``chip_smoke.py``'s phase "whisper" alone, after the kernels' build.

    python3 tools/whisper_phase.py

Builds the CUDA kernels from this checkout, prints the card's name and
power limit (``nvidia-smi``) and torch's versions, then runs
``phase_whisper``: kernel 8 at whisper's ragged lengths against its plain
version, W1 (whisper-base's prefill and greedy decode on the card against
``attn_mode="ref"``, the teacher-forced decode against the forward, the
dry-run's roofline of the prefill) and W2 (``launch.train --arch
whisper-base``, loop against replay). Needs a CUDA device.
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
    from repro_torch.kernels import gossip_mix as gm

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
    chip_smoke.phase_whisper(torch, gm, card)


if __name__ == "__main__":
    main()
