"""Build and load the port's CUDA kernels.

``load_library()`` compiles every ``csrc/*.cu`` with ``nvcc`` for
``sm_90a`` at first use — one ``nvcc -c`` per source, all started together,
then one link — into ``build/repro_torch_kernels/`` at the root of the
checkout, named by a hash of the sources, the headers they include
(``csrc/*.cuh``) and the flags, and loads the shared
library with ``ctypes``. A library already built from the same sources is
loaded as it is. Nothing is downloaded: the build uses the sources in the
repository and the CUDA toolkit on the machine (``$CUDA_HOME`` or
``/usr/local/cuda``, else ``nvcc`` on ``PATH``).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
# C entry points: (argtypes, restype); every one returns cudaGetLastError()
SIGNATURES = {
    "gossip_mix_flat": ([_P, _P, _P, ctypes.c_int, ctypes.c_longlong, _P],
                        ctypes.c_int),
    "gossip_mix_stack": ([_P, _P, _P, ctypes.c_int, ctypes.c_int,
                          ctypes.c_longlong, _P],
                         ctypes.c_int),
    "gossip_mix_fused_dp": ([_P, _P, _P, _P, _P, ctypes.c_float, _P,
                             ctypes.c_int, ctypes.c_longlong, _P],
                            ctypes.c_int),
    "gossip_mix_dequant": ([_P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                            ctypes.c_longlong, ctypes.c_longlong, _P],
                           ctypes.c_int),
    "mixture_mix_dequant4": ([_P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                              ctypes.c_longlong, ctypes.c_longlong, _P],
                             ctypes.c_int),
    "gossip_mix_sparse": ([_P, _P, _P, _P, ctypes.c_int, ctypes.c_longlong, _P],
                          ctypes.c_int),
    "gossip_mix_dequant_masked": ([_P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_longlong, ctypes.c_longlong,
                                   ctypes.c_longlong, _P],
                                  ctypes.c_int),
    # q, k, v, o, part, ml, b, lq, lkv, hq, hkv, hd, causal, window, route,
    # n_split, chunk, stream
    "flash_attention": ([_P] * 6 + [ctypes.c_int] * 11 + [_P], ctypes.c_int),
    # x, dt, a, bm, cm, s0, y, s_final, states, cum, dtt,
    # b, l, h, g, p, n, chunk, bf16, route, hb, cols, stage, stream
    "ssd_scan_stage": ([_P] * 11 + [ctypes.c_int] * 12 + [_P], ctypes.c_int),
}


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found (looked for {cand} and on PATH); the port's CUDA "
            "kernels are compiled at first use with: nvcc "
            + " ".join(NVCC_FLAGS) + f" -c {CSRC}/*.cu"
        )
    return found


def _digest(sources: list) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run(cmds: list) -> str:
    """Run the commands concurrently; raise with the first failure's
    command and output. Returns their combined output (ptxas reports)."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    logs = [p.communicate()[0] for p in procs]
    for cmd, p, log in zip(cmds, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(
                f"kernel build failed ({p.returncode}): {' '.join(cmd)}\n{log}")
    return "".join(logs)


def build() -> pathlib.Path:
    """Compile the sources unless a library built from them exists; return
    the library's path. The build log (with ptxas register and spill
    counts) lands beside it as ``<name>.log``."""
    sources = sorted(CSRC.glob("*.cu"))
    # the headers the sources include are hashed too, so an edit to one
    # builds anew
    digest = _digest(sources + sorted(CSRC.glob("*.cuh")))
    lib = BUILD_DIR / f"librepro_torch_kernels_{digest}.so"
    if lib.is_file():
        return lib
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [pathlib.Path(tmp) / (s.stem + ".o") for s in sources]
        log = _run([[nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)]
                    for s, o in zip(sources, objs)])
        tmp_lib = pathlib.Path(tmp) / lib.name
        log += _run([[nvcc, "-shared", "-o", str(tmp_lib), *map(str, objs)]])
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp_lib, lib)  # atomic: concurrent builders never see half a file
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """The built kernels, with every entry point's C signature declared."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib
