"""Multi-pod dry-run on the meta device: every (architecture × input
shape × mesh) combination's step, one rank's share of it run on meta
tensors (no storage, no card, the same on every host), its work counted
and turned into roofline terms: the JAX package's ``launch/dryrun.py``.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all            # 40 pairs
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod

JAX lowers and compiles each step on 512 placeholder devices and reads
the compiled program's costs; the port runs rank 0's share of the step
(``launch/specs.DryrunCase.local_args``) under
``roofline/analysis.count_work`` with the collectives' counting stand-in
(``counting_collectives``): FLOPs, bytes and collective bytes a chip, as
the port would run on that mesh (the model axis replicated, one client a
data row; each row's ``note`` says so). The layers are a Python loop, so
one count covers every layer: there is no second compile and no
two-point correction.

The flags are JAX's. Refused by name: ``--layout dpc|dpr`` (they split a
client's sequences over the model axis, which the port replicates).
Accepted and doing nothing: ``--single-compile`` (there is no compile)
and ``--no-remat`` (the port keeps every activation anyway). Every
``--gossip-mode`` runs the port's mesh exchange, the send/recv schedule
(``permute`` builds the permute-wired gossip spec, as JAX's). One JSON
row a case goes to ``--out`` (default ``build/dryrun``, which
``.gitignore`` lists), then the table is printed.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time
import traceback

import torch

from repro_torch.configs.base import ARCH_ALIASES, INPUT_SHAPES, get_config
from repro_torch.launch.mesh import PRODUCTION_SHAPES, MeshShape, n_chips
from repro_torch.launch.specs import build_dryrun
from repro_torch.launch.steps import arch_for_shape, supports_shape
from repro_torch.roofline import analysis as rl

CANONICAL_ARCHS = [
    "olmo-1b", "olmoe-1b-7b", "phi3.5-moe-42b-a6.6b", "whisper-base",
    "h2o-danube-1.8b", "zamba2-1.2b", "gemma3-1b", "granite-3-8b",
    "mamba2-370m", "chameleon-34b",
]


def production_mesh(multi_pod: bool = False) -> MeshShape:
    """The production mesh by its axis sizes: (16, 16) ("data", "model"),
    or (2, 16, 16) ("pod", "data", "model")."""
    return MeshShape.of(*PRODUCTION_SHAPES[bool(multi_pod)])


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in torch.utils._pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def run_case(arch: str, shape_name: str, mesh: MeshShape, mesh_name: str, *,
             step_kind: str = "auto", attn_mode: str = "blocked",
             gossip_mode: str = "dense", moe_dispatch: str | None = None,
             verbose: bool = True, cfg_override=None):
    """Count one combination; return (Roofline, wall seconds), or (None,
    why) for a combination ``supports_shape`` skips."""
    cfg = cfg_override if cfg_override is not None else get_config(arch)
    ok, why = supports_shape(cfg, shape_name)
    if not ok:
        return None, why
    if moe_dispatch:
        cfg = cfg.with_overrides(moe_dispatch=moe_dispatch)

    t0 = time.time()
    case = build_dryrun(arch, shape_name, mesh, step_kind=step_kind, attn_mode=attn_mode,
                        gossip_mode=gossip_mode, cfg_override=cfg)
    args = case.local_args()
    with rl.count_work() as counts, rl.counting_collectives(counts, n_chips(mesh)):
        out = case.fn(*args)
    wall = time.time() - t0

    cfg_eff, _ = arch_for_shape(cfg, shape_name)
    roof = rl.analyze(
        arch=arch, shape=shape_name, step_kind=case.step_kind, mesh_name=mesh_name,
        chips=n_chips(mesh), counts=counts,
        model_flops=rl.model_flops_for(cfg_eff, INPUT_SHAPES[shape_name], case.step_kind),
        memory={"argument_size_in_bytes": _bytes(args), "output_size_in_bytes": _bytes(out)},
        note=case.note)
    if verbose:
        print(f"--- {arch} × {shape_name} × {mesh_name} [{case.step_kind}] "
              f"({wall:.1f}s counted) {case.note}")
        print(f"    memory: {roof.memory_per_chip}")
        print(f"    counts: flops/chip={roof.flops_per_chip:.3e} "
              f"bytes/chip={roof.bytes_per_chip:.3e}")
        print(f"    kernels: {counts.kernels}")
        print(f"    collectives/chip: {roof.coll_breakdown}")
        print(f"    roofline: compute={roof.compute_s:.3e}s "
              f"memory={roof.memory_s:.3e}s coll={roof.collective_s:.3e}s "
              f"-> {roof.bottleneck}-bound, useful={roof.useful_ratio:.3f}")
    return roof, wall


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="multi-pod dry-run on the meta device")
    ap.add_argument("--arch", choices=sorted(ARCH_ALIASES), default=None)
    ap.add_argument("--shape", choices=sorted(INPUT_SHAPES), default=None)
    ap.add_argument("--all", action="store_true", help="all 10×4 pairs")
    ap.add_argument("--multi-pod", action="store_true",
                    help="(2,16,16) pod mesh instead of (16,16)")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--step", default="auto",
                    choices=["auto", "fedspd", "plain", "prefill", "decode"])
    ap.add_argument("--attn-mode", default="blocked", choices=["blocked", "ref", "pallas"],
                    help="prefill/decode attention: blocked and pallas are kernel 8, "
                         "ref the materialized softmax (training is always ref)")
    ap.add_argument("--gossip-mode", default="dense",
                    choices=["dense", "permute", "ppermute"])
    ap.add_argument("--layout", default="tp", choices=["tp", "dpc", "dpr"])
    ap.add_argument("--moe-dispatch", default=None, choices=["cumsum", "sort", "grouped"])
    ap.add_argument("--no-remat", action="store_true",
                    help="accepted for the JAX package's CLI; a no-op (the port keeps "
                         "every activation)")
    ap.add_argument("--single-compile", action="store_true",
                    help="accepted for the JAX package's CLI; a no-op (nothing compiles)")
    ap.add_argument("--out", default="build/dryrun")
    return ap


def main(argv=None) -> list:
    """The CLI; returns the rows."""
    args = _parser().parse_args(argv)
    if args.layout != "tp":
        raise SystemExit(
            f"--layout {args.layout} splits a client's sequences over the model axis; "
            "the port replicates the model axis (each rank of a data row computes its "
            "client's whole batch): use --layout tp")
    if args.single_compile or args.no_remat:
        print("--single-compile / --no-remat: no-ops in the port (one count on the meta "
              "device covers every layer; no activation is recomputed)")

    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    if args.both_meshes:
        meshes = [(production_mesh(), "pod16x16"), (production_mesh(True), "2pod")]
    elif args.multi_pod:
        meshes = [(production_mesh(True), "2pod")]
    else:
        meshes = [(production_mesh(), "pod16x16")]

    if args.all:
        pairs = [(a, s) for a in CANONICAL_ARCHS for s in INPUT_SHAPES]
    elif args.arch and args.shape:
        pairs = [(args.arch, args.shape)]
    else:
        raise SystemExit("give --arch and --shape, or --all")

    rows, failures, skips = [], [], []
    for mesh, mesh_name in meshes:
        for arch, shape_name in pairs:
            try:
                roof, wall = run_case(arch, shape_name, mesh, mesh_name, step_kind=args.step,
                                      attn_mode=args.attn_mode,
                                      gossip_mode=args.gossip_mode,
                                      moe_dispatch=args.moe_dispatch)
            except Exception:
                print(f"!!! FAILED {arch} × {shape_name} × {mesh_name}")
                traceback.print_exc()
                failures.append((arch, shape_name, mesh_name))
                continue
            if roof is None:
                print(f"--- SKIP {arch} × {shape_name}: {wall}")
                skips.append((arch, shape_name, wall))
                continue
            rows.append(roof)
            tag = f"{arch}__{shape_name}__{mesh_name}".replace(".", "_")
            if args.step != "auto":
                tag += f"__{args.step}"
            if args.gossip_mode != "dense":
                tag += f"__{args.gossip_mode}"
            if args.moe_dispatch:
                tag += f"__{args.moe_dispatch}"
            with open(outdir / f"{tag}.json", "w") as f:
                json.dump(roof.to_json(), f, indent=1)

    print()
    print(rl.format_table(rows))
    if skips:
        print(f"\nskipped ({len(skips)}):")
        for a, s, why in skips:
            print(f"  {a} × {s}: {why}")
    if failures:
        print(f"\nFAILURES ({len(failures)}): {failures}")
        raise SystemExit(1)
    print(f"\nall {len(rows)} combinations counted OK")
    return rows


if __name__ == "__main__":
    main()
