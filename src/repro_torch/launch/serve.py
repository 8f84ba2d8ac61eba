"""Serving launcher: a thin CLI over the port's serve/ subsystem.

After FedSPD training the product is Eq. (2)'s per-user mixture of S
cluster models. This launcher builds a ``ServeConfig`` from flags (the JAX
package's ``launch/serve.py`` flags, and ``--device``), loads a servable
artifact or builds a random 2-cluster plane, and answers one request
batch off the resident plane with ``ClusterPlaneServer.generate``; per-user
models are never materialized.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \\
      --batch 4 --prompt-len 512 --gen 16 --codec int8

  # a trained plane, one client's mixture; or every request its own
  ... --artifact runs/servable.npz --client 0
  ... --mixture 0.7,0.3

It runs on the card unless ``--device cpu`` is given. Non-smoke runs use
the flash kernel for attention (``attn_mode="cuda"``); ``--smoke`` runs the
arch's smoke config with the reference attention, as the JAX launcher
does. Without ``--artifact`` the plane is ``bundle.init`` drawn with seeds
``seed + s`` for s = 0, 1, shipped in ``--codec`` (nearest rounding, as an
exported artifact; the JAX launcher serves this plane in fp32 whatever
the codec). The JAX package's deprecated surface, ``--ckpt`` serving and
the module-level ``generate``, raises here.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.comm.codecs import Channel, CommConfig, int4_pack
from repro_torch.configs.base import ARCH_ALIASES
from repro_torch.core.packing import PackSpec, make_pack_spec, pack
from repro_torch.device import make_generator, resolve_device, synchronize
from repro_torch.models.registry import ModelBundle, build_model
from repro_torch.serve import SERVE_CODECS, ClusterPlaneServer, ServeConfig, load_servable
from repro_torch.telemetry.events import write_events
from repro_torch.telemetry.profile import trace_session


def generate(*args, **kwargs):
    """The JAX package's deprecated module-level decode loop: not ported."""
    raise ValueError(
        "launch.serve.generate (deprecated in the JAX package) is not ported: build a "
        "ServeConfig and use serve.ClusterPlaneServer.generate")


def _parse_mixture(text):
    if text is None:
        return None
    return np.asarray([float(t) for t in text.split(",")], np.float32)


def build_config(args) -> ServeConfig:
    """Flags -> resolved ServeConfig (the CLI's only config authority)."""
    return ServeConfig(
        arch=args.arch, smoke=args.smoke, batch=args.batch,
        prompt_len=args.prompt_len, gen=args.gen,
        temperature=args.temperature, client=args.client,
        mixture=_parse_mixture(args.mixture), codec=args.codec,
        seed=args.seed,
    ).resolve()


def _random_row(bundle: ModelBundle, spec: PackSpec, seed: int,
                dev: torch.device) -> torch.Tensor:
    """``bundle.init`` drawn with ``seed``, packed to one fp32 ``(X,)`` row
    (the tree is freed as soon as it is packed)."""
    return pack(bundle.init(make_generator(dev, seed)), spec)


def random_plane(bundle: ModelBundle, spec: PackSpec, *, seed: int, n_clusters: int = 2,
                 device: str | torch.device = "cuda") -> torch.Tensor:
    """The ``(S, X)`` fp32 plane of ``bundle.init`` drawn with seeds
    ``seed + s``, one model at a time."""
    dev = resolve_device(device)
    plane = torch.empty((n_clusters, spec.size), dtype=torch.float32, device=dev)
    for s in range(n_clusters):
        plane[s] = _random_row(bundle, spec, seed + s, dev)
    return plane


# columns encoded at a time (a whole number of blocks): the encode's fp32
# temporaries stay a few hundred MB whatever the width of the plane
ENCODE_COLUMNS = 1 << 24


class _PlaneEncoder:
    """An ``(S, X)`` plane's serving form in ``codec`` (int8 or int4),
    filled one fp32 row at a time, each row in chunks of whole blocks:
    per-block scales make the chunks' bytes the whole row's."""

    def __init__(self, n_clusters: int, x: int, codec: str, qblock: int,
                 device: torch.device):
        self.codec, self.qblock = codec, qblock
        self.ch = Channel(CommConfig(codec=codec, block=qblock), x)
        nq = -(-x // qblock)
        width = nq * qblock // 2 if codec == "int4" else nq * qblock
        self.q = torch.empty((n_clusters, width), dtype=torch.uint8 if codec == "int4"
                             else torch.int8, device=device)
        self.scale = torch.empty((n_clusters, nq), dtype=torch.float32, device=device)
        self.step = max(1, ENCODE_COLUMNS // qblock) * qblock

    def put(self, s: int, row: torch.Tensor) -> None:
        """Encode fp32 ``row`` ``(X,)`` as cluster row ``s`` (nearest
        rounding, as ``save_servable``)."""
        for c0 in range(0, row.shape[0], self.step):
            enc = self.ch.encode(row[None, c0:c0 + self.step], rounding="nearest")
            q = int4_pack(enc["q"]) if self.codec == "int4" else enc["q"]
            a, b0 = (c0 // 2 if self.codec == "int4" else c0), c0 // self.qblock
            self.q[s, a:a + q.shape[1]] = q[0]
            self.scale[s, b0:b0 + enc["scale"].shape[1]] = enc["scale"][0]

    def keywords(self) -> dict:
        if self.codec == "int8":
            return {"plane_q": self.q, "plane_scale": self.scale}
        return {"plane_packed": self.q, "plane_scale": self.scale}


def encode_plane(plane: torch.Tensor, codec: str, qblock: int = 64) -> dict:
    """An fp32 ``(S, X)`` plane in ``codec``'s serving form, as the
    ``ClusterPlaneServer`` keywords: int8 quanta or int4 bit-packed
    nibbles with their per-block scales, encoded as ``save_servable``
    encodes them (nearest rounding, int4 scales through fp16), one
    cluster row at a time."""
    if codec == "fp32":
        return {"plane": plane}
    enc = _PlaneEncoder(plane.shape[0], plane.shape[1], codec, qblock, plane.device)
    for s in range(plane.shape[0]):
        enc.put(s, plane[s])
    return enc.keywords()


def random_server_plane(bundle: ModelBundle, spec: PackSpec, *, seed: int, codec: str,
                        qblock: int = 64, n_clusters: int = 2,
                        device: str | torch.device = "cuda") -> dict:
    """``random_plane`` in ``codec``'s serving form (the
    ``ClusterPlaneServer`` keywords), equal to ``encode_plane`` of it.
    int8 and int4 never hold the fp32 plane: each cluster's model is
    drawn, packed, encoded and freed before the next (at olmoe-1b-7b's
    X = 6.9 B the fp32 plane alone is 55 GB)."""
    dev = resolve_device(device)
    if codec == "fp32":
        return {"plane": random_plane(bundle, spec, seed=seed, n_clusters=n_clusters,
                                      device=dev)}
    enc = _PlaneEncoder(n_clusters, spec.size, codec, qblock, dev)
    for s in range(n_clusters):
        row = _random_row(bundle, spec, seed + s, dev)
        enc.put(s, row)
        del row
    return enc.keywords()


def build_server(cfg: ServeConfig, bundle: ModelBundle, spec: PackSpec, *,
                 artifact: str | None = None, device: str | torch.device = "cuda"):
    """(server, (B, S) request mixture) for a resolved config: the
    artifact's plane, or without one the random S = 2 plane in
    ``cfg.codec``."""
    dev = resolve_device(device)
    if artifact:
        art = load_servable(artifact, spec, device=dev)
        art.manifest.check(arch=cfg.arch, codec=cfg.codec)
        server = ClusterPlaneServer.from_artifact(art, spec, bundle=bundle, device=dev)
        u_table = None if art.u_table is None else art.u_table.cpu().numpy()
        print(f"serving {server.n_clusters}-cluster {art.codec} plane from {artifact}")
        return server, cfg.request_mixture(server.n_clusters, u_table)
    planes = random_server_plane(bundle, spec, seed=cfg.seed, codec=cfg.codec,
                                 qblock=cfg.qblock, device=dev)
    server = ClusterPlaneServer(spec, codec=cfg.codec, qblock=cfg.qblock, bundle=bundle,
                                device=dev, **planes)
    print(f"serving a randomly initialized 2-cluster {cfg.codec} plane (no --artifact)")
    return server, cfg.request_mixture(2)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCH_ALIASES), default="olmo-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--artifact", default=None,
                    help="servable cluster-plane artifact (experiments.export_run)")
    ap.add_argument("--client", type=int, default=None,
                    help="serve this trained client's mixture row")
    ap.add_argument("--mixture", default=None,
                    help="explicit mixture weights, e.g. 0.7,0.3 (exclusive with --client)")
    ap.add_argument("--codec", choices=SERVE_CODECS, default="fp32",
                    help="plane shipping format (of the artifact, or of the random plane)")
    ap.add_argument("--ckpt", default=None,
                    help="deprecated in the JAX package and not ported: use --artifact")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--telemetry-out", default=None,
                    help="write serve-path telemetry (latency percentiles, QPS, plane "
                         "residency) as a JSONL event log")
    ap.add_argument("--profile-dir", default=None,
                    help="capture a torch.profiler trace of the serve batch here")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.ckpt:
        raise ValueError(
            "--ckpt serving (deprecated in the JAX package) is not ported: export a "
            "servable artifact (experiments.export_run) and pass --artifact")

    cfg = build_config(args)
    dev = resolve_device(args.device)
    arch_cfg = cfg.arch_config()
    bundle = build_model(arch_cfg, attn_mode="ref" if cfg.smoke else "cuda")
    spec = make_pack_spec(bundle.init(None))
    server, u = build_server(cfg, bundle, spec, artifact=args.artifact, device=dev)
    prompts = torch.randint(0, arch_cfg.vocab, (cfg.batch, cfg.prompt_len),
                            generator=make_generator(dev, cfg.seed), device=dev)
    t0 = time.perf_counter()
    with trace_session(args.profile_dir, filename="serve_trace.json"):
        toks = server.generate(u, prompts, gen=cfg.gen, temperature=cfg.temperature,
                               key=make_generator(dev, cfg.seed))
        synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"generated {cfg.gen} tokens × {cfg.batch} requests in {dt:.2f}s "
          f"({cfg.gen * cfg.batch / dt:.1f} tok/s, {server.n_compiles} compile(s), "
          f"{server.n_dispatches} dispatch(es))")
    print(toks.cpu().numpy())
    if args.telemetry_out:
        snap = server.telemetry_snapshot()
        events = [
            {"event": "serve_meta", "arch": cfg.arch, "codec": snap["codec"],
             "n_clusters": snap["n_clusters"], "plane_bytes": snap["plane_bytes"]},
            {"event": "serve_batch", "entry": "generate", "batch": cfg.batch,
             "latency_ms": server.latency.percentile(50) * 1e3},
            {"event": "serve_summary", **snap},
        ]
        write_events(args.telemetry_out, events)
        print(f"telemetry -> {args.telemetry_out}")
    return toks


if __name__ == "__main__":
    main()
