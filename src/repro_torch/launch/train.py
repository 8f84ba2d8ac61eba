"""Training launcher: FedSPD over an LM architecture, the JAX package's
``launch/train.py`` on one card.

The stream regime (``core/fedspd``, ``regime="stream"``): every round each
client draws a fresh batch of documents from its own mixture of
cluster-specific Markov chains (``data/synthetic.make_mixture_tokens``),
selects a cluster, takes τ SGD steps of the cluster-masked LM loss, and
the exchange mixes the selected rows (kernel 1; 4 under int8/int4, 5 and
6 with sparse masks). The packed ``(S, N, X)`` plane is made once after
the init and updated in place every round; ``--pytree`` runs the per-leaf
engine. Parameters re-enter model form at the personalize / checkpoint
boundary.

Two engines, one round closure over static buffers (the state, the
heterogeneity carry, the round counter, the metric tapes):

- the loop (the default): the closure called once a round;
- ``--scan-rounds``, the port's counterpart of JAX's one-``lax.scan``
  program: on the card the closure is warmed up on a throwaway copy of
  the state, the cache it left is released, and it is captured once into
  a CUDA graph (one per host branch: the sparse masks' update rounds) and
  replayed ``--rounds`` times. The batch is drawn inside the graph from a
  generator registered with it, the lr comes from a device tape at the
  device round counter, and nothing is read on the host inside a round.
  On the CPU the closure is called directly. Both engines give the same
  final state bit for bit.

The model takes the training route (``build_model(..., train=True)``:
attention ``ref_attention`` and the SSD ``ssm.ssd_chunked`` under
autograd), as JAX trains outside its Pallas kernels.

The flags are JAX's, by name and default, with these differences:
``--gossip-backend`` offers ``reference|cuda`` (``cuda`` is the
counterpart of ``pallas``, which is refused by name); ``--device``
(default the card; raises without one; ``cpu`` runs on the CPU);
``--mesh pod|2pod`` is refused (ROADMAP queue 1 item 2); ``--no-donate``
is accepted and does nothing, since the port always updates the plane in
place. ``main`` returns the run's outcome as a dict; ``draws`` (the loop
only) injects each round's selections and batch indices.

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --smoke \\
      --rounds 20 --clients 8 --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import Callable

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.comm.codecs import CommConfig, make_channel, sparse_wire_model_bytes
from repro_torch.configs.base import ARCH_ALIASES, get_config, get_smoke_config
from repro_torch.core.fedspd import FedSPDConfig, FedSPDState, init_state, personalize, round_lr
from repro_torch.core.gossip import MIX_BACKENDS, GossipSpec, make_mix_fn
from repro_torch.core.packing import make_pack_spec
from repro_torch.core.sparse import SparseConfig, init_masks
from repro_torch.data.synthetic import make_mixture_tokens
from repro_torch.device import (
    capture,
    make_generator,
    resolve_device,
    synchronize,
    warm_up,
)
from repro_torch.experiments.config import RunConfig
from repro_torch.experiments.heterogeneity import (
    ClientSystemModel,
    draw_het,
    het_round,
    masked_client_step,
)
from repro_torch.experiments.runner import _copy_state, _write_back
from repro_torch.graphs.topology import make_graph
from repro_torch.launch.steps import MESH_LATER, make_fedspd_train_step
from repro_torch.models.registry import build_model
from repro_torch.telemetry import step_annotation, trace_session, write_events

# the seeds of the run's streams beside the init's: the seed xor a tag (the
# masks' and heterogeneity's are the constants JAX folds into its key)
_DATA, _MASKS, _HET = 0xDA7A, 0x3A5C, 0x51AC


def fl_perplexity(bundle, params_stack, batch) -> float:
    """Mean per-client LM loss of personalized models ``(N, ...)`` on
    held-out batches ``{"tokens": (N, b, L)}``."""
    with torch.no_grad():
        return float(bundle.per_example_loss(params_stack, batch).mean())


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCH_ALIASES), default="olmo-1b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--clusters", type=int, default=2)
    ap.add_argument("--tau", type=int, default=1)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=5e-2)
    ap.add_argument("--graph", default="er")
    ap.add_argument("--avg-degree", type=float, default=4)
    ap.add_argument("--gossip-mode", default="dense", choices=["dense", "permute"])
    ap.add_argument("--gossip-backend", default="reference",
                    help="Eq. (1) execution path: reference | cuda (cuda is the "
                         "counterpart of the JAX package's pallas)")
    ap.add_argument("--pytree", dest="param_plane", action="store_false", default=True,
                    help="per-leaf pytree state; default carries the packed "
                         "(S, N, X) plane")
    ap.add_argument("--no-donate", dest="donate", action="store_false", default=True,
                    help="accepted for the JAX package's CLI; a no-op (the port "
                         "always updates the plane in place)")
    ap.add_argument("--scan-rounds", action="store_true",
                    help="capture one round into a CUDA graph and replay it every "
                         "round (on the CPU: the same round closure, called)")
    ap.add_argument("--mesh", default="none", choices=["none", "pod", "2pod"],
                    help="shard the client axis over a mesh (not in the port yet)")
    ap.add_argument("--codec", default="fp32", choices=["fp32", "int8", "int4", "topk"],
                    help="wire codec for the exchange (needs the packed plane)")
    ap.add_argument("--error-feedback", action="store_true",
                    help="carry per-client error-feedback residuals")
    ap.add_argument("--codec-block", type=int, default=256,
                    help="quantization-scale block width along X")
    ap.add_argument("--sparse-density", type=float, default=1.0,
                    help="DisPFL sparse training: active fraction of each client's "
                         "parameters (1.0 = dense, off)")
    ap.add_argument("--prune-rate", type=float, default=0.2,
                    help="fraction of active coords cycled per mask update")
    ap.add_argument("--regrow", default="rigl", choices=["rigl", "random"],
                    help="regrow criterion: dense-gradient magnitude (RigL) or random")
    ap.add_argument("--mask-update-every", type=int, default=10,
                    help="rounds between RigL prune/regrow mask updates")
    ap.add_argument("--slow-fraction", type=float, default=0.0,
                    help="fraction of clients running at 1/slow-factor speed")
    ap.add_argument("--slow-factor", type=float, default=4.0,
                    help="slowdown multiplier for the slow clients")
    ap.add_argument("--time-budget", type=float, default=0.0,
                    help="per-round time budget in nominal round units; clients "
                         "over budget straggle (0 = off)")
    ap.add_argument("--het-jitter", type=float, default=0.0,
                    help="lognormal sigma on per-round compute time")
    ap.add_argument("--p-unavailable", type=float, default=0.0,
                    help="i.i.d. per-round client unavailability")
    ap.add_argument("--staleness-gamma", type=float, default=1.0,
                    help="stale-gossip decay in (0, 1] (1 = off)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-every", type=int, default=10)
    ap.add_argument("--telemetry-out", default=None,
                    help="write the run's JSONL event log here (render with "
                         "python -m repro_torch.telemetry.summary)")
    ap.add_argument("--profile-dir", default=None,
                    help="capture a torch.profiler trace of the rounds here")
    ap.add_argument("--save", default=None, help="checkpoint path (.npz)")
    ap.add_argument("--export-servable", default=None,
                    help="also export the consensus cluster plane as a servable "
                         "artifact for launch/serve --artifact")
    ap.add_argument("--export-codec", default="fp32", choices=["fp32", "int8", "int4"],
                    help="plane shipping format for --export-servable")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def _refusals(args) -> None:
    """The flags the port refuses, each by name."""
    if args.gossip_backend == "pallas":
        raise SystemExit(
            "--gossip-backend pallas is the JAX package's TPU kernel path; the "
            "port's counterpart is --gossip-backend cuda")
    if args.gossip_backend not in MIX_BACKENDS:
        raise SystemExit(f"--gossip-backend {args.gossip_backend!r}: choose from "
                         f"{MIX_BACKENDS}")
    if args.mesh != "none":
        raise SystemExit(f"--mesh {args.mesh}: {MESH_LATER}")
    if not args.donate:
        print("--no-donate: a no-op in the port (the round always updates the "
              "plane in place)")


class _Round:
    """The round closure over static buffers, and its two engines.

    The buffers are the state, the heterogeneity carry (or None), the
    data and heterogeneity generators, and the device round counter
    ``ctr``; each round writes its consensus and logical bytes into
    ``tapes`` at ``ctr``. ``het`` is (model, speeds, axes, base adjacency)
    or None."""

    def __init__(self, step: Callable, state, *, sample: Callable, n: int, batch: int,
                 n_docs: int, lr_tape: torch.Tensor, tapes: dict,
                 data_gen: torch.Generator, het=None, het_carry=None,
                 het_gen: torch.Generator | None = None):
        self.step, self.sample, self.n, self.batch, self.n_docs = step, sample, n, batch, n_docs
        self.lr_tape, self.tapes, self.het = lr_tape, tapes, het
        self.bufs = (state, het_carry, data_gen, het_gen)
        self.ctr = torch.zeros(1, dtype=torch.int64, device=lr_tape.device)
        self.graphs: dict = {}

    def body(self, bufs, ctr, r: int, draws: dict | None = None):
        """One round on ``bufs`` at device round ``ctr`` (host round ``r``,
        which the step reads only for the sparse masks' update rounds);
        returns (state', carry')."""
        state, carry, data_gen, het_gen = bufs
        lr = self.lr_tape.index_select(0, ctr).reshape(())
        if draws is not None and "idx" in draws:
            idx = torch.as_tensor(draws["idx"], device=ctr.device).long()
        else:
            idx = torch.randint(0, self.n_docs, (self.n, self.batch), generator=data_gen,
                                device=ctr.device)
        kw = {} if draws is None or "s" not in draws else {"s": draws["s"]}
        state, batch = state._replace(round=r), self.sample(idx)
        if self.het is None:
            new, metrics = self.step(state, batch, lr=lr, **kw)
        else:
            model, speeds, axes, adj = self.het
            carry, aw = het_round(model, speeds, carry, *draw_het(het_gen, self.n))
            step_h = masked_client_step(
                lambda st, b, _gen, lr_, adj_: self.step(st, b, adj_, lr=lr_, **kw), axes)
            new, metrics = step_h(state, batch, None, lr, adj, aw)
        self.tapes["consensus"].index_copy_(0, ctr, metrics["consensus"][None].float())
        self.tapes["comm_bytes"].index_copy_(0, ctr, new.comm_bytes.reshape(1))
        ctr.add_(1)
        return new, carry

    @property
    def state(self):
        return self.bufs[0]

    def loop(self, r: int, draws: dict | None = None) -> None:
        new, carry = self.body(self.bufs, self.ctr, r, draws)
        self.bufs = (new, carry) + self.bufs[2:]

    def _in_place(self, bufs, ctr, r: int) -> None:
        """The body with its results written back into ``bufs``."""
        new, carry = self.body(bufs, ctr, r)
        _write_back(bufs[0], new)
        if carry is not None:
            _write_back(bufs[1], carry)

    def replay(self, r: int, branch) -> None:
        """Round ``r`` by the graph of ``branch`` (captured at its first
        round after a warm-up on copies of the buffers); on the CPU the
        closure, called on the buffers."""
        dev = self.ctr.device
        if dev.type != "cuda":
            return self._in_place(self.bufs, self.ctr, r)
        if branch not in self.graphs:
            copies = tuple(_copy_state(b) for b in self.bufs)
            warm_up(lambda: self._in_place(copies, self.ctr.clone(), r), dev)
            del copies
            # the warm-up's transients sit in the allocator's cache: release
            # them, or the graph's private pool holds a second set beside them
            torch.cuda.empty_cache()
            gens = [self.state.gen] + [g for g in self.bufs[2:] if g is not None]
            self.graphs[branch] = capture(
                lambda: self._in_place(self.bufs, self.ctr, r), gens)
        self.graphs[branch].replay()

    def release(self) -> None:
        """Free the graphs and their private pools."""
        self.graphs.clear()
        if self.ctr.device.type == "cuda":
            torch.cuda.empty_cache()


def main(argv=None, *, draws: Callable[[int], dict] | None = None,
         on_round: Callable[[int], None] | None = None) -> dict:
    """The launcher; returns the run's outcome (``state``, ``final_loss``,
    ``round_ms``, ``comm_bytes``, ``wire_bytes``, ``wire_ratio``,
    ``n_captures``, the peak memory, ``personalized``, ``eval_batch``,
    ``bundle``, ``pack_spec``). ``draws(r)`` gives round r's ``{"s": (N,),
    "idx": (N, b)}`` (loop only); ``on_round(r)`` is called after each
    round, outside its timing."""
    args = _parser().parse_args(argv)
    _refusals(args)
    dev = resolve_device(args.device)
    if draws is not None and args.scan_rounds:
        raise SystemExit("draws= injects into the loop engine; drop --scan-rounds")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    bundle = build_model(cfg, train=True)
    n, s = args.clients, args.clusters

    comm = CommConfig(codec=args.codec, block=args.codec_block,
                      error_feedback=args.error_feedback)
    sparse = None
    if args.sparse_density < 1.0:
        try:
            sparse = SparseConfig(density=args.sparse_density, prune_rate=args.prune_rate,
                                  regrow=args.regrow, update_every=args.mask_update_every)
        except ValueError as e:
            raise SystemExit(str(e)) from None
    run_cfg = RunConfig(gossip_mode=args.gossip_mode, gossip_backend=args.gossip_backend,
                        param_plane=args.param_plane, comm=comm, eval_every=args.eval_every,
                        scan_rounds=args.scan_rounds, sparse=sparse, device=args.device)
    try:
        opts = run_cfg.resolve_options()
    except ValueError as e:
        raise SystemExit(str(e)) from None

    het = None
    if args.time_budget > 0 or args.p_unavailable > 0:
        try:
            het = ClientSystemModel(
                slow_fraction=args.slow_fraction, slow_factor=args.slow_factor,
                time_budget=args.time_budget, jitter=args.het_jitter,
                p_unavailable=args.p_unavailable,
                staleness_gamma=args.staleness_gamma, seed=args.seed)
        except ValueError as e:
            raise SystemExit(str(e)) from None

    fcfg = FedSPDConfig(n_clients=n, n_clusters=s, tau=args.tau, batch=args.batch,
                        lr0=args.lr, regime="stream")
    graph = make_graph(args.graph, n, args.avg_degree, seed=args.seed)
    gossip = GossipSpec.from_graph(graph, mode=opts["mode"])

    # the plane is packed as each model is drawn (core/fedspd.init_state)
    pack_spec = make_pack_spec(bundle.init(None)) if opts["param_plane"] else None
    state = init_state(make_generator(dev, args.seed), bundle.init, fcfg, data_m=1,
                       spec=pack_spec)

    if sparse is not None:
        state = state._replace(mask=init_masks(
            make_generator(dev, args.seed ^ _MASKS), n, pack_spec.size, sparse))

    wire_ratio = 1.0
    if comm.codec != "fp32":
        channel = make_channel(comm, pack_spec.size)
        wire_ratio = channel.wire_ratio(pack_spec.model_bytes)
        if channel.has_ef:
            state = state._replace(ef=channel.init_residual((n,), device=dev))
    if sparse is not None and sparse.enabled:
        x = pack_spec.size
        wire_ratio = (sparse_wire_model_bytes(comm, x, sparse.k_active(x))
                      / float(pack_spec.model_bytes))

    mix_fn = make_mix_fn(gossip, opts["gossip_backend"], comm=comm,
                         plane=pack_spec is not None)
    step = make_fedspd_train_step(bundle, gossip, fcfg, mix_fn=mix_fn,
                                  pack_spec=pack_spec, comm=comm, sparse=sparse)

    het_parts = het_carry = None
    if het is not None:
        if pack_spec is None:
            raise SystemExit("client heterogeneity requires the packed plane (drop --pytree)")
        if opts["mode"] != "dense":
            raise SystemExit("client heterogeneity needs --gossip-mode dense "
                             "(stale-gossip weights are real-valued)")
        axes = FedSPDState(centers=1, u=0, z=0, round=None, gen=None, comm_bytes=None,
                           ef=None if state.ef is None else 0,
                           mask=None if state.mask is None else 0)
        het_parts = (het, torch.as_tensor(het.resolve_speeds(n), device=dev), axes,
                     torch.as_tensor(graph.adj, dtype=torch.float32, device=dev))
        het_carry = het.init_carry(n, device=dev)

    pool = make_mixture_tokens(n_clients=n, n_clusters=s,
                               docs_per_client=max(32, 4 * args.batch), seq_len=args.seq,
                               vocab=min(cfg.vocab, 512), seed=args.seed)
    docs = torch.as_tensor(pool["tokens"], dtype=torch.int64, device=dev)   # (N, D, L)

    def sample(idx):
        """The clients' documents at ``idx`` ``(N, b)``: ``{"tokens": (N, b, L)}``."""
        return {"tokens": torch.gather(docs, 1, idx[:, :, None].expand(-1, -1, docs.shape[2]))}

    lr_tape = torch.tensor([round_lr(fcfg, r) for r in range(max(args.rounds, 1))],
                           dtype=torch.float32, device=dev)
    tapes = {"consensus": torch.zeros((max(args.rounds, 1), s), device=dev),
             "comm_bytes": torch.zeros((max(args.rounds, 1),), device=dev)}
    rnd = _Round(step, state, sample=sample, n=n, batch=args.batch, n_docs=docs.shape[1],
                 lr_tape=lr_tape, tapes=tapes, data_gen=make_generator(dev, args.seed ^ _DATA),
                 het=het_parts, het_carry=het_carry,
                 het_gen=None if het is None else make_generator(dev, args.seed ^ _HET))
    del state

    print(f"FedSPD: arch={cfg.name} N={n} S={s} graph={args.graph} "
          f"deg={graph.avg_degree:.1f} gossip={opts['mode']} "
          f"true-mix[0]={pool['mix_true'][0].round(2)}")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    round_ms = []
    with trace_session(args.profile_dir):
        for r in range(args.rounds):
            synchronize(dev)
            t = time.perf_counter()
            with step_annotation("repro/round", r):
                if args.scan_rounds:
                    rnd.replay(r, sparse is not None and sparse.update_due(r))
                else:
                    rnd.loop(r, None if draws is None else draws(r))
                synchronize(dev)
            round_ms.append((time.perf_counter() - t) * 1e3)
            if on_round is not None:
                on_round(r)
            if r % run_cfg.eval_every == 0 or r == args.rounds - 1:
                logical = float(tapes["comm_bytes"][r])
                print(f"round {r:4d}  lr={float(lr_tape[r]):.4f}  "
                      f"consensus={tapes['consensus'][r].cpu().numpy()}  "
                      f"comm={logical:.3e}B  wire={logical * wire_ratio:.3e}B  "
                      f"({time.time() - t0:.1f}s)")
    n_captures = len(rnd.graphs)
    rnd.release()
    state, het_carry = rnd.state._replace(round=args.rounds), rnd.bufs[1]
    if args.scan_rounds:
        print(f"replayed: {args.rounds} rounds from {n_captures} captured round "
              f"graph(s) ({time.time() - t0:.1f}s)")
    peak = {}
    if dev.type == "cuda":
        peak = {"max_memory_allocated": torch.cuda.max_memory_allocated(dev),
                "max_memory_reserved": torch.cuda.max_memory_reserved(dev)}
        print(f"max_memory_allocated {peak['max_memory_allocated'] / 2**30:.2f} GiB  "
              f"max_memory_reserved {peak['max_memory_reserved'] / 2**30:.2f} GiB")

    personalized = personalize(state, pack_spec)
    idx = torch.randint(0, docs.shape[1], (n, args.batch), generator=rnd.bufs[2],
                        device=dev)
    eval_batch = sample(idx)
    final_loss = fl_perplexity(bundle, personalized, eval_batch)
    print(f"final mean per-client loss (personalized Eq.2): {final_loss:.4f}")

    logical = [float(v) for v in tapes["comm_bytes"][:args.rounds].cpu()]
    last_logical = logical[-1] if logical else 0.0
    if args.telemetry_out:
        cons = tapes["consensus"][:args.rounds].cpu().numpy()
        events = [{
            "event": "run_meta", "method": "fedspd", "arch": cfg.name,
            "rounds": args.rounds, "n_clients": n, "n_clusters": s,
            "seed": args.seed, "codec": comm.codec,
            "streams": sorted(("lr", "consensus", "logical_bytes", "wire_bytes")),
        }]
        events += [{"event": "round", "round": r, "lr": float(lr_tape[r]),
                    "consensus": cons[r], "logical_bytes": logical[r],
                    "wire_bytes": logical[r] * wire_ratio}
                   for r in range(args.rounds)]
        summary = {"event": "summary", "final_loss": final_loss,
                   "comm_bytes": last_logical, "wire_bytes": last_logical * wire_ratio,
                   "wall_s": time.time() - t0}
        if het is not None:
            summary["staleness"] = het_carry.stale.cpu().numpy()
        events.append(summary)
        write_events(args.telemetry_out, events)
        print(f"telemetry -> {args.telemetry_out} ({args.rounds} round events)")
    print(f"mixture coefficients u:\n{state.u.cpu().numpy().round(3)}")
    if het is not None:
        print(f"final staleness (rounds since last exchange): "
              f"{het_carry.stale.cpu().numpy()}")
    if args.save:
        ckpt.save(args.save, {"personalized": personalized, "u": state.u},
                  manifest=ckpt.CkptManifest(
                      kind="checkpoint", arch=cfg.name, n_clients=n, n_clusters=s,
                      pack_digest=pack_spec.digest if pack_spec else None))
        print(f"saved -> {args.save}")
    if args.export_servable:
        from repro_torch.experiments.export import export_servable

        export_servable(state, pack_spec or make_pack_spec(bundle.init(None)),
                        args.export_servable, arch=cfg.name, codec=args.export_codec,
                        qblock=max(2, args.codec_block // 2 * 2))
        print(f"servable plane -> {args.export_servable} ({args.export_codec})")
    return {"state": state, "final_loss": final_loss, "round_ms": round_ms,
            "comm_bytes": last_logical, "wire_bytes": last_logical * wire_ratio,
            "wire_ratio": wire_ratio, "n_captures": n_captures, **peak,
            "personalized": personalized, "eval_batch": eval_batch, "bundle": bundle,
            "pack_spec": pack_spec}


if __name__ == "__main__":
    main()
