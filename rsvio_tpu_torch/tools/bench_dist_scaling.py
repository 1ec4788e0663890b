"""Distributed BA scaling: a weak-scaling table of the landmark-sharded
window solve and its all-reduce payload per LM iteration.

Port of tools/bench_dist_scaling.py over rsvio_tpu_torch.parallel:

1. Weak scaling: the landmark shard per rank held fixed while the mesh
   grows 1 -> 2 -> 4 ranks (parallel.dryrun.run_ranks, spawned
   processes), median ms per solve and per LM iteration, and the
   efficiency against the 1-rank run. NCCL at one rank per card where the
   host has a card for every rank; otherwise gloo, with the ranks sharing
   one card (each collective staged through the host) or on the CPU —
   then the table is not multi-card scaling, and says so. Over NCCL the
   solve is timed compiled, as JAX's tool times its jitted solve: a CUDA
   graph with the collectives captured (utils.graphs.compile_function);
   gloo's collectives cannot be captured, so there the eager solve is
   timed. Each row's ``route`` says which ("graph" or "eager").
2. The all-reduce payload of one LM iteration, from the mesh's own counts
   (``Mesh.counts``: a full-budget solve less one of half the budget),
   at two landmark counts: O(W^2 * 36) bytes, independent of L.

Usage:
  python -m rsvio_tpu_torch.tools.bench_dist_scaling [--devices cuda|cpu]
      [--per-device 512] [--repeats 5] [--iters 10]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

RANKS = (1, 2, 4)


def predicted_bytes(W: int, itemsize: int = 4) -> int:
    """The reduced (Schur) system's all-reduce: W*6 x W*6 matrix, W*6
    vector and the cost."""
    return (W * W * 36 + W * 6 + 1) * itemsize


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _solver(mesh, cfg):
    """The sharded solve of `cfg` as a function of the window problem:
    compiled (a CUDA graph, the mesh's counts carried over replays) where
    the mesh's collectives can be captured, else eager."""
    from ..parallel import dist_ba
    from ..utils.graphs import compile_function

    def solve(*prob):
        return dist_ba.solve_ba_distributed(mesh, *prob, cfg)
    if not mesh.capturable:
        return solve
    mesh.warm_up()
    return compile_function(solve, mesh.device, (mesh.counts,))


def _solve_counts(mesh, solve, prob):
    """(result, all-reduce calls, bytes) of one call of solve(*prob)."""
    c0 = dict(mesh.counts)
    res = solve(*prob)
    _sync(mesh.device)
    return (res, mesh.counts["all_reduce_calls"] - c0["all_reduce_calls"],
            mesh.counts["all_reduce_bytes"] - c0["all_reduce_bytes"])


def scaling_rank(mesh, per_device, W, iters, repeats, comm_landmarks):
    """One rank: the timed solve at L = per_device x ranks, then the
    per-iteration all-reduce calls and bytes at each of comm_landmarks."""
    from ..models import ba
    from ..parallel import dryrun

    dev = mesh.device
    cfg = ba.BAConfig(max_iterations=iters, cost_tol=0.0, param_tol=0.0)
    half = ba.BAConfig(max_iterations=iters // 2, cost_tol=0.0,
                       param_tol=0.0)
    L = per_device * mesh.size
    prob = dryrun.window_problem(W, L, seed=100 + mesh.size, device=dev)
    solve, solve_half = _solver(mesh, cfg), _solver(mesh, half)
    res, _, _ = _solve_counts(mesh, solve, prob)      # warm-up (capture)
    if not bool(res.success):
        raise RuntimeError(f"ranks={mesh.size} L={L}: the solve failed")
    its = int(res.iterations)
    times = []
    for _ in range(repeats):
        _sync(dev)
        t0 = time.perf_counter()
        _solve_counts(mesh, solve, prob)
        times.append(time.perf_counter() - t0)
    comm = []
    for Lc in comm_landmarks:
        p = dryrun.window_problem(W, Lc, seed=7, device=dev)
        _, calls, nbytes = _solve_counts(mesh, solve, p)
        _, calls_h, nbytes_h = _solve_counts(mesh, solve_half, p)
        n = iters - iters // 2
        comm.append([Lc, (calls - calls_h) / n, (nbytes - nbytes_h) / n])
    return {"solve_s": statistics.median(times), "iterations": its,
            "route": "graph" if mesh.capturable else "eager",
            "comm": np.array(comm)}


def choose_backend(devices: str, max_ranks: int):
    """(backend, devices, note): NCCL at one rank per card when the host
    has a card for every rank, else gloo (ranks sharing card 0, or the
    CPU)."""
    if devices == "cpu":
        return "gloo", "cpu", "gloo on the CPU: the ranks share host cores"
    cards = torch.cuda.device_count()
    if cards >= max_ranks:
        return "nccl", "cuda", f"nccl, one rank per card ({cards} cards)"
    return "gloo", "cuda", (
        f"gloo, the ranks share {cards} card(s) and each collective "
        f"stages through the host: not multi-card scaling")


def main(argv=None):
    from ..cli.run import resolve_device
    from ..parallel.dryrun import run_ranks
    # The ranks import scaling_rank by its package path, also when this
    # file runs as __main__.
    from . import bench_dist_scaling as this

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", default="cuda", help="cuda | cpu")
    ap.add_argument("--per-device", type=int, default=512,
                    help="landmarks per rank (weak scaling)")
    ap.add_argument("--window", type=int, default=10)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--json", default="dist_scaling_torch.json")
    args = ap.parse_args(argv)

    resolve_device(args.devices)
    backend, devices, note = choose_backend(args.devices, max(RANKS))
    print(f"backend: {note}", file=sys.stderr)
    W = args.window
    rows, comm = [], []
    t_ref = None
    comm_L = [args.per_device * max(RANKS) * k for k in (1, 2)]
    for nd in RANKS:
        L = args.per_device * nd
        out = run_ranks(this.scaling_rank, nd, args.per_device, W,
                        args.iters, args.repeats,
                        comm_L if nd == max(RANKS) else [],
                        backend=backend, devices=devices, timeout=600.0,
                        threads=2 if devices == "cpu" else None)
        t_med = max(float(r["solve_s"]) for r in out)   # the slowest rank
        its = int(out[0]["iterations"])
        t_ref = t_med if t_ref is None else t_ref
        rows.append(dict(devices=nd, backend=backend,
                         route=str(out[0]["route"]), landmarks=L,
                         per_device=args.per_device, iterations=its,
                         solve_ms=round(t_med * 1e3, 2),
                         ms_per_iter=round(t_med * 1e3 / max(its, 1), 3),
                         weak_efficiency=round(t_ref / t_med, 3)))
        print(f"ranks={nd} L={L} iters={its} solve={t_med * 1e3:.1f} ms "
              f"({rows[-1]['route']})  weak-eff={t_ref / t_med:.2f}",
              file=sys.stderr)
        for Lc, calls, nbytes in out[0]["comm"].reshape(-1, 3):
            comm.append(dict(devices=nd, landmarks=int(Lc),
                             allreduce_bytes=int(nbytes),
                             n_allreduce=calls,
                             predicted_schur_psum_bytes=predicted_bytes(W)))
            print(f"L={int(Lc)}: {calls:g} all-reduces, {int(nbytes)} bytes "
                  f"an LM iteration (claim: reduced-system psum "
                  f"{predicted_bytes(W)} B, L-independent)", file=sys.stderr)

    note += ("; the solve timed as a CUDA graph" if backend == "nccl"
             else "; the solve timed eager (gloo cannot be captured)")
    print(f"\n{note}")
    print("\n| ranks | landmarks | solve ms | ms/iter | weak eff | route |")
    print("|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['devices']} | {r['landmarks']} | {r['solve_ms']} | "
              f"{r['ms_per_iter']} | {r['weak_efficiency']} | "
              f"{r['route']} |")
    print("\n| landmarks | all-reduces an LM iteration | bytes an LM "
          "iteration |")
    print("|---|---|---|")
    for c in comm:
        print(f"| {c['landmarks']} | {c['n_allreduce']:g} | "
              f"{c['allreduce_bytes']} |")

    out = dict(window=W, per_device=args.per_device, repeats=args.repeats,
               lm_iterations=args.iters, weak_scaling=rows,
               communication=comm, note=note)
    with open(args.json, "w") as f:
        json.dump(out, f, indent=1)
    print(f"\nwrote {args.json}", file=sys.stderr)
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
