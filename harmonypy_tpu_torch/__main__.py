"""Command-line interface: Harmony correction and LISI evaluation on files
(JAX package __main__.py).

Usage:
  python -m harmonypy_tpu_torch correct --pcs pcs.tsv.gz --meta meta.tsv.gz \
      --vars donor [--out corrected.npy] [--theta 2.0] [--sigma 0.1] ...
  python -m harmonypy_tpu_torch lisi --x corrected.npy --meta meta.tsv.gz \
      --labels donor,cell_type [--out lisi.tsv]

--device takes a torch device string ("cuda", "cuda:1", "cpu"); both
subcommands run on default_mesh(--device) (JAX package __main__.py:111-118):
without it, or with "cuda", every visible card, failing when there is none.
"""

from __future__ import annotations

import argparse
import sys
import time

# The JAX package's multi-process flags (ROADMAP.md §1 item 11b).
_MULTI = ("coordinator", "num_processes", "process_id")


def _add_correct(sub):
    p = sub.add_parser("correct", help="run Harmony batch correction")
    p.add_argument("--pcs", required=True,
                   help="embedding matrix (.tsv[.gz]/.csv/.npy/.npz/.parquet),"
                        " cells x PCs")
    p.add_argument("--meta", required=True, help="metadata table (.tsv[.gz])")
    p.add_argument("--vars", required=True,
                   help="comma-separated batch variable column names")
    p.add_argument("--out", default="harmony_corrected.npy")
    p.add_argument("--theta", type=float, default=None)
    p.add_argument("--lamb", type=float, default=None)
    p.add_argument("--sigma", type=float, default=0.1)
    p.add_argument("--nclust", type=int, default=None)
    p.add_argument("--tau", type=float, default=0)
    p.add_argument("--block-size", type=float, default=0.05)
    p.add_argument("--max-iter-harmony", type=int, default=10)
    p.add_argument("--max-iter-kmeans", type=int, default=20)
    p.add_argument("--random-state", type=int, default=0)
    p.add_argument("--checkpoint-dir", default=None,
                   help="write harmony_iter_{i}.npz after every iteration")
    p.add_argument("--device", default=None,
                   help="torch device (cuda, cuda:N, cpu); default every "
                        "visible CUDA card")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--coordinator", default=None,
                   help="multi-process runs: not ported (ROADMAP.md §1 "
                        "item 11b)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)


def _add_lisi(sub):
    p = sub.add_parser("lisi", help="compute LISI mixing metric")
    p.add_argument("--x", required=True, help="embedding (cells x dims)")
    p.add_argument("--meta", required=True)
    p.add_argument("--labels", required=True,
                   help="comma-separated label column names")
    p.add_argument("--perplexity", type=float, default=30)
    p.add_argument("--sample", type=int, default=None,
                   help="evaluate LISI at this many sampled query cells "
                        "(exact values; neighbors come from all cells)")
    p.add_argument("--knn", choices=["exact", "brute", "pruned", "approx"],
                   default="exact",
                   help="neighbor search: exact (reference semantics; "
                        "auto-picks brute force or the cluster-pruned "
                        "search above 100k cells), brute / pruned to force "
                        "one, or approx (answered exactly in this package)")
    p.add_argument("--knn-recall", type=float, default=0.95,
                   help="recall target for --knn approx (0 < r <= 1)")
    p.add_argument("--device", default=None,
                   help="torch device (cuda, cuda:N, cpu); default every "
                        "visible CUDA card")
    p.add_argument("--out", default=None, help="output TSV (default: stdout)")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="harmonypy_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    _add_correct(sub)
    _add_lisi(sub)
    sub.add_parser("bench", help="not ported (ROADMAP.md §1 item 10)"
                   ).add_argument("tiers", nargs="*")
    args = parser.parse_args(argv)

    if args.cmd == "bench":
        sys.exit("harmonypy_tpu_torch: the bench subcommand is not ported "
                 "yet (ROADMAP.md §1 item 10, utils/profiling.py and bench); "
                 "on a CUDA card, python3 chip_smoke.py measures the port")

    import numpy as np
    import pandas as pd

    from .io import load_matrix
    from .parallel.mesh import default_mesh

    if args.cmd == "lisi":
        from .lisi import compute_lisi
        X = load_matrix(args.x)
        meta = pd.read_csv(args.meta, sep="\t")
        labels = args.labels.split(",")
        t0 = time.time()
        out = compute_lisi(X, meta, labels, perplexity=args.perplexity,
                           sample=args.sample, knn=args.knn,
                           knn_recall_target=args.knn_recall,
                           mesh=default_mesh(args.device))
        if isinstance(out, tuple):
            lisi, qidx = out
            df = pd.DataFrame(lisi, columns=labels)
            df.insert(0, "cell_index", qidx)
        else:
            df = pd.DataFrame(out, columns=labels)
        if args.out:
            df.to_csv(args.out, sep="\t", index=False)
            print(f"wrote {args.out} ({time.time() - t0:.2f}s)")
        else:
            df.to_csv(sys.stdout, sep="\t", index=False)
        return

    # correct
    given = [f for f in _MULTI if getattr(args, f) is not None]
    if given:
        sys.exit(f"harmonypy_tpu_torch: --{given[0].replace('_', '-')}: "
                 f"multi-process runs are not ported yet (ROADMAP.md §1 "
                 f"item 11b); one process drives every visible card")
    from .api import run_harmony

    meta = pd.read_csv(args.meta, sep="\t")
    X = load_matrix(args.pcs)
    t0 = time.time()
    ho = run_harmony(
        X, meta, args.vars.split(","),
        theta=args.theta, lamb=args.lamb, sigma=args.sigma,
        nclust=args.nclust, tau=args.tau, block_size=args.block_size,
        max_iter_harmony=args.max_iter_harmony,
        max_iter_kmeans=args.max_iter_kmeans,
        random_state=args.random_state,
        checkpoint_dir=args.checkpoint_dir,
        mesh=default_mesh(args.device),
        verbose=not args.quiet,
    )
    Z = ho.Z_corr
    out = args.out
    if out.endswith(".npy"):
        np.save(out, Z)
    else:
        pd.DataFrame(Z).to_csv(out, sep="\t", index=False)
    print(f"wrote {out}: {Z.shape[0]} cells x {Z.shape[1]} PCs in "
          f"{time.time() - t0:.2f}s ({len(ho.objective_harmony) - 1} harmony "
          f"iterations)")


if __name__ == "__main__":
    main()
