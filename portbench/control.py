#!/usr/bin/env python3
"""Readings that set a cell's correctness limits (not part of a run).

    python3 portbench/control.py --workload NAME --seeds 1,2,3 \
        [--controls fp8,fp32] [--program 1] [--faults intercept]

For each seed, in one process: the input set a run with that seed would
check, the program's answer on it through the timed entry (--program 1),
each control: the plain reference put in the program's place in another
precision (fit: "fp8" one step below the stated bf16 products, "fp32"
one above; LISI: "float32" one step below float64), and each fault
planted in the program (fit: "intercept", the ridge's intercept row
solved and applied, not zeroed). Every answer is compared with the
reference in the stated precision exactly as a run compares it. Prints
one JSON line per seed and answer.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(1, ROOT)


def keep_intercept(setattr_):
    """Plant the fault "intercept": every ridge solve of the program keeps
    its intercept row W[:, 0] (solved, then applied with the batch rows)
    where Harmony zeroes it. setattr_(obj, name, value) installs it."""
    import torch
    import harmonypy_tpu_torch.engine as engine
    import harmonypy_tpu_torch.ops.ridge as ridge

    def solve(S, E, params, cfg):
        K, B1, d = cfg.K, cfg.B1, cfg.d
        cov = S[: B1 * B1].reshape(B1, B1, K).permute(2, 0, 1)
        rhs = S[B1 * B1:].reshape(B1, d, K).permute(2, 0, 1)
        cov = cov + torch.diag_embed(params.lamb[None, :].expand(K, B1))
        return torch.cholesky_solve(rhs, torch.linalg.cholesky(cov))
    setattr_(engine, "solve_w", solve)
    setattr_(ridge, "solve_w", solve)


FAULTS = {"intercept": keep_intercept}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", default="")
    ap.add_argument("--program", type=int, default=1)
    ap.add_argument("--faults", default="")
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--root", default=ROOT)
    a = ap.parse_args(argv)
    import torch
    from harness import entries
    from harness.manifest import Bench
    bench = Bench(a.root)
    cell = bench.cell(a.workload)
    config, traffic = bench.config(cell), bench.traffic(cell)
    limits = bench.limits(cell)
    controls = [c for c in a.controls.split(",") if c]
    faults = [f for f in a.faults.split(",") if f]
    for seed in [int(s) for s in a.seeds.split(",")]:
        e = entries.ENTRIES[traffic["entry"]](config, traffic, seed, a.device)
        sets = e.make_inputs()
        e.kept = {i: None for i in range(len(sets))}
        inp = sets[e.sampled_set()]
        answers = []
        if a.program:
            t = time.perf_counter()
            out, counters = e.call(inp)
            answers.append(("program", out, time.perf_counter() - t,
                            counters))
        for f in faults:
            undo = []
            FAULTS[f](lambda o, n, v: (undo.append((o, n, getattr(o, n))),
                                       setattr(o, n, v)))
            try:
                t = time.perf_counter()
                out, counters = e.call(inp)
                answers.append((f, out, time.perf_counter() - t, counters))
            finally:
                for o, n, v in reversed(undo):
                    setattr(o, n, v)
        for c in controls:
            t = time.perf_counter()
            if traffic["entry"] == "run_harmony":
                out = e.reference(inp, c)[0].cpu().numpy()
            else:
                q = e.queries(inp.X.shape[0])
                full = torch.zeros((inp.X.shape[0], 2), dtype=torch.float64)
                full[q] = torch.as_tensor(e.reference(inp, q, c))
                out = full.numpy()
            answers.append((c, out, time.perf_counter() - t, {}))
        for name, out, secs, counters in answers:
            t = time.perf_counter()
            got = {n: v for n, v, _ in e.compare(inp, out, limits)}
            print(json.dumps({"workload": a.workload, "seed": seed,
                              "answer": name, "readings": got,
                              "answer_s": secs,
                              "compare_s": time.perf_counter() - t,
                              **counters}), flush=True)
            del out
        del answers, sets
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
