"""k-means loop: rounds per call, sum(Harmony.kmeans_rounds), the
program's own count; under fixed-work traffic it is the same for every
call (max_iter_harmony x max_iter_kmeans)."""


def read(run):
    got = [c["counters"]["kmeans_rounds"] for c in run.calls
           if c["ok"] and "kmeans_rounds" in c["counters"]]
    return sum(got) / len(got) if got else None
