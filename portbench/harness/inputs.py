"""Inputs made from the seed: a clustered PCA embedding with additive batch
offsets (the construction of the repository's synthetic Harmony
workloads), drawn on the device in a few large calls and copied to the
host, where an analyst's embedding and metadata live.

cells = centers[group] * center_scale + shifts[batch] * shift_scale
        + noise * noise_scale,
centers and shifts standard normal, group and batch uniform, noise
standard normal. Every seed gives the same sizes; only the values move.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pandas as pd
import torch


@dataclasses.dataclass
class InputSet:
    X: np.ndarray          # (N, d) float32, cells by PCs
    meta: pd.DataFrame     # one categorical column per label
    codes: dict            # label -> (N,) int64 codes
    n_cats: dict           # label -> number of categories
    random_state: int      # the fit's seed


def derive(seed: int, *salt: int) -> int:
    """A 63-bit seed of (seed, *salt): any whole seed, negative or beyond
    64 bits, maps to one stream."""
    ss = np.random.SeedSequence([abs(int(seed)), int(seed < 0), *salt])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def make(data: dict, seed: int, index: int, device,
         shift_scale: float | None = None) -> InputSet:
    """Input set `index` of seed `seed` for the configuration's `data`
    block; shift_scale overrides the batch offsets' scale."""
    N, d = int(data["n_cells"]), int(data["n_pcs"])
    B, G = int(data["n_batches"]), int(data["n_groups"])
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, index, 0))
    kw = dict(generator=gen, device=device)
    scale = data["batch_shift_scale"] if shift_scale is None else shift_scale
    centers = torch.randn((G, d), **kw) * float(data["center_scale"])
    shifts = torch.randn((B, d), **kw) * float(scale)
    groups = torch.randint(0, G, (N,), **kw)
    batches = torch.randint(0, B, (N,), **kw)
    X = torch.randn((N, d), **kw).mul_(float(data["noise_scale"]))
    X.add_(centers[groups]).add_(shifts[batches])
    codes = {"batch": batches.cpu().numpy(), "group": groups.cpu().numpy()}
    n_cats = {"batch": B, "group": G}
    meta = pd.DataFrame({
        k: pd.Categorical.from_codes(v, categories=[f"{k}{i}" for i in
                                                    range(n_cats[k])])
        for k, v in codes.items()})
    return InputSet(X=X.cpu().numpy(), meta=meta, codes=codes,
                    n_cats=n_cats, random_state=derive(seed, index, 1) % 2**31)
