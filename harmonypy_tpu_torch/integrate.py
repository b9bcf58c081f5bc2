"""scanpy-style integration helper (JAX package integrate.py).

scanpy consumes the reference through
`sc.external.pp.harmony_integrate(adata, key)`, which calls run_harmony on
`adata.obsm[basis]` and `adata.obs`. The same entry point here:

    from harmonypy_tpu_torch.integrate import harmony_integrate
    harmony_integrate(adata, "donor")
    adata.obsm["X_pca_harmony"]   # corrected embedding

Works with any AnnData-like object exposing `.obsm` (a mapping of arrays)
and `.obs` (a DataFrame); anndata itself is not required.
"""

from __future__ import annotations

from .api import run_harmony


def harmony_integrate(adata, key, *, basis: str = "X_pca",
                      adjusted_basis: str = "X_pca_harmony", **kwargs):
    """Run Harmony on `adata.obsm[basis]` against the `key` column(s) of
    `adata.obs`, storing the corrected embedding in
    `adata.obsm[adjusted_basis]`. Returns the fitted Harmony object.
    kwargs go to run_harmony (mesh= and device= as there: by default every
    visible CUDA card)."""
    vars_use = [key] if isinstance(key, str) else list(key)
    ho = run_harmony(adata.obsm[basis], adata.obs, vars_use, **kwargs)
    adata.obsm[adjusted_basis] = ho.Z_corr
    return ho
