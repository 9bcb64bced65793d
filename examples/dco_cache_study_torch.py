"""Paper-technique deep dive: sweep every DCO policy across cache sizes
and dataflows, fit the analytical model, and project a long-context case
— a miniature of the paper's full evaluation pipeline.  The PyTorch port's
copy of ``dco_cache_study.py``: the same sweep through ``repro_torch.core``
(numpy, host-side), whose printed output is identical to the JAX package's.

Run:  PYTHONPATH=src python examples/dco_cache_study_torch.py
"""

import numpy as np

from repro_torch.core import (SimConfig, build_fa2_trace, fa2_counts, fit_params,
                        get_workload, kendall_tau, named_policy, predict,
                        r_squared, run_policy)

MB = 2**20

print("=== policy × capacity sweep (Gemma temporal / Qwen spatial) ===")
pts = []
for model in ("gemma3-27b", "qwen3-8b"):
    wl = get_workload(model, seq_len=2048)
    gqa = wl.group_alloc == "spatial"
    trace = build_fa2_trace(wl)
    counts = fa2_counts(wl)
    for mb in (1, 2, 4):
        cfg = SimConfig(llc_bytes=mb * MB)
        row = f"{model:12s} {mb}MB: "
        base = None
        for pol in ("lru", "at", "all"):
            res = run_policy(trace, named_policy(pol, gqa=gqa), cfg,
                             record_history=False)
            if base is None:
                base = res.cycles
            row += f"{pol}={base / res.cycles:.2f}x "
            mpol = {"lru": "lru", "at": "at+dbp", "all": "all"}[pol]
            pts.append((counts, mb * MB, mpol, "optimal", gqa,
                        counts.n_rounds, res.cycles))
        print(row)

print("=== analytical model fit (paper Fig. 9 methodology) ===")
params = fit_params(pts)
pred = np.array([predict(c, l, p, params=params, bypass_variant=v, gqa=g,
                         n_rounds=r).cycles for c, l, p, v, g, r, _ in pts])
tgt = np.array([x[-1] for x in pts])
print(f"  R^2 = {r_squared(pred, tgt):.3f}   "
      f"Kendall tau = {kendall_tau(pred, tgt):.3f}   (n={len(pts)})")

print("=== long-context projection (paper Fig. 10 methodology) ===")
wl = get_workload("gemma3-27b", seq_len=131072)
counts = fa2_counts(wl)
for mb in (16, 32, 64):
    lru = predict(counts, mb * MB, "lru", params=params,
                  n_rounds=counts.n_rounds).cycles
    allp = predict(counts, mb * MB, "all", params=params,
                   n_rounds=counts.n_rounds)
    print(f"  gemma3 128K, {mb}MB LLC: DCO(all) = {lru / allp.cycles:.2f}x "
          f"over LRU (kept fraction {allp.kept_fraction:.2f})")
