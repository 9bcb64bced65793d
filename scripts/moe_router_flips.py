#!/usr/bin/env python3
"""How close to a tie the expert choices are that the card's and the CPU's
bf16 runs of deepseek-moe-16b's parity cut make differently, over several
weight draws, and how planted router faults on the card read to the check
that bounds them (``chip_smoke.py``'s parity_moe, ``ROUTER_NEAR_TIE`` and
``ROUTER_MAX_FLIPS``).

    python3 scripts/moe_router_flips.py                 # on one CUDA device
    python3 scripts/moe_router_flips.py --seeds 0,1 --no-faults

For each weight seed the model is drawn at full size on the card
(``init_params(cfg, seed)``; seed 0 is the draw ``chip_smoke.py`` serves)
and cut as parity_moe cuts it (the dense layer and the first MoE layer);
the phase's calls (prefill of 2 x 64 tokens + 4 decode steps,
``chip_smoke.parity_logits``) then run:

- bf16 on the card, recording its expert choices, and on the CPU following
  them (``chip_smoke.routing``), as parity_moe does: the tokens the CPU would
  have routed otherwise (flips), their gaps in router probability, the
  logits held as the phase holds them, and the phase's verdict;
- bf16 on the CPU routing on its own, as the check stood before the CPU
  followed the card: the logits' share within 3e-2, and each (call, row)
  whose share is below 0.999;
- fp32 on both, each routing on its own: the tokens routed to other experts,
  the largest logit error and the phase's fp32 verdict;
- the quantiles, over every token the CPU routed, of the probability gap
  between its k-th and (k+1)-th expert: what a fault that swaps the two
  gives up.

Each planted fault runs on the card only, the CPU following its choices:
``router_bf16`` computes the router's logits from bf16 operands,
``swap_all`` sends every token to its (k+1)-th expert instead of its k-th,
``swap_1_in_20`` does so for every 20th token; ``router_bf16`` also runs in
fp32 (``router_bf16_fp32``), against the CPU routing on its own, as the
phase's fp32 check runs.  One JSON line a seed; the
last two lines are the card's name and power limit and the device record.
"""

from __future__ import annotations

import argparse
from contextlib import contextmanager
import json
from pathlib import Path
import sys

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke
from repro_torch.configs import get_arch
from repro_torch.models import init_params
from repro_torch.models import moe
import torch

ARCH = "deepseek-moe-16b"
REAL_ROUTE = moe._route


def _top(probs, top_k, swap):
    """Each token's top-k of ``probs`` (T, E), its k-th expert swapped for its
    (k+1)-th where ``swap`` (T,) holds; weights renormalised over the k."""
    idx = torch.topk(probs, top_k + 1, dim=-1).indices
    idx = torch.cat([idx[:, :top_k - 1],
                     torch.where(swap[:, None], idx[:, top_k:], idx[:, top_k - 1:top_k])], -1)
    w = probs.gather(-1, idx)
    return w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9), idx


def router_bf16(xt, w_gate, top_k):
    probs = torch.softmax(torch.matmul(xt.bfloat16(), w_gate.bfloat16()).float(), dim=-1)
    return _top(probs, top_k, torch.zeros(xt.shape[0], dtype=torch.bool, device=xt.device))


def swap_every(n):
    def route(xt, w_gate, top_k):
        probs = torch.softmax(torch.matmul(xt.float(), w_gate.float()), dim=-1)
        return _top(probs, top_k, torch.arange(xt.shape[0], device=xt.device) % n == 0)
    return route


FAULTS = {"router_bf16": router_bf16, "swap_all": swap_every(1),
          "swap_1_in_20": swap_every(20)}


@contextmanager
def router(route):
    """``moe._route`` replaced by ``route`` (``routing`` wraps whatever it finds)."""
    real = moe._route
    moe._route = route
    try:
        yield
    finally:
        moe._route = real


def tie_gaps(gaps):
    """A router that records each token's k-th minus (k+1)-th probability."""
    def route(xt, w_gate, top_k):
        probs = torch.softmax(torch.matmul(xt.float(), w_gate.float()), dim=-1)
        top = torch.topk(probs, top_k + 1, dim=-1).values
        gaps.append((top[:, top_k - 1] - top[:, top_k]).cpu())
        return REAL_ROUTE(xt, w_gate, top_k)
    return route


def followed(cfg, params, fault=None):
    """bf16 card run (with ``fault`` as its router) recorded, CPU run
    following it: the phase's verdict on the flips and the logits."""
    routes = {}
    with router(fault or REAL_ROUTE):
        card = chip_smoke.parity_logits(ARCH, cfg, params, "cuda", torch.bfloat16,
                                        routes=routes)
    cpu = chip_smoke.parity_logits(ARCH, cfg, params, "cpu", torch.bfloat16, routes=routes)
    flips = chip_smoke.router_flips(routes)
    logits = chip_smoke.held_logits(card, cpu)
    gaps = sorted(routes["flips"], reverse=True)
    flips["smallest_gap"] = gaps[-1] if gaps else None
    flips["gaps"] = gaps if len(gaps) <= 20 else gaps[:10] + ["..."] + gaps[-10:]
    flips["logits"] = logits
    flips["phase_passes"] = bool(flips["near_ties"] and logits["share_within_tol"] >= 0.999
                                 and logits["rms_err"] <= chip_smoke.LOGIT_TOL / 2
                                 and logits["clear_margin_tokens_equal"])
    return card, flips


def own_routes(cfg, params, dev, dtype, fault=None):
    routes = {}
    with router(fault or REAL_ROUTE):
        got = chip_smoke.parity_logits(ARCH, cfg, params, dev, dtype, routes=routes)
    return got, [c.sort(-1).values for c in routes["calls"]]


def apart_fp32(card, a, cpu, b):
    """fp32 runs that routed on their own: the tokens routed to other
    experts, the largest logit error and the phase's fp32 verdict."""
    err = (card - cpu).abs()
    tol = chip_smoke.LOGIT_TOL
    return dict(tokens_routed_otherwise=int(sum(int((x != y).any(-1).sum())
                                                for x, y in zip(a, b))),
                max_abs_err=float(err.max()),
                phase_passes=bool((err <= tol + tol * cpu.abs()).all()))


def seed_record(cfg, seed, faults):
    params = init_params(cfg, seed=seed, device="cuda")
    rec = {"seed": seed}
    card, rec["bf16_cpu_follows_card"] = followed(cfg, params)
    gaps = []
    with router(tie_gaps(gaps)):
        cpu = chip_smoke.parity_logits(ARCH, cfg, params, "cpu", torch.bfloat16)
    err = (card - cpu).abs()
    within = (err <= chip_smoke.LOGIT_TOL + chip_smoke.LOGIT_TOL * cpu.abs()).float()
    rows = within.mean(-1)
    rec["bf16_cpu_routes_itself"] = dict(
        share_within_tol=float(within.mean()),
        rows_below_0999=[[i, j, float(rows[i, j])] for i, j in (rows < 0.999).nonzero().tolist()])
    gaps = torch.cat(gaps)
    rec["k_vs_k1_gap_quantiles"] = {str(q): float(torch.quantile(gaps, q))
                                    for q in (0.0, 0.01, 0.05, 0.1, 0.25, 0.5)}
    cpu32, b = own_routes(cfg, params, "cpu", torch.float32)
    rec["fp32_each_routes_itself"] = apart_fp32(
        *own_routes(cfg, params, "cuda", torch.float32), cpu32, b)
    for name in faults:
        _, rec[name] = followed(cfg, params, FAULTS[name])
    if faults:
        card32, a = own_routes(cfg, params, "cuda", torch.float32, router_bf16)
        rec["router_bf16_fp32"] = apart_fp32(card32, a, cpu32, b)
    del params
    torch.cuda.empty_cache()
    return rec


def summary(recs, faults):
    """Over the seeds: the honest flips' largest count and gap, the seeds
    where the check without replay fails, fp32's flips, and for each fault
    the seeds where the phase fails and its smallest count and largest gap."""
    honest = [r["bf16_cpu_follows_card"] for r in recs]
    out = {"seeds": len(recs),
           "honest_bf16_flips_most": max(h["tokens_routed_otherwise_on_cpu"] for h in honest),
           "honest_bf16_gap_largest": max(h["largest_gap"] for h in honest),
           "honest_bf16_phase_fails": sum(not h["phase_passes"] for h in honest),
           "no_replay_check_fails_on_seeds": [
               r["seed"] for r in recs if r["bf16_cpu_routes_itself"]["share_within_tol"] < 0.999],
           "fp32_flips": sum(r["fp32_each_routes_itself"]["tokens_routed_otherwise"]
                             for r in recs),
           "fp32_phase_fails": sum(not r["fp32_each_routes_itself"]["phase_passes"]
                                   for r in recs)}
    for name in faults:
        out[name] = dict(phase_fails=sum(not r[name]["phase_passes"] for r in recs),
                         flips_fewest=min(r[name]["tokens_routed_otherwise_on_cpu"]
                                          for r in recs),
                         largest_gap_smallest=min(r[name]["largest_gap"] for r in recs))
    if faults:
        out["router_bf16_fp32"] = dict(
            phase_fails=sum(not r["router_bf16_fp32"]["phase_passes"] for r in recs),
            flips_fewest=min(r["router_bf16_fp32"]["tokens_routed_otherwise"] for r in recs))
    return {"summary": out}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="0,1,2,3,4,5,6,7",
                    help="comma-separated weight seeds (0 is chip_smoke.py's draw)")
    ap.add_argument("--no-faults", action="store_true", help="skip the planted faults")
    args = ap.parse_args()
    smi = chip_smoke.phase_device()
    cfg = get_arch(ARCH)
    faults = () if args.no_faults else tuple(FAULTS)
    print(json.dumps({"limits": {"ROUTER_NEAR_TIE": chip_smoke.ROUTER_NEAR_TIE,
                                 "ROUTER_MAX_FLIPS": chip_smoke.ROUTER_MAX_FLIPS}}),
          flush=True)
    recs = []
    for seed in (int(s) for s in args.seeds.split(",")):
        recs.append(seed_record(cfg, seed, faults))
        print(json.dumps(recs[-1]), flush=True)
    print(json.dumps(summary(recs, faults)), flush=True)
    print(smi, flush=True)
    print(json.dumps({"device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
