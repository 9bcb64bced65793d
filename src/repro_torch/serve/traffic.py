"""Seeded synthetic request-arrival generator for serving replay.

Produces the request population of DESIGN.md §11: Poisson or bursty
arrivals (rounds are the time unit — one lockstep simulator round per
serve-engine step), mixed prefill/decode lengths drawn from small
categorical mixes, and a prefix-sharing subpopulation (groups of
requests that read one shared prompt-prefix KV region, the paper's
inter-request reuse carrier).

Generation is cohort-buffered: requests are drawn ``cohort`` at a time
with vectorized numpy calls from one ``default_rng(seed)``, so a
million-request stream costs a few thousand RNG calls and O(cohort)
memory.  Prefix groups never span a cohort, so by the time a request is
yielded its whole group is known — the replay driver can declare the
shared-prefix tensor with its *exact* total read count
(:meth:`RequestStream.prefix_info`), which is what lets every tile
self-retire in the TMU (see ``repro_torch.dataflows.stream``).

Re-iterating a :class:`RequestStream` re-seeds the generator, so two
passes over the same stream (e.g. the monolithic and streamed halves of
the bit-identity property) see identical requests.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict
from typing import Iterator
from typing import Tuple

import numpy as np


@dataclass(frozen=True)
class TrafficConfig:
    """Arrival process + request-shape mix (all rounds/pages units)."""

    n_requests: int
    seed: int = 0
    process: str = "poisson"               # "poisson" | "bursty"
    #: mean rounds between arrivals (poisson); ~0.7 keeps a 16-slot
    #: engine around 80% utilized with the default length mix
    mean_interarrival_rounds: float = 0.7
    #: bursty process: geometric burst sizes with this mean, separated
    #: by exponential gaps of this mean
    burst_mean_size: float = 8.0
    burst_gap_rounds: float = 12.0
    prefill_pages_choices: Tuple[int, ...] = (2, 4, 8)
    prefill_pages_weights: Tuple[float, ...] = (0.5, 0.3, 0.2)
    decode_steps_choices: Tuple[int, ...] = (4, 8, 16)
    decode_steps_weights: Tuple[float, ...] = (0.5, 0.3, 0.2)
    #: fraction of requests that share a prompt prefix with neighbours
    share_fraction: float = 0.3
    prefix_pages: int = 4
    prefix_group_size: int = 4
    #: vectorized generation window (groups never span a cohort)
    cohort: int = 1024

    def __post_init__(self) -> None:
        if self.n_requests <= 0:
            raise ValueError("n_requests must be positive")
        if self.process not in ("poisson", "bursty"):
            raise ValueError(f"unknown arrival process {self.process!r}")
        if not 0.0 <= self.share_fraction <= 1.0:
            raise ValueError("share_fraction must be in [0, 1]")
        if self.prefix_group_size < 2:
            raise ValueError("prefix_group_size must be >= 2")
        if self.cohort < self.prefix_group_size:
            raise ValueError("cohort must hold at least one prefix group")


@dataclass(frozen=True)
class ReplayRequest:
    uid: int
    arrival_round: int
    prefill_pages: int
    decode_steps: int
    prefix_id: int = -1                    # -1: no shared prefix


@dataclass(frozen=True)
class PrefixInfo:
    """Whole-group facts, available as soon as any member is yielded."""

    members: int
    total_decode_steps: int                # == per-line reads of the prefix
    uid_min: int
    uid_max: int


class RequestStream:
    """Deterministic, re-iterable stream of :class:`ReplayRequest`."""

    def __init__(self, cfg: TrafficConfig):
        self.cfg = cfg
        self._prefixes: Dict[int, PrefixInfo] = {}

    def prefix_info(self, prefix_id: int) -> PrefixInfo:
        return self._prefixes[prefix_id]

    def __iter__(self) -> Iterator[ReplayRequest]:
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed)
        pp_choices = np.asarray(cfg.prefill_pages_choices)
        pp_w = np.asarray(cfg.prefill_pages_weights, dtype=np.float64)
        pp_w = pp_w / pp_w.sum()
        ds_choices = np.asarray(cfg.decode_steps_choices)
        ds_w = np.asarray(cfg.decode_steps_weights, dtype=np.float64)
        ds_w = ds_w / ds_w.sum()

        uid = 0
        clock = 0.0
        next_pid = 0
        remaining = cfg.n_requests
        while remaining:
            n = min(cfg.cohort, remaining)
            remaining -= n
            pp = rng.choice(pp_choices, size=n, p=pp_w)
            ds = rng.choice(ds_choices, size=n, p=ds_w)
            shared = rng.random(n) < cfg.share_fraction

            if cfg.process == "poisson":
                gaps = rng.exponential(cfg.mean_interarrival_rounds, n)
            else:
                # geometric bursts: each request opens a new burst with
                # probability 1/mean_size; only burst openers add a gap
                opener = rng.random(n) < 1.0 / cfg.burst_mean_size
                opener[0] = True
                gaps = np.where(opener,
                                rng.exponential(cfg.burst_gap_rounds, n),
                                0.0)
            arrivals = np.floor(clock + np.cumsum(gaps)).astype(np.int64)
            clock = float(clock + gaps.sum())

            # consecutive sharing requests chunk into groups; prefix
            # facts are recorded before any member is yielded (idempotent
            # overwrite, so re-iteration never double-counts)
            pid = np.full(n, -1, dtype=np.int64)
            sh_idx = np.nonzero(shared)[0]
            g = cfg.prefix_group_size
            for k in range(0, len(sh_idx) - len(sh_idx) % g, g):
                grp = sh_idx[k:k + g]
                pid[grp] = next_pid
                self._prefixes[next_pid] = PrefixInfo(
                    members=len(grp),
                    total_decode_steps=int(ds[grp].sum()),
                    uid_min=uid + int(grp[0]),
                    uid_max=uid + int(grp[-1]))
                next_pid += 1

            for i in range(n):
                yield ReplayRequest(
                    uid=uid + i, arrival_round=int(arrivals[i]),
                    prefill_pages=int(pp[i]), decode_steps=int(ds[i]),
                    prefix_id=int(pid[i]))
            uid += n
