"""Paper workloads (§VI-C): attention units of Gemma3-27B, Llama3-70B,
Llama3-405B, Qwen3-8B, evaluated as FlashAttention-2 GQA dataflows.

"In each attention unit, these models mainly differ in the number of Q
heads and KV heads."  Group allocation (paper Fig. 4, §VI-C):

* **temporal group allocation** — the Group dimension (Q heads sharing a
  KV head) is mapped entirely to the time domain *on the same core*; no
  inter-core KV sharing (used for Gemma3-27B in the paper).
* **spatial group allocation** — the Group dimension is (at least
  partially) spread across cores; cores share KV streams through the LLC
  and its MSHRs (used for Qwen3-8B / Llama3 in the paper).
"""

from __future__ import annotations

from dataclasses import dataclass
from dataclasses import replace
from typing import Dict

TEMPORAL = "temporal"
SPATIAL = "spatial"


@dataclass(frozen=True)
class AttnWorkload:
    """One attention unit of a model, in FlashAttention-2 form."""

    name: str
    n_q_heads: int
    n_kv_heads: int
    head_dim: int
    seq_len: int
    group_alloc: str = TEMPORAL       # temporal | spatial
    n_batches: int = 1                # >1 → the multi-batch DBP scenario (§VI-F)
    # int8/fp8 activations: with 1-byte K/V the Gemma3-27B 2K active
    # working set is 16 heads × 512 KB = 8 MB — exactly the paper's §VI-D2
    # statement ("8MB, which is exactly the size of the active working
    # set of the Gemma3-27B 2K case").
    dtype_bytes: int = 1
    q_block: int = 128                # Br (rows of Q per tile)
    kv_block: int = 128               # Bc (rows of K/V per tile)
    causal: bool = False              # the paper's dataflow streams full K/V

    def __post_init__(self) -> None:
        if self.n_q_heads % self.n_kv_heads:
            raise ValueError("GQA requires n_q_heads % n_kv_heads == 0")
        if self.seq_len % self.q_block or self.seq_len % self.kv_block:
            raise ValueError("seq_len must be tile-aligned")
        if self.group_alloc not in (TEMPORAL, SPATIAL):
            raise ValueError(f"bad group_alloc {self.group_alloc!r}")

    # -- derived quantities ------------------------------------------------
    @property
    def group_size(self) -> int:
        return self.n_q_heads // self.n_kv_heads

    @property
    def n_q_tiles(self) -> int:
        return self.seq_len // self.q_block

    @property
    def n_kv_tiles(self) -> int:
        return self.seq_len // self.kv_block

    @property
    def kv_head_bytes(self) -> int:
        """K + V bytes for one KV head."""
        return 2 * self.seq_len * self.head_dim * self.dtype_bytes

    @property
    def kv_tile_bytes(self) -> int:
        return self.kv_block * self.head_dim * self.dtype_bytes

    @property
    def q_tile_bytes(self) -> int:
        return self.q_block * self.head_dim * self.dtype_bytes

    def flops_per_inner_step(self) -> float:
        """QK^T + softmax update + PV for one (q_tile, kv_tile) pair."""
        qk = 2.0 * self.q_block * self.kv_block * self.head_dim
        pv = 2.0 * self.q_block * self.kv_block * self.head_dim
        softmax = 6.0 * self.q_block * self.kv_block
        return qk + pv + softmax

    def with_seq(self, seq_len: int) -> "AttnWorkload":
        return replace(self, seq_len=seq_len)

    def with_batches(self, n: int) -> "AttnWorkload":
        return replace(self, n_batches=n)


@dataclass(frozen=True)
class DecodeWorkload:
    """Decode-time attention over paged KV (the §VI-F multi-batch scenario
    generalized to serving): every decode step streams the full live KV
    history of each sequence; sequences finish at different steps, so
    their pages become dead mid-run and pollute the LLC until retired.

    ``n_short`` of the ``n_seqs`` sequences end after ``retire_step``
    decode steps; the rest run all ``n_steps``.  Each K/V line is read
    once per decode step its sequence is alive, so ``nAcc`` equals the
    sequence's lifetime in steps — the dataflow knowledge DBP retires
    pages with.
    """

    name: str = "decode-paged"
    n_seqs: int = 16
    seq_len: int = 2048               # KV history rows per sequence
    head_dim: int = 128
    n_kv_heads: int = 1
    page_rows: int = 128
    dtype_bytes: int = 1
    n_steps: int = 8                  # decode steps simulated
    retire_step: int = 4              # short sequences end after this step
    n_short: int = 8

    def __post_init__(self) -> None:
        if self.seq_len % self.page_rows:
            raise ValueError("seq_len must be page-aligned")
        if not (0 < self.retire_step <= self.n_steps):
            raise ValueError("retire_step must lie in (0, n_steps]")
        if not (0 <= self.n_short <= self.n_seqs):
            raise ValueError("n_short out of range")

    @property
    def page_bytes(self) -> int:
        return (self.page_rows * self.head_dim * self.n_kv_heads
                * self.dtype_bytes)

    @property
    def n_pages(self) -> int:
        return self.seq_len // self.page_rows

    @property
    def kv_bytes_per_seq(self) -> int:
        """K + V bytes of one sequence's history."""
        return 2 * self.n_pages * self.page_bytes

    def steps_alive(self, seq: int) -> int:
        return self.retire_step if seq < self.n_short else self.n_steps


@dataclass(frozen=True)
class SpecDecodeWorkload:
    """Speculative decoding: per verification cycle, a small draft model
    autoregressively proposes ``gamma`` tokens (streaming its own
    speculation-window KV ``gamma`` times), then the target model
    verifies them in one pass over its full KV history.

    The draft KV of one speculation round has a *short, known lifetime*:
    it dies at verification (accepted tokens re-enter through the target
    KV, rejected ones are discarded), so each round's draft KV is its
    own liveness epoch — the §VI-F two-epoch retirement pattern
    interleaved with a persistent reuse carrier.  ``nAcc`` of a draft
    page is ``gamma + 1`` (γ autoregressive draft passes plus the one
    verification read, matching ``spec_decode_spec``); DBP retires the
    whole speculation window on exactly that verification read, while
    LRU drags every retired window through the LLC as dead pollution.
    """

    name: str = "spec-decode"
    n_seqs: int = 16
    target_len: int = 512             # target-model KV history rows/seq
    draft_len: int = 256              # draft speculation-window rows/seq
    head_dim: int = 128
    n_kv_heads: int = 1
    page_rows: int = 128
    dtype_bytes: int = 1
    gamma: int = 4                    # draft tokens per verification
    n_verify: int = 4                 # draft→verify cycles simulated

    def __post_init__(self) -> None:
        if self.target_len % self.page_rows or self.draft_len % self.page_rows:
            raise ValueError("KV lengths must be page-aligned")
        if self.gamma < 1 or self.n_verify < 1:
            raise ValueError("gamma and n_verify must be >= 1")

    @property
    def page_bytes(self) -> int:
        return (self.page_rows * self.head_dim * self.n_kv_heads
                * self.dtype_bytes)

    @property
    def n_target_pages(self) -> int:
        return self.target_len // self.page_rows

    @property
    def n_draft_pages(self) -> int:
        return self.draft_len // self.page_rows

    @property
    def token_bytes(self) -> int:
        """One decode token's activation row (Q or logit output)."""
        return self.head_dim * self.n_kv_heads * self.dtype_bytes


@dataclass(frozen=True)
class SSDScanWorkload:
    """Mamba2 SSD chunked scan (``models/ssm.py::ssd_chunked``) as a
    cache dataflow — the dead-block insight on an attention-free
    architecture (DESIGN.md §4).

    Per chunk, the intra-chunk quadratic pass streams the chunk's
    x/B/C inputs (bursty, bypass class), then the inter-chunk recurrence
    reads the *previous* chunk's running state and materializes this
    chunk's: each head's (P × N) state tile is stored once and read
    exactly once by the next chunk's recurrence, so its ``nAcc`` ends at
    the next chunk's materialization and the TMU retires it there.
    Consumed states are the most-recently-read mass in the LLC — under
    LRU they shadow the freshly materialized generation (the §VI-F
    pollution at chunk cadence), DBP frees them on the spot.  States are
    *dirty* reuse carriers (produced by stores), so the scenario also
    stresses the dirty-lifetime write-back model: every state writes
    back once it ages out, whether or not its read hit.
    """

    name: str = "ssd-scan"
    n_seqs: int = 16
    n_chunks: int = 6
    n_heads: int = 6
    d_head: int = 128                 # P
    d_state: int = 128                # N
    chunk_len: int = 128              # rows per chunk (x/B/C stream)
    dtype_bytes: int = 1

    def __post_init__(self) -> None:
        if self.n_chunks < 2:
            raise ValueError("need >= 2 chunks for a state recurrence")
        if self.n_heads < 1 or self.n_seqs < 1:
            raise ValueError("n_heads and n_seqs must be >= 1")

    @property
    def head_state_bytes(self) -> int:
        """One head's (P × N) running-state tile."""
        return self.d_head * self.d_state * self.dtype_bytes

    @property
    def state_bytes(self) -> int:
        """One sequence's full running state (all heads) for one chunk."""
        return self.n_heads * self.head_state_bytes

    @property
    def head_slab_bytes(self) -> int:
        """All sequences' head-``h`` state tiles of one chunk — the unit
        that dies in a single lockstep round (every core's recurrence
        reads its sequence's tile in the same round), sized so it tiles
        the TMU's ``tag``-slice dead-id regions cleanly."""
        return self.n_seqs * self.head_state_bytes

    @property
    def chunk_in_bytes(self) -> int:
        """x + B + C rows of one chunk (the bursty input stream)."""
        return self.chunk_len * (self.n_heads * self.d_head
                                 + 2 * self.d_state) * self.dtype_bytes

    @property
    def chunk_out_bytes(self) -> int:
        """y rows of one chunk."""
        return self.chunk_len * self.n_heads * self.d_head * self.dtype_bytes

    @property
    def intra_flops(self) -> float:
        """Intra-chunk quadratic term per (seq, chunk), all heads."""
        return 4.0 * self.n_heads * self.chunk_len ** 2 * self.d_head

    @property
    def inter_flops(self) -> float:
        """State materialization + inter-chunk contribution per
        (seq, chunk), all heads."""
        return 4.0 * self.n_heads * self.chunk_len * self.d_head \
            * self.d_state


@dataclass(frozen=True)
class PrefixShareWorkload:
    """Prefix-cache sharing: a batch of requests whose prompts share one
    common prefix (system prompt / few-shot header) while each request
    appends a private suffix.

    Every decode step streams the shared prefix KV on *all* cores at
    once — a high-``sharers`` co-stream whose same-round requests merge
    in the MSHRs while the lagging rank's reuses ride LLC storage — plus
    each request's private suffix KV (``sharers == 1``).  The private
    streams thrash; blind bypassing that caught them would also kill the
    shared prefix's inter-core reuse, which is exactly the §IV-E failure
    mode the conservative ``gqa_bypass`` variant exists to avoid — the
    suite runs this scenario with that variant.
    """

    name: str = "prefix-share"
    n_reqs: int = 16
    prefix_len: int = 2048            # shared-prompt KV rows
    suffix_len: int = 512             # private KV rows per request
    head_dim: int = 128
    n_kv_heads: int = 1
    page_rows: int = 128
    dtype_bytes: int = 1
    n_steps: int = 4                  # decode steps simulated

    def __post_init__(self) -> None:
        if self.prefix_len % self.page_rows or \
                self.suffix_len % self.page_rows:
            raise ValueError("KV lengths must be page-aligned")
        if self.n_reqs < 2:
            raise ValueError("prefix sharing needs >= 2 requests")
        if self.n_steps < 1:
            raise ValueError("n_steps must be >= 1")

    @property
    def page_bytes(self) -> int:
        return (self.page_rows * self.head_dim * self.n_kv_heads
                * self.dtype_bytes)

    @property
    def n_prefix_pages(self) -> int:
        return self.prefix_len // self.page_rows

    @property
    def n_suffix_pages(self) -> int:
        return self.suffix_len // self.page_rows

    @property
    def token_bytes(self) -> int:
        """One decode token's activation row (Q or logit output)."""
        return self.head_dim * self.n_kv_heads * self.dtype_bytes


@dataclass(frozen=True)
class MoEWorkload:
    """Expert-FFN of a Mixture-of-Experts layer with skewed routing:
    ``n_hot`` experts stay active for the whole run and are co-streamed by
    several cores (inter-core expert-weight sharing through the LLC),
    while the remaining cold experts serve traffic only during the first
    ``warm_steps`` token waves and then retire — dead expert weights that
    pollute the cache exactly like finished batches do in §VI-F.
    """

    name: str = "moe-ffn"
    n_experts: int = 16
    n_hot: int = 8
    d_model: int = 512
    d_ff: int = 512
    tile_bytes: int = 16 * 1024
    token_block: int = 32             # tokens per routed activation tile
    dtype_bytes: int = 1
    n_steps: int = 8                  # token waves
    warm_steps: int = 2               # waves during which cold experts route

    def __post_init__(self) -> None:
        if not (0 < self.n_hot <= self.n_experts):
            raise ValueError("n_hot out of range")
        if self.expert_bytes % self.tile_bytes:
            raise ValueError("expert weights must be tile-aligned")
        if not (0 < self.warm_steps <= self.n_steps):
            raise ValueError("warm_steps must lie in (0, n_steps]")

    @property
    def expert_bytes(self) -> int:
        """W_up + W_down bytes of one expert."""
        return 2 * self.d_model * self.d_ff * self.dtype_bytes

    @property
    def n_cold(self) -> int:
        return self.n_experts - self.n_hot

    @property
    def act_tile_bytes(self) -> int:
        return self.token_block * self.d_model * self.dtype_bytes

    @property
    def flops_per_use(self) -> float:
        """One routed token block through W_up and W_down."""
        return 4.0 * self.token_block * self.d_model * self.d_ff


# Paper benchmark models (attention-unit shapes; GQA head counts are the
# models' published configurations, head_dim 128 across all four).
PAPER_WORKLOADS: Dict[str, AttnWorkload] = {
    "gemma3-27b": AttnWorkload("gemma3-27b", n_q_heads=32, n_kv_heads=16,
                               head_dim=128, seq_len=2048,
                               group_alloc=TEMPORAL),
    "qwen3-8b": AttnWorkload("qwen3-8b", n_q_heads=32, n_kv_heads=8,
                             head_dim=128, seq_len=2048,
                             group_alloc=SPATIAL),
    "llama3-70b": AttnWorkload("llama3-70b", n_q_heads=64, n_kv_heads=8,
                               head_dim=128, seq_len=2048,
                               group_alloc=SPATIAL),
    "llama3-405b": AttnWorkload("llama3-405b", n_q_heads=128, n_kv_heads=8,
                                head_dim=128, seq_len=2048,
                                group_alloc=SPATIAL),
}


def get_workload(name: str, seq_len: int | None = None,
                 n_batches: int = 1) -> AttnWorkload:
    wl = PAPER_WORKLOADS[name]
    if seq_len is not None:
        wl = wl.with_seq(seq_len)
    if n_batches != 1:
        wl = wl.with_batches(n_batches)
    return wl
