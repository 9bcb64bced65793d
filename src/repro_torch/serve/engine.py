"""Batched serving engine: continuous batching over a slotted KV pool.

The DCO mapping: each slot's KV region is a *tensor* with dataflow-known
lifetime.  When a sequence finishes, its slot is retired immediately and
reused by the next queued request — the serving-level dead-block
prediction (paper §VI-F: "data from completed batches becomes dead and
pollutes the cache"; here the pollution is reclaimed the moment
``accCnt == nAcc``, i.e. at EOS/max-tokens).  A TMU instance tracks the
slot lifetimes so the analogy is executable, not rhetorical.  For a family
with attention, the cache orchestrator, budgeted with the shared memory the
flash kernel keeps for a pinned KV prefix, chooses each prefill's
pinned/streamed split; an attention-free (SSM) model has no KV to plan.

The engine is synchronous.  ``step()`` runs one batched ``decode_step`` of
the whole padded batch for each distinct slot position.  **The pooled
cache is updated in place**: a step for one position group writes K/V (or
conv history and SSM state) only for that group's rows and reads logits
only from them, which is what the JAX engine's ``_merge_slots`` (keep the
updated rows of the group, the old rows of everyone else) amounts to on a
cache that is not copied.  In a MoE model the rows of a call compete for the
experts' slots, so there every row still takes the step, as in the JAX
engine, and only the group's rows keep what it wrote (``decode_step``).

Under a mesh bound when the engine is made (``sharding.use_mesh``), with a
data axis of one rank, the engine serves tensor- and expert-parallel: every
rank makes its own engine with its parameter shards (``shard_tree``), holds
its shard of the pooled cache (``init_cache``), gets the same requests and
runs the same scheduler.  ``prefill`` and ``decode_step`` give every rank the
same whole logits, so every rank picks the same tokens and makes the same
calls.  Data-parallel serving is a set of replicas behind a router, which
the reference does not have: a data axis of more than one rank raises.  The
pool's K/V take ``models.model.kv_layout``'s layout for its ``max_batch``
rows: by KV heads over the model axis where the KV heads divide it (the
engine's batch is above 1), else ``kvseq``, every KV head over a slice of
each slot's rows; each prefill returns its K/V in the pool's layout, and a
``kvseq`` prefill is gathered whole before its rows are spliced in.
"""

from __future__ import annotations

from dataclasses import dataclass
from dataclasses import field
from typing import Dict
from typing import List
from typing import Optional

import numpy as np
import torch

from .. import require_device
from ..configs import ArchConfig
from ..configs import SSM
from ..core.orchestrator import CacheOrchestrator
from ..core.orchestrator import FLASH_TILE_ROWS
from ..core.orchestrator import flash_kv_row_bytes
from ..core.orchestrator import hopper_pin_budget_bytes
from ..core.tmu import TMU
from ..core.tmu import TensorMeta
from ..models import Cache
from ..models import decode_step
from ..models import init_cache
from ..models import prefill
from ..models.model import gather_cache
from ..models.model import kv_rows
from ..models.model import kv_slice
from ..sharding.api import axis_sizes
from ..sharding.api import current_mesh
from ..sharding.api import dp_axes
from ..sharding.api import use_mesh
from .scheduler import ServeTruncation
from .scheduler import SlotScheduler


@dataclass
class Request:
    uid: int
    prompt: np.ndarray                 # (prompt_len,) int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    tokens_out: List[int] = field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, cfg: ArchConfig, params, *, max_batch: int = 4,
                 max_seq: int = 256, greedy: bool = True, device="cuda"):
        self.mesh = current_mesh()
        if self.mesh is not None:
            sizes = axis_sizes(self.mesh)
            data = [f"{a}={sizes[a]}" for a in dp_axes(self.mesh) if sizes[a] > 1]
            if data:
                raise NotImplementedError(
                    f"serving under a data axis ({', '.join(data)}): data-parallel "
                    "serving is replicas behind a router, which no slice ports")
        self.cfg = cfg
        self.params = params
        self.device = require_device(device)
        self.max_batch = max_batch
        self.max_seq = max_seq
        dtype = params["embed"].dtype
        with use_mesh(self.mesh):
            self.cache = init_cache(cfg, max_batch, max_seq, device=self.device,
                                    dtype=dtype)
        self.sched: SlotScheduler[Request] = SlotScheduler(max_batch)
        self.slot_pos = np.zeros(max_batch, dtype=np.int32)
        self.greedy = greedy
        # TMU tracking slot lifetimes (dead-block analogue)
        self._tmu = TMU(tensor_entries=max_batch * 2)
        self._slot_bytes = 1 << 20
        # pinned/streamed split of each prefill's KV, from the shared memory
        # the flash kernel can keep for a pinned prefix; none without attention
        self._orch: Optional[CacheOrchestrator] = None
        if cfg.family != SSM:
            itemsize = torch.empty((), dtype=dtype).element_size()
            self._kv_row_bytes = flash_kv_row_bytes(cfg.head_dim, itemsize)
            self._orch = CacheOrchestrator(
                vmem_budget_bytes=hopper_pin_budget_bytes(cfg.head_dim, itemsize))
        self.decode_calls = 0
        self.prefill_calls = 0
        self.last_logits: Optional[torch.Tensor] = None

    # ------------------------------------------------------------------
    def add_request(self, req: Request) -> None:
        self.sched.add(req)

    def _admit(self) -> None:
        for slot, req in self.sched.admit():
            self._start(slot, req)

    def _pick(self, logits: torch.Tensor, uid: int) -> int:
        """Greedy token from one row of logits; a device→host sync per token."""
        return int(torch.argmax(logits))

    def _sample(self, logits: torch.Tensor, uid: int) -> int:
        """A token drawn from one row of logits by a generator seeded with the
        request's uid.  The reference draws with ``jax.random.categorical``
        keyed by the uid, a stream that torch cannot reproduce: the draw is
        the same for the same uid and logits, not the reference's token."""
        gen = torch.Generator(device=logits.device)
        gen.manual_seed(uid)
        probs = torch.softmax(logits.float(), dim=-1)
        return int(torch.multinomial(probs, 1, generator=gen))

    def _start(self, slot: int, req: Request) -> None:
        plen = req.prompt.shape[0]
        # max_seq bounds the K/V rows; an SSM's state has no length, and the
        # reference serves its prompts and decodes past max_seq
        if self.cache.k is not None and plen > self.max_seq:
            raise ValueError(f"prompt of {plen} tokens exceeds max_seq {self.max_seq}")
        prompt = torch.as_tensor(np.asarray(req.prompt)[None, :], dtype=torch.long,
                                 device=self.device)
        plan = {}
        if self._orch is not None:
            plan["pinned_rows"], _ = self._orch.plan_kv_split(
                plen, FLASH_TILE_ROWS, self._kv_row_bytes)
        sliced = bool(kv_rows(self.cache))
        if self.mesh is not None and self.cache.k is not None:
            # the pool's layout, not the one a batch of 1 would get
            plan["layout"] = "kvseq" if sliced else "heads"
        with use_mesh(self.mesh):
            logits, pcache = prefill(self.params, prompt, self.cfg, **plan)
            if sliced:
                # every row of the prompt's K/V, then this rank's slice of them
                kv = gather_cache(Cache(k=pcache.k, v=pcache.v), self.cfg, 1)
                first, rows, _ = kv_slice(self.cfg, self.max_batch, self.max_seq)
                pcache = pcache._replace(k=kv.k[:, :, first:first + rows],
                                         v=kv.v[:, :, first:first + rows])
        self.prefill_calls += 1
        # splice this request's prefilled KV / state into the pooled cache
        _splice(self.cache, pcache, slot)
        self.slot_pos[slot] = plen
        self.last_logits = logits
        # as in the reference, only this first token is sampled when not
        # greedy; every decoded token is the argmax (``step``)
        pick = self._pick if self.greedy else self._sample
        req.tokens_out.append(pick(logits[0], req.uid))
        self._tmu.register(TensorMeta(
            tensor_id=req.uid, base_addr=slot * self._slot_bytes,
            size_bytes=self._slot_bytes, tile_bytes=self._slot_bytes,
            n_acc=req.max_new_tokens))

    def _retire(self, slot: int) -> None:
        req = self.sched.release(slot)
        req.done = True
        self._tmu.clear(req.uid)          # slot retires → space reusable
        self.slot_pos[slot] = 0

    # ------------------------------------------------------------------
    def step(self) -> int:
        """One batched decode step; returns #active slots."""
        self._admit()
        active = self.sched.active_slots()
        if not active:
            return 0
        toks = np.zeros((self.max_batch, 1), dtype=np.int64)
        for i in active:
            toks[i, 0] = self.sched.slots[i].tokens_out[-1]
        tokens = torch.as_tensor(toks, device=self.device)
        # a single scalar position per call requires aligned decoding, so the
        # engine decodes each distinct position group separately
        groups: Dict[int, List[int]] = {}
        for i in active:
            groups.setdefault(int(self.slot_pos[i]), []).append(i)
        for pos, slots in groups.items():
            if self.cache.k is not None and pos >= self.max_seq:
                raise ValueError(f"slot(s) {slots} ran past max_seq {self.max_seq}")
            with use_mesh(self.mesh):
                logits, _ = decode_step(self.params, tokens,
                                        self.cache._replace(pos=pos), self.cfg,
                                        rows=slots)
            self.decode_calls += 1
            self.last_logits = logits
            for i in slots:
                req = self.sched.slots[i]
                nxt = self._pick(logits[i, 0], req.uid)
                req.tokens_out.append(nxt)
                self.slot_pos[i] += 1
                self._tmu.on_access(
                    i * self._slot_bytes + self._slot_bytes - 128, 0)
                exhausted = len(req.tokens_out) >= req.max_new_tokens
                if exhausted or (req.eos_id is not None
                                 and nxt == req.eos_id):
                    self._retire(i)
        return len(active)

    def run_to_completion(self, max_steps: int = 1000) -> int:
        """Drive :meth:`step` until every request finishes; returns the
        number of steps taken.  Raises :class:`ServeTruncation` if the
        budget runs out with requests still active or queued."""
        for n in range(max_steps):
            if self.step() == 0 and self.sched.drained:
                return n + 1
        if not self.sched.drained:
            raise ServeTruncation(max_steps, self.sched.n_active,
                                  self.sched.n_queued)
        return max_steps


# ---------------------------------------------------------------------------
def _splice(pool: Cache, one: Cache, slot: int) -> None:
    """Copy a single-sequence prefill cache into pool slot ``slot``, in place,
    and zero-fill the rest of the slot: a reused slot keeps nothing of the
    request that held it before.

    The prefill's K/V (one row per prompt token) and conv histories fill the
    first rows of the slot.  After a 2-token prompt the conv history has 2 of
    the ``d_conv - 1`` rows and they land in rows 0 and 1, where the
    reference's ``dynamic_update_slice`` puts them."""
    for pool_a, one_a in ((pool.k, one.k), (pool.v, one.v), (pool.conv_x, one.conv_x),
                          (pool.conv_bc, one.conv_bc)):
        if pool_a is None:
            continue
        rows = one_a.shape[2]
        pool_a[:, slot, :rows] = one_a[:, 0]
        pool_a[:, slot, rows:] = 0
    if pool.ssm is not None:
        pool.ssm[:, slot] = one.ssm[:, 0]
