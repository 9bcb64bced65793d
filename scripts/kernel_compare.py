#!/usr/bin/env python3
"""Time the decode, SSD and flash kernels against an earlier tree's, in one run.

    git show <rev>:src/repro_torch/csrc/decode_attention.cu > reports/base/decode_attention.cu
    git show <rev>:src/repro_torch/csrc/ssd_scan.cu > reports/base/ssd_scan.cu
    python3 scripts/kernel_compare.py --baseline reports/base

    for f in flash_attention.cu flash_attention_pos.cu bf16_tiles.cuh positions.cuh; do
        git show <rev>:src/repro_torch/csrc/$f > reports/base/$f; done
    python3 scripts/kernel_compare.py --kernel flash --baseline reports/base
    # (a tree from commit c50a149 on, whose forward takes this tree's Q tiles:
    #  --baseline-chunks this_tree times both at this tree's chunking)

    for f in flash_attention_bwd.cu flash_attention_bwd_pos.cu bf16_tiles.cuh positions.cuh; do
        git show <rev>:src/repro_torch/csrc/$f > reports/base_bwd/$f; done
    python3 scripts/kernel_compare.py --kernel flash_bwd --baseline reports/base_bwd

(``bf16_tiles.cuh`` for a tree before the Hopper backward, whose kernels were
built on it; a later tree's sources need ``hopper.cuh`` instead.)

The earlier sources go in a directory of their own (never under ``csrc/``:
``kernels/build.py`` links every ``csrc/*.cu`` into one library, and two copies
would clash on their ``extern "C"`` names); they are built into a library of
their own and called through their own C interfaces, which ``Baseline`` knows
for the earlier trees' two-launch decode kernel (with ``n_splits``), SSD
kernel (with no ring-depth argument) and flash forward (the interface of
today's, with the tiles a chunk that the mma.sync kernel of commit ba0963a
chose) and flash backward (today's ``dco_flash_attention_bwd`` interface, the
same for the mma.sync kernel of commit c50a149).

One JSON line per shape, on the inputs and with the timing of ``chip_smoke.py``
(``decode_record`` / ``ssd_record`` / ``flash_record``: CUDA-graph replay, L2
rewritten before each call): this tree's record (ms, plain, library, bound),
the earlier kernel's ``baseline_ms``, both timed in turns (old, new, new, old:
``turns_ms``), and for decode the time at each fixed ``rows_per_split`` beside
the rows the kernel chose; for flash also both kernels with nothing pinned, in
turns, this tree's at other tiles a chunk, and the host microseconds a call.  Decode runs on the engine's pool (8 slots x 2048
rows, llama3.2-3b heads, bf16) at mixed positions, a serving call's one live
position group of 801 and of 97 rows, and every slot full; SSD at mamba2-2.7b's
prompts of 1024 and 256 tokens; the flash forward (both kernels at the
``pinned_rows`` this tree's planner gives) at every path's prefill of 1024 and
256 tokens (``ATTN_SHAPES``, with the path's softcap, scale and window),
gemma2-27b's 5120-token prefills as a local and a global layer, also without
the softcap, the forward with the LSE at four training shapes
(``BWD_SHAPES``) and the position variant at qwen2-vl-7b's 1024 tokens in
both modes.  The flash backward (``--kernel flash_bwd``): both kernels
against the plain version at every training shape of ``chip_smoke.BWD_SHAPES``
and with a positions table at llama3.2-3b's (``flash_bwd_compare``), timed in
turns with CUDA events as ``chip_smoke.flash_bwd_record`` times them, with
the library's ``autograd.grad`` through ``scaled_dot_product_attention`` (its
time as timed, and its kernels' device time by the profiler beside this
tree's, in all and by kernel: ``library_device_ms``, ``device_ms``,
``*kernels_ms``), the bound, two calls checked bit-identical, the host
microseconds a call and both builds' registers and spills.  Needs one CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
from pathlib import Path
import subprocess
import sys
import time

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs

DECODE_SHAPES = {
    "ragged": cs.DECODE_RAGGED,
    "one group of 801": cs.DECODE_ONE_GROUP,
    "one group of 97": [0, 0, 97, 0, 0, 0, 0, 0],
    "full": [2048] * 8,
}
FIXED_ROWS = (32, 64, 128, 256, 512)


class Baseline:
    """The decode and SSD kernels of an earlier tree, built from ``csrc`` into
    a library of their own."""

    def __init__(self, csrc, verbose=False, chunks="mma_sync"):
        from repro_torch.kernels import build
        from repro_torch.kernels.flash_attention import ops
        self.path = build.build(verbose=verbose, csrc=Path(csrc).resolve())
        self.lib = ctypes.CDLL(str(self.path))
        for name, types in (
                ("dco_decode_attention", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                 + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]),
                ("dco_ssd_scan", [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                 + [ctypes.c_void_p] * 2),
                ("dco_flash_attention", ops.ARGTYPES),
                ("dco_flash_attention_bwd", ops.BWD_ARGTYPES)):
            if hasattr(self.lib, name):
                getattr(self.lib, name).argtypes = types
        self.sms = torch.cuda.get_device_properties(0).multi_processor_count
        self.chunks = chunks

    def decode(self, q, k, v, cl):
        """The two-launch decode interface: the valid range cut into n_splits
        pieces (two blocks an SM, 64 rows a piece at least, 32 pieces at most),
        a partial kernel and a combine kernel."""
        b, h, d = q.shape
        _, s, g, _ = k.shape
        n_splits = max(1, min(-(-2 * self.sms // (b * g)), s // 64, 32))
        out = torch.empty_like(q)
        scratch = torch.empty(b * h * n_splits * (d + 2), dtype=torch.float32, device="cuda")
        st = (ctypes.c_longlong * 8)(q.stride(0), q.stride(1), *k.stride()[:3],
                                     *v.stride()[:3])
        rc = self.lib.dco_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), cl.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), 0 if q.dtype == torch.bfloat16 else 1, b, s, h, g, d,
            n_splits, 1.0 / d ** 0.5, st, torch.cuda.current_stream().cuda_stream)
        cs.check(rc == 0, f"baseline decode launch failed ({rc})")
        return out

    @staticmethod
    def mma_sync_tile_rows(group, d):
        """Query rows of the mma.sync kernel's Q tile (its ``q_tile_rows``):
        16 a warp, up to 4 warps a head, heads in passes of at most 8 warps
        (4 above head_dim 128)."""
        most = 4 if d > 128 else 8
        passes = -(-group // most)
        heads = -(-group // passes)
        warps = 4
        while warps > 1 and heads * warps > most:
            warps //= 2
        return 16 * warps

    def flash_entry(self, fn, q, k, v, *, tiles, pinned_rows=0, lse=None, positions=None,
                    keys_at_rows=False, window=None, softcap=None, scale=None):
        """``fn`` (a library's ``dco_flash_attention``) bound to its arguments:
        a call of it is the C entry alone, with no Python wrapper around it.
        Returns (the call, its output)."""
        b, sq, h, d = q.shape
        _, sk, g, _ = k.shape
        out = torch.empty_like(q)
        st = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                      *out.stride()[:3])
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(),
                None if positions is None else positions.data_ptr(), int(keys_at_rows), 0, b,
                sq, sk, h, g, d, tiles, pinned_rows, 1, int(window or 0),
                float(scale or d ** -0.5), float(softcap or 0.0), st,
                torch.cuda.current_stream().cuda_stream)

        def call():
            rc = fn(*args)
            cs.check(rc == 0, f"flash entry failed ({rc})")
        return call, out

    def flash(self, q, k, v, **kw):
        """The bf16 flash forward through the interface of today's
        ``dco_flash_attention``, causal, with the tiles a chunk that the
        earlier wrapper chose (about one block an SM), or with
        ``chunks == "this_tree"`` the ones this tree's wrapper chooses (for
        an earlier tree whose kernel takes this tree's Q tiles)."""
        from repro_torch.kernels.flash_attention import ops
        b, sq, h, d = q.shape
        g = k.shape[2]
        if self.chunks == "this_tree":
            tiles = ops.tiles_per_chunk_for(b, g, sq, self.sms, ops.q_tile_rows(h // g, 2, d))
            call, out = self.flash_entry(self.lib.dco_flash_attention, q, k, v, tiles=tiles, **kw)
            call()
            return out
        n_q_tiles = -(-sq // self.mma_sync_tile_rows(h // g, q.shape[3]))
        tiles = -(-n_q_tiles // max(1, min(n_q_tiles, self.sms // (b * g))))
        call, out = self.flash_entry(self.lib.dco_flash_attention, q, k, v, tiles=tiles, **kw)
        call()
        return out

    @staticmethod
    def flash_bwd_entry(fn, q, k, v, o, lse, do, positions=None, window=None, softcap=None,
                        scale=None):
        """``fn`` (a library's ``dco_flash_attention_bwd``) bound to its
        arguments, bf16: a call of it is the C entry alone (three launches).
        Returns (the call, (dq, dk, dv))."""
        b, s, h, d = q.shape
        g = k.shape[2]
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                None if positions is None else positions.data_ptr(), 0, b, s, h, g, d,
                int(window or 0), float(scale or d ** -0.5), float(softcap or 0.0),
                torch.cuda.current_stream().cuda_stream)

        def call():
            rc = fn(*args)
            cs.check(rc == 0, f"flash backward entry failed ({rc})")
        return call, (dq, dk, dv)

    def ssd(self, x, dt, A, B, C):
        """The SSD interface (fp32 dt and A, no initial state)."""
        b, s, h, p = x.shape
        g, n = B.shape[2], B.shape[3]
        y = torch.empty_like(x)
        state = torch.empty((b, h, p, n), dtype=torch.float32, device="cuda")
        st = (ctypes.c_longlong * 12)(*x.stride()[:3], *dt.stride(), *B.stride()[:3],
                                      *C.stride()[:3])
        rc = self.lib.dco_ssd_scan(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(), None,
            y.data_ptr(), state.data_ptr(), 0 if x.dtype == torch.bfloat16 else 1,
            b, s, h, g, p, n, st, torch.cuda.current_stream().cuda_stream)
        cs.check(rc == 0, f"baseline ssd launch failed ({rc})")
        return y, state


def in_turns(new, old, flush, key=""):
    """``new`` and ``old`` timed old, new, new, old."""
    turns = [cs.time_ms(fn, flush) for fn in (old, new, new, old)]
    return {f"ms{key}_in_turns": (turns[1] + turns[2]) / 2,
            f"baseline_ms{key}": (turns[0] + turns[3]) / 2, f"turns_ms{key}": turns}


def host_us(fn, calls=200):
    """Host microseconds a call of ``fn``: ``calls`` calls back to back on
    the host clock, the device synchronised only before and after (the
    launch queue holds them all, so the device's time does not enter)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def host_in_turns(new, old):
    """``host_us`` of ``new`` and ``old``, timed old, new, new, old."""
    turns = [host_us(fn) for fn in (old, new, new, old)]
    return (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2


def flash_cases():
    """(name, B, S, H, G, D, options, lse, positions mode) of each timed flash call."""
    cases = []
    for path, (h, g, d) in cs.ATTN_SHAPES.items():
        timed = cs.ATTN_TIMED.get(path, {})
        kw = {k: timed[k] for k in ("softcap", "scale") if k in timed}
        if "window" in timed:
            kw["window"] = timed["window"]
        for s in (1024, 256):
            cases.append((f"{path} {s}", 1, s, h, g, d, kw, False, None))
        if path == "gemma2-27b":
            for local in (True, False):
                kw5 = dict(kw) if local else {k: v for k, v in kw.items() if k != "window"}
                layer = "local" if local else "global"
                cases.append((f"{path} 5120 {layer}", 1, 5120, h, g, d, kw5, False, None))
                cases.append((f"{path} 5120 {layer} no softcap", 1, 5120, h, g, d,
                              {k: v for k, v in kw5.items() if k != "softcap"}, False, None))
    for key in ("train", "train_hybrid", "train_gemma2", "train_gemma7b"):
        shape = cs.BWD_SHAPES[key]
        kw = {k: shape[k] for k in ("scale", "softcap", "window") if k in shape}
        cases.append((f"{key} forward with the LSE", shape["b"], shape["s"], shape["h"],
                      shape["g"], shape["d"], kw, True, None))
    h, g, d = cs.ATTN_SHAPES["qwen2-vl-7b"]
    for mode in ("prefill", "forward"):
        cases.append((f"qwen2-vl-7b 1024 positions, {mode} mode", 1, 1024, h, g, d, {}, False,
                      mode))
    return cases


def flash_compare(base, gen, flush):
    """One line a case of ``flash_cases``: both kernels against the plain
    version, each one's time in turns, at the planner's ``pinned_rows`` and
    with nothing pinned (``ms_unpinned_in_turns``, ``baseline_ms_unpinned``),
    the bound, the library call's time (none with a softcap), the TFLOP/s of
    the visible pairs, and the host microseconds a call (``host_us``): the
    wrapper ``flash_attention`` whole, and each library's C entry alone in
    turns (``entry``, ``baseline_entry``), which for this tree's kernel
    encodes its three tensor maps."""
    from repro_torch.core.orchestrator import CacheOrchestrator
    from repro_torch.core.orchestrator import FLASH_TILE_ROWS
    from repro_torch.core.orchestrator import flash_kv_row_bytes
    from repro_torch.core.orchestrator import hopper_pin_budget_bytes
    from repro_torch.kernels import attention_ref
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import ops
    import torch.nn.functional as F
    bf = torch.bfloat16
    for name, b, s, h, g, d, kw, with_lse, mode in flash_cases():
        q = cs.randn(gen, (b, s, h, d), bf)
        k = cs.randn(gen, (b, s, g, d), bf)
        v = cs.randn(gen, (b, s, g, d), bf)
        pinned = 0 if with_lse or mode == "forward" else CacheOrchestrator(
            vmem_budget_bytes=hopper_pin_budget_bytes(d, 2)).plan_kv_split(
                s, FLASH_TILE_ROWS, flash_kv_row_bytes(d, 2))[0]
        pos = None
        at_rows = mode == "prefill"
        if mode:
            pos = (torch.arange(s, device="cuda", dtype=torch.int32) + cs.POS_SHIFT)[None]
            pos = pos.expand(b, s).contiguous()
        lse = torch.empty((b, h, s), dtype=torch.float32, device="cuda") if with_lse else None
        opts = dict(pinned_rows=pinned, positions=pos, keys_at_rows=at_rows, **kw)

        def new():
            if with_lse:
                return cs.flash_lse(q, k, v, pinned_rows=pinned, **kw)[0]
            return flash_attention(q, k, v, **opts)

        def old():
            return base.flash(q, k, v, lse=lse, **opts)

        ref = attention_ref(q, k, v, q_positions=pos, kv_positions=None if at_rows else pos,
                            **kw)
        err = cs.close(new(), ref, cs.TOL[bf], f"flash {name}")
        base_err = cs.close(old(), ref, cs.TOL[bf], f"baseline flash {name}")
        del ref
        seen = (cs.visible_by_tables(pos, at_rows, s, kw.get("window")) if mode else None)
        rows = torch.arange(s, device="cuda")
        if seen is None:
            seen = rows[None, :] <= rows[:, None]
            if kw.get("window"):
                seen &= rows[None, :] > rows[:, None] - kw["window"]
            seen = seen[None]
        n_seen = int(seen.expand(b, s, s).sum())
        n_flops = 4 * n_seen * d * h
        n_bytes = 2 * (2 * q.numel() + 2 * k.numel()) + (4 * b * h * s if with_lse else 0)
        t_bytes, t_ops = n_bytes / cs.PEAK_BYTES * 1e3, n_flops / cs.PEAK_FLOPS[bf] * 1e3
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        lib_ms = None
        if not kw.get("softcap"):
            mask = dict(is_causal=True) if not mode and not kw.get("window") else dict(
                attn_mask=seen[:, None])
            lib_ms = cs.time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, enable_gqa=True, scale=kw.get("scale"), **mask), flush)
        rec = {"shape_name": name, "B": b, "S": s, "H": h, "G": g, "D": d,
               "options": {x: y for x, y in kw.items()}, "lse": with_lse, "positions": mode,
               "pinned_rows": pinned, "visible_pairs": n_seen, "max_abs_err": err,
               "baseline_max_abs_err": base_err,
               **in_turns(new, old, flush), "library_ms": lib_ms,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        if pinned:
            unpinned = dict(opts, pinned_rows=0)
            rec.update(in_turns(lambda: flash_attention(q, k, v, **unpinned),
                                lambda: base.flash(q, k, v, lse=lse, **unpinned), flush,
                                "_unpinned"))
        tiles = ops.tiles_per_chunk_for(b, g, s, base.sms, ops.q_tile_rows(h // g, 2, d))
        entry_kw = dict(opts, lse=lse)
        entry_new = base.flash_entry(ops._kernel(), q, k, v, tiles=tiles, **entry_kw)[0]
        entry_old = base.flash_entry(base.lib.dco_flash_attention, q, k, v, tiles=tiles,
                                     **entry_kw)[0]
        entry, baseline_entry = host_in_turns(entry_new, entry_old)
        rec["host_us"] = {"wrapper": host_us(new), "entry": entry,
                          "baseline_entry": baseline_entry}
        rec["tflops"] = n_flops / rec["ms_in_turns"] * 1e-9
        rec["baseline_tflops"] = n_flops / rec["baseline_ms"] * 1e-9
        # this tree's kernel at other Q tiles a chunk: one, two, a pair's all
        n_q = -(-s // ops.q_tile_rows(h // g, 2, d))
        rec["tiles_per_chunk"] = tiles
        rec["ms_at_tiles_per_chunk"] = {str(tpc): cs.time_ms(
            lambda tpc=tpc: cs.flash_lse(q, k, v, pinned_rows=pinned, tiles_per_chunk=tpc, **kw)
            if with_lse else flash_attention(q, k, v, tiles_per_chunk=tpc, **opts), flush)
            for tpc in sorted({1, min(2, n_q), n_q})}
        print(json.dumps(rec), flush=True)
        del q, k, v, seen


def device_ms(fn, calls=5):
    """Device milliseconds of one ``fn()`` by ``torch.profiler``, the kernels
    and memsets of ``calls`` calls over ``calls`` (no host time between them:
    a call whose host time exceeds its device time is timed on the host by
    ``chip_smoke.time_ms_events``): (the sum, {kernel name: ms})."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA],
                                acc_events=True) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    per = {}
    for ev in prof.key_averages():
        if ev.device_time_total > 0:   # a kernel's name without its template and arguments
            name = ev.key.split("<")[0].split("::")[-1].split("(")[0][:60] or ev.key[:60]
            per[name] = per.get(name, 0.0) + ev.device_time_total / 1000 / calls
    return sum(per.values()), per


def flash_bwd_cases():
    """(name, shape, positions pattern) of each timed backward call: every
    training shape of ``chip_smoke.BWD_SHAPES``, and llama3.2-3b's with the
    shifted table of ``chip_smoke.flash_bwd_pos_record``."""
    return [(key, shape, None) for key, shape in cs.BWD_SHAPES.items()] + [
        ("train with positions", cs.TRAIN_SHAPE, "shifted")]


def flash_bwd_compare(base, gen, flush):
    """One line a case of ``flash_bwd_cases``: both backwards against the
    plain version on the forward kernel's O and LSE (``chip_smoke.grad_err``),
    this tree's checked bit-identical over two calls, each one's time in
    turns (old, new, new, old; ``chip_smoke.time_ms_events``), the library's
    ``autograd.grad`` through ``scaled_dot_product_attention`` (without the
    softcap where the shape has one; a window that binds, or the table, as
    its boolean mask), the bound (``chip_smoke.flash_bwd_record``'s: five
    products of 2 D FLOP a visible pair and query head against the bytes
    moved once), TFLOP/s of those five products, and the host microseconds a
    call: the wrapper ``flash_attention_bwd`` whole, and each library's C
    entry alone in turns."""
    from repro_torch.kernels import attention_bwd_ref
    from repro_torch.kernels import flash_attention_bwd
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import _mask
    import torch.nn.functional as F
    bf = torch.bfloat16
    for name, shape, pattern in flash_bwd_cases():
        b, s, h, g, d = (shape[x] for x in ("b", "s", "h", "g", "d"))
        kw = {x: shape[x] for x in ("scale", "softcap", "window") if x in shape}
        q = cs.randn(gen, (b, s, h, d), bf)
        k = cs.randn(gen, (b, s, g, d), bf)
        v = cs.randn(gen, (b, s, g, d), bf)
        do = cs.randn(gen, (b, s, h, d), bf)
        pos = cs.position_tables(pattern, b, s)[0] if pattern else None
        o, lse = cs.flash_lse(q, k, v, positions=pos, **kw)

        def new():
            return flash_attention_bwd(q, k, v, o, lse, do, positions=pos, **kw)

        old_call, old_out = base.flash_bwd_entry(base.lib.dco_flash_attention_bwd, q, k, v, o,
                                                 lse, do, pos, **kw)

        def old():
            old_call()
            return old_out

        want = attention_bwd_ref(q, k, v, o, lse, do, q_positions=pos, kv_positions=pos, **kw)
        got = new()
        again = flash_attention_bwd(q, k, v, o, lse, do, positions=pos, **kw)
        torch.cuda.synchronize()
        identical = all(torch.equal(a, c) for a, c in zip(got, again))
        cs.check(identical, f"flash bwd {name}: two calls differ")
        held = {n: cs.close_grad(a, r, cs.TOL[bf], f"flash bwd {name} {n}")[0]
                for n, a, r in zip(("dq", "dk", "dv"), got, want)}
        base_held = {n: cs.close_grad(a, r, cs.TOL[bf], f"baseline flash bwd {name} {n}")[0]
                     for n, a, r in zip(("dq", "dk", "dv"), old(), want)}
        del got, again, want
        window = kw.get("window")
        if pattern:   # the pairs of every batch row
            seen = cs.visible_by_tables(pos, False, s)
            n_seen = int(seen.sum())
            lib_kw = dict(attn_mask=seen[:, None])
        else:
            n_seen = cs.visible_pairs(s, window) * b
            lib_kw = (dict(attn_mask=_mask(s, s, True, window, q.device))
                      if window and window < s else dict(is_causal=True))
        ql, kl, vl = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(ql, kl, vl, scale=kw.get("scale"),
                                                 enable_gqa=True, **lib_kw)
        dol = do.transpose(1, 2)
        n_flops = 10 * d * n_seen * h
        n_bytes = (2 * (3 * q.numel() + 2 * k.numel()) + 4 * lse.numel()
                   + 2 * (q.numel() + 2 * k.numel()) + (4 * pos.numel() if pattern else 0))
        t_bytes, t_ops = n_bytes / cs.PEAK_BYTES * 1e3, n_flops / cs.PEAK_FLOPS[bf] * 1e3
        turns = [cs.time_ms_events(fn, flush) for fn in (old, new, new, old)]
        ms, base_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
        entry_new = base.flash_bwd_entry(ops._kernel("dco_flash_attention_bwd"), q, k, v, o,
                                         lse, do, pos, **kw)[0]
        entry, baseline_entry = host_in_turns(entry_new, old_call)
        rec = {"shape_name": name, "B": b, "S": s, "H": h, "G": g, "D": d,
               "options": kw, "positions": pattern, "visible_pairs": n_seen,
               "worst_ratio": held, "baseline_worst_ratio": base_held,
               "bit_identical_over_two_calls": identical,
               "ms_in_turns": ms, "baseline_ms": base_ms, "turns_ms": turns,
               "speedup": base_ms / ms,
               "library_ms": cs.time_ms_events(lambda: torch.autograd.grad(
                   lib_out, (ql, kl, vl), dol, retain_graph=True), flush),
               "library_note": "without the softcap" if kw.get("softcap") else None,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "tflops": n_flops / ms * 1e-9, "baseline_tflops": n_flops / base_ms * 1e-9,
               "host_us": {"wrapper": host_us(new), "entry": entry,
                           "baseline_entry": baseline_entry}}
        rec["device_ms"], rec["kernels_ms"] = device_ms(new)
        rec["library_device_ms"], rec["library_kernels_ms"] = device_ms(
            lambda: torch.autograd.grad(lib_out, (ql, kl, vl), dol, retain_graph=True))
        rec["vs_library"] = ms / rec["library_ms"]
        print(json.dumps(rec), flush=True)
        del q, k, v, do, o, lse, ql, kl, vl, lib_out


def bwd_ptxas(base):
    """Registers and spills of both builds' backward kernels (``-Xptxas -v``):
    {"new": {kernel: usage}, "baseline": {...}}."""
    from repro_torch.kernels import build
    logs = {"new": Path(build.build(verbose=True)).with_suffix(".log"),
            "baseline": Path(base.path).with_suffix(".log")}
    return {which: {n: u for n, u in cs.ptxas_usage(path.read_text()).items()
                    if "dkdv" in n or "dq_" in n or "delta_kernel" in n}
            for which, path in logs.items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", metavar="DIR", required=True,
                    help="directory holding the earlier kernels' sources")
    ap.add_argument("--kernel", choices=("decode", "ssd", "both", "flash", "flash_bwd"),
                    default="both")
    ap.add_argument("--baseline-chunks", choices=("mma_sync", "this_tree"), default="mma_sync",
                    help="flash: the Q tiles a chunk of the earlier kernel, as the mma.sync "
                         "kernel of commit ba0963a chose them, or as this tree's wrapper "
                         "does (an earlier tree on TMA and wgmma)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_compare: needs a CUDA device")
    from repro_torch.kernels import decode_attention
    from repro_torch.kernels import decode_attention_ref
    from repro_torch.kernels import ssd_ref
    from repro_torch.kernels import ssd_scan
    torch.backends.cuda.matmul.allow_tf32 = False   # as chip_smoke.py's device phase
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    base = Baseline(args.baseline, verbose=args.kernel == "flash_bwd", chunks=args.baseline_chunks)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    bf, f32 = torch.bfloat16, torch.float32
    if args.kernel in ("decode", "both"):
        for name, lens in DECODE_SHAPES.items():
            q, k, v, cl = cs.decode_inputs(gen, lens, *cs.ATTN_SHAPES["llama3.2-3b"])
            rec = cs.decode_record(q, k, v, cl, flush)
            cs.close(base.decode(q, k, v, cl), decode_attention_ref(q, k, v, cl), cs.TOL[bf],
                     f"baseline decode at {name}")
            rec.update(in_turns(lambda: decode_attention(q, k, v, cl),
                                lambda: base.decode(q, k, v, cl), flush))
            rec["ms_fixed_rows"] = {str(r): cs.time_ms(
                lambda: decode_attention(q, k, v, cl, rows_per_split=r), flush)
                for r in FIXED_ROWS}
            print(json.dumps({"shape_name": name, **rec}), flush=True)
    if args.kernel in ("ssd", "both"):
        for s in cs.SSD_PROMPTS:
            x, dt, A, B, C = cs.ssd_inputs(gen, 1, s, 80, 1, 64, 128, f32)
            chunk = min(256, s)
            rec = cs.ssd_record(x, dt, A, B, C, chunk, flush)
            y_ref, st_ref = ssd_ref(x, dt, A, B, C, chunk)
            yb, stb = base.ssd(x, dt, A, B, C)
            cs.close(yb, y_ref, cs.SSD_TOL[f32], "baseline ssd vs plain")
            cs.close(stb, st_ref, cs.SSD_TOL[f32], "baseline ssd state vs plain")
            rec.update(in_turns(lambda: ssd_scan(x, dt, A, B, C, chunk=chunk),
                                lambda: base.ssd(x, dt, A, B, C), flush))
            print(json.dumps(rec), flush=True)
    if args.kernel == "flash":
        flash_compare(base, gen, flush)
    if args.kernel == "flash_bwd":
        print(json.dumps({"ptxas": bwd_ptxas(base)}), flush=True)
        flash_bwd_compare(base, gen, flush)


if __name__ == "__main__":
    main()
