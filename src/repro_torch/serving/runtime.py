"""Continuous-batching runtime over the paged multi-LoRA engine (port of
the main path of ``repro/serving/runtime.py``).

The decode dispatch has fixed shapes — (num_slots,) tokens / positions /
adapters and a (num_slots, max_blocks) block table — and requests join and
leave by mutating host-side numpy mirrors.  Decode runs in chunks of
``decode_chunk`` tokens; slots join/leave at chunk boundaries.

Join path (chunked paged prefill): each prompt is processed in fixed
``prefill_chunk``-sized slices, ``prefill_rows`` prompts side by side,
writing K/V straight into the slot's pool blocks through the block table.
The chunk loop starts at the first prefix-cache-uncovered token, so blocks
shared with earlier requests skip compute as well as writes.

Leave path: EOS / token budget exhausted -> block refcounts drop; the last
holder actually frees.  If the pool runs dry mid-flight a slot *stalls*:
it still runs the chunk from its current (token, pos) — writes into
allocated blocks are identical to what the resume writes, writes past the
table land in the garbage block — but its outputs are discarded.  If every
slot stalls, the stalled slot closest to completion is force-evicted.

The kernels update the KV pools IN PLACE; that is the port's stand-in for
the reference's ``donate_argnums`` on the two jitted dispatches.  Every
measurement uses the injectable ``timer`` with the reference's exact
sequence of timer readings, so a replay under a deterministic fake clock
takes the same scheduling decisions as the reference's.

Not ported yet (see ROADMAP.md): the ``AdapterRegistry`` (adapters here
are raw bank slots), preemption, ``abort``, deadline shedding, fault
plans, sliding-window reclamation, compile guards and CUDA-graph capture
of the two dispatches, and REC/SSD slot state.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.engine import (make_chunked_prefill_step,
                                     make_sampled_serve_step)
from repro_torch.core.lora import partition_lora, tree_leaves
from repro_torch.core.sampling import (GREEDY, MODES, SamplingParams,
                                       sample_tokens)
from repro_torch.models.cache import (GARBAGE_BLOCK, init_paged_cache,
                                      paging_unsupported_reason)
from repro_torch.models.config import ModelConfig
from repro_torch.serverless.batching import Request
from repro_torch.serving.kv_pool import BlockPool, blocks_for_tokens
from repro_torch.serving.metrics import MetricsRegistry
from repro_torch.serving.prefix import PrefixCache
from repro_torch.serving.slots import SlotState, SlotTable
from repro_torch.serving.telemetry import Telemetry, host_bubble_fraction


@dataclasses.dataclass(frozen=True)
class PrefillConfig:
    """Chunked paged prefill — the join path's one dispatch shape."""
    chunk: int = 32                  # tokens per dispatch (whole blocks)
    rows: int = 4                    # prompts advanced side by side


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    """The fixed-shape decode loop."""
    chunk: int = 4                   # tokens per decode dispatch
    eos_id: Optional[int] = None


@dataclasses.dataclass(frozen=True, init=False)
class ServingConfig:
    """Runtime shape + policy knobs.  Construct with nested groups
    (``prefill=PrefillConfig(chunk=64)``) or the flat kwargs
    (``prefill_chunk=64``) — not both for one group."""
    num_slots: int = 8
    block_size: int = 16
    num_blocks: int = 64             # physical blocks incl. the garbage block
    max_blocks_per_slot: int = 8
    prefix_sharing: bool = True      # map full prompt blocks shared with
    #   earlier same-adapter requests (refcounted) and skip their compute
    prefill: PrefillConfig = PrefillConfig()
    decode: DecodeConfig = DecodeConfig()

    _FLAT = {
        "prefill_chunk": ("prefill", "chunk"),
        "prefill_rows": ("prefill", "rows"),
        "decode_chunk": ("decode", "chunk"),
        "eos_id": ("decode", "eos_id"),
    }
    _GROUPS = {"prefill": PrefillConfig, "decode": DecodeConfig}

    def __init__(self, num_slots: int = 8, block_size: int = 16,
                 num_blocks: int = 64, max_blocks_per_slot: int = 8,
                 prefix_sharing: bool = True,
                 prefill: Optional[PrefillConfig] = None,
                 decode: Optional[DecodeConfig] = None, **flat: Any):
        groups: Dict[str, Any] = {"prefill": prefill, "decode": decode}
        over: Dict[str, Dict[str, Any]] = {g: {} for g in self._GROUPS}
        for k, v in flat.items():
            if k not in self._FLAT:
                raise TypeError(
                    f"ServingConfig got an unexpected keyword {k!r}")
            g, f = self._FLAT[k]
            if groups[g] is not None:
                raise ValueError(
                    f"pass {g}=... or the flat kwarg {k!r}, not both")
            over[g][f] = v
        for g, cls_ in self._GROUPS.items():
            if groups[g] is None:
                groups[g] = cls_(**over[g])
        for name, val in (("num_slots", num_slots),
                          ("block_size", block_size),
                          ("num_blocks", num_blocks),
                          ("max_blocks_per_slot", max_blocks_per_slot),
                          ("prefix_sharing", prefix_sharing),
                          ("prefill", groups["prefill"]),
                          ("decode", groups["decode"])):
            object.__setattr__(self, name, val)

    @property
    def prefill_chunk(self) -> int:
        return self.prefill.chunk

    @property
    def prefill_rows(self) -> int:
        return self.prefill.rows

    @property
    def decode_chunk(self) -> int:
        return self.decode.chunk

    @property
    def eos_id(self) -> Optional[int]:
        return self.decode.eos_id


@dataclasses.dataclass
class ServeRequest:
    """One admission-ready request.  ``adapter`` is a raw bank slot
    (``None`` means slot 0); ``request`` carries the trace record when the
    caller has one, else a fresh ``Request`` is synthesized."""
    prompt: Any                      # (L,) int token ids (np/list)
    adapter: Optional[Any] = None
    arrival: float = 0.0
    max_new_tokens: int = 1
    request: Optional[Request] = None
    slo_class: int = 0
    sampling: Optional[SamplingParams] = None  # None = greedy

    _auto_id = 0

    def ensure_request(self) -> Request:
        if self.request is None:
            ServeRequest._auto_id += 1
            self.request = Request(
                req_id=-ServeRequest._auto_id, fn_id=str(self.adapter),
                arrival=self.arrival, prompt_len=len(self.prompt),
                output_len=max(int(self.max_new_tokens), 1),
                slo_ttft=float("inf"), slo_class=int(self.slo_class))
        return self.request


@dataclasses.dataclass
class AdmitResult:
    slot_ids: List[int]              # bound slot per admitted item; -1 =
    #   finished at prefill, never bound
    first_tokens: List[int]
    finished: List[SlotState]
    dt: float                        # total prefill wall time this admit
    shared_blocks: List[int] = dataclasses.field(default_factory=list)
    rejected: List[Request] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class DecodeResult:
    emitted: Dict[int, List[int]]    # sid -> tokens accepted this chunk
    finished: List[SlotState]
    aborted: List[SlotState]         # force-evicted on pool exhaustion
    stalled: List[int]
    dt: float


_REJECT_FLAGS = ("rejected_too_long", "rejected_unknown_adapter")
_ABORT_FLAGS = ("aborted_oom",)
_ABANDON_FLAGS = ("abandoned",)


def terminal_state(req: Request) -> Optional[str]:
    """Terminal class of a request record — ``"finished"`` /
    ``"rejected"`` / ``"aborted"`` / ``"abandoned"`` — or None while
    unresolved; raises ValueError if the flags put it in several."""
    rejected = any(f in req.breakdown for f in _REJECT_FLAGS)
    aborted = any(f in req.breakdown for f in _ABORT_FLAGS)
    abandoned = any(f in req.breakdown for f in _ABANDON_FLAGS)
    finished = (req.first_token >= 0 and req.done >= 0
                and not (aborted or abandoned))
    hit = [name for name, is_hit in (
        ("rejected", rejected), ("aborted", aborted),
        ("abandoned", abandoned), ("finished", finished)) if is_hit]
    if len(hit) > 1:
        raise ValueError(
            f"request {req.req_id} is in {len(hit)} terminal states at "
            f"once: {hit} (breakdown flags {sorted(req.breakdown)})")
    return hit[0] if hit else None


class ContinuousRuntime:
    def __init__(self, cfg: ModelConfig, params, scfg: ServingConfig, *,
                 device="cuda", telemetry: Optional[Telemetry] = None,
                 timer: Callable[[], float] = time.perf_counter):
        """``params`` must already live on ``device``.  ``timer`` is the
        wall clock for every latency measurement (injectable for
        deterministic replays); ``telemetry`` attaches a span recorder."""
        reason = paging_unsupported_reason(cfg)
        if reason is not None:
            raise ValueError(reason)
        if scfg.prefill_chunk < scfg.block_size \
                or scfg.prefill_chunk % scfg.block_size:
            raise ValueError(
                f"prefill_chunk {scfg.prefill_chunk} must be a positive "
                f"multiple of block_size {scfg.block_size}")
        if scfg.prefill_rows < 1:
            raise ValueError("prefill_rows must be >= 1")
        self.cfg = cfg
        self.params = params
        self.scfg = scfg
        self.device = torch.device(device)
        self.pool = BlockPool(scfg.num_blocks, scfg.block_size)
        self.slots = SlotTable(scfg.num_slots, scfg.max_blocks_per_slot)
        self.cache = init_paged_cache(cfg, scfg.num_blocks, scfg.block_size,
                                      device=self.device)
        self.prefix: Optional[PrefixCache] = None
        if scfg.prefix_sharing:
            self.prefix = PrefixCache(scfg.block_size)
            self.pool.cache_hook = self.prefix.has_block
            self.pool.evict_hook = self.prefix.forget_block
        self.telemetry = telemetry
        self._timer = timer
        self.metrics = MetricsRegistry()
        for name, help_ in (
            ("prompt_tokens", "tokens in admitted prompts"),
            ("prefill_tokens", "prompt tokens newly written into the pool"),
            ("recomputed_tokens", "prompt tokens run through prefill"),
            ("shared_tokens", "prompt tokens covered by shared blocks"),
            ("shared_block_maps", "table entries mapped via sharing"),
            ("prefill_chunks", "chunked-prefill dispatches"),
            ("decode_chunks", "decode-chunk dispatches"),
            ("stall_steps", "slot-chunks discarded on pool exhaustion"),
            ("rejected_too_long", "requests dropped: prompt + output "
             "exceed slot KV capacity"),
            ("rejected_unknown_adapter", "requests dropped at admission: "
             "bank slot out of range"),
            ("admit_syncs", "deliberate device reads during admission"),
            ("aborted", "in-flight requests force-evicted"),
            ("abandoned", "requests dropped after their TTFT SLO lapsed"),
            ("sampled_tokens", "accepted tokens drawn with temperature > 0"),
        ):
            self.metrics.counter(name, help_)
        for m in MODES:
            self.metrics.counter(f"tokens_mode_{m}",
                                 f"accepted tokens emitted in mode {m!r}")
        self.stats = self.metrics.counter_view()
        # multi-LoRA bank capacity N off the stacked lora leaves (adapter
        # axis -3); None = backbone only (only adapter 0/None admits)
        leaves = tree_leaves(partition_lora(params)[1])
        self.bank_slots: Optional[int] = (
            int(leaves[0].shape[-3]) if leaves else None)
        self._dispatch_windows: List[Tuple[float, float]] = []
        self._serve = make_sampled_serve_step(cfg)
        self._chunk_step = make_chunked_prefill_step(cfg)

    # ------------------------------------------------------------ dispatches
    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.tensor(a, device=self.device)

    @torch.no_grad()
    def _decode(self, tok, pos, tbl, ai, temp, top_k, top_p, seed,
                counter) -> torch.Tensor:
        """The fixed-shape decode loop: ``decode_chunk`` steps, each with
        the sampling epilogue; the RNG counter advances by one per emitted
        token.  Sampling vectors are host arrays.  Returns (B, chunk)
        tokens on the device."""
        tok, pos, tbl, ai = (self._dev(tok), self._dev(pos), self._dev(tbl),
                             self._dev(ai))
        out = []
        for i in range(self.scfg.decode_chunk):
            tok, self.cache = self._serve(
                self.params, tok, self.cache, pos + i, adapter_idx=ai,
                block_tbl=tbl, temperature=temp, top_k=top_k, top_p=top_p,
                seed=seed, counter=counter + i)
            out.append(tok)
        return torch.stack(out, dim=1)

    @torch.no_grad()
    def _prefill(self, tokens, start, last_idx, ai, chunk_ids, tbl, temp,
                 top_k, top_p, seed) -> torch.Tensor:
        """ONE slice of the join path: write this chunk's K/V into pool
        blocks and sample the first output token from the logit at
        ``last_idx`` with RNG counter 0.  Returns (G,) tokens on the
        device."""
        logits, self.cache = self._chunk_step(
            self.params, self._dev(tokens), self._dev(start),
            self._dev(last_idx), self.cache, self._dev(chunk_ids),
            self._dev(tbl), adapter_idx=self._dev(ai))
        return sample_tokens(logits, temp, top_k, top_p, seed,
                             np.zeros_like(seed))

    # ------------------------------------------------------------ capacity
    def max_output_for(self, prompt_len: int) -> int:
        cap = self.scfg.max_blocks_per_slot * self.scfg.block_size
        return cap - prompt_len + 1        # last KV write is L + out - 2

    def fits(self, prompt_len: int, output_len: int) -> bool:
        """The last KV write (position prompt_len + output_len - 2) must
        land inside max_blocks_per_slot."""
        if prompt_len < 1 or output_len < 1:
            return False
        return output_len <= self.max_output_for(prompt_len)

    def admit_cost_blocks(self, prompt_len: int, output_len: int = 2) -> int:
        extra = 1 if output_len > 1 else 0
        return blocks_for_tokens(prompt_len + extra, self.scfg.block_size)

    def reject_too_long(self, req: Request) -> None:
        """Count a capacity rejection once per request and flag it."""
        if "rejected_too_long" not in req.breakdown:
            self.stats["rejected_too_long"] += 1
        req.breakdown["rejected_too_long"] = 1.0

    def reject_unknown_adapter(self, req: Request) -> None:
        if "rejected_unknown_adapter" not in req.breakdown:
            self.stats["rejected_unknown_adapter"] += 1
        req.breakdown["rejected_unknown_adapter"] = 1.0

    def _resolve_adapter(self, adapter) -> Optional[int]:
        """Raw bank slot -> validated slot, or None if it cannot be
        served.  Adapter names need the AdapterRegistry (not ported)."""
        if adapter is None:
            adapter = 0
        if isinstance(adapter, str):
            raise ValueError(
                f"adapter name {adapter!r} needs an AdapterRegistry, which "
                f"the PyTorch runtime does not have yet; pass a bank slot")
        slot = int(adapter)
        if self.bank_slots is None:
            return slot if slot == 0 else None
        if not 0 <= slot < self.bank_slots:
            return None
        return slot

    def _coerce_admit_items(self, items: Sequence[ServeRequest]) -> Tuple[
            List[Tuple[Request, np.ndarray, int, SamplingParams, int]],
            List[Request]]:
        out: List[Tuple[Request, np.ndarray, int, SamplingParams, int]] = []
        rejected: List[Request] = []
        for it in items:
            req = it.ensure_request()
            sp = it.sampling if it.sampling is not None else GREEDY
            slot = self._resolve_adapter(it.adapter)
            if slot is None:
                self.reject_unknown_adapter(req)
                rejected.append(req)
                continue
            out.append((req, np.asarray(it.prompt), slot, sp,
                        sp.resolve_seed(req.req_id)))
        return out, rejected

    # ----------------------------------------------------------- admission
    def _plan_blocks(self, items: Sequence[Tuple]
                     ) -> Optional[Tuple[List[Tuple[List[int], List[int]]],
                                         List[List[int]]]]:
        """Per item, (shared prefix blocks, freshly allocated blocks), plus
        the blocks each item newly registered in the prefix index.
        Sequential with rollback; None (pool restored) if any item's fresh
        allocation cannot be covered."""
        plans: List[Tuple[List[int], List[int]]] = []
        registered: List[List[int]] = []
        for req, prompt, adapter, *_ in items:
            need = self.admit_cost_blocks(len(prompt), req.output_len)
            shared: List[int] = []
            node = None
            if self.prefix is not None:
                shared, node = self.prefix.match(adapter, prompt)
                self.pool.share(shared)
            fresh = self.pool.alloc(need - len(shared))
            if fresh is None:
                if shared:
                    self.pool.free(shared)
                for plan, reg in zip(reversed(plans), reversed(registered)):
                    for b in reg:
                        self.prefix.forget_block(b)
                    if plan[1]:
                        self.pool.free(plan[1])
                    if plan[0]:
                        self.pool.free(plan[0])
                return None
            reg: List[int] = []
            if self.prefix is not None:
                reg = self.prefix.register(adapter, prompt, shared + fresh,
                                           len(shared), node)
            plans.append((shared, fresh))
            registered.append(reg)
        return plans, registered

    def _chunk_prefill(self, items: Sequence[Tuple[np.ndarray, int,
                                                   List[int], int, int,
                                                   SamplingParams, int]]
                       ) -> List[int]:
        """Advance up to ``prefill_rows`` prompts' chunk loops side by side,
        one fixed (prefill_rows, prefill_chunk) dispatch per round; rows
        that finished early and unused rows ride along as garbage rows.
        Each item is (prompt, adapter, blocks, covered_blk, sid, sampling,
        seed).  Returns the per-item first output tokens."""
        scfg = self.scfg
        bs, C = scfg.block_size, scfg.prefill_chunk
        G, MB = scfg.prefill_rows, scfg.max_blocks_per_slot
        assert 0 < len(items) <= G
        starts: List[List[int]] = []
        temp = np.zeros((G,), np.float32)
        top_k = np.zeros((G,), np.int32)
        top_p = np.ones((G,), np.float32)
        seed = np.zeros((G,), np.int32)
        for i, (prompt, _, _, cov, _, sp, sd) in enumerate(items):
            L = len(prompt)
            start_tok = min(cov * bs, ((L - 1) // bs) * bs)
            starts.append(list(range(start_tok, L, C)))
            self.stats["recomputed_tokens"] += L - start_tok
            temp[i] = sp.temperature
            top_k[i] = sp.top_k
            top_p[i] = sp.top_p
            seed[i] = sd
        nb_c = C // bs
        final_rounds = {len(s) - 1 for s in starts}
        toks_by_round: Dict[int, torch.Tensor] = {}
        for r in range(max(len(s) for s in starts)):
            tok = np.zeros((G, C), np.int32)
            start = np.zeros((G,), np.int32)
            last_idx = np.zeros((G,), np.int32)
            ai = np.zeros((G,), np.int32)
            ids = np.full((G, nb_c), GARBAGE_BLOCK, np.int32)
            tbl = np.full((G, MB), -1, np.int32)
            for i, (prompt, adapter, blocks, cov, _, _, _) \
                    in enumerate(items):
                if r >= len(starts[i]):
                    continue             # finished: garbage row
                c0 = starts[i][r]
                L = len(prompt)
                n_real = min(C, L - c0)
                tok[i, :n_real] = prompt[c0:c0 + n_real]
                start[i] = c0
                last_idx[i] = min(max(L - 1 - c0, 0), C - 1)
                ai[i] = adapter
                tbl[i, : len(blocks)] = blocks
                for jj in range(nb_c):
                    j = c0 // bs + jj
                    # skip shared blocks (already hold these K/V) and
                    # out-of-range blocks (chunk-tail junk)
                    if cov <= j < len(blocks):
                        ids[i, jj] = blocks[j]
            first = self._prefill(tok, start, last_idx, ai, ids, tbl, temp,
                                  top_k, top_p, seed)
            if r in final_rounds:
                toks_by_round[r] = first
            self.stats["prefill_chunks"] += 1
        # one whole-batch device read per final round, then index on host
        self.stats["admit_syncs"] += len(toks_by_round)
        synced: Dict[int, np.ndarray] = {
            r: t.cpu().numpy()  # reprolint: sync-point (token emission)
            for r, t in toks_by_round.items()}
        return [int(synced[len(starts[i]) - 1][i]) for i in range(len(items))]

    def try_admit(self, items: Sequence[ServeRequest]
                  ) -> Optional[AdmitResult]:
        """Join ``ServeRequest`` items into free slots.

        Unserveable items are dropped, flagged and reported in
        ``AdmitResult.rejected`` (oversized prompts, out-of-range bank
        slots); the per-item result lists align with the surviving items.
        All-or-nothing for the survivors: returns None (no state change
        beyond rejection counts and prefix-cache eviction) if slots or
        blocks are short.  Prefix sharing maps each item's longest chain of
        already-indexed full prompt blocks and starts its chunk loop past
        them."""
        assert len(items) > 0
        resolved, rejected = self._coerce_admit_items(items)
        kept: List[Tuple[Request, np.ndarray, int, SamplingParams, int]] \
            = []
        for it in resolved:
            req, prompt = it[0], it[1]
            if self.fits(len(prompt), max(req.output_len, 1)):
                kept.append(it)
            else:
                self.reject_too_long(req)
                rejected.append(req)
        if not kept:
            return AdmitResult([], [], [], 0.0, rejected=rejected)
        scfg = self.scfg
        free = self.slots.free_slots()
        if len(kept) > len(free):
            return None
        planned = self._plan_blocks(kept)
        if planned is None:
            return None
        plans, registered = planned

        # an item sharing a block a groupmate registered in this very call
        # must wait for that groupmate's writes: it runs in its own
        # dispatch afterwards
        group_reg: set = set()
        independent: List[int] = []
        dependent: List[int] = []
        for i in range(len(kept)):
            if group_reg & set(plans[i][0]):
                dependent.append(i)
            else:
                independent.append(i)
            group_reg.update(registered[i])
        sids = [free[i] for i in range(len(kept))]

        bs = scfg.block_size
        firsts: Dict[int, int] = {}
        total_dt = 0.0
        for batch_idx in ([independent[j:j + scfg.prefill_rows]
                           for j in range(0, len(independent),
                                          scfg.prefill_rows)]
                          + [[i] for i in dependent]):
            if not batch_idx:
                continue
            w0 = self._timer()
            got = self._chunk_prefill(
                [(kept[i][1], kept[i][2], plans[i][0] + plans[i][1],
                  len(plans[i][0]), sids[i], kept[i][3], kept[i][4])
                 for i in batch_idx])
            w1 = self._timer()
            total_dt += w1 - w0
            self._dispatch_windows.append((w0, w1))
            if self.telemetry is not None:
                self.telemetry.record_dispatch("prefill", w0, w1,
                                               rows=len(batch_idx))
            self.metrics.histogram(
                "prefill_dispatch_s",
                "wall seconds per prefill group dispatch").observe(w1 - w0)
            firsts.update(zip(batch_idx, got))

        slot_ids, first_tokens, finished = [], [], []
        for i, (req, prompt, adapter, sp, sd) in enumerate(kept):
            shared, fresh = plans[i]
            L = len(prompt)
            first = firsts[i]
            self.stats["prompt_tokens"] += L
            self.stats[f"tokens_mode_{sp.mode()}"] += 1
            if not sp.greedy:
                self.stats["sampled_tokens"] += 1
            cov = len(shared) * bs
            self.stats["shared_tokens"] += cov
            self.stats["prefill_tokens"] += L - cov
            self.stats["shared_block_maps"] += len(shared)
            sid = sids[i]
            st = SlotState(sid=sid, req=req, adapter=adapter, prompt_len=L,
                           budget=max(req.output_len, 1), pos=L,
                           blocks=shared + fresh, last_token=first,
                           shared=len(shared), sampling=sp, seed=sd)
            first_tokens.append(first)
            done = st.budget == 1 or (scfg.eos_id is not None
                                      and first == scfg.eos_id)
            if done:
                st.sid = -1
                slot_ids.append(-1)
                self.pool.free(st.blocks)
                finished.append(st)
            else:
                slot_ids.append(sid)
                self.slots.bind(st, first)
        self._sample_gauges()
        return AdmitResult(slot_ids, first_tokens, finished, total_dt,
                           shared_blocks=[len(p[0]) for p in plans],
                           rejected=rejected)

    # -------------------------------------------------------------- decode
    def _release_slot(self, st: SlotState) -> None:
        """The exit path for every way a bound slot dies (finish,
        force-evict): release the held blocks."""
        self.pool.free(self.slots.release(st.sid))

    def _ensure_blocks(self) -> Tuple[List[int], List[SlotState]]:
        """On-demand allocation for this chunk's writes; stall on
        shortage.  If every slot stalls, the lowest-class slot closest to
        completion is force-evicted (``aborted_oom``) so the system makes
        progress."""
        scfg, aborted = self.scfg, []
        while True:
            stalled = []
            for s in self.slots.active():
                s.stalled = False
                last_pos = min(s.pos + scfg.decode_chunk - 1,
                               s.prompt_len + s.budget - 2)
                while len(s.blocks) * scfg.block_size <= last_pos:
                    ids = self.pool.alloc(1)
                    if ids is None:
                        s.stalled = True
                        break
                    self.slots.grow(s.sid, ids[0])
                if s.stalled:
                    stalled.append(s)
            if stalled and len(stalled) == self.slots.num_active:
                victim = min(stalled,
                             key=lambda s: (s.req.slo_class,
                                            s.budget - s.produced))
                victim.req.breakdown["aborted_oom"] = 1.0
                self.stats["aborted"] += 1
                self._release_slot(victim)
                aborted.append(victim)
                continue
            return [s.sid for s in stalled], aborted

    def decode(self) -> Optional[DecodeResult]:
        """One fixed-shape decode chunk across every slot (inactive rows
        write to the garbage block and are ignored)."""
        if self.slots.num_active == 0:
            return None
        scfg = self.scfg
        t_plan0 = self._timer()
        stalled, aborted = self._ensure_blocks()
        self.stats["stall_steps"] += len(stalled)
        if self.slots.num_active == 0:      # everything force-evicted
            return DecodeResult({}, [], aborted, stalled, 0.0)

        # stalled slots run the chunk unmodified from (pending token, pos):
        # every position they write is re-written by the resumed chunk
        # before it can be attended, and writes past the table clip to the
        # garbage block — discarding their outputs is a true no-op
        t0 = self._timer()
        toks = self._decode(
            self.slots.tokens, self.slots.pos, self.slots.block_tbl,
            self.slots.adapter, self.slots.temp, self.slots.top_k,
            self.slots.top_p, self.slots.seed, self.slots.rng_counter)
        toks = toks.cpu().numpy()  # reprolint: sync-point — (B, K) token
        #   emission, the serving loop's one deliberate decode sync
        t1 = self._timer()
        dt = t1 - t0
        self.stats["decode_chunks"] += 1
        self._dispatch_windows.append((t0, t1))
        if self.telemetry is not None:
            self.telemetry.record_dispatch(
                "decode", t0, t1, host_plan_s=t0 - t_plan0,
                rows=self.slots.num_active)
        self.metrics.histogram(
            "decode_dispatch_s",
            "wall seconds per decode-chunk dispatch").observe(dt)

        emitted: Dict[int, List[int]] = {}
        finished: List[SlotState] = []
        for s in list(self.slots.active()):
            if s.stalled:
                continue
            remaining = s.budget - s.produced
            accept = toks[s.sid, :remaining]
            eos_hit = False
            if scfg.eos_id is not None:
                hits = np.flatnonzero(accept == scfg.eos_id)
                if hits.size:
                    accept = accept[: hits[0] + 1]
                    eos_hit = True
            emitted[s.sid] = [int(t) for t in accept]
            s.produced += len(accept)
            mode = s.sampling.mode()
            self.stats[f"tokens_mode_{mode}"] += len(accept)
            if mode != "greedy":
                self.stats["sampled_tokens"] += len(accept)
            if eos_hit or s.produced >= s.budget:
                self._release_slot(s)
                finished.append(s)
            else:
                s.pos += scfg.decode_chunk
                s.last_token = int(accept[-1])
                self.slots.pos[s.sid] = s.pos
                self.slots.tokens[s.sid] = s.last_token
                self.slots.rng_counter[s.sid] = s.produced
        self._sample_gauges()
        return DecodeResult(emitted, finished, aborted, stalled, dt)

    # -------------------------------------------------------------- meta
    def check_invariants(self, requests: Optional[Sequence[Request]] = None,
                         *, raise_on_error: bool = True) -> Dict[str, Any]:
        """Audit the books: every block a bound slot maps is live with a
        refcount covering its holders and not parked in the cached LRU;
        with ``requests``, every request ends in exactly one terminal
        class.  Returns a report; raises AssertionError on any violation
        unless ``raise_on_error=False``."""
        problems: List[str] = []
        held: Dict[int, int] = {}
        for s in self.slots.active():
            for b in s.blocks:
                if b >= 0:
                    held[b] = held.get(b, 0) + 1
        for b, n in sorted(held.items()):
            r = self.pool.refcount(b)
            if r < n:
                problems.append(
                    f"block {b}: {n} slot holder(s) but refcount {r}")
            if self.pool.is_cached(b):
                problems.append(
                    f"block {b} parked in the cached LRU while a bound "
                    f"slot still maps it")
        terminal = {"finished": 0, "rejected": 0, "aborted": 0,
                    "abandoned": 0, "unresolved": 0}
        if requests is not None:
            requests = list(requests)
            for r in requests:
                try:
                    cls = terminal_state(r)
                except ValueError as e:
                    problems.append(str(e))
                    continue
                terminal[cls if cls is not None else "unresolved"] += 1
            if terminal["unresolved"]:
                problems.append(
                    f"{terminal['unresolved']} request(s) ended the "
                    f"replay in NO terminal state")
        report = {
            "problems": problems,
            "terminal": terminal,
            "pool": {"live": self.pool.in_use,
                     "cached": self.pool.num_cached,
                     "free": self.pool.num_free},
            "slots_active": self.slots.num_active,
        }
        if problems and raise_on_error:
            raise AssertionError(
                "runtime invariant violation(s): " + "; ".join(problems))
        return report

    def warmup(self) -> Dict[str, Any]:
        """Run each dispatch twice on garbage rows (pool and slots stay
        untouched: warmup writes only the garbage block) and record the
        second run's wall time — the admission scheduler's Eq. 2 seed.
        On the card the first run also builds and loads the kernels."""
        scfg, timings = self.scfg, {}
        C, G = scfg.prefill_chunk, scfg.prefill_rows
        ids = np.full((G, C // scfg.block_size), GARBAGE_BLOCK, np.int32)
        tbl = np.full((G, scfg.max_blocks_per_slot), -1, np.int32)
        zeros = np.zeros((G,), np.int32)
        B = scfg.num_slots
        for _ in range(2):
            t0 = self._timer()
            self._prefill(np.zeros((G, C), np.int32), zeros, zeros, zeros,
                          ids, tbl, np.zeros((G,), np.float32), zeros,
                          np.ones((G,), np.float32), zeros).cpu()
            timings["prefill_chunk_s"] = self._timer() - t0
        for _ in range(2):
            t0 = self._timer()
            self._decode(self.slots.tokens, self.slots.pos,
                         self.slots.block_tbl, self.slots.adapter,
                         np.zeros((B,), np.float32),
                         np.zeros((B,), np.int32), np.ones((B,), np.float32),
                         np.zeros((B,), np.int32),
                         np.zeros((B,), np.int32)).cpu()
            timings["decode_chunk_s"] = self._timer() - t0
        for key, val in timings.items():
            self.metrics.gauge(
                f"warmup_{key}", "steady-state step latency measured at "
                "warmup (the admission scheduler's Eq. 2 seed)").set(val)
        return timings

    def _sample_gauges(self) -> None:
        """Sample the occupancy gauges at a scheduling boundary (pure host
        reads)."""
        g = self.metrics.gauge
        g("pool_free_blocks", "free-list blocks").set(self.pool.num_free)
        g("pool_live_blocks",
          "live blocks (refcount >= 1)").set(self.pool.in_use)
        g("pool_cached_blocks",
          "refcount-0 blocks parked for prefix reuse").set(
            self.pool.num_cached)
        g("pool_high_water_blocks",
          "peak live-block count").set(self.pool.high_water)
        g("slots_active", "bound decode slots").set(self.slots.num_active)
        g("slot_utilization_frac", "active / num_slots").set(
            self.slots.num_active / max(self.scfg.num_slots, 1))
        if self.prefix is not None:
            g("prefix_trie_blocks",
              "physical blocks indexed by the prefix trie").set(
                len(self.prefix))

    def host_bubble_fraction(self) -> float:
        """Share of the wall interval between the first and last dispatch
        NOT covered by device work."""
        return host_bubble_fraction(self._dispatch_windows)
