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
slot stalls, one slot dies so the system makes progress: with
``RobustConfig.preemption`` the victim is preempted (the caller requeues
it), otherwise force-evicted (``aborted_oom``).  Either way its completed
blocks are demoted into the prefix cache's cached-LRU tier, so a
re-admission of the same request pays only the tail.

Overload robustness (as the reference's): ``try_admit(..., now=)`` sheds
requests whose finite TTFT/e2e deadline is provably unmeetable
(``deadline_floors``, built on the minimum observed dispatch times);
``preempt`` and ``abort`` release a bound slot between chunks with full
accounting; ``check_invariants`` audits pins, blocks and that every
request ends in exactly one terminal state.  All of it is host work: a
release resets the slot's numpy mirrors, and the next dispatch stages the
mirrors after every release of its planning step, so a captured graph
never reads a dead slot's block table.

The two dispatches are ``serving.graphs.GraphedDispatch``es — the port's
form of the reference's ``jax.jit``: on the card each is captured once as
a CUDA graph (the decode chunk with all its steps and sampling epilogues,
the prefill slice with its epilogue) and replayed, its inputs copied in
from the numpy mirrors through pinned buffers; ``decode_compiles()`` /
``prefill_compiles()`` count the captures, which ``CompileGuard`` holds to
one each.  The kernels update the KV pools IN PLACE and the adapter
registry writes the bank in place; that is the port's stand-in for the
reference's ``donate_argnums``, and it keeps the graphs' addresses valid.
Every measurement uses the injectable ``timer`` with the reference's exact
sequence of timer readings, so a replay under a deterministic fake clock
takes the same scheduling decisions as the reference's.

Sliding-window reclamation (``ServingConfig.window_reclamation``, as the
reference's): after each accepted decode chunk, blocks whose whole
[j*bs, (j+1)*bs) token range slid out of the window are released back to
the pool and the slot's table entry set to -1.  Every decode and prefill
kernel masks both -1 entries and positions <= pos - window, so those keys
are never read again, and the -1 entries are staged into the captured
decode graph as they are.  The per-slot live working set shrinks to
O(window); the block table still caps the total sequence length.

Hybrid REC/SSD slot state (as the reference's): hybrid and
attention-free stacks (RecurrentGemma, Mamba-2) carry, per REC/SSD layer,
dense ``(num_slots + 1, ...)`` recurrent-state rows beside the paged pools
(the last row is the garbage row).  Both dispatches take a ``state_rows``
vector mapping dispatch rows to state rows, staged like every other
input: a prefill row starting at position 0 reads zero state (so a
recycled slot needs no reset), later chunks continue the scans from the
carried row, and decode advances it in the same captured step as the KV
write.  Recurrent state summarises the WHOLE prefix, so stacks with state
start the chunk loop at token 0 (prefix-shared blocks skip the write,
never the compute), and a stalled slot's row points at the garbage row
for the stalled chunk (its state would otherwise advance twice).
Attention-free stacks charge no pool blocks, are not bounded by the block
table, never stall, and run without prefix sharing.

Adapters are registry names (``serving.adapters.AdapterRegistry``) or raw
bank slots.  Not ported yet (see ROADMAP.md): checkpoint artifacts (so a
``FaultPlan``'s checkpoint faults have no loader to reach).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.engine import (make_chunked_prefill_step,
                                     make_serve_step)
from repro_torch.core.lora import partition_lora, tree_leaves
from repro_torch.core.sampling import (GREEDY, MODES, SamplingParams,
                                       philox_uniform_torch,
                                       sample_tokens, sample_with_uniform)
from repro_torch.models.cache import (GARBAGE_BLOCK, has_slot_state,
                                      init_paged_cache,
                                      paging_unsupported_reason)
from repro_torch.models.config import ATTN, ModelConfig
from repro_torch.serverless.batching import Request
from repro_torch.serving.graphs import GraphedDispatch
from repro_torch.serving.kv_pool import BlockPool, blocks_for_tokens
from repro_torch.serving.metrics import MetricsRegistry
from repro_torch.serving.prefix import PrefixCache
from repro_torch.serving.slots import SlotState, SlotTable
from repro_torch.serving.telemetry import (EVT_ABORT, EVT_PREEMPT,
                                           Telemetry, host_bubble_fraction)


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


@dataclasses.dataclass(frozen=True)
class RobustConfig:
    """Overload robustness: preemption, requeue, and artifact-retry
    policy."""
    preemption: bool = False     # pool exhaustion with EVERY slot stalled:
    #   True = preempt the lowest-priority slot to the cached-LRU tier so
    #   the caller can requeue it (cheap resume through the prefix cache);
    #   False (default) = the terminal force-evict (aborted_oom)
    retry_budget: int = 3        # preemptions one request may absorb before
    #   the replay declares it terminally abandoned (abandoned_retries)
    backoff_s: float = 0.05      # virtual-clock requeue delay base; doubles
    #   with every further preemption of the same request
    artifact_retries: int = 2        # AdapterRegistry.load/swap retries on
    #   transient artifact-load failures (faults.retry_with_backoff)
    artifact_backoff_s: float = 0.0  # host-clock sleep base between
    #   artifact retries (0 = immediate; tests inject fake sleeps)


@dataclasses.dataclass(frozen=True)
class AdapterConfig:
    """Multi-LoRA serving: the stacked adapter bank."""
    max_live: Optional[int] = None   # AdapterRegistry capacity (bank slots);
    #   None = size the registry to the bank already in ``params``
    lora_rank: Optional[int] = None  # bank rank; adapters loaded with a
    #   smaller rank are zero-padded up to it (None = whatever the bank has)


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
    window_reclamation: bool = True  # sliding-window configs: release
    #   blocks that slid fully out of the window after each decode chunk
    prefill: PrefillConfig = PrefillConfig()
    decode: DecodeConfig = DecodeConfig()
    adapters: AdapterConfig = AdapterConfig()
    robust: RobustConfig = RobustConfig()

    _FLAT = {
        "prefill_chunk": ("prefill", "chunk"),
        "prefill_rows": ("prefill", "rows"),
        "decode_chunk": ("decode", "chunk"),
        "eos_id": ("decode", "eos_id"),
        "max_live_adapters": ("adapters", "max_live"),
        "lora_rank": ("adapters", "lora_rank"),
        "preemption": ("robust", "preemption"),
        "retry_budget": ("robust", "retry_budget"),
        "retry_backoff_s": ("robust", "backoff_s"),
        "artifact_retries": ("robust", "artifact_retries"),
        "artifact_backoff_s": ("robust", "artifact_backoff_s"),
    }
    _GROUPS = {"prefill": PrefillConfig, "decode": DecodeConfig,
               "adapters": AdapterConfig, "robust": RobustConfig}

    def __init__(self, num_slots: int = 8, block_size: int = 16,
                 num_blocks: int = 64, max_blocks_per_slot: int = 8,
                 prefix_sharing: bool = True,
                 window_reclamation: bool = True,
                 prefill: Optional[PrefillConfig] = None,
                 decode: Optional[DecodeConfig] = None,
                 adapters: Optional[AdapterConfig] = None,
                 robust: Optional[RobustConfig] = None, **flat: Any):
        groups: Dict[str, Any] = {"prefill": prefill, "decode": decode,
                                  "adapters": adapters, "robust": robust}
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
                          ("window_reclamation", window_reclamation),
                          ("prefill", groups["prefill"]),
                          ("decode", groups["decode"]),
                          ("adapters", groups["adapters"]),
                          ("robust", groups["robust"])):
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
    """One admission-ready request.  ``adapter`` is a registry name (needs
    an attached ``AdapterRegistry``), a raw bank slot, or ``None`` (slot
    0); ``request`` carries the trace record when the caller has one, else
    a fresh ``Request`` is synthesized."""
    prompt: Any                      # (L,) int token ids (np/list)
    adapter: Optional[Any] = None
    arrival: float = 0.0
    max_new_tokens: int = 1
    request: Optional[Request] = None
    slo_class: int = 0               # preemption priority: HIGHER classes
    #   may preempt lower ones when they would provably miss a deadline
    deadline_ttft: float = float("inf")  # hard first-token budget from
    #   arrival; inf (default) disables deadline shedding for this request
    deadline_e2e: float = float("inf")   # hard end-to-end budget
    sampling: Optional[SamplingParams] = None  # None = greedy

    _auto_id = 0

    def ensure_request(self) -> Request:
        if self.request is None:
            ServeRequest._auto_id += 1
            self.request = Request(
                req_id=-ServeRequest._auto_id, fn_id=str(self.adapter),
                arrival=self.arrival, prompt_len=len(self.prompt),
                output_len=max(int(self.max_new_tokens), 1),
                slo_ttft=float("inf"), slo_class=int(self.slo_class),
                deadline_ttft=float(self.deadline_ttft),
                deadline_e2e=float(self.deadline_e2e))
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
    preempted: List[SlotState] = dataclasses.field(default_factory=list)
    #   released with completed KV demoted to the cached-LRU tier
    #   (``RobustConfig.preemption``); the CALLER owns requeue policy —
    #   replay_trace re-enters them with exponential backoff + retry budget


# terminal-state taxonomy: which breakdown flags put a request in which
# terminal class.  Every request ends in EXACTLY one class (or none while
# still in flight) — the conservation invariant check_invariants() audits.
_REJECT_FLAGS = ("rejected_too_long", "rejected_unknown_adapter",
                 "rejected_deadline")
_ABORT_FLAGS = ("aborted", "aborted_oom")
_ABANDON_FLAGS = ("abandoned", "abandoned_retries")


def terminal_state(req: Request) -> Optional[str]:
    """Terminal class of a request record — ``"finished"`` /
    ``"rejected"`` / ``"aborted"`` / ``"abandoned"`` — or None while
    unresolved.  ``"preempted"`` is deliberately NOT terminal: a
    preempted request is still in flight (requeued) until it finishes,
    exhausts its retry budget (``abandoned_retries``), or is aborted.
    Raises ValueError if the flags put the request in more than one
    class at once."""
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
        self.has_state = has_slot_state(cfg)
        # attention-free stacks have no K/V to page: no blocks charged,
        # capacity not bounded by the block table, no prefix sharing, no
        # stalls
        self.needs_kv = ATTN in cfg.layer_kinds
        if self.has_state and scfg.prefill_chunk % cfg.ssm_chunk:
            raise ValueError(
                f"prefill_chunk {scfg.prefill_chunk} must be a multiple of "
                f"ssm_chunk {cfg.ssm_chunk} for REC/SSD stacks: recurrent "
                f"scans run in ssm_chunk-aligned blocks so chunk-at-a-time "
                f"prefill stays bitwise-equal to whole-prompt prefill")
        self.cfg = cfg
        self.params = params
        self.scfg = scfg
        self.device = torch.device(device)
        self.pool = BlockPool(scfg.num_blocks, scfg.block_size)
        self.slots = SlotTable(scfg.num_slots, scfg.max_blocks_per_slot)
        # REC/SSD state rows: one per slot + the trailing garbage row
        self.garbage_state_row = scfg.num_slots
        self.cache = init_paged_cache(
            cfg, scfg.num_blocks, scfg.block_size, device=self.device,
            num_slots=scfg.num_slots if self.has_state else None)
        self.prefix: Optional[PrefixCache] = None
        if scfg.prefix_sharing and self.needs_kv:
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
             "adapter name not in the registry / bank slot out of range "
             "(the decode path would compute a zero delta, but serving an "
             "unloaded adapter silently is a correctness bug)"),
            ("reclaimed_blocks", "blocks returned mid-flight (window)"),
            ("admit_syncs", "deliberate device reads during admission"),
            # terminal-state + preemption counters: every request ends in
            # exactly ONE of finished / rejected_* / aborted / abandoned —
            # check_invariants() audits the books
            ("rejected_deadline", "requests shed at admission: even the "
             "optimistic lower bound on remaining work misses their "
             "TTFT/e2e deadline"),
            ("aborted", "in-flight requests cancelled (runtime.abort, "
             "force-evict on pool exhaustion)"),
            ("abandoned", "requests terminally dropped after admission "
             "was attempted (SLO lapse in queue, retry budget exhausted)"),
            ("preemptions", "slots released mid-flight with completed KV "
             "demoted to the cached-LRU tier for cheap resume"),
            ("retries", "preempted requests re-entered into the admission "
             "queue (backoff requeues, not artifact retries)"),
            ("resume_prefix_hits", "re-admissions of preempted requests "
             "that recovered demoted blocks through the prefix cache"),
            ("demoted_blocks", "completed blocks re-indexed into the "
             "prefix trie at preempt/abort so they park cached, not free"),
            ("sampled_tokens", "accepted tokens drawn with temperature > 0"),
            ("artifact_retries", "adapter load attempts retried after a "
             "transient artifact failure"),
            ("injected_pool_squeezes", "FaultPlan pool-squeeze windows "
             "that actually captured blocks"),
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
        self.adapters = None         # Optional[AdapterRegistry]
        # deterministic fault injection (serving.faults.FaultPlan):
        # replay_trace attaches the active plan here so the adapter
        # registry can consult it; None (the default) costs one attribute
        # test per load
        self.faults = None           # Optional[faults.FaultPlan]
        self._dispatch_windows: List[Tuple[float, float]] = []
        self._serve = make_serve_step(cfg)
        self._chunk_step = make_chunked_prefill_step(cfg)
        # the two dispatches, each captured once on the card; their graphs
        # share one memory pool
        pool = (torch.cuda.graph_pool_handle()
                if self.device.type == "cuda" else None)
        self._decode = GraphedDispatch(self._decode_chunk, self.device,
                                       pool=pool)
        self._prefill = GraphedDispatch(self._prefill_chunk, self.device,
                                        pool=pool)

    # ------------------------------------------------------------ dispatches
    @torch.no_grad()
    def _decode_chunk(self, tok, pos, tbl, ai, srows, temp, top_k, top_p,
                      seed, counter) -> torch.Tensor:
        """The fixed-shape decode loop: ``decode_chunk`` steps, each with
        the sampling epilogue; step i runs at positions ``pos + i`` with
        RNG counters ``counter + i`` and feeds its tokens to step i + 1;
        ``srows`` names each row's REC/SSD state row.  Every input is a
        device tensor; the uniforms of all steps are drawn up front.
        Returns (B, chunk) int32 tokens."""
        steps = self.scfg.decode_chunk
        offs = torch.arange(steps, device=tok.device)
        u = philox_uniform_torch(seed[None], counter.long()[None]
                                 + offs[:, None])          # (steps, B)
        out = []
        for i in range(steps):
            logits, _ = self._serve(self.params, tok, self.cache, pos + i,
                                    adapter_idx=ai, block_tbl=tbl,
                                    state_rows=srows)
            tok = sample_with_uniform(logits, temp, top_k, top_p, u[i])
            out.append(tok)
        return torch.stack(out, dim=1)

    @torch.no_grad()
    def _prefill_chunk(self, tokens, start, last_idx, ai, chunk_ids, tbl,
                       srows, temp, top_k, top_p, seed) -> torch.Tensor:
        """ONE slice of the join path: write this chunk's K/V into pool
        blocks (REC/SSD layers: advance the state rows ``srows`` names) and
        sample the first output token from the logit at ``last_idx`` with
        RNG counter 0.  Returns (G,) int32 tokens."""
        logits, _ = self._chunk_step(self.params, tokens, start, last_idx,
                                     self.cache, chunk_ids, tbl,
                                     adapter_idx=ai, state_rows=srows)
        return sample_tokens(logits, temp, top_k, top_p, seed,
                             torch.zeros_like(seed))

    def decode_compiles(self) -> int:
        """Capture count of the decode dispatch (must be 1 after warmup;
        a recapture mid-serving would blow every TPOT SLO)."""
        return self._decode._cache_size()

    def prefill_compiles(self) -> int:
        """Capture count of the chunked prefill dispatch (must be 1 after
        warmup across EVERY prompt length)."""
        return self._prefill._cache_size()

    # ------------------------------------------------------------ capacity
    def max_output_for(self, prompt_len: int) -> int:
        """Largest output a request with this prompt can be granted: the
        block table's capacity, or (attention-free stacks, whose whole
        decode state is a slot row) any int32-positionable length."""
        if not self.needs_kv:
            return 2 ** 31 - 1 - prompt_len
        cap = self.scfg.max_blocks_per_slot * self.scfg.block_size
        return cap - prompt_len + 1        # last KV write is L + out - 2

    def fits(self, prompt_len: int, output_len: int) -> bool:
        """The last KV write (position prompt_len + output_len - 2) must
        land inside max_blocks_per_slot."""
        if prompt_len < 1 or output_len < 1:
            return False
        return output_len <= self.max_output_for(prompt_len)

    def admit_cost_blocks(self, prompt_len: int, output_len: int = 2) -> int:
        if not self.needs_kv:
            return 0                       # nothing to page for REC/SSD-only
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

    def reject_deadline(self, req: Request) -> None:
        """Count a deadline shed once per request.  Shed requests were
        PROVABLY going to miss: even the optimistic lower bound on their
        remaining work exceeds the deadline."""
        if "rejected_deadline" not in req.breakdown:
            self.stats["rejected_deadline"] += 1
        req.breakdown["rejected_deadline"] = 1.0

    # ------------------------------------------------- deadline estimation
    def _dispatch_floor(self, kind: str) -> Optional[float]:
        """Optimistic seconds per ``kind`` dispatch: the MINIMUM observed
        dispatch time (falling back to the warmup gauge before traffic
        exists), so every deadline bound built on it is a true lower
        bound — noise can delay real dispatches, never speed them up.
        None when no timing data exists yet (shedding then stands down).
        On the card the first dispatch of each kind also captures its
        graph; it is slow, and only the minimum is read."""
        h = self.metrics.histograms.get(f"{kind}_dispatch_s")
        if h is not None:
            v = h.min_observed()
            if v is not None:
                return v
        g = self.metrics.gauges.get(f"warmup_{kind}_chunk_s")
        if g is not None and g.count:
            return g.last
        return None

    def _prefill_rounds(self, prompt_len: int, covered_tokens: int) -> int:
        """Chunk-loop dispatch rounds a prompt needs — the exact loop
        bound ``_chunk_prefill`` runs (prefix-covered tokens skip rounds;
        stacks with recurrent state always start at token 0)."""
        return max(-(-(prompt_len - self._start_token(prompt_len,
                                                      covered_tokens))
                     // self.scfg.prefill_chunk), 1)

    def _start_token(self, prompt_len: int, covered_tokens: int) -> int:
        """First prompt token the chunk loop computes: the first one past
        the prefix-shared blocks (a fully covered prompt still recomputes
        its last block), or 0 for stacks with REC/SSD state, which must
        integrate every token."""
        if self.has_state:
            return 0
        bs = self.scfg.block_size
        return min((covered_tokens // bs) * bs, ((prompt_len - 1) // bs) * bs)

    def deadline_floors(self, prompt_len: int, output_len: int,
                        covered_tokens: int = 0
                        ) -> Optional[Tuple[float, float]]:
        """(TTFT floor, e2e floor): optimistic additional seconds to first
        token / last token if the request dispatched right now.  None when
        no prefill timing data exists.  The decode term is omitted when
        decode has no floor yet — the bound gets weaker, never wrong."""
        tp = self._dispatch_floor("prefill")
        if tp is None:
            return None
        ttft = self._prefill_rounds(prompt_len, covered_tokens) * tp
        e2e = ttft
        if output_len > 1:
            td = self._dispatch_floor("decode")
            if td is not None:
                k = max(self.scfg.decode_chunk, 1)
                e2e += -(-(output_len - 1) // k) * td
        return ttft, e2e

    def _resolve_adapter(self, adapter) -> Optional[int]:
        """Registry name / bank slot -> validated bank slot, or None if the
        id cannot be served.  Pure host work — admission planning calls
        this per item with no device interaction."""
        if adapter is None:
            adapter = 0
        if isinstance(adapter, str):
            if self.adapters is None:
                raise ValueError(
                    f"adapter name {adapter!r} needs an AdapterRegistry "
                    f"attached to the runtime (serving.adapters)")
            return self.adapters.resolve(adapter)   # None when unknown
        slot = int(adapter)
        if self.bank_slots is None:
            return slot if slot == 0 else None      # backbone-only params
        if not 0 <= slot < self.bank_slots:
            return None
        if self.adapters is not None and not self.adapters.slot_loaded(slot):
            return None                             # unloaded/free slot
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
        that finished early and unused rows ride along as garbage rows (and
        point at the garbage state row; a live row points at its sid's).
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
            start_tok = self._start_token(L, cov * bs)
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
            srows = np.full((G,), self.garbage_state_row, np.int32)
            for i, (prompt, adapter, blocks, cov, sid, _, _) \
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
                srows[i] = sid
                for jj in range(nb_c):
                    j = c0 // bs + jj
                    # skip shared blocks (already hold these K/V) and
                    # out-of-range blocks (chunk-tail junk)
                    if cov <= j < len(blocks):
                        ids[i, jj] = blocks[j]
            first = self._prefill(tok, start, last_idx, ai, ids, tbl, srows,
                                  temp, top_k, top_p, seed)
            if r in final_rounds:
                toks_by_round[r] = first
            self.stats["prefill_chunks"] += 1
        # one whole-batch device read per final round, then index on host
        self.stats["admit_syncs"] += len(toks_by_round)
        synced: Dict[int, np.ndarray] = {
            r: t.cpu().numpy()  # reprolint: sync-point (token emission)
            for r, t in toks_by_round.items()}
        return [int(synced[len(starts[i]) - 1][i]) for i in range(len(items))]

    def try_admit(self, items: Sequence[ServeRequest], *,
                  now: Optional[float] = None) -> Optional[AdmitResult]:
        """Join ``ServeRequest`` items into free slots.

        ``now`` (virtual-clock seconds) arms deadline shedding: items
        whose finite ``deadline_ttft``/``deadline_e2e`` provably cannot be
        met — queue wait so far plus the OPTIMISTIC lower bound on their
        remaining work (``deadline_floors``) already exceeds the budget —
        are dropped (``stats["rejected_deadline"]``).  Without ``now``, or
        for requests with the default infinite deadlines, nothing is shed.

        Unserveable items are dropped, flagged and reported in
        ``AdmitResult.rejected`` (oversized prompts, out-of-range bank
        slots, provable deadline misses); the per-item result lists align
        with the surviving items.
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
        if now is not None and kept:
            # deadline shedding — only requests that OPTED IN by setting a
            # finite deadline are ever considered, and only a provable
            # miss sheds (lower-bound estimates; no data -> no shedding)
            shed_checked: List[Tuple[Request, np.ndarray, int,
                                     SamplingParams, int]] = []
            for it in kept:
                req, prompt, adapter = it[0], it[1], it[2]
                d_ttft, d_e2e = req.deadline_ttft, req.deadline_e2e
                if not (math.isfinite(d_ttft) or math.isfinite(d_e2e)):
                    shed_checked.append(it)
                    continue
                cov = (self.prefix.covered_tokens(adapter, prompt)
                       if self.prefix is not None else 0)
                floors = self.deadline_floors(
                    len(prompt), max(req.output_len, 1), cov)
                if floors is None:
                    shed_checked.append(it)
                    continue
                waited = now - req.arrival
                if waited + floors[0] > d_ttft \
                        or waited + floors[1] > d_e2e:
                    self.reject_deadline(req)
                    rejected.append(req)
                else:
                    shed_checked.append(it)
            kept = shed_checked
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
            if req.breakdown.get("preempted"):
                # resume accounting: a preempted request re-admitting —
                # shared coverage here IS the cheap-resume payoff (its
                # demoted blocks survived in the cached-LRU tier)
                if shared:
                    self.stats["resume_prefix_hits"] += 1
                req.breakdown["resumed_covered_tokens"] = float(cov)
                req.breakdown["resume_recomputed_tokens"] = \
                    float(L - self._start_token(L, cov))
            sid = sids[i]
            st = SlotState(sid=sid, req=req, adapter=adapter, prompt_len=L,
                           budget=max(req.output_len, 1), pos=L,
                           blocks=shared + fresh, last_token=first,
                           shared=len(shared), prompt_tokens=prompt,
                           history=[first], sampling=sp, seed=sd)
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
                if self.adapters is not None:
                    # in-flight requests pin their adapter: unload/swap of
                    # a bank slot some live decode row still reads would
                    # change that request's results mid-stream
                    self.adapters.pin(adapter)
        self._sample_gauges()
        return AdmitResult(slot_ids, first_tokens, finished, total_dt,
                           shared_blocks=[len(p[0]) for p in plans],
                           rejected=rejected)

    # -------------------------------------------------------------- decode
    def _unpin(self, st: SlotState) -> None:
        """Release a finished/aborted slot's adapter pin (no-op without a
        registry — raw-slot runtimes have nothing to pin)."""
        if self.adapters is not None:
            self.adapters.unpin(st.adapter)

    def _demote_blocks(self, st: SlotState) -> int:
        """Re-index a dying slot's COMPLETED full blocks in the prefix
        trie, so the ``pool.free`` that follows parks them in the
        cached-LRU tier instead of the free list: a re-admission of the
        same request (preempt-resume, resubmitted force-evict victim)
        recovers the computed prefix through the normal ``prefix.match``
        and pays only the tail.

        A block is completed when every position in its [j*bs, (j+1)*bs)
        range was written (j < pos // bs); the chain truncates at the
        first window-reclaimed entry (-1) because trie chains must be
        contiguous from block 0.  Token content comes from the slot's own
        record: prompt_tokens for positions [0, L), history for [L, pos).
        Returns the number of newly indexed blocks."""
        if self.prefix is None or st.prompt_tokens is None:
            return 0
        bs = self.scfg.block_size
        n_full = min(st.pos // bs, len(st.blocks))
        for j in range(n_full):
            if st.blocks[j] < 0:
                n_full = j
                break
        if n_full <= 0:
            return 0
        stream = [int(t) for t in st.prompt_tokens]
        stream += st.history[: max(st.pos - st.prompt_len, 0)]
        tokens = stream[: n_full * bs]
        covered, node = self.prefix.match(st.adapter, tokens)
        new = self.prefix.register(st.adapter, tokens, st.blocks,
                                   len(covered), node)
        self.stats["demoted_blocks"] += len(new)
        return len(new)

    def _release_slot(self, st: SlotState, *, demote: bool = False) -> None:
        """THE exit path for every way a bound slot dies — finish, abort,
        preempt, force-evict: optionally demote completed blocks to the
        cached-LRU tier, release the held blocks (the slot's mirrors reset
        with them), release the adapter pin."""
        if demote:
            self._demote_blocks(st)
        self.pool.free(self.slots.release(st.sid))
        self._unpin(st)

    def _preempt_slot(self, st: SlotState) -> None:
        """Release a slot preserving its computed prefix (demote-to-
        cached) and count the preemption.  The request record stays
        re-admittable: the caller requeues (or abandons) it."""
        st.req.breakdown["preempted"] = \
            st.req.breakdown.get("preempted", 0.0) + 1.0
        self._release_slot(st, demote=True)
        self.stats["preemptions"] += 1

    def preempt(self, sid: int, *, now: Optional[float] = None
                ) -> SlotState:
        """Public preemption of bound slot ``sid`` (deadline-driven
        scheduling), between decode chunks: completed KV demotes to the
        cached-LRU tier, blocks and adapter pin release, telemetry gets
        the preempt instant.  Requeue policy belongs to the caller.
        Returns the released ``SlotState``."""
        st = self.slots.states[sid]
        if st is None:
            raise KeyError(f"slot {sid} is not bound")
        self._preempt_slot(st)
        t = now if now is not None else self._timer()
        if self.telemetry is not None:
            self.telemetry.instant(EVT_PREEMPT, f"slot{sid}", t,
                                   req_id=st.req.req_id,
                                   produced=st.produced)
        self._sample_gauges()
        return st

    def abort(self, request_id: int, *, now: Optional[float] = None
              ) -> bool:
        """Cancel an in-flight request by id with full accounting:
        completed blocks demote to the cached-LRU tier, remaining blocks
        and the adapter pin release, the abort lands in the ``aborted``
        counter, the breakdown flag, and a telemetry abort instant.
        Returns False when no bound slot serves ``request_id`` (a queued
        request belongs to the scheduler, not the runtime)."""
        for st in self.slots.active():
            if st.req.req_id == request_id:
                self._release_slot(st, demote=True)
                st.req.breakdown["aborted"] = 1.0
                self.stats["aborted"] += 1
                t = now if now is not None else self._timer()
                if st.req.done < 0:
                    st.req.done = t
                if self.telemetry is not None:
                    self.telemetry.instant(EVT_ABORT, f"slot{st.sid}", t,
                                           req_id=request_id,
                                           produced=st.produced)
                self._sample_gauges()
                return True
        return False

    def deadline_preemption_victim(self, req: Request,
                                   now: float) -> Optional[int]:
        """Slot id worth preempting so the queued ``req`` can still meet
        its TTFT deadline, or None.  Conservative on both sides: fires
        only when even the OPTIMISTIC bound on waiting for a natural slot
        release (fastest-finishing slot's remaining decode rounds at the
        decode floor) plus req's own prefill floor already misses the
        deadline — and only a victim of STRICTLY lower SLO class (equal
        classes never thrash each other)."""
        if not self.scfg.robust.preemption:
            return None
        if not math.isfinite(req.deadline_ttft):
            return None
        if self.slots.free_slots():
            return None              # a slot is free; plain admission wins
        tp = self._dispatch_floor("prefill")
        td = self._dispatch_floor("decode")
        if tp is None or td is None:
            return None              # nothing provable without timing data
        k = max(self.scfg.decode_chunk, 1)
        waits = [(-(-(s.budget - s.produced) // k)) * td
                 for s in self.slots.active()]
        wait_floor = min(waits) if waits else 0.0
        ttft_floor = self._prefill_rounds(req.prompt_len, 0) * tp
        if (now - req.arrival) + wait_floor + ttft_floor \
                <= req.deadline_ttft:
            return None              # could still make it by waiting
        cands = [s for s in self.slots.active()
                 if s.req.slo_class < req.slo_class]
        if not cands:
            return None
        victim = min(cands, key=lambda s: (s.req.slo_class,
                                           s.budget - s.produced))
        return victim.sid

    def _ensure_blocks(self) -> Tuple[List[int], List[SlotState],
                                      List[SlotState]]:
        """On-demand allocation for this chunk's writes; stall on
        shortage.  If *everyone* stalls, one slot must die for the system
        to make progress: with ``RobustConfig.preemption`` the victim is
        PREEMPTED (the caller requeues it), otherwise force-evicted
        terminally (``aborted_oom``); either way its completed blocks park
        cached.  Victim choice: lowest SLO class first, then closest to
        completion (fewest remaining tokens = least wasted work).
        Attention-free stacks never allocate and never stall."""
        scfg, aborted, preempted = self.scfg, [], []
        if not self.needs_kv:
            for s in self.slots.active():
                s.stalled = False
            return [], aborted, preempted
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
                if scfg.robust.preemption:
                    self._preempt_slot(victim)
                    preempted.append(victim)
                else:
                    victim.req.breakdown["aborted_oom"] = 1.0
                    self.stats["aborted"] += 1
                    self._release_slot(victim, demote=True)
                    aborted.append(victim)
                continue
            return [s.sid for s in stalled], aborted, preempted

    def decode(self) -> Optional[DecodeResult]:
        """One fixed-shape decode chunk across every slot (inactive rows
        write to the garbage block and are ignored)."""
        if self.slots.num_active == 0:
            return None
        scfg = self.scfg
        t_plan0 = self._timer()
        # planning may release slots (preempt / force-evict): it runs to
        # the end BEFORE the mirrors are staged, so the dispatch never
        # sees a released slot's block table, position or adapter
        stalled, aborted, preempted = self._ensure_blocks()
        self.stats["stall_steps"] += len(stalled)
        if self.slots.num_active == 0:      # everything aborted/preempted
            return DecodeResult({}, [], aborted, stalled, 0.0,
                                preempted=preempted)

        # stalled slots run the chunk unmodified from (pending token, pos):
        # every position they write is re-written by the resumed chunk
        # before it can be attended, writes past the table clip to the
        # garbage block, and their REC/SSD state row points at the garbage
        # row — discarding their outputs is a true no-op
        t0 = self._timer()
        toks = self._decode(
            self.slots.tokens, self.slots.pos, self.slots.block_tbl,
            self.slots.adapter,
            self.slots.state_rows(self.garbage_state_row), self.slots.temp,
            self.slots.top_k, self.slots.top_p, self.slots.seed,
            self.slots.rng_counter)
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
            s.history.extend(emitted[s.sid])
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
                # RNG counter == tokens generated so far: a requeued
                # request restarts at produced = 1, so its draws repeat
                self.slots.rng_counter[s.sid] = s.produced
                self._reclaim_window(s)
        self._sample_gauges()
        return DecodeResult(emitted, finished, aborted, stalled, dt,
                            preempted=preempted)

    def _reclaim_window(self, s: SlotState) -> None:
        """Release blocks that slid fully out of the sliding window.

        Every future query of this slot sits at position >= s.pos, and the
        attention kernels mask keys at t <= pos - window (and -1 table
        entries), so a block whose whole [j*bs, (j+1)*bs) range is
        <= s.pos - window can never be read (or written: writes land at
        pos // bs >= the first live block) again.  The release is a
        refcount drop — a prefix-shared prompt block outlives this slot's
        window if other requests still map it, and a registered one parks
        in the cached LRU, still matchable by future admits."""
        w = self.cfg.sliding_window
        if w is None or not self.scfg.window_reclamation:
            return
        dead = (s.pos - w + 1) // self.scfg.block_size
        if dead > s.reclaimed:
            freed = self.slots.reclaim(s.sid, dead)
            if freed:
                self.pool.free(freed)
                self.stats["reclaimed_blocks"] += len(freed)

    # -------------------------------------------------------------- meta
    def check_invariants(self, requests: Optional[Sequence[Request]] = None,
                         *, raise_on_error: bool = True) -> Dict[str, Any]:
        """Audit the books, whichever way each slot died (finish, abort,
        preempt, force-evict): every block a bound slot maps (window-
        reclaimed -1 entries skipped) is live with a refcount covering its
        holders and not parked in the cached LRU;
        adapter pin counts equal the live holders per bank slot; with
        ``requests``, every request ends in exactly one terminal class
        (per-request breakdown flags, so several replays may share one
        runtime).  Returns a report; raises AssertionError on any
        violation unless ``raise_on_error=False``."""
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
        if self.adapters is not None:
            want: Dict[int, int] = {}
            for s in self.slots.active():
                want[s.adapter] = want.get(s.adapter, 0) + 1
            got = self.adapters.pin_counts()
            if got != want:
                problems.append(
                    f"adapter pins {got} != active-slot holders {want} "
                    f"(pin leak/double-unpin on some exit path)")
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
            resolved = sum(v for k, v in terminal.items()
                           if k != "unresolved")
            if resolved + terminal["unresolved"] != len(requests):
                problems.append(
                    f"terminal classes sum to {resolved} != trace "
                    f"length {len(requests)}")
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
        """Run each dispatch twice on garbage rows (pool, state rows and slots
        stay untouched: warmup writes only the garbage block and the
        garbage state row) and record the second run's wall time — the
        admission scheduler's Eq. 2 seed.
        On the card the first run builds and loads the kernels and
        captures the dispatch; the second is a timed replay."""
        scfg, timings = self.scfg, {}
        C, G = scfg.prefill_chunk, scfg.prefill_rows
        ids = np.full((G, C // scfg.block_size), GARBAGE_BLOCK, np.int32)
        tbl = np.full((G, scfg.max_blocks_per_slot), -1, np.int32)
        zeros = np.zeros((G,), np.int32)
        B = scfg.num_slots
        g_pre = np.full((G,), self.garbage_state_row, np.int32)
        g_dec = np.full((B,), self.garbage_state_row, np.int32)
        for _ in range(2):
            t0 = self._timer()
            self._prefill(np.zeros((G, C), np.int32), zeros, zeros, zeros,
                          ids, tbl, g_pre, np.zeros((G,), np.float32), zeros,
                          np.ones((G,), np.float32), zeros).cpu()
            timings["prefill_chunk_s"] = self._timer() - t0
        for _ in range(2):
            t0 = self._timer()
            self._decode(self.slots.tokens, self.slots.pos,
                         self.slots.block_tbl, self.slots.adapter, g_dec,
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
        g("decode_compiles", "decode-chunk capture count (must be "
          "1)").set(self.decode_compiles())
        g("prefill_compiles", "chunked-prefill capture count (must be "
          "1)").set(self.prefill_compiles())

    def host_bubble_fraction(self) -> float:
        """Share of the wall interval between the first and last dispatch
        NOT covered by device work."""
        return host_bubble_fraction(self._dispatch_windows)

    def metrics_snapshot(self) -> Dict[str, Any]:
        """One flat JSON-able dict of everything the runtime knows:
        counters (the ``stats`` keys), gauge summaries, latency histograms,
        the capture-count gauges and the host-bubble fraction; with a
        recorder attached, its span and instant counts.  Exporters
        (``telemetry.write_metrics_json``) call this once after a
        replay."""
        self._sample_gauges()
        snap = self.metrics.snapshot()
        snap["host_bubble_fraction"] = self.host_bubble_fraction()
        snap["dispatches"] = len(self._dispatch_windows)
        if self.telemetry is not None:
            snap["spans"] = len(self.telemetry.spans)
            snap["instant_events"] = len(self.telemetry.instants)
        return snap
