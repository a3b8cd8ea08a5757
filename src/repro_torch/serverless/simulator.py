"""Discrete-event serverless LoRA inference simulator (paper §3.3 workflow;
port of ``repro/serverless/simulator.py``, same names and arithmetic).

Implements the full request path — pre-loading (steps 1–3), instance
selection, batching, dispatch, and dynamic memory management (steps 4–7) —
against the analytic latency model, for ServerlessLoRA and every baseline
policy.  Time advances through a heap of events; the cost meter integrates
GPU/host byte-seconds continuously.

The simulator runs no model: ``core/engine.py`` is the real compute path.
Its cold-start stages come from the ``Hardware`` it is given
(``serverless/latency.py``): ``SLICE_HW`` reproduces the reference's
results, and ``H100_HW`` holds the stages measured for one H100.
``SimResult`` is also what ``serving.replay`` returns.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Dict, List, Optional, Tuple

from repro_torch.core.lora import adapter_bytes
from repro_torch.models.config import ModelConfig
from repro_torch.serverless.artifacts import Artifact, Kind, Tier
from repro_torch.serverless.batching import (BatchingScheduler,
                                             BatchProfile, Request,
                                             profile_function)
from repro_torch.serverless.baselines import Policy
from repro_torch.serverless.cluster import Cluster
from repro_torch.serverless.costs import (CostMeter, Pricing,
                                          cost_effectiveness)
from repro_torch.serverless.latency import SLICE_HW, Hardware, LatencyModel
from repro_torch.serverless.offload import apply_offload, plan_offload
from repro_torch.serverless.preload import FunctionSpec, greedy_preload

LIB_BYTES = int(2.2 * 2 ** 30)
KERNEL_BYTES = int(0.47 * 2 ** 30)       # per-process context+program (§6.9)


@dataclasses.dataclass
class FunctionDef:
    fn_id: str
    backbone_id: str
    cfg: ModelConfig
    rate_hint: float = 0.1


@dataclasses.dataclass
class SimResult:
    policy: str
    requests: List[Request]
    dollars: float
    gpu_byte_s: float
    sched_overhead_s: float = 0.0

    # ---- metrics ----
    def _ok(self):
        return [r for r in self.requests if r.first_token >= 0]

    @property
    def mean_ttft(self) -> float:
        ok = self._ok()
        return sum(r.first_token - r.arrival for r in ok) / max(len(ok), 1)

    @property
    def p99_ttft(self) -> float:
        ok = sorted(r.first_token - r.arrival for r in self._ok())
        return ok[int(0.99 * (len(ok) - 1))] if ok else 0.0

    @property
    def mean_tpot(self) -> float:
        ok = [r for r in self._ok() if r.output_len > 1]
        return sum((r.done - r.first_token) / max(r.output_len - 1, 1)
                   for r in ok) / max(len(ok), 1)

    @property
    def mean_e2e(self) -> float:
        ok = self._ok()
        return sum(r.done - r.arrival for r in ok) / max(len(ok), 1)

    @property
    def slo_violation_rate(self) -> float:
        ok = self._ok()
        if not ok:
            return 1.0
        v = sum(1 for r in ok if (r.first_token - r.arrival) > r.slo_ttft)
        return v / len(ok)

    @property
    def cost_effectiveness(self) -> float:
        return cost_effectiveness(self.mean_e2e, self.dollars)

    @property
    def mean_cold_start(self) -> float:
        ok = self._ok()
        return sum(r.cold_start for r in ok) / max(len(ok), 1)

    def breakdown_totals(self) -> Dict[str, float]:
        tot: Dict[str, float] = {}
        for r in self.requests:
            for k, v in r.breakdown.items():
                tot[k] = tot.get(k, 0.0) + v
        return tot

    def throughput_tokens_per_s(self, horizon: float) -> float:
        toks = sum(r.output_len for r in self._ok())
        return toks / max(horizon, 1e-9)


class Simulator:
    def __init__(self, functions: List[FunctionDef], policy: Policy, *,
                 cluster: Optional[Cluster] = None,
                 hw: Hardware = SLICE_HW, pricing: Pricing = Pricing(),
                 seed: int = 0, sched_overhead_s: float = 0.001):
        self.policy = policy
        self.hw = hw
        self.lat = LatencyModel(hw)
        self.functions = {f.fn_id: f for f in functions}
        self.cluster = cluster or self._default_cluster(functions)
        self.meter = CostMeter(pricing)
        self.sched_overhead_s = sched_overhead_s
        self._seq = itertools.count()
        self._events: List[Tuple[float, int, str, object]] = []
        self._armed_timers: set = set()   # dedupe retry/batch timers
        self._rates: Dict[str, float] = {
            f.fn_id: f.rate_hint for f in functions}
        self._warm: Dict[str, Tuple[str, float]] = {}   # fn -> (container, t)
        self._last_use: Dict[Tuple, float] = {}         # artifact key -> t
        # billing: an artifact is *billable* only while in actual use by
        # invocations (+ keep-alive window). Pre-loaded-but-idle artifacts
        # ride in over-allocated idle memory for free (paper §2.4).
        self._billed_until: Dict[Tuple, float] = {}
        self._serverful_gpus: set = set()
        self._running: Dict[str, List[Tuple[float, int]]] = {}  # gpu -> [(end, kv)]
        self.requests: List[Request] = []
        self._sched = BatchingScheduler(
            adaptive=policy.adaptive_batching,
            fixed_batch=policy.fixed_batch, fixed_delay=policy.fixed_delay)
        self._profiles: Dict[str, BatchProfile] = {}
        self._overhead = 0.0

    # ------------------------------------------------------------- helpers
    def _is_warm(self, fn_id: str) -> bool:
        """Warm for batching purposes: backbone + compiled program resident
        on some GPU (pre-loaded counts — the point of the paper)."""
        f = self.functions[fn_id]
        owner, name = self._backbone_key_name(f)
        g = self.cluster.find_gpu_with((owner, Kind.BACKBONE, name))
        if g is None:
            return False
        return g.holds((fn_id, Kind.KERNEL, f"{fn_id}-kernel"))

    def _default_cluster(self, functions) -> Cluster:
        n = max(2, len(functions))
        return Cluster(num_nodes=1, gpus_per_node=n, containers_per_gpu=2,
                       hbm_bytes=self.hw.hbm_bytes,
                       host_bytes=self.hw.host_mem_bytes)

    def _backbone_key_name(self, f: FunctionDef) -> Tuple[str, str]:
        """(fn_id, name) of the backbone artifact under this policy —
        shared policies dedupe on the backbone id."""
        if self.policy.share_backbone:
            return "", f.backbone_id
        return f.fn_id, f"{f.backbone_id}@{f.fn_id}"

    def _artifacts_for(self, f: FunctionDef) -> List[Artifact]:
        bbytes = self.lat.backbone_bytes(f.cfg)
        remote = 0.0 if self.policy.fast_checkpoint \
            else self.lat.remote_to_host_s(bbytes)
        owner, name = self._backbone_key_name(f)
        abytes = max(adapter_bytes(f.cfg), 8 * 2 ** 20)
        return [
            Artifact(f.fn_id, Kind.LIBRARY, "libs", LIB_BYTES,
                     self.hw.library_load_s, 0.0),
            Artifact(owner, Kind.BACKBONE, name, bbytes, remote,
                     self.lat.host_to_gpu_s(bbytes)),
            Artifact(f.fn_id, Kind.ADAPTER, f"{f.fn_id}-adapter", abytes,
                     self.lat.remote_to_host_s(abytes),
                     self.lat.host_to_gpu_s(abytes)),
            Artifact(f.fn_id, Kind.KERNEL, f"{f.fn_id}-kernel", KERNEL_BYTES,
                     0.0, self.hw.kernel_compile_s),
        ]

    def _push(self, t: float, kind: str, payload=None) -> None:
        heapq.heappush(self._events, (t, next(self._seq), kind, payload))

    def _arm_timer(self, t: float) -> None:
        """Timer events re-run the dispatch loop; arming is deduped —
        otherwise every blocked dispatch under saturation spawns a timer
        that spawns more blocked dispatches (exponential event growth)."""
        if self._armed_timers and min(self._armed_timers) <= t + 1e-9:
            return
        self._armed_timers.add(t)
        self._push(t, "timer", None)

    def _bill(self, now: float) -> None:
        if self.policy.serverful:
            gpu_b = len(self._serverful_gpus) * self.hw.hbm_bytes
            host_b = sum(c.used for c in self.cluster.containers)
            cores = float(len(self._serverful_gpus))
            self.meter.set_usage(now, gpu_b, host_b, cores)
            return
        gpu_b = 0
        for g in self.cluster.gpus:
            gpu_b += g.kv_reserved
            for key, art in g.resident.items():
                if self._billed_until.get(key, -1.0) >= now:
                    gpu_b += art.nbytes
        host_b = 0
        for c in self.cluster.containers:
            for key, art in c.resident.items():
                if self._billed_until.get(key, -1.0) >= now:
                    host_b += art.nbytes
        cores = sum(1.0 for c in self.cluster.containers
                    if c.busy_until > now)
        self.meter.set_usage(now, gpu_b, host_b, cores)

    # -------------------------------------------------------- pre-loading
    def _preload_stage(self, now: float) -> None:
        if self.policy.serverful:
            self._serverful_residency()
            return
        if not self.policy.preload_kinds:
            return
        specs = []
        for f in self.functions.values():
            arts = [a for a in self._artifacts_for(f)
                    if a.kind in self.policy.preload_kinds]
            if not self.policy.preload_to_gpu:
                arts = [a for a in arts if a.host_eligible()]
            specs.append(FunctionSpec(f.fn_id, f.backbone_id, arts,
                                      self._rates[f.fn_id]))
        plan = greedy_preload(specs, self.cluster,
                              share_backbone=self.policy.share_backbone)
        for p in plan:
            if not self.policy.preload_to_gpu and p.tier == Tier.GPU:
                continue
            try:
                if p.tier == Tier.GPU:
                    self.cluster.gpu(p.location).add(p.artifact)
                else:
                    c = self.cluster.container(p.location)
                    c.add(p.artifact)
                    c.warm = True
                self._last_use[p.artifact.key] = now
            except MemoryError:
                continue

    def _serverful_residency(self) -> None:
        """vLLM/dLoRA: replicas pinned for the whole run."""
        gpus = self.cluster.gpus
        gi = 0
        placed_backbones: Dict[str, str] = {}
        for f in self.functions.values():
            owner, name = self._backbone_key_name(f)
            arts = self._artifacts_for(f)
            bb = next(a for a in arts if a.kind == Kind.BACKBONE)
            kern = next(a for a in arts if a.kind == Kind.KERNEL)
            ad = next(a for a in arts if a.kind == Kind.ADAPTER)
            if name in placed_backbones:
                g = self.cluster.gpu(placed_backbones[name])
            else:
                g = gpus[gi % len(gpus)]
                gi += 1
                g.add(bb)
                g.pinned.add(bb.key)
                placed_backbones[name] = g.gpu_id
            self._serverful_gpus.add(g.gpu_id)
            for a in (kern, ad):
                if not g.holds(a.key):
                    g.add(a)
                    g.pinned.add(a.key)
            c = self.cluster.containers_of_gpu(g.gpu_id)[0]
            lib = next(a for a in arts if a.kind == Kind.LIBRARY)
            if not c.holds(lib.key):
                c.add(lib)
            c.warm = True
            self._warm[f.fn_id] = (c.container_id, float("inf"))

    # ----------------------------------------------------------- dispatch
    def _pick_gpu(self, f: FunctionDef):
        owner, name = self._backbone_key_name(f)
        key = (owner, Kind.BACKBONE, name)
        g = self.cluster.find_gpu_with(key)
        if g is not None:
            return g
        return max(self.cluster.gpus, key=lambda g: g.free)

    def _ensure_gpu_space(self, gpu, need: int, now: float) -> Optional[float]:
        """Free `need` bytes. Returns extra wait seconds, or None if the
        batch must retry later (no-offload policy)."""
        if gpu.free >= need:
            return 0.0
        if self.policy.dynamic_offload:
            plan = plan_offload(gpu, need, self.cluster, self._rates)
            if plan is not None:
                apply_offload(plan, self.cluster)
                return 0.0
        # wait for the earliest completion on this gpu
        running = self._running.get(gpu.gpu_id, [])
        if running:
            return None   # caller re-queues at next completion
        # last resort: force-evict unpinned artifacts even without offloader
        plan = plan_offload(gpu, need, self.cluster, self._rates)
        if plan is not None:
            apply_offload(plan, self.cluster)
            return 0.0
        return None

    def _dispatch(self, batch: List[Request], now: float) -> None:
        f = self.functions[batch[0].fn_id]
        gpu = self._pick_gpu(f)
        if gpu.active_batches >= self.policy.max_concurrency:
            # chip saturated: keep collecting (continuous-batching style)
            self._requeue(batch, gpu, now)
            return
        arts = {a.kind: a for a in self._artifacts_for(f)}
        bd: Dict[str, float] = {}
        cold = 0.0

        # container / runtime warm-up
        warm = self._warm.get(f.fn_id)
        cont = None
        if warm is not None:
            cont = self.cluster.container(warm[0])
            if cont.gpu_id != gpu.gpu_id:
                cont = None
        if cont is None:
            cands = self.cluster.containers_of_gpu(gpu.gpu_id)
            lib_key = (f.fn_id, Kind.LIBRARY, "libs")
            cont = min(cands, key=lambda c: (not c.holds(lib_key),
                                             c.busy_until))
            if not cont.warm:
                bd["container_init"] = self.hw.container_init_s
                cont.warm = True
            bd["runtime_init"] = self.hw.runtime_init_s

        # libraries
        lib = arts[Kind.LIBRARY]
        if not cont.holds(lib.key):
            bd["library_load"] = lib.load_remote_s
            if cont.free >= lib.nbytes:
                cont.add(lib)

        # backbone
        bb = arts[Kind.BACKBONE]
        if not gpu.holds(bb.key):
            t_load = 0.0
            if self.cluster.find_host_with(bb.key) is None \
                    and not self.policy.fast_checkpoint:
                t_load += bb.load_remote_s
            t_load += bb.load_host_s
            wait = self._ensure_gpu_space(gpu, bb.nbytes, now)
            if wait is None:
                self._requeue(batch, gpu, now)
                return
            bd["backbone_load"] = t_load
            gpu.add(bb)
        self._last_use[bb.key] = now

        # adapter
        ad = arts[Kind.ADAPTER]
        if not gpu.holds(ad.key):
            t_load = 0.0
            if self.cluster.find_host_with(ad.key) is None:
                t_load += ad.load_remote_s
            t_load += ad.load_host_s
            if self._ensure_gpu_space(gpu, ad.nbytes, now) is None:
                self._requeue(batch, gpu, now)
                return
            bd["adapter_load"] = t_load
            gpu.add(ad)
        self._last_use[ad.key] = now

        # kernel / compiled program
        kern = arts[Kind.KERNEL]
        if not gpu.holds(kern.key):
            if self._ensure_gpu_space(gpu, kern.nbytes, now) is None:
                self._requeue(batch, gpu, now)
                return
            bd["kernel_compile"] = kern.load_host_s
            gpu.add(kern)
        self._last_use[kern.key] = now

        # KV-cache memory for the batch (step 7: dynamic memory management)
        b = len(batch)
        ctx = batch[0].prompt_len + batch[0].output_len
        kv_need = b * self.lat.kv_bytes_per_request(f.cfg, ctx)
        wait = self._ensure_gpu_space(gpu, kv_need, now)
        if wait is None:
            self._requeue(batch, gpu, now)
            return
        gpu.kv_reserved += kv_need
        for k in (bb.key, ad.key, kern.key):
            gpu.pinned.add(k)

        cold = sum(bd.values())
        prof = self._profiles[f.fn_id]
        M = gpu.active_batches + 1                  # Eq. 4 contention
        gpu.active_batches = M
        t_prefill = prof.t(b) * M
        t_decode = (batch[0].output_len - 1) * M * \
            self.lat.decode_s_per_token(f.cfg, b, ctx)
        overhead = self.sched_overhead_s
        self._overhead += overhead
        t_first = now + overhead + cold + t_prefill
        t_done = t_first + t_decode
        for r in batch:
            r.dispatch = now
            r.cold_start = cold
            r.breakdown = dict(bd)
            r.breakdown["queue_wait"] = now - r.arrival
            r.breakdown["prefill"] = t_prefill
            r.breakdown["decode"] = t_decode
            r.first_token = t_first
            r.done = t_done
            self.meter.count_invocation()
        cont.busy_until = t_done
        self._warm[f.fn_id] = (cont.container_id, now)
        # billing: artifacts in active use billed through completion plus the
        # function keep-alive window (the user-visible "warm instance" cost)
        ka = self.policy.keepalive_s
        for k in (bb.key, ad.key, kern.key, lib.key):
            self._billed_until[k] = max(self._billed_until.get(k, 0.0),
                                        t_done + ka)
        self._running.setdefault(gpu.gpu_id, []).append((t_done, kv_need))
        self._push(t_done, "complete",
                   (gpu.gpu_id, kv_need, (bb.key, ad.key, kern.key)))
        self._bill(now)

    def _requeue(self, batch: List[Request], gpu, now: float) -> None:
        """Chip saturated / memory full: retry at the earliest completion."""
        running = self._running.get(gpu.gpu_id, [])
        t_retry = min((t for t, _ in running), default=now + 0.05) + 1e-6
        self._sched.queues[batch[0].fn_id].push_front(batch)
        self._arm_timer(t_retry)

    # --------------------------------------------------------------- run
    def run(self, workload: List[Dict], *, preload_at: float = 0.0,
            replan_every: float = 60.0) -> SimResult:
        # estimate per-function rates from the workload itself (the paper's
        # scheduler analyses arrival frequency)
        horizon = max((w["arrival"] for w in workload), default=1.0) + 1.0
        counts: Dict[str, int] = {}
        for w in workload:
            counts[w["fn_id"]] = counts.get(w["fn_id"], 0) + 1
        for fn, c in counts.items():
            self._rates[fn] = c / horizon

        for f in self.functions.values():
            slo = next((w["slo_ttft"] for w in workload
                        if w["fn_id"] == f.fn_id), 2.5)
            plen = next((w["prompt_len"] for w in workload
                         if w["fn_id"] == f.fn_id), 512)
            olen = next((w["output_len"] for w in workload
                         if w["fn_id"] == f.fn_id), 64)
            # memory cap (§4.3): batch bounded by HBM left for KV after the
            # resident artifacts; backbone sharing frees (n_fns-1) replicas.
            kv_per = self.lat.kv_bytes_per_request(f.cfg, plen + olen)
            bb = self.lat.backbone_bytes(f.cfg)
            n_share = 1 if self.policy.share_backbone else max(
                1, sum(1 for g in self.functions.values()
                       if g.backbone_id == f.backbone_id))
            resident = bb * n_share + KERNEL_BYTES * len(self.functions) // 2
            free_kv = max(self.hw.hbm_bytes - resident
                          - 2 * 2 ** 30, kv_per)
            mem_cap = max(1, int(free_kv // kv_per))
            prof = profile_function(f.cfg, plen, slo, self.lat,
                                    mem_cap_batch=mem_cap)
            self._profiles[f.fn_id] = prof
            self._sched.register(f.fn_id, prof)
        self._sched.warm_hint = self._is_warm
        self._sched.rate_hint = lambda fn: self._rates.get(fn, 0.1)

        self._preload_stage(preload_at)
        self._bill(0.0)

        for w in workload:
            r = Request(**w)
            self.requests.append(r)
            self._push(r.arrival, "arrival", r)
        if not self.policy.serverful:
            t = replan_every
            while t < horizon:
                self._push(t, "replan", None)
                t += replan_every
            t = 30.0
            while t < horizon + 300:
                self._push(t, "keepalive", None)
                t += 30.0

        while self._events:
            now, _, kind, payload = heapq.heappop(self._events)
            self.meter.advance(now)
            if kind == "timer":
                self._armed_timers.discard(now)
            if kind == "arrival":
                self._sched.push(payload)
            elif kind == "complete":
                gpu_id, kv, keys = payload
                g = self.cluster.gpu(gpu_id)
                g.kv_reserved -= kv
                g.active_batches -= 1
                self._running[gpu_id] = [
                    (t, k) for (t, k) in self._running.get(gpu_id, [])
                    if t > now + 1e-9]
                if g.active_batches == 0:
                    for k in keys:
                        g.pinned.discard(k)
                self._bill(now)
            elif kind == "keepalive":
                self._expire_keepalive(now)
            elif kind == "replan":
                self._preload_stage(now)
                self._bill(now)
            # after any event, dispatch ready batches and arm the next timer
            ready = self._sched.ready_queues(now)
            dispatched_fns = set()
            for q in ready:
                if q.fn_id in dispatched_fns:
                    continue          # already requeued this event
                batch = q.pop_batch()
                if batch:
                    dispatched_fns.add(q.fn_id)
                    self._dispatch(batch, now)
            nt = self._sched.next_timer(now)
            if nt is not None and nt > now:
                self._arm_timer(nt)

        self.meter.advance(max((r.done for r in self.requests
                                if r.done > 0), default=0.0))
        return SimResult(self.policy.name, self.requests,
                         self.meter.dollars, self.meter.gpu_byte_s,
                         self._overhead)

    def _expire_keepalive(self, now: float) -> None:
        """Baselines drop artifacts when the billed keep-alive lapses.
        ServerlessLoRA's pre-loaded artifacts instead stay resident for free
        (over-allocated idle memory, §2.4) until the Dynamic Offloader or a
        re-plan displaces them — so residency (what drives warm starts) and
        billing (what drives cost) are decoupled, as in the paper."""
        if not self.policy.dynamic_offload:
            ka = self.policy.keepalive_s
            for g in self.cluster.gpus:
                for key in list(g.resident):
                    if key in g.pinned:
                        continue
                    if now - self._last_use.get(key, 0.0) > ka and \
                            key[1] not in self.policy.preload_kinds:
                        g.remove(key)
            for c in self.cluster.containers:
                for key in list(c.resident):
                    if now - self._last_use.get(key, now) > 4 * ka and \
                            key[1] not in self.policy.preload_kinds:
                        c.remove(key)
        self._bill(now)
