"""Dry run of every (architecture x input shape) on the production meshes
(port of ``repro/launch/dryrun.py``): per-device argument bytes, FLOPs
and collectives, with nothing allocated.

  python -m repro_torch.launch.dryrun --arch llama2_7b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--optimized] \\
      [--skip-existing]

Results land in ``results/dryrun_torch/<arch>__<shape>__<mesh>.json``.

The reference lowers and compiles each step with XLA over 256 or 512
forced host devices and reads the numbers off the compiled artifact.
PyTorch has no ahead-of-time partitioner, so the port EXECUTES the step,
eagerly, on tensors of the meta device laid out as DTensors over a fake
world of 256 or 512 ranks (``mesh.fake_world``): the args carry the
sharding policy's placements (``launch/sharding.py``), DTensor inserts
the redistributions its sharding propagation needs, and nothing is
allocated or computed.  The report reads:
  * argument bytes per device (params, adapters, optimizer state, cache,
    batch), exact, from each arg's local shard;
  * FLOPs per device, counted on the LOCAL ops (``StepCounter`` lets
    DTensor desugar each op into its shard-local ops and collectives
    before counting, so a product column-sharded 4 ways counts a quarter
    of its global FLOPs), plus each kernel's ``work()`` (its meta branch
    computes nothing); for a dense or dropless MoE decoder also
    ``analytic_flops`` over the devices, and the ratio of the two: 1 when
    no device repeats another's work.  The products place their operands
    themselves (``models/layers.py::matmul``), so the count does not hang
    on the strategy a torch release's DTensor picks;
  * collectives by kind: count and result bytes per device;
  * temp/peak bytes: null, with the reason (no meta-safe tracker).
The two-pod mesh's steps execute with ("pod", "data") flattened into one
32-way axis (``run_one``): the shards are the same.
Regions DTensor cannot propagate (the ring cache writes and the kernels,
``models/layers.py::_ring_attention``; the MoE routing) run per shard on
local tensors, as the reference's per-shard math does; the
redistributions they force show among the collectives.

The reference's depth probes (``_probe_reports``) are dropped: they
corrected XLA counting a scan body once, and an eager run counts every
layer.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.kernels import cuda_lib
from repro_torch.launch.mesh import (fake_world, make_mesh,
                                     make_production_mesh)
from repro_torch.launch.sharding import (BASELINE, OPTIMIZED,
                                         ShardingOptions, batch_specs,
                                         cache_specs, local_shape,
                                         params_specs, to_placements)
from repro_torch.launch.specs import (INPUT_SHAPES, StepSpec, adapt_config,
                                      build_step)
from repro_torch.models import moe as moe_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models import transformer as tf_mod
from repro_torch.training.adamw import AdamWState

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")
TEMP_NULL_REASON = ("no meta-safe allocator tracker: meta tensors make no "
                    "allocations, so the step's temporaries and peak are "
                    "not seen; chip_smoke.py phase 17b measures the peak "
                    "on the card at a reduced batch")

_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast_": "broadcast",
}


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


class StepCounter:
    """FLOPs and collectives of a step, per device.  An op on DTensors is
    handed back to DTensor (``NotImplemented``), which desugars it into
    local ops and collectives that come back here: so every count is of a
    device's own shards."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry
        counter = self
        self.flops = 0
        self.flops_by_op: Dict[str, int] = defaultdict(int)
        self.collectives: Dict[str, Dict[str, float]] = {}

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                from torch._subclasses.fake_tensor import FakeTensor
                from torch.distributed.tensor import DTensor
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                out = func(*args, **(kwargs or {}))
                if any(issubclass(t, FakeTensor) for t in types):
                    return out       # DTensor's shape inference, no work
                packet = func._overloadpacket
                if packet in flop_registry:
                    n = int(flop_registry[packet](*args, **(kwargs or {}),
                                                  out_val=out))
                    counter.flops += n
                    counter.flops_by_op[str(packet)] += n
                kind = _COLLECTIVES.get(packet.__name__)
                if kind is not None:
                    rec = counter.collectives.setdefault(
                        kind, {"count": 0, "bytes": 0.0})
                    rec["count"] += 1
                    rec["bytes"] += float(sum(
                        t.numel() * t.element_size() for t in _tensors(out)))
                return out

        self.mode = _Mode()

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)


def analytic_flops(cfg, shape_name: str,
                   capacity: bool = False) -> Optional[int]:
    """The step's FLOPs over all devices, counted by hand, for a
    decoder-only dense or MoE model (SwiGLU or squared-ReLU MLP, no image
    prefix, a sliding window or none); None for any other config, and for
    an MoE whose step runs the capacity dispatch (``capacity``: its
    products follow the data).  An MoE counts its dropless dispatch as
    the port runs it (``models/moe.py::_moe_math``): the router, then
    every expert over every row.  The products count 2 per multiply-add;
    attention counts as the step computes it:
      * train_4k (LoRA, remat): forward, the remat recompute, which stops
        once the last tensor the backward needs is back (so each layer's
        down projection runs twice, not three times; an MoE's runs three
        times, its combine needing the experts' outputs), and the
        backward's input gradients (the backbone is frozen, so no weight
        gradients but the adapters'; layer 0's q/k/v input needs none).
        Attention is ``attention_chunked``'s full blocks past 2048
        positions (else ``attention_core``'s full scores): 4 B T^2 H hd a
        pass, the backward twice that;
      * prefill_32k: one forward, the flash kernel's causal pairs inside
        the window (``flash_attention.ops.visible_pairs``), logits of the
        last position;
      * decode_32k: one token a row, the ring-decode kernel over the whole
        ring, the window long at most (its ``work()`` on meta tensors).
    Held against the counted FLOPs times the devices, it shows work that
    a device repeats (a product or an attention block left unsplit)."""
    from repro_torch.kernels.flash_attention.ops import visible_pairs
    from repro_torch.models.config import MOE, SQRELU, SWIGLU
    moe = cfg.mlp_for == MOE                         # SwiGLU experts
    if (cfg.family not in ("dense", "moe") or (moe and capacity)
            or cfg.mlp_for not in (SWIGLU, SQRELU, MOE)
            or shape_name not in ("train_4k", "prefill_32k", "decode_32k")):
        return None
    sh = INPUT_SHAPES[shape_name]
    B, T = sh["global_batch"], sh["seq_len"]
    L, D, F, V = cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
    H, hd = cfg.num_heads, cfg.head_dim_
    Hq, Kv = H * hd, cfg.num_kv_heads * hd
    E = cfg.num_experts if moe else 1
    mlp = (2 if cfg.mlp_for == SQRELU else 3) * D * F * E \
        + (D * E if moe else 0)                      # the router
    W = cfg.sliding_window
    proj = {"q": (D, Hq), "k": (D, Kv), "v": (D, Kv), "o": (Hq, D)}
    per_tok = D * Hq + 2 * D * Kv + Hq * D + mlp
    r = cfg.lora.rank if cfg.lora else 0
    sites = [proj[t] for t in (cfg.lora.targets if cfg.lora else ())
             if t in proj]
    lora = sum(2 * r * (a + b) for a, b in sites)   # a token, forward
    if shape_name == "decode_32k":
        ring = B * min(T, W or T) * 4 * hd * H      # every slot visible
        return L * (B * (2 * per_tok + lora) + ring) + 2 * B * D * V
    if shape_name == "prefill_32k":
        pairs = visible_pairs(T, T, window=W)
        return (L * (B * T * (2 * per_tok + lora) + 4 * hd * H * B * pairs)
                + 2 * B * D * V)
    N = B * T
    Tp = -(-T // 1024) * 1024 if T > 2048 else T
    att = 4 * B * Tp * Tp * H * hd
    fwd = N * (2 * per_tok + lora) + att
    recompute = fwd - (0 if moe else N * 2 * D * F)
    back = (N * (2 * per_tok + 2 * lora) + 2 * att)
    first = N * 2 * (D * Hq + 2 * D * Kv) + N * sum(
        2 * r * a for t, (a, b) in proj.items()
        if t != "o" and (a, b) in sites)
    head = 2 * N * D * V
    return L * (fwd + recompute + back) - first + 2 * head


# ----------------------------------------------------------- placement
def _map_with_specs(tree, specs, fn):
    """fn(leaf, spec) over a data tree and its spec tree (host ints and
    None leaves pass through)."""
    if isinstance(tree, AdamWState):
        return AdamWState(fn(tree.step, ()), _map_with_specs(tree.mu, specs.mu,
                                                              fn),
                          _map_with_specs(tree.nu, specs.nu, fn))
    if isinstance(tree, dict):
        return {k: _map_with_specs(v, specs[k], fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_specs(v, s, fn)
                          for v, s in zip(tree, specs))
    if isinstance(tree, torch.Tensor):
        return fn(tree, specs)
    return tree


def distribute(tree, specs, mesh):
    """Each tensor leaf as a DTensor with its spec's placements, over a
    local shard of the leaf's dtype on the leaf's device (meta: no
    storage; a real leaf on a one-rank mesh: the leaf itself)."""
    from torch.distributed.tensor import DTensor

    def leaf(t, spec):
        pl = to_placements(spec, mesh)
        if t.device.type == "meta":
            local = torch.empty(local_shape(t.shape, spec, mesh),
                                dtype=t.dtype, device="meta")
        elif mesh.size() == 1:
            local = t
        else:
            raise ValueError("distribute: real tensors only on a one-rank "
                             "mesh (use the launcher's sharding for more)")
        return DTensor.from_local(local, mesh, pl, run_check=False)

    return _map_with_specs(tree, specs, leaf)


def local_bytes(tree, specs, mesh) -> int:
    """Bytes a device holds of ``tree`` under ``specs``."""
    total = [0]

    def leaf(t, spec):
        n = 1
        for d in local_shape(t.shape, spec, mesh):
            n *= d
        total[0] += n * t.element_size()
        return t

    _map_with_specs(tree, specs, leaf)
    return total[0]


def arg_specs(step: StepSpec, mesh, cfg, opts: ShardingOptions = BASELINE):
    """Specs of the step's args, as the reference's ``arg_shardings``:
    each category with its names."""
    if step.name == "train_step":
        backbone, adapters, opt_state, batch = step.args
        so = AdamWState((), params_specs(opt_state.mu, mesh, cfg, opts),
                        params_specs(opt_state.nu, mesh, cfg, opts))
        return {"params": params_specs(backbone, mesh, cfg, opts),
                "adapters": params_specs(adapters, mesh, cfg, opts),
                "optimizer": so, "batch": batch_specs(batch, mesh)}
    if step.name == "prefill_step":
        params, batch, cache = step.args
        return {"params": params_specs(params, mesh, cfg, opts),
                "batch": batch_specs(batch, mesh),
                "cache": cache_specs(cache, mesh, cfg, opts)}
    params, token, cache, pos = step.args
    return {"params": params_specs(params, mesh, cfg, opts),
            "batch": (batch_specs(token, mesh), ()),
            "cache": cache_specs(cache, mesh, cfg, opts)}


def _categories(step: StepSpec) -> Dict[str, Any]:
    """The step's args by category, in the order ``arg_specs`` names."""
    a = step.args
    if step.name == "train_step":
        return {"params": a[0], "adapters": a[1], "optimizer": a[2],
                "batch": a[3]}
    if step.name == "prefill_step":
        return {"params": a[0], "batch": a[1], "cache": a[2]}
    return {"params": a[0], "batch": (a[1], a[3]), "cache": a[2]}


def distributed_args(step: StepSpec, specs: Dict[str, Any], mesh
                     ) -> Tuple[Any, ...]:
    """The step's args as DTensors, in the step's order."""
    d = {k: distribute(v, specs[k], mesh)
         for k, v in _categories(step).items()}
    if step.name == "train_step":
        return d["params"], d["adapters"], d["optimizer"], d["batch"]
    if step.name == "prefill_step":
        return d["params"], d["batch"], d["cache"]
    return d["params"], d["batch"][0], d["cache"], d["batch"][1]


def argument_bytes(step: StepSpec, specs: Dict[str, Any], mesh
                   ) -> Dict[str, int]:
    """Per-device bytes of each category of the step's args, and their
    sum under "total"."""
    out = {k: local_bytes(v, specs[k], mesh)
           for k, v in _categories(step).items()}
    out["total"] = sum(out.values())
    return out


def set_opt_modes(mesh, opts: Optional[ShardingOptions]) -> None:
    """Install (or clear, with None) the module-level modes around a run:
    shard-local MoE routing and its dispatch.  The activation hook stays
    unset, as the reference leaves it (its carry constraint was refuted
    there)."""
    if mesh is None or opts is None:
        moe_mod.set_parallel_mesh(None)
        moe_mod.set_dispatch("ragged")
        tf_mod.set_activation_spec(None)
        return
    moe_mod.set_parallel_mesh(mesh if opts.moe_shard_map else None)
    moe_mod.set_dispatch(opts.moe_dispatch)
    tf_mod.set_activation_spec(None)


def run_step(step: StepSpec, args, mesh) -> Dict[str, Any]:
    """Execute ``step`` on its distributed args under the counters."""
    from torch.distributed.tensor.experimental import implicit_replication
    with cuda_lib.record_work() as work, StepCounter() as counter, \
            implicit_replication():
        step.fn(*args)
    kernels: Dict[str, Dict[str, float]] = {}
    for name, w in work:
        rec = kernels.setdefault(name, {"calls": 0, "flops": 0,
                                        "bytes": 0})
        rec["calls"] += 1
        rec["flops"] += w.flops
        rec["bytes"] += w.bytes
    kflops = sum(r["flops"] for r in kernels.values())
    return {"flops": counter.flops + kflops,
            "aten_flops": counter.flops,
            "aten_flops_by_op": dict(counter.flops_by_op),
            "kernels": kernels, "collectives": counter.collectives}


def mesh_name(multi_pod: bool, tag: str = "") -> str:
    return ("pod2x16x16" if multi_pod else "pod16x16") + tag


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            save: bool = True, opts: ShardingOptions = BASELINE,
            tag: str = "", world: bool = True,
            config: Optional[ModelConfig] = None) -> Dict:
    """The report of one (arch, shape, mesh).  ``world`` starts the fake
    world of 256 or 512 ranks for the call (False: one is already up);
    ``config`` replaces the arch's config (a cut depth)."""
    cfg0 = config or get_config(arch)
    cfg = adapt_config(cfg0, shape_name)
    name = mesh_name(multi_pod, tag)
    if cfg is None:
        report = {"arch": arch, "shape": shape_name, "mesh": name,
                  "skipped": "full-attention enc-dec cannot serve 524288 "
                             "context"}
        if save:
            _save(report)
        return report
    if world:
        with fake_world(512 if multi_pod else 256):
            return run_one(arch, shape_name, multi_pod=multi_pod, save=save,
                           opts=opts, tag=tag, world=False, config=config)
    t0 = time.perf_counter()
    step = build_step(cfg0, shape_name)
    mesh = make_production_mesh(multi_pod=multi_pod)
    specs = arg_specs(step, mesh, cfg, opts)
    arg_b = argument_bytes(step, specs, mesh)
    if multi_pod:
        # executed over ("pod", "data") flattened into one 32-way "data"
        # axis: every rule shards over the two together (as one replica
        # group of 32 in XLA), so each arg's shard is the same; and DTensor
        # before torch 2.13 cannot shard one dim over two mesh dims
        mesh = make_mesh((32, 16), ("data", "model"))
        specs = arg_specs(step, mesh, cfg, opts)
        if argument_bytes(step, specs, mesh) != arg_b:
            raise AssertionError("the flattened mesh shards differently")
    args = distributed_args(step, specs, mesh)
    t_build = time.perf_counter() - t0
    sh = INPUT_SHAPES[shape_name]
    set_opt_modes(mesh, opts)
    try:
        counts = run_step(step, args, mesh)
        capacity = moe_mod.runs_capacity(
            cfg, sh["global_batch"],
            1 if step.name == "serve_step" else sh["seq_len"])
    finally:
        set_opt_modes(None, None)
    t_run = time.perf_counter() - t0 - t_build
    analytic = analytic_flops(cfg, shape_name, capacity)
    n_dev = int(mesh.size())
    report = {
        "arch": arch, "shape": shape_name, "mesh": name, "step": step.name,
        "options": dataclasses.asdict(opts),
        "build_s": round(t_build, 2), "run_s": round(t_run, 2),
        "memory": {
            "argument_bytes": arg_b["total"],
            "argument_bytes_by_kind": arg_b,
            "temp_bytes": None, "peak_bytes": None,
            "temp_bytes_null_reason": TEMP_NULL_REASON,
        },
        "cost": {"flops": counts["flops"],
                 "flops_analytic": None if analytic is None
                 else analytic / n_dev,
                 "flops_over_analytic": None if analytic is None
                 else counts["flops"] * n_dev / analytic,
                 "aten_flops": counts["aten_flops"],
                 "aten_flops_by_op": counts["aten_flops_by_op"],
                 "kernels": counts["kernels"]},
        "collectives": counts["collectives"],
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "n_devices": n_dev,
        "num_periods": cfg.num_periods,
        "pattern": list(cfg.pattern),
        "n_tail": len(cfg.remainder_layers),
        "encoder_layers": cfg.encoder_layers,
        "cfg_meta": {
            "n_attn_layers": sum(1 for k in cfg.layer_kinds if k == "attn"),
            "num_heads": cfg.num_heads,
            "head_dim": cfg.head_dim_,
            "kv_heads": cfg.num_kv_heads,
            "window": cfg.sliding_window,
        },
    }
    if save:
        _save(report)
    return report


def _save(report: Dict) -> None:
    os.makedirs(RESULTS_DIR, exist_ok=True)
    fn = f"{report['arch']}__{report['shape']}__{report['mesh']}.json"
    with open(os.path.join(RESULTS_DIR, fn), "w") as f:
        json.dump(report, f, indent=1)


def summary_line(r: Dict) -> str:
    coll = sum(v["bytes"] for v in r["collectives"].values())
    by = r["memory"]["argument_bytes_by_kind"]
    ratio = r["cost"]["flops_over_analytic"]
    vs = "" if ratio is None else f" ({ratio:.4f} x analytic)"
    return (f"[ OK ] {r['arch']:20s} {r['shape']:12s} {r['mesh']} "
            f"run={r['run_s']:6.1f}s flops={r['cost']['flops']:.3e}{vs} "
            f"coll={coll:.3e}B args="
            + " ".join(f"{k}:{v / 1e9:.3f}GB" for k, v in by.items()))


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(INPUT_SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="all assigned archs x shapes on the chosen mesh")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--optimized", action="store_true",
                    help="the OPTIMIZED sharding options (auto TP, "
                         "shard-local MoE); results saved with '-opt'")
    args = ap.parse_args(argv)

    archs = ASSIGNED_ARCHS if args.all or not args.arch else [args.arch]
    shapes = list(INPUT_SHAPES) if args.all or not args.shape \
        else [args.shape]
    tag = "-opt" if args.optimized else ""
    opts = OPTIMIZED if args.optimized else BASELINE
    reports, failures = [], []
    with fake_world(512 if args.multi_pod else 256):
        for arch in archs:
            for shape in shapes:
                name = mesh_name(args.multi_pod, tag)
                out = os.path.join(RESULTS_DIR,
                                   f"{arch}__{shape}__{name}.json")
                if args.skip_existing and os.path.exists(out):
                    print(f"[skip] {arch} {shape} {name} (exists)")
                    continue
                try:
                    r = run_one(arch, shape, multi_pod=args.multi_pod,
                                opts=opts, tag=tag, world=False)
                except Exception as e:  # noqa: BLE001 — report, go on
                    failures.append((arch, shape, str(e)))
                    print(f"[FAIL] {arch:20s} {shape:12s}: {e}")
                    traceback.print_exc()
                    continue
                reports.append(r)
                if r.get("skipped"):
                    print(f"[SKIP] {arch:20s} {shape:12s} {r['skipped']}")
                else:
                    print(summary_line(r), flush=True)
    if failures:
        raise SystemExit(f"{len(failures)} dry-run failures: "
                         + ", ".join(f"{a}/{s}" for a, s, _ in failures))
    print("dry-run complete: every combination ran on the meta device.")
    return reports


if __name__ == "__main__":
    main()
