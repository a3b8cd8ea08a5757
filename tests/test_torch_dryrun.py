"""The port's dry run (``repro_torch/launch/dryrun.py``) and input specs
(``launch/specs.py``) against the reference's arithmetic.

* Argument bytes: one subprocess starts the fake world of 256 ranks
  (512 for the two-pod mesh) and reports, for Llama-2-7B and
  Mixtral-8x22B at full size on the meta device, each step's per-device
  argument bytes by kind for all four shapes on both meshes under both
  option sets, and executes Llama-2-7B's and Mixtral's ``decode_32k``
  through ``dryrun.main``.  Each kind must equal what the reference's
  specs give its ``eval_shape`` args (bytes / shard count, summed), except
  that the reference's ring keeps an int32 ``idx`` per attention layer
  that the port keeps on the host: the port's cache is 4 bytes a layer
  less, exactly.
* FLOPs count local shards: a product column-sharded 4 ways over "model"
  counts a quarter of its global FLOPs.  A whole step's count, in a
  second subprocess: Llama-2-7B at full width cut to 2 layers, its
  train/prefill/decode steps on 16 x 16 and its train step on 2 x 16 x
  16; run on plain meta tensors, the count equals
  ``dryrun.analytic_flops`` exactly (6 P N of the products, less the
  remat's early stop and the frozen first layer's input gradients, plus
  the attention blocks); sharded, each device's count times the devices
  is within 3% of it (the rest: rank-16 LoRA products on partial sums
  whose rows do not divide; 1.7% on the two-pod mesh).
* MoE and windows (F12, F13): Mixtral-8x22B (dropless, window 4096) and
  Phi-3-medium-14B (heads and prefill rows that do not divide "model")
  at 2 layers: the hand count equals the plain meta count, and each
  device's count times the devices is within 3% above it; Mixtral's
  experts' bmm is its 1/256 share, and its decode (both option sets),
  prefill and train steps are within 1.03x the reference's depth probe
  d2 (a third subprocess compiles them with XLA).
* Every kernel wrapper's meta branch returns the kernel's output shape,
  calls no plain version, and records the ``work()`` its bound counts;
  ``work()`` on real inputs equals a brute-force count of its mask.
* ``adapt_config`` and ``build_step``'s kinds for every arch x shape.
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import cuda_lib
from repro_torch.launch import specs as psp

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ("llama2_7b", "mixtral_8x22b")
MESHES = {"pod16x16": {"data": 16, "model": 16},
          "pod2x16x16": {"pod": 2, "data": 16, "model": 16}}

SCRIPT = """
import json, sys
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.launch.sharding import BASELINE, OPTIMIZED
from repro_torch.launch.specs import INPUT_SHAPES, adapt_config, build_step

out = {}
for multi in (False, True):
    with fake_world(512 if multi else 256):
        mesh = make_production_mesh(multi_pod=multi)
        for arch in %(archs)r:
            for shape in INPUT_SHAPES:
                step = build_step(get_config(arch), shape)
                cfg = adapt_config(get_config(arch), shape)
                for tag, opts in (("base", BASELINE), ("opt", OPTIMIZED)):
                    specs = dryrun.arg_specs(step, mesh, cfg, opts)
                    out[f"{arch}/{shape}/{dryrun.mesh_name(multi)}/{tag}"] = \\
                        dryrun.argument_bytes(step, specs, mesh)
dryrun.RESULTS_DIR = sys.argv[2]
dryrun.main(["--arch", "llama2_7b", "--shape", "decode_32k"])
dryrun.main(["--arch", "mixtral_8x22b", "--shape", "decode_32k",
             "--optimized"])
json.dump(out, open(sys.argv[1], "w"))
"""

FLOPS_SCRIPT = """
import json, sys
from repro_torch.configs import get_config
from repro_torch.kernels import cuda_lib
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world
from repro_torch.launch.specs import build_step

from repro_torch.launch.sharding import BASELINE, OPTIMIZED

cfg = get_config("llama2_7b").with_(num_layers=2)
NEMOTRON2 = get_config("nemotron_4_340b").with_(num_layers=2)
# MoE and sliding-window cells at 2 layers: (name, arch, shape, OPTIMIZED)
CELLS = [("mixtral2", "mixtral_8x22b", s, False)
         for s in ("decode_32k", "prefill_32k", "train_4k")] + [
    ("mixtral2", "mixtral_8x22b", "decode_32k", True),
    ("mixtral2", "mixtral_8x22b", "prefill_32k", True),
    ("phi3_2", "phi3_medium_14b", "prefill_32k", False)]
out = {}
for multi, shapes in ((False, ("train_4k", "prefill_32k", "decode_32k")),
                      (True, ("train_4k",))):
    with fake_world(512 if multi else 256):
        for shape in shapes:
            r = dryrun.run_one("llama2_7b", shape, multi_pod=multi,
                               save=False, world=False, config=cfg)
            out[f"{shape}/{r['mesh']}"] = dict(r["cost"],
                                              n_devices=r["n_devices"])
        if not multi:
            r = dryrun.run_one("nemotron_4_340b", "decode_32k", save=False,
                               world=False, config=NEMOTRON2)
            out["nemotron2/decode_32k/pod16x16"] = dict(
                r["cost"], n_devices=r["n_devices"])
            for name, arch, shape, opt in CELLS:
                r = dryrun.run_one(
                    arch, shape, save=False, world=False,
                    config=get_config(arch).with_(num_layers=2),
                    opts=OPTIMIZED if opt else BASELINE)
                out[f"{name}/{shape}/{r['mesh']}{'-opt' if opt else ''}"] = \
                    dict(r["cost"], n_devices=r["n_devices"])


def plain(key, c2, shape):
    step = build_step(c2, shape)
    with cuda_lib.record_work() as work, dryrun.StepCounter() as c:
        step.fn(*step.args)
    out[key] = {"flops": c.flops + sum(w.flops for _, w in work),
                "bmm": c.flops_by_op.get("aten.bmm", 0),
                "analytic": dryrun.analytic_flops(c2, shape)}


for shape in ("train_4k", "prefill_32k", "decode_32k"):
    plain(f"{shape}/plain", cfg, shape)
for name, arch, shape, opt in CELLS:
    if not opt:
        plain(f"{name}/{shape}/plain",
              get_config(arch).with_(num_layers=2), shape)
json.dump(out, open(sys.argv[1], "w"))
"""

# the reference's depth probe d2 (``repro/launch/dryrun.py::_probe_reports``:
# the config at twice its layer pattern, compiled by XLA over the forced
# host devices that importing the module sets up) for Nemotron-4-340B
# decode_32k on 16 x 16: per-device FLOPs of 2 layers; and d2 alone
# (``_compile_stats``, what ``_probe_reports`` compiles for it) for
# Mixtral-8x22B's decode_32k (both option sets), prefill_32k and
# train_4k, and Phi-3-medium-14B's prefill_32k
REF_PROBE_SCRIPT = """
import json, sys
from repro.launch import dryrun
from repro.configs import get_config
from repro.launch.mesh import make_production_mesh
from repro.launch.sharding import BASELINE, OPTIMIZED
mesh = make_production_mesh(multi_pod=False)
cfg = get_config("nemotron_4_340b")
probes = dryrun._probe_reports(cfg, "decode_32k", mesh, BASELINE)
out = {"pattern": list(cfg.pattern), **probes}
for name, arch, cells in (
        ("mixtral", "mixtral_8x22b", (("decode_32k", False),
                                      ("decode_32k", True),
                                      ("prefill_32k", False),
                                      ("train_4k", False))),
        ("phi3", "phi3_medium_14b", (("prefill_32k", False),))):
    c = get_config(arch)
    out[f"{name}_pattern"] = list(c.pattern)
    d2 = c.with_(num_layers=2 * len(c.pattern), layer_pattern=c.pattern * 2)
    for shape, opt in cells:
        out[f"{name}/{shape}{'-opt' if opt else ''}"] = dryrun._compile_stats(
            d2, shape, mesh, OPTIMIZED if opt else BASELINE)
        print(name, shape, opt, out[f"{name}/{shape}{'-opt' if opt else ''}"][
            "flops"])
json.dump(out, open(sys.argv[1], "w"))
"""


class _Mesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _reference_bytes(step, cfg, axes, optimized):
    """Per-device bytes of the reference step's args by kind, from its
    own specs and ``eval_shape`` args."""
    import jax
    from jax.sharding import PartitionSpec as P
    from repro.launch import sharding as rs

    mesh = _Mesh(axes)
    opts = rs.OPTIMIZED if optimized else rs.BASELINE

    def nbytes(specs, args):
        leaves = jax.tree_util.tree_leaves(args, is_leaf=lambda x: x is None)
        flat = jax.tree_util.tree_leaves(
            specs, is_leaf=lambda x: isinstance(x, P) or x is None)
        assert len(flat) == len(leaves)
        total = 0
        for spec, a in zip(flat, leaves):
            if a is None:
                continue
            n = int(np.prod(a.shape)) * a.dtype.itemsize
            for entry in tuple(spec):
                if entry is not None:
                    n //= rs._axis_size(mesh, entry)
            total += n
        return total

    if step.name == "train_step":
        backbone, adapters, opt_state, batch = step.args
        so = type(opt_state)(P(), rs.params_specs(opt_state.mu, mesh, cfg,
                                                  opts),
                             rs.params_specs(opt_state.nu, mesh, cfg, opts))
        return {"params": nbytes(rs.params_specs(backbone, mesh, cfg, opts),
                                 backbone),
                "adapters": nbytes(rs.params_specs(adapters, mesh, cfg,
                                                   opts), adapters),
                "optimizer": nbytes(so, opt_state),
                "batch": nbytes(rs.batch_specs(batch, mesh), batch)}, 0
    if step.name == "prefill_step":
        params, batch, cache = step.args
        batch_b = nbytes(rs.batch_specs(batch, mesh), batch)
    else:
        params, token, cache, pos = step.args
        batch_b = nbytes(rs.batch_specs(token, mesh), token) + 4
    n_idx = sum(int(np.prod(x.shape)) for path, x in
                jax.tree_util.tree_flatten_with_path(cache)[0]
                if getattr(path[-1], "key", None) == "idx")
    return {"params": nbytes(rs.params_specs(params, mesh, cfg, opts),
                             params),
            "batch": batch_b,
            "cache": nbytes(rs.cache_specs(cache, mesh, cfg, opts), cache)
            }, 4 * n_idx


@pytest.fixture(scope="module")
def dry(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dry")
    (tmp / "script.py").write_text(SCRIPT % {"archs": ARCHS})
    (tmp / "flops.py").write_text(FLOPS_SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, str(tmp / "script.py"), str(tmp / "bytes.json"),
         str(tmp / "results")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=str(ROOT))
    fproc = subprocess.Popen(
        [sys.executable, str(tmp / "flops.py"), str(tmp / "flops.json")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=str(ROOT))
    (tmp / "probe.py").write_text(REF_PROBE_SCRIPT)
    rproc = subprocess.Popen(
        [sys.executable, str(tmp / "probe.py"), str(tmp / "probe.json")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=str(ROOT))
    from repro.configs import get_config as ref_config
    from repro.launch.specs import adapt_config, build_step
    want = {}
    for arch in ARCHS:                    # while the subprocess runs
        for shape in psp.INPUT_SHAPES:
            step = build_step(ref_config(arch), shape)
            cfg = adapt_config(ref_config(arch), shape)
            for mesh, axes in MESHES.items():
                for tag in ("base", "opt"):
                    want[f"{arch}/{shape}/{mesh}/{tag}"] = _reference_bytes(
                        step, cfg, axes, tag == "opt")
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, out[-3000:] + err[-5000:]
    fout, ferr = fproc.communicate(timeout=300)
    assert fproc.returncode == 0, fout[-3000:] + ferr[-5000:]
    rout, rerr = rproc.communicate(timeout=300)
    assert rproc.returncode == 0, rout[-3000:] + rerr[-5000:]
    got = json.loads((tmp / "bytes.json").read_text())
    got["flops"] = json.loads((tmp / "flops.json").read_text())
    got["reference_probe"] = json.loads((tmp / "probe.json").read_text())
    return got, want, tmp / "results", out


@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_equal_reference_arithmetic(dry, arch):
    got, want, _, _ = dry
    keys = [k for k in want if k.startswith(arch + "/")]
    assert len(keys) == 16
    for key in keys:
        ref, idx_bytes = want[key]
        port = dict(got[key])
        assert port.pop("total") == sum(port.values())
        if "cache" in ref:
            assert port["cache"] == ref["cache"] - idx_bytes, key
            ref = {k: v for k, v in ref.items() if k != "cache"}
            port.pop("cache")
        assert port == ref, key


def test_reference_byte_counts(dry):
    """The quoted per-device counts: Llama-2-7B decode_32k on 16 x 16,
    0.087 GB of weights + 8.594 GB of cache (BASELINE), 0.876 + 8.594 GB
    (OPTIMIZED)."""
    got = dry[0]
    base = got["llama2_7b/decode_32k/pod16x16/base"]
    opt = got["llama2_7b/decode_32k/pod16x16/opt"]
    assert round(base["params"] / 1e9, 3) == 0.087
    assert round(opt["params"] / 1e9, 3) == 0.876
    assert round(base["cache"] / 1e9, 3) == round(opt["cache"] / 1e9, 3) \
        == 8.594


def test_dryrun_reports(dry):
    """The CLI's reports: argument bytes from the placements, FLOPs on
    local shards (the ring-decode kernel's work included), collectives,
    temp/peak null with the reason, the reference's config metadata."""
    got, _, results, stdout = dry
    assert "dry-run complete" in stdout
    for name, key in (("llama2_7b__decode_32k__pod16x16.json",
                       "llama2_7b/decode_32k/pod16x16/base"),
                      ("mixtral_8x22b__decode_32k__pod16x16-opt.json",
                       "mixtral_8x22b/decode_32k/pod16x16/opt")):
        r = json.loads((results / name).read_text())
        assert r["memory"]["argument_bytes_by_kind"] == got[key]
        assert r["memory"]["temp_bytes"] is None
        assert r["memory"]["peak_bytes"] is None
        assert r["memory"]["temp_bytes_null_reason"]
        assert r["cost"]["flops"] > r["cost"]["aten_flops"] > 0
        k = r["cost"]["kernels"]["decode_attention"]
        assert k["calls"] == r["cfg_meta"]["n_attn_layers"]
        assert r["collectives"] and r["n_devices"] == 256
        assert r["step"] == "serve_step"
    # per device: the ring of 128 rows x 32768 slots sharded 16 ways on
    # rows and 16 on kv heads, one query a row: 4 hd H B S / 256
    r = json.loads((results / "llama2_7b__decode_32k__pod16x16.json"
                    ).read_text())
    cfg = get_config("llama2_7b")
    per_layer = 4 * 128 * 32 * 128 * 32768 // 256
    assert r["cost"]["kernels"]["decode_attention"]["flops"] == \
        cfg.num_layers * per_layer


def test_flops_count_local_shards():
    """A product column-sharded 4 ways over "model" counts a quarter of
    its global FLOPs on a device."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch.dryrun import StepCounter
    from repro_torch.launch.mesh import fake_world, make_debug_mesh
    with fake_world(4):
        mesh = make_debug_mesh(1, 4)
        x = DTensor.from_local(torch.empty(8, 64, device="meta"), mesh,
                               [Replicate(), Replicate()], run_check=False)
        w = DTensor.from_local(torch.empty(64, 256 // 4, device="meta"),
                               mesh, [Replicate(), Shard(1)],
                               run_check=False)
        with StepCounter() as c, implicit_replication():
            y = x @ w
        assert y.placements[1] == Shard(1)
        assert c.flops == 2 * 8 * 64 * 256 // 4


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k",
                                   "decode_32k"])
def test_analytic_flops_equal_the_plain_count(dry, shape):
    """The hand count equals the counter's on plain meta tensors."""
    r = dry[0]["flops"][f"{shape}/plain"]
    assert r["analytic"] == r["flops"]


@pytest.mark.parametrize("key", ["train_4k/pod16x16", "prefill_32k/pod16x16",
                                 "decode_32k/pod16x16",
                                 "train_4k/pod2x16x16"])
def test_step_flops_per_device_match_analytic(dry, key):
    """A whole step's per-device FLOPs times the devices: no device
    repeats another's products or attention blocks (within 3%)."""
    r = dry[0]["flops"][key]
    shape = key.split("/")[0]
    analytic = dry[0]["flops"][f"{shape}/plain"]["analytic"]
    assert r["flops_analytic"] * r["n_devices"] == analytic
    assert r["flops_over_analytic"] == r["flops"] * r["n_devices"] / analytic
    assert 1.0 - 1e-9 <= r["flops_over_analytic"] <= 1.03, r


def test_nemotron_decode_flops_within_reference_probe(dry):
    """Nemotron-4-340B at 2 layers, decode_32k on 16 x 16: its 8 kv heads
    do not divide "model", so the ring is split on head_dim; each device
    still takes its share of the attention (6 query heads and the kv head
    they read), and its FLOPs stay within 3% of the reference's depth
    probe d2 for the same cell (the whole data shard's attention on every
    model rank read 2.6x it)."""
    ref = dry[0]["reference_probe"]
    assert ref["pattern"] == ["attn"]          # d2 = 2 layers
    r = dry[0]["flops"]["nemotron2/decode_32k/pod16x16"]
    assert r["n_devices"] == 256
    assert 0 < r["flops"] <= 1.03 * ref["d2"]["flops"], (r["flops"], ref)


def _wrapper_cases():
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.paged_attention import ops as pops
    from repro_torch.kernels.paged_prefill import ops as ppops
    from repro_torch.kernels.sgmv import ops as sops
    g = torch.Generator().manual_seed(0)

    def r(*s):
        return torch.randn(s, generator=g)

    B, T, K, G, hd, S, bs, NB, MB = 2, 40, 2, 2, 32, 48, 8, 16, 6
    H = K * G
    slot_pos = torch.arange(S, dtype=torch.int32)
    slot_pos[30:] = -1
    tbl = torch.randint(1, NB, (B, MB), generator=g, dtype=torch.int32)
    tbl[1, 2] = -1
    pos = torch.tensor([33, 40], dtype=torch.int32)
    q_pos = (torch.tensor([16, 24])[:, None] + torch.arange(8)[None]).to(
        torch.int32)
    idx = torch.tensor([0, 1, 1, 3, 0], dtype=torch.int32)
    return [
        ("flash", fops, fops.flash_mha, (r(B, T, H, hd), r(B, T, K, hd),
                                         r(B, T, K, hd)),
         dict(window=16, prefix_len=5)),
        ("decode", dops, dops.decode_gqa,
         (r(B, H, hd), r(B, S, K, hd), r(B, S, K, hd), slot_pos, 29),
         dict(window=20)),
        ("paged", pops, pops.paged_decode_gqa,
         (r(B, H, hd), r(K, NB, bs, hd), r(K, NB, bs, hd), tbl, pos),
         dict(window=24)),
        ("prefill", ppops, ppops.paged_prefill_gqa,
         (r(B, 8, H, hd), r(K, NB, bs, hd), r(K, NB, bs, hd), tbl, q_pos),
         {}),
        ("sgmv", sops, sops.sgmv_apply,
         (r(5, 64), r(3, 64, 8), r(3, 8, 48), idx), {}),
    ]


@pytest.mark.parametrize("name", ["flash", "decode", "paged", "prefill",
                                  "sgmv"])
def test_meta_branch_returns_the_kernel_shape(name, monkeypatch):
    for case in _wrapper_cases():
        if case[0] != name:
            continue
        _, mod, fn, args, kw = case
        want = fn(*args, **kw)                      # the plain version
        for ref in ("flash_ref", "decode_attention_ref",
                    "paged_attention_ref", "paged_prefill_ref", "sgmv_ref"):
            if hasattr(mod, ref):
                monkeypatch.setattr(mod, ref, None)  # calling it raises
        meta = [a.to("meta") if isinstance(a, torch.Tensor) else a
                for a in args]
        with cuda_lib.record_work() as work:
            out = fn(*meta, **kw)
        assert out.device.type == "meta"
        assert out.shape == want.shape and out.dtype == want.dtype
        assert [w[0] for w in work] == [
            {"flash": "flash_attention", "decode": "decode_attention",
             "paged": "paged_attention", "prefill": "paged_prefill",
             "sgmv": "sgmv"}[name]]
        if name == "decode":                # the split-KV merge's lse too
            with cuda_lib.record_work() as work:
                out, lse = fn(*meta, **kw, return_lse=True)
            assert out.shape == want.shape and lse.device.type == "meta"
            assert lse.shape == want.shape[:2] and lse.dtype == torch.float32
            assert [w[0] for w in work] == ["decode_attention"]


def test_work_counts_equal_brute_force():
    """``work()`` (what the bounds in chip_smoke.py and the dry run's
    kernel FLOPs read) against the masks counted element by element."""
    cases = {c[0]: c for c in _wrapper_cases()}
    _, fops, _, (q, k, v), kw = cases["flash"]
    T = q.shape[1]
    i = torch.arange(T)[:, None]
    j = torch.arange(T)[None]
    ok = ((j <= i) | (j < kw["prefix_len"])) & (j > i - kw["window"])
    w = fops.work(q, k, v, **kw)
    assert w.flops == 4 * 32 * 4 * 2 * int(ok.sum())
    assert fops.visible_pairs(T, T, causal=False) == T * T
    _, dops, _, (q, k, v, sp, pos), kw = cases["decode"]
    valid = int(((sp >= 0) & (sp <= pos) & (sp > pos - kw["window"])).sum())
    assert dops.work(q, k, v, sp, pos, **kw).flops == 4 * 32 * 4 * 2 * valid
    assert dops.work(q.to("meta"), k.to("meta"), v.to("meta"),
                     sp.to("meta"), torch.empty((), device="meta")
                     ).flops == 4 * 32 * 4 * 2 * 48
    _, sops, _, (x, a, b, idx), _ = cases["sgmv"]
    w = sops.work(x, a, b, idx)
    assert w.flops == 2 * 4 * 8 * (64 + 48)         # 4 rows in range
    assert w.bytes == 4 * (5 * 64 + 2 * 8 * (64 + 48) + 5 * 48) + 4 * 5


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_adapt_config_and_step_kinds(arch):
    """Every arch x shape: the reference's ``adapt_config`` rule and the
    step each shape lowers (train / prefill / serve, None when skipped)."""
    from repro.configs import get_config as ref_config
    from repro.launch.specs import adapt_config as ref_adapt
    kinds = {"train_4k": "train_step", "prefill_32k": "prefill_step",
             "decode_32k": "serve_step", "long_500k": "serve_step"}
    for shape in psp.INPUT_SHAPES:
        ref = ref_adapt(ref_config(arch), shape)
        cfg = psp.adapt_config(get_config(arch), shape)
        assert (ref is None) == (cfg is None)
        step = psp.build_step(get_config(arch), shape)
        if cfg is None:
            assert step is None
            continue
        assert cfg.sliding_window == ref.sliding_window
        assert step.name == kinds[shape]
        if step.name == "serve_step":
            _, token, cache, pos = step.args
            assert token.shape == (128 if shape == "decode_32k" else 1,)
            assert pos.shape == () and token.device.type == "meta"


def test_activation_spec_hook():
    """``transformer.set_activation_spec``: unset, it does nothing (as the
    reference's); set, a DTensor activation is redistributed to the spec
    and a plain tensor passes unchanged."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch.mesh import fake_world, make_debug_mesh
    from repro_torch.models import transformer as tf
    with fake_world(4):
        mesh = make_debug_mesh(2, 2)
        x = DTensor.from_local(torch.empty(4, 8, 16, device="meta"), mesh,
                               [Replicate(), Shard(2)], run_check=False)
        assert tf._constrain(x) is x
        tf.set_activation_spec(("data", None, None), mesh)
        try:
            y = tf._constrain(x)
            plain = torch.empty(4, 8, 16)
            assert tf._constrain(plain) is plain
        finally:
            tf.set_activation_spec(None)
        assert list(y.placements) == [Shard(0), Replicate()]
        assert y.shape == (4, 8, 32) and y.to_local().shape == (2, 8, 32)


MOE_CELLS = ["mixtral2/decode_32k/pod16x16", "mixtral2/prefill_32k/pod16x16",
             "mixtral2/train_4k/pod16x16", "mixtral2/decode_32k/pod16x16-opt",
             "phi3_2/prefill_32k/pod16x16"]


@pytest.mark.parametrize("key", MOE_CELLS)
def test_moe_and_window_flops_per_device_match_analytic(dry, key):
    """Mixtral-8x22B (MoE, window 4096) and Phi-3-medium (40 heads and 32
    prefill rows: neither divides "model"; its ring prefill splits the
    queries) at 2 layers on 16 x 16: the hand count equals the plain
    meta count, and each device's count times the devices is within 3%
    above it: no device repeats the experts' products (F12: 120-125x
    before) or the prefill's attention (F13: 5.95x before).  Under
    OPTIMIZED, decode falls back to the dropless math, which the hand
    count covers."""
    r = dry[0]["flops"][key]
    name, shape = key.split("/")[:2]
    want = dry[0]["flops"][f"{name}/{shape}/plain"]
    assert want["analytic"] == want["flops"]
    assert r["flops_analytic"] * r["n_devices"] == want["analytic"]
    assert 1.0 - 1e-9 <= r["flops_over_analytic"] <= 1.03, r


@pytest.mark.parametrize("shape", ["decode_32k", "prefill_32k", "train_4k"])
def test_moe_bmm_per_device_is_its_share(dry, shape):
    """Mixtral at 2 layers under BASELINE: the experts' products (every
    bmm of prefill and training; at decode, less the attention
    projections' matmuls that DTensor lowers to bmm for one token a row)
    come to the plain meta count / 256 a device within 1%."""
    r = dry[0]["flops"][f"mixtral2/{shape}/pod16x16"]
    share = dry[0]["flops"][f"mixtral2/{shape}/plain"]["bmm"] / 256
    bmm = r["aten_flops_by_op"]["aten.bmm"]
    if shape == "decode_32k":
        cfg = get_config("mixtral_8x22b")
        # per layer and device (8 rows of one token), two products of the
        # attention that torch's matmul lowers to bmm on these local
        # views: x (8, 1, D) @ a projection's (D, D / 16) block, and x's
        # D / 16 features @ LoRA's A block (D / 16, r)
        bmm -= 2 * 2 * 8 * (cfg.d_model // 16) * (cfg.d_model
                                                  + cfg.lora.rank)
    assert abs(bmm / share - 1) <= 0.01, (bmm, share)


def test_moe_capacity_cells_keep_no_hand_count(dry):
    """Mixtral prefill_32k under OPTIMIZED runs the capacity dispatch,
    whose products follow the data: no hand count."""
    r = dry[0]["flops"]["mixtral2/prefill_32k/pod16x16-opt"]
    assert r["flops_analytic"] is None and r["flops_over_analytic"] is None


@pytest.mark.parametrize("cell", ["decode_32k", "decode_32k-opt",
                                  "prefill_32k", "train_4k"])
def test_mixtral_flops_within_reference_probe(dry, cell):
    """Mixtral-8x22B at 2 layers on 16 x 16 (BASELINE; decode also under
    OPTIMIZED): a device's FLOPs at most 1.03x the reference's depth probe
    d2 for the same cell (its experts gathered whole on every device read
    120x, 120x, 125x and 123x)."""
    ref = dry[0]["reference_probe"]
    assert ref["mixtral_pattern"] == ["attn"]     # d2 = 2 layers
    shape, _, opt = cell.partition("-")
    r = dry[0]["flops"][f"mixtral2/{shape}/pod16x16{'-' + opt if opt else ''}"]
    d2 = ref[f"mixtral/{cell}"]["flops"]
    assert 0 < r["flops"] <= 1.03 * d2, (r["flops"], d2)


def test_flash_work_counts_the_shifted_pairs():
    """``visible_pairs`` / ``work`` with a query offset: queries at
    positions [q0, q0 + t) against the mask counted element by element,
    causal with a prefix and a window."""
    from repro_torch.kernels.flash_attention import ops as fops
    T, q0, t, W, P = 64, 24, 16, 12, 30
    i = torch.arange(q0, q0 + t)[:, None]
    j = torch.arange(T)[None]
    ok = ((j <= i) | (j < P)) & (j > i - W)
    assert fops.visible_pairs(t, T, window=W, prefix_len=P,
                              q_offset=q0) == int(ok.sum())
    q, k = torch.empty(2, t, 4, 32), torch.empty(2, T, 2, 32)
    assert fops.work(q, k, k, window=W, prefix_len=P, q_offset=q0).flops \
        == 4 * 32 * 4 * 2 * int(ok.sum())
