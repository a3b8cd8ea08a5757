"""The port's multi-device paths on 4 gloo ranks (one ``torchrun`` of a
script written to a temporary directory), held against the reference:

* shard order: a dim over ("pod", "data") is cut pod-major on a (2, 2, 1)
  ("pod", "data", "model") mesh, as JAX cuts it, by both
  ``sharding.shard_of`` and DTensor under ``sharding.to_placements``;
* ``models/moe.py::_apply_moe_parallel`` on a 2 x 2 ("data", "model")
  mesh against the reference's shard-local math (``_moe_math`` /
  ``_moe_capacity_math`` on each data shard's tokens with the full F, the
  aux losses averaged over the shards), float32: within 2e-5 (ragged) and
  5e-3 (capacity; drop_fraction <= 0.05), as the reference's own
  ``tests/test_moe_parallel.py`` holds its shard_map; under 64 local
  tokens the fallback equals the reference's dropless plain path on all
  tokens under either dispatch; the gradients of x and of every weight
  equal ``jax.grad`` of that per-shard math (the sum over the model group
  of each rank's share);
* a LoRA step over the 2 x 2 mesh, the launcher's ``--mesh`` path
  (``launch/train.py::shard``: the backbone cut by ``params_specs(...,
  OPTIMIZED)``; adapters, optimizer state and batch replicated;
  ``forward_train`` on DTensors), against the same step unsharded in the
  same process: the loss within 1e-5 relative (of the gradients' pass and
  of the whole step), each adapter leaf's gradient within 1e-4 of its
  largest.  d_model 1024 and 2 layers, so that the matrices shard (under
  2^20 elements the policy replicates them); some leaf must be sharded.

Inputs are seeded numpy arrays; the reference computes while the ranks
run.  The ranks tear their group down; the parent never starts one.
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent

RANKS = textwrap.dedent('''
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.core.lora import combine_lora, partition_lora, tree_leaves
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import init_world, make_debug_mesh, make_mesh
    from repro_torch.launch.sharding import shard_of, to_placements
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    from repro_torch.models.config import LoRAConfig, ModelConfig
    from repro_torch.training.adamw import AdamW, constant_schedule
    from repro_torch.training.train import (_value_and_grad, batch_to,
                                            make_lora_train_step)

    out_path, in_path = sys.argv[1], sys.argv[2]
    init_world("gloo")
    rank = dist.get_rank()
    res = {}

    # shard order: rows over ("pod", "data"), pod-major
    pm = make_mesh((2, 2, 1), ("pod", "data", "model"))
    t = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    spec = (("pod", "data"), None)
    p, d, _ = pm.get_coordinate()
    mine = shard_of(t, spec, pm)
    assert torch.equal(mine, t[(p * 2 + d) * 2:(p * 2 + d + 1) * 2]), mine
    dt = DTensor.from_local(mine, pm, to_placements(spec, pm),
                            run_check=False)
    assert torch.equal(dt.full_tensor(), t)
    res["shard_order_ok"] = 1

    # shard-local MoE on a 2 x 2 (data, model) mesh
    mesh = make_debug_mesh(2, 2)
    inp = np.load(in_path)
    cfg = ModelConfig(name="m", family="moe", num_layers=1, d_model=32,
                      num_heads=2, num_kv_heads=1, d_ff=64, vocab_size=64,
                      num_experts=4, experts_per_token=2, dtype="float32")
    pm_ = {"router": {"w": torch.from_numpy(inp["router"])},
           "wi": torch.from_numpy(inp["wi"]),
           "wg": torch.from_numpy(inp["wg"]),
           "wo": torch.from_numpy(inp["wo"])}
    moe.set_parallel_mesh(mesh)
    for dispatch in ("ragged", "capacity"):
        moe.set_dispatch(dispatch)
        out, aux = moe._apply_moe_parallel(pm_, cfg,
                                           torch.from_numpy(inp["x"]))
        assert isinstance(out, DTensor)
        res[f"moe_{dispatch}"] = out.full_tensor().numpy()
        for k, v in aux.items():
            res[f"aux_{dispatch}_{k}"] = v.full_tensor().numpy()
    for dispatch in ("ragged", "capacity"):
        moe.set_dispatch(dispatch)
        small, _ = moe._apply_moe_parallel(pm_, cfg,
                                           torch.from_numpy(inp["x_small"]))
        res[f"moe_fallback_{dispatch}"] = small.numpy()

    # gradients through the shard-local MoE, of x and of every weight
    r = torch.from_numpy(inp["r"])
    for dispatch in ("ragged", "capacity"):
        moe.set_dispatch(dispatch)
        xg = torch.from_numpy(inp["x"]).requires_grad_(True)
        wg = {k: torch.from_numpy(inp[k]).requires_grad_(True)
              for k in ("router", "wi", "wg", "wo")}
        out, aux = moe._apply_moe_parallel(
            {"router": {"w": wg["router"]}, "wi": wg["wi"], "wg": wg["wg"],
             "wo": wg["wo"]}, cfg, xg)
        loss = (out.full_tensor() * r).sum() \
            + 0.3 * aux["load_balance_loss"].full_tensor() \
            + 0.7 * aux["router_z_loss"].full_tensor()
        loss.backward()
        res[f"grad_{dispatch}_x"] = xg.grad.numpy()
        for k, t in wg.items():
            res[f"grad_{dispatch}_{k}"] = t.grad.numpy()
    moe.set_dispatch("ragged")

    # no rank runs rows it does not own through experts it does not hold:
    # the experts as the sharding policy stores them ((None, data, model):
    # D over "data", F over "model"; wo F over "data", D over "model"),
    # x's rows over "data"; the fallback under the parallel mesh (plain
    # weights, and those DTensors) and a DTensor MoE with no parallel mesh
    # (8 rows of one token: decode, 4 x 8 and 4 x 32 tokens: the
    # shard-local path), each against the plain math on every token, and
    # each rank's bmm FLOPs against the plain math's; then the gradients
    # through the decode path
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch.dryrun import StepCounter
    specs = {"router": (None, None), "wi": (None, "data", "model"),
             "wg": (None, "data", "model"), "wo": (None, "data", "model")}

    def stored(tree, specs=specs):
        return {"router": {"w": distribute_tensor(
                    tree["router"]["w"], mesh,
                    to_placements(specs["router"], mesh))},
                **{k: distribute_tensor(tree[k], mesh,
                                        to_placements(specs[k], mesh))
                   for k in ("wi", "wg", "wo")}}

    def rows(t):
        return distribute_tensor(t, mesh, to_placements(("data", None, None),
                                                        mesh))

    def bmm_flops(fn):
        with StepCounter() as c:
            out = fn()
        return out, c.flops_by_op.get("aten.bmm", 0)

    # d_ff 63 does not divide "model", the 4 experts do: the shard-local
    # path slices the experts, decode's path the rows; stored as the
    # policy would: D over "data" (wi / wg), D over "model" (wo)
    ocfg = ModelConfig(name="m", family="moe", num_layers=1, d_model=32,
                       num_heads=2, num_kv_heads=1, d_ff=63, vocab_size=64,
                       num_experts=4, experts_per_token=2, dtype="float32")
    po = {"router": pm_["router"],
          **{k: torch.from_numpy(inp[f"{k}_odd"]) for k in ("wi", "wg",
                                                              "wo")}}
    variants = {"": (cfg, pm_, stored(pm_)),
                "_odd": (ocfg, po, stored(po, {
                    "router": (None, None), "wi": (None, "data", None),
                    "wg": (None, "data", None),
                    "wo": (None, None, "model")}))}
    for tag in ("x_dec", "x_small", "x", "x_dec_odd", "x_odd"):
        xt = torch.from_numpy(inp[tag.replace("_odd", "")])
        mcfg, pm, pd = variants["_odd" if tag.endswith("_odd") else ""]
        (want, want_aux), plain = bmm_flops(
            lambda: moe._moe_math(pm, mcfg, xt.reshape(-1, 32)))
        res[f"moe_plain_{tag}"] = want.reshape(xt.shape).numpy()
        for k, v in want_aux.items():
            res[f"moe_plain_aux_{tag}_{k}"] = v.numpy()
        runs = {"nomesh": lambda: moe.apply_moe(pd, mcfg, rows(xt),
                                                return_aux=True)}
        if tag in ("x_dec", "x_small"):
            runs["fallback_plain"] = lambda: moe._apply_moe_parallel(
                pm_, cfg, xt)
            runs["fallback_dt"] = lambda: moe._apply_moe_parallel(
                pd, cfg, rows(xt))
        for name, fn in runs.items():
            moe.set_parallel_mesh(None if name == "nomesh" else mesh)
            (o, aux), n = bmm_flops(fn)
            full = o.full_tensor() if isinstance(o, DTensor) else o
            res[f"moe_{name}_{tag}"] = full.numpy()
            for k, v in aux.items():
                res[f"moe_{name}_aux_{tag}_{k}"] = (
                    v.full_tensor() if isinstance(v, DTensor) else v).numpy()
            share = torch.tensor([n / plain], dtype=torch.float64)
            dist.all_reduce(share, op=dist.ReduceOp.MAX)   # the most a rank
            res[f"moe_{name}_share_{tag}"] = share.numpy()
    # the capacity dispatch: which inputs run it through the parallel mesh
    # (64 local tokens with F dividing "model"; not the fallback's 16, not
    # d_ff 63's expert slices), and a DTensor input with no parallel mesh
    # refused, where a plain one still runs the capacity math
    moe.set_dispatch("capacity")
    moe.set_parallel_mesh(mesh)
    res["moe_runs_capacity"] = np.array([
        moe.runs_capacity(c, *inp[t].shape[:2])
        for c, t in ((cfg, "x"), (cfg, "x_small"), (ocfg, "x"))])
    moe.set_parallel_mesh(None)
    try:
        moe.apply_moe(stored(pm_), cfg, rows(torch.from_numpy(inp["x"])))
        res["moe_capacity_dtensor_refused"] = 0
    except ValueError:
        res["moe_capacity_dtensor_refused"] = 1
    _, aux = moe.apply_moe(pm_, cfg, torch.from_numpy(inp["x_small"]),
                           return_aux=True)
    res["moe_capacity_plain_drop"] = aux["drop_fraction"].numpy()
    moe.set_dispatch("ragged")
    xt = torch.from_numpy(inp["x_dec"])
    cot = torch.from_numpy(inp["r"][:, :2]).reshape(8, 1, 32)
    for side in ("plain", "dt"):
        leaves = {k: torch.from_numpy(inp[k]).requires_grad_(True)
                  for k in ("router", "wi", "wg", "wo")}
        xg = xt.clone().requires_grad_(True)
        tree = {"router": {"w": leaves["router"]}, "wi": leaves["wi"],
                "wg": leaves["wg"], "wo": leaves["wo"]}
        if side == "dt":
            tree, xin = stored(tree), rows(xg)
        else:
            xin = xg
        o, aux = moe.apply_moe(tree, cfg, xin, return_aux=True)
        if side == "dt":
            o, aux = o.full_tensor(), {k: v.full_tensor()
                                       for k, v in aux.items()}
        ((o * cot).sum() + 0.3 * aux["load_balance_loss"]
         + 0.7 * aux["router_z_loss"]).backward()
        if side == "dt":
            leaves = {k: (tree["router"]["w"] if k == "router"
                          else tree[k]).grad.full_tensor() for k in leaves}
            leaves["x"] = xin.grad.full_tensor()
        else:
            leaves = {k: t.grad for k, t in leaves.items()}
            leaves["x"] = xg.grad
        for k, g in leaves.items():
            res[f"moe_grad_{side}_{k}"] = g.numpy()

    # a LoRA step over the mesh against the same step unsharded
    lcfg = ModelConfig(name="wide", family="dense", num_layers=2,
                       d_model=1024, num_heads=8, num_kv_heads=8,
                       head_dim=128, d_ff=2048, vocab_size=256,
                       dtype="float32",
                       lora=LoRAConfig(rank=4, alpha=8.0, num_adapters=1))
    gen = torch.Generator().manual_seed(0)
    params = tf.init_params(lcfg, gen, "cpu", lora_adapters=None,
                            lora_b_scale=0.02)
    backbone, adapters = partition_lora(params)
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, 256, (4, 16)).astype(np.int32),
             "labels": rng.integers(0, 256, (4, 16)).astype(np.int32)}
    opt = AdamW(lr=constant_schedule(1e-3))
    loss0, _, g0 = _value_and_grad(
        lcfg, adapters, lambda ad: combine_lora(backbone, ad),
        batch_to(batch, "cpu"), True)
    new0, _, m0 = make_lora_train_step(lcfg, opt)(
        backbone, adapters, opt.init(adapters), batch)

    run = launch_train.TrainRun(lcfg, backbone, adapters, opt,
                                opt.init(adapters),
                                make_lora_train_step(lcfg, opt), iter(()),
                                64)
    run = launch_train.shard(run, mesh)
    sharded = [x for x in tree_leaves(run.backbone)
               if any(not pl.is_replicate() for pl in x.placements)]
    res["sharded_leaves"] = len(sharded)
    sb = launch_train._replicated(batch_to(batch, "cpu"), mesh)
    with implicit_replication():
        loss1, _, g1 = _value_and_grad(
            lcfg, run.adapters, lambda ad: combine_lora(run.backbone, ad),
            sb, True)
    new1, _, m1 = run.step_fn(run.backbone, run.adapters, run.opt_state,
                              batch)
    res["loss0"], res["loss1"] = float(loss0), float(loss1.full_tensor())
    res["step_loss0"], res["step_loss1"] = float(m0["loss"]), \\
        float(m1["loss"])
    for i, (a, b) in enumerate(zip(tree_leaves(g0), tree_leaves(g1))):
        res[f"g0_{i}"], res[f"g1_{i}"] = a.numpy(), b.full_tensor().numpy()

    # ring prefill and decode with one kv head, which does not divide
    # "model": the ring falls back to head_dim or to the sequence.  As
    # DTensors against the same steps on plain tensors; spies on the
    # wrappers layers.py calls sum the attention kernels' work() a rank
    import dataclasses
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.launch import dryrun
    from repro_torch.launch import specs as lspecs
    from repro_torch.launch.sharding import BASELINE
    from repro_torch.models import layers

    work = {"prefill": 0, "decode": 0}

    def spy(fn, count, key, names):
        def call(*a, **kw):
            work[key] += count(*a, **{k: kw[k] for k in names
                                      if k in kw}).flops
            return fn(*a, **kw)
        return call

    layers.flash_mha = spy(fops.flash_mha, fops.work, "prefill",
                           ("causal", "window", "prefix_len", "q_offset"))
    layers.decode_gqa = spy(dops.decode_gqa, dops.work, "decode",
                            ("window",))

    def placed(tree, specs):
        return dryrun._map_with_specs(tree, specs, lambda t, sp: (
            DTensor.from_local(shard_of(t, sp, mesh), mesh,
                               to_placements(sp, mesh), run_check=False)))

    def full(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    for H, B in ((2, 4), (3, 4), (3, 2)):
        rcfg = ModelConfig(name="ring", family="dense", num_layers=2,
                           d_model=48, num_heads=H, num_kv_heads=1,
                           head_dim=16, d_ff=64, vocab_size=64,
                           dtype="float32")
        rparams = tf.init_params(rcfg, torch.Generator().manual_seed(1),
                                 "cpu", lora_adapters=None)
        for fb, T in ((fb, T) for fb in ("hd", "seq") for T in (6, 8)):
            toks = torch.from_numpy(np.random.default_rng(
                H * 10 + B).integers(0, 64, (B, T)).astype(np.int32))
            opts = dataclasses.replace(BASELINE, kv_fallback=fb)
            tag = f"ring_{H}_{B}_{fb}_t{T}"
            for dt in (False, True):
                side = "dt" if dt else "plain"
                cache = lspecs.abstract_cache(rcfg, B, 8, device="cpu")
                args = (rparams, {"tokens": toks}, cache)
                if dt:
                    sp = dryrun.arg_specs(lspecs.StepSpec(
                        "prefill_step", None, args), mesh, rcfg, opts)
                    res[f"{tag}_placements"] = np.array(
                        [str(x) for x in to_placements(sp["cache"][0]["k"],
                                                       mesh)])
                    args = tuple(placed(a, sp[k]) for a, k in zip(
                        args, ("params", "batch", "cache")))
                work.update(prefill=0, decode=0)
                with implicit_replication():
                    logits, ring = lspecs.prefill_fn(rcfg)(*args)
                    outs = [full(logits)]
                    tok = outs[0].argmax(-1).to(torch.int32)
                    # 3 decode steps into the 8 slots: positions 6-8
                    # (the last wraps slot 0), or 8-10 (wrapping 0-2)
                    for p_ in range(T, T + 3):
                        logits, ring = lspecs.serve_fn(rcfg)(
                            args[0], tok, ring,
                            torch.tensor(p_, dtype=torch.int32))
                        outs.append(full(logits))
                        tok = outs[-1].argmax(-1).to(torch.int32)
                res[f"{tag}_{side}_logits"] = torch.stack(outs).numpy()
                for li, layer in enumerate(ring):
                    for name in ("k", "v", "slot_pos"):
                        res[f"{tag}_{side}_{name}{li}"] = \
                            full(layer[name]).numpy()
                w = torch.tensor([work["prefill"], work["decode"]],
                                 dtype=torch.float64)
                dist.all_reduce(w, op=dist.ReduceOp.MAX)   # the most a rank
                res[f"{tag}_{side}_work"] = w.numpy()
    layers.flash_mha, layers.decode_gqa = fops.flash_mha, dops.decode_gqa
    if rank == 0:
        np.savez(out_path, **res)
    dist.barrier()
    dist.destroy_process_group()
''')


D, F, E = 32, 64, 4


def _inputs():
    """Seeded float32 MoE weights at the reference's init scales (router
    and wi/wg N(0, 1/D), wo N(0, 1/F)) and tokens: 4 x 32 (64 local tokens
    a data shard: the parallel path), 4 x 8 (16: the fallback) and 8 x 1
    (decode), with the cotangent ``r`` of the gradient checks."""
    rng = np.random.default_rng(0)

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    router = n(D, E, scale=D ** -0.5)
    inp = {"router": router, "wi": n(E, D, F, scale=D ** -0.5),
           "wg": n(E, D, F, scale=D ** -0.5),
           "wo": n(E, F, D, scale=F ** -0.5),
           "x": n(4, 32, D), "x_small": n(4, 8, D), "r": n(4, 32, D)}
    # every small token leans to expert 0: capacity dispatch would drop
    # some (32 picks of it for 20 places), the dropless math none
    inp["x_small"] += 4.0 * router[:, 0] / np.linalg.norm(router[:, 0])
    inp["x_dec"] = n(8, 1, D)                  # decode: 8 rows, one token
    # experts of d_ff 63, which does not divide a mesh dim of 2
    inp["wi_odd"], inp["wg_odd"] = (n(E, D, 63, scale=D ** -0.5)
                                    for _ in range(2))
    inp["wo_odd"] = n(E, 63, D, scale=63 ** -0.5)
    return inp


def _reference_moe(inp):
    """The reference's shard-local math on each data shard's tokens, the
    aux losses averaged over the shards; the plain path on all tokens."""
    import jax
    import jax.numpy as jnp
    from repro.models import moe as jmoe
    from repro.models.config import ModelConfig as JaxConfig

    cfg = JaxConfig(name="m", family="moe", num_layers=1, d_model=D,
                    num_heads=2, num_kv_heads=1, d_ff=F, vocab_size=64,
                    num_experts=E, experts_per_token=2)
    p = {"router": {"w": jnp.asarray(inp["router"])},
         "wi": jnp.asarray(inp["wi"]), "wg": jnp.asarray(inp["wg"]),
         "wo": jnp.asarray(inp["wo"])}
    x = jnp.asarray(inp["x"])
    fns = {name: jax.jit(lambda p, x, math=math: math(p, cfg, x))
           for name, math in (("ragged", jmoe._moe_math),
                              ("capacity", jmoe._moe_capacity_math))}
    want = {}
    for name, fn in fns.items():
        outs, auxes = [], []
        for shard in (x[:2], x[2:]):               # data shards of B
            o, a = fn(p, shard.reshape(-1, D))
            outs.append(np.asarray(o).reshape(2, 32, D))
            auxes.append({k: float(v) for k, v in a.items()})
        want[name] = np.concatenate(outs)
        want[f"aux_{name}"] = {k: np.mean([a[k] for a in auxes])
                               for k in auxes[0]}
    o, _ = fns["ragged"](p, jnp.asarray(inp["x_small"]).reshape(-1, D))
    want["fallback"] = np.asarray(o).reshape(4, 8, D)
    r = jnp.asarray(inp["r"])
    for name, math in (("ragged", jmoe._moe_math),
                       ("capacity", jmoe._moe_capacity_math)):
        def loss(p, x, math=math):
            outs, lb, z = [], [], []
            for shard in (x[:2], x[2:]):
                o, a = math(p, cfg, shard.reshape(-1, D))
                outs.append(o.reshape(2, 32, D))
                lb.append(a["load_balance_loss"])
                z.append(a["router_z_loss"])
            return (jnp.sum(jnp.concatenate(outs) * r)
                    + 0.3 * jnp.mean(jnp.stack(lb))
                    + 0.7 * jnp.mean(jnp.stack(z)))
        gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, x)
        want[f"grad_{name}"] = {
            "x": np.asarray(gx), "router": np.asarray(gp["router"]["w"]),
            "wi": np.asarray(gp["wi"]), "wg": np.asarray(gp["wg"]),
            "wo": np.asarray(gp["wo"])}
    return want


def run_ranks(tmp: Path, script: str, inputs=None, nproc: int = 4):
    """Start ``script`` on ``nproc`` gloo ranks under torchrun with
    ``(out.npz, in.npz)`` as its arguments; returns a function that waits
    for it and loads what rank 0 saved."""
    if inputs is not None:
        np.savez(tmp / "in.npz", **inputs)
    (tmp / "ranks.py").write_text(script)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(nproc), str(tmp / "ranks.py"),
         str(tmp / "out.npz"), str(tmp / "in.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=str(ROOT))

    def wait():
        out, err = proc.communicate(timeout=240)
        assert proc.returncode == 0, out[-3000:] + err[-5000:]
        with np.load(tmp / "out.npz") as z:
            return {k: z[k] for k in z.files}

    return wait


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    inp = _inputs()
    wait = run_ranks(tmp_path_factory.mktemp("ranks"), RANKS, inp)
    want = _reference_moe(inp)          # while the ranks run
    return wait(), want


def test_pod_data_shard_order_is_pod_major(ranks):
    got, _ = ranks
    assert int(got["shard_order_ok"]) == 1


@pytest.mark.parametrize("dispatch,tol", [("ragged", 2e-5),
                                          ("capacity", 5e-3)])
def test_moe_parallel_matches_shard_local_reference(ranks, dispatch, tol):
    got, want = ranks
    np.testing.assert_allclose(got[f"moe_{dispatch}"], want[dispatch],
                               atol=tol, rtol=tol)
    for k, v in want[f"aux_{dispatch}"].items():
        np.testing.assert_allclose(float(got[f"aux_{dispatch}_{k}"]), v,
                                   atol=tol, rtol=tol)
    if dispatch == "capacity":
        assert float(got["aux_capacity_drop_fraction"]) <= 0.05


def test_moe_parallel_falls_back_under_64_local_tokens(ranks):
    """Under either dispatch the fallback is the reference's dropless
    ``_moe_math`` on all tokens."""
    got, want = ranks
    for dispatch in ("ragged", "capacity"):
        np.testing.assert_allclose(got[f"moe_fallback_{dispatch}"],
                                   want["fallback"], atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dispatch,tol", [("ragged", 2e-5),
                                          ("capacity", 5e-3)])
def test_moe_parallel_gradients_match_shard_local_reference(ranks, dispatch,
                                                            tol):
    """The gradients of x and of every weight, through the shard-local
    MoE on the 2 x 2 mesh, against ``jax.grad`` of the reference's math
    on each data shard (aux losses averaged over the shards): each within
    ``tol`` of the leaf's largest gradient."""
    got, want = ranks
    for k, g in want[f"grad_{dispatch}"].items():
        d = np.abs(got[f"grad_{dispatch}_{k}"] - g).max()
        assert d <= tol * np.abs(g).max(), (k, d, np.abs(g).max())


def test_sharded_lora_step_equals_unsharded(ranks):
    got, _ = ranks
    assert int(got["sharded_leaves"]) > 0
    l0, l1 = float(got["loss0"]), float(got["loss1"])
    assert abs(l1 - l0) <= 1e-5 * abs(l0)
    s0, s1 = float(got["step_loss0"]), float(got["step_loss1"])
    assert abs(s1 - s0) <= 1e-5 * abs(s0)
    n = sum(1 for k in got if k.startswith("g0_"))
    assert n > 0
    for i in range(n):
        g0, g1 = got[f"g0_{i}"], got[f"g1_{i}"]
        assert np.abs(g1 - g0).max() <= 1e-4 * np.abs(g0).max()


# (query heads, rows, ring fallback) -> prompt length -> the most a
# rank's prefill and decode kernels may do, as a share of the same steps
# unsharded: the data axis halves the rows; on "model" the attention
# splits its query heads (H = 2) or its rows (4 rows: 2 a data shard).
# Where neither divides (2 rows, H = 3): an 8-token prefill splits its
# queries (chunks 0 and 3 of 4 on one rank, 1 and 2 on the other: 18 of
# the 36 causal pairs each) and the decode of the full ring its slots (8
# valid, 4 a rank); a 6-token prefill, which 2n = 4 chunks do not divide,
# runs whole on "model"'s ranks, and at positions 6-8 the rank of slots
# 0-3 sees 4 valid slots at each step, 12 of the 23 a row sees whole
RING_CASES = {
    (2, 4, "hd"): {6: (0.25, 0.25), 8: (0.25, 0.25)},
    (2, 4, "seq"): {6: (0.25, 0.25), 8: (0.25, 0.25)},
    (3, 4, "hd"): {6: (0.25, 0.25), 8: (0.25, 0.25)},
    (3, 4, "seq"): {6: (0.25, 0.25), 8: (0.25, 0.25)},
    (3, 2, "hd"): {6: (0.5, 12 / 46), 8: (0.25, 0.25)},
    (3, 2, "seq"): {6: (0.5, 12 / 46), 8: (0.25, 0.25)}}


@pytest.mark.parametrize("heads,rows,fallback", list(RING_CASES))
def test_sharded_ring_attention_splits_over_model(ranks, heads, rows,
                                                  fallback):
    """A ring prefill of 6 tokens, and one of 8, into 8 slots, each
    followed by 3 decode steps (which wrap a slot), of a 2-layer float32
    model with one kv head, as DTensors on the 2 x 2 mesh under
    ``kv_fallback`` "hd" and "seq": the ring split on head_dim or on the
    sequence over "model", the logits and every layer's ring within 1e-5
    of the same steps on plain tensors, and no rank's attention kernels
    doing more than their share of the work."""
    got, _ = ranks
    for T, shares in RING_CASES[heads, rows, fallback].items():
        tag = f"ring_{heads}_{rows}_{fallback}_t{T}"
        assert list(got[f"{tag}_placements"]) == \
            ["S(0)", "S(3)" if fallback == "hd" else "S(1)"]
        np.testing.assert_allclose(got[f"{tag}_dt_logits"],
                                   got[f"{tag}_plain_logits"], atol=1e-5,
                                   rtol=1e-5)
        for layer in range(2):
            for name in ("k", "v", "slot_pos"):
                np.testing.assert_allclose(
                    got[f"{tag}_dt_{name}{layer}"],
                    got[f"{tag}_plain_{name}{layer}"], atol=1e-5, rtol=1e-5)
        plain, dt = got[f"{tag}_plain_work"], got[f"{tag}_dt_work"]
        assert (plain > 0).all()
        share = np.array(shares)
        assert (dt <= share * plain * (1 + 1e-12)).all(), (T, dt, plain)


@pytest.mark.parametrize("tag", ["x_dec", "x_small", "x", "x_dec_odd",
                                 "x_odd"])
def test_moe_splits_rows_and_experts_over_the_mesh(ranks, tag):
    """The experts as the sharding policy stores them and x's rows over
    "data": with no parallel mesh (decode's 8 x 1, then 4 x 8 tokens, and
    4 x 32 on the shard-local path; "_odd": d_ff 63, which "model" does
    not divide, so the shard-local path slices the 4 experts) and through
    the parallel mesh's fallback (plain weights, and those DTensors), the
    output and the aux losses equal the plain dropless math on all tokens
    within 2e-5, and no rank's bmm FLOPs exceed a quarter of the plain
    math's: no rank runs rows it does not own through experts it does
    not hold."""
    got, _ = ranks
    want = got[f"moe_plain_{tag}"]
    names = ["nomesh"] + (["fallback_plain", "fallback_dt"]
                          if tag in ("x_dec", "x_small") else [])
    for name in names:
        np.testing.assert_allclose(got[f"moe_{name}_{tag}"], want,
                                   atol=2e-5, rtol=2e-5)
        for k in ("load_balance_loss", "router_z_loss"):
            np.testing.assert_allclose(
                got[f"moe_{name}_aux_{tag}_{k}"],
                got[f"moe_plain_aux_{tag}_{k}"], atol=2e-5, rtol=2e-5)
        share = float(got[f"moe_{name}_share_{tag}"][0])
        assert share <= 0.25 * (1 + 1e-12), (name, share)


def test_moe_capacity_dispatch_needs_the_parallel_mesh(ranks):
    """Under the capacity dispatch the parallel mesh runs the capacity
    math only on its shard-local path with the experts sliced on F (64
    local tokens, d_ff 64), dropless on its fallback (16 local tokens) and
    on d_ff 63's expert slices, as the reference's shard_map does; with no
    parallel mesh a DTensor input is refused (the dropless math would not
    drop what the reference's plain path drops), while a plain input runs
    the capacity math and drops (its small tokens lean to expert 0)."""
    got, _ = ranks
    assert list(got["moe_runs_capacity"]) == [True, False, False]
    assert int(got["moe_capacity_dtensor_refused"]) == 1
    assert float(got["moe_capacity_plain_drop"]) > 0


def test_moe_decode_gradients_equal_plain(ranks):
    """The gradients of x and of every weight through the decode path
    (the experts left where they are stored, the tokens moved to them)
    equal the plain math's within 2e-5 of each leaf's largest."""
    got, _ = ranks
    for k in ("x", "router", "wi", "wg", "wo"):
        g = got[f"moe_grad_plain_{k}"]
        d = np.abs(got[f"moe_grad_dt_{k}"] - g).max()
        assert d <= 2e-5 * np.abs(g).max(), (k, d, np.abs(g).max())
