"""The port's training substrate (``training/adamw.py``,
``training/train.py``, ``data/pipeline.py``) held against the reference
on the CPU: the LoRA step against ``jax.jit(make_lora_train_step)`` on
the reference's tiny ``CFG`` (``tests/test_training.py``) and on bridged
SMOKE Llama-2-7B and Mixtral-8x22B (3 steps), the full step (2 steps),
AdamW, the schedules, the cross-entropy and the global norm; the
reference's three behavioural tests on the port with their thresholds;
the synthetic corpus and batches bit for bit.

Models are float32 with one adapter, LoRA B drawn nonzero (the
reference's init gives B = 0, so A's gradient is zero at step 1), except
one LoRA run of the tiny CFG in its own bfloat16 and the behavioural
tests, which start from the reference's own init.

Tolerances (float32; the two frameworks reduce in other orders): losses
and gradient norms within 1e-5 x max(1, |reference|); each gradient leaf
within 1e-5 x its largest reference element; the moments within 1e-4 x
their leaf's largest; parameters after n AdamW steps at rate lr within
1e-2 x lr x n (a step moves an element by about lr, and a gradient
element near zero turns float32 noise into a visible share of that step;
the largest differences seen are 6e-4 x lr x 3 steps for the adapters and
5.4e-3 x lr x 2 steps for the full model, whose embedding and MLP carry
many gradient elements near zero); AdamW alone within
1e-6 x max(1, |reference|) in float32 and one bfloat16 unit (2^-8
relative) in bfloat16; the schedules within 1e-6 relative.
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.store import _flatten as jax_flatten
from repro.core import lora as jax_lora
from repro.data import pipeline as jax_pipeline
from repro.models.config import LoRAConfig as JLoRAConfig
from repro.models.config import ModelConfig as JModelConfig
from repro.training import adamw as jax_adamw
from repro.training import train as jax_train
from repro_torch.checkpoint import store
from repro_torch.checkpoint.bridge import reference_tree
from repro_torch.core.lora import combine_lora, partition_lora, tree_leaves
from repro_torch.data import pipeline
from repro_torch.models.config import LoRAConfig, ModelConfig
from repro_torch.training import adamw, train
from test_torch_train_forward import bridged, single_adapter_model

CFG_J = JModelConfig(name="tiny", family="dense", num_layers=2, d_model=64,
                     num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
                     lora=JLoRAConfig(rank=8, alpha=16.0))
CFG = ModelConfig(name="tiny", family="dense", num_layers=2, d_model=64,
                  num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
                  lora=LoRAConfig(rank=8, alpha=16.0))
TOL = 1e-5
MOMENT_TOL = 1e-4
STEP_TOL = 1e-2          # x lr x steps


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat_t(tree, cfg) -> dict:
    """A port model-shaped tree as the reference's flat arrays."""
    return {k: torch.as_tensor(v).detach().float().numpy() for k, v in
            store._flatten(reference_tree(tree, cfg)).items()
            if not k.endswith("__empty_tuple__")}


def _flat_j(tree) -> dict:
    return {k: np.asarray(v, np.float32) for k, v in jax_flatten(tree).items()
            if not k.endswith("__empty_tuple__")}


def _leafwise(got: dict, want: dict, tol, what: str, own_scale: bool):
    """Every leaf within ``tol`` x (its largest reference element, or
    max(1, that) without ``own_scale``)."""
    assert got.keys() == want.keys(), what
    for k in want:
        m = float(np.abs(want[k]).max())
        scale = m if own_scale else max(1.0, m)
        err = float(np.abs(got[k] - want[k]).max())
        assert err <= tol * scale, f"{what} {k}: {err:.3e} > {tol * scale:.3e}"


def _scalar(got, want, tol=TOL, what=""):
    want = float(want)
    assert abs(float(got) - want) <= tol * max(1.0, abs(want)), \
        f"{what}: {float(got)} vs {want}"


def _batches(cfg, n, B, T, seed):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
        yield {"tokens": toks, "labels": np.roll(toks, -1, 1)}


def _models(name):
    """(jax cfg, jax params, port cfg, port params) in float32: the tiny
    CFG at its widths, or a SMOKE config."""
    if name == "tiny":
        cfg_j, cfg_t = (c.with_(dtype="float32") for c in (CFG_J, CFG))
        pj, pt = bridged(cfg_j, cfg_t, seed=0)
        return cfg_j, pj, cfg_t, pt
    return single_adapter_model(name)


# ------------------------------------------------------------- train steps
@pytest.mark.parametrize("name", ["tiny", "llama2_7b", "mixtral_8x22b"])
def test_lora_step_matches_reference(name):
    """Step 1's loss, grad norm and every adapter gradient; then 3 steps:
    the losses, the adapters and both moments; the backbone untouched."""
    cfg_j, pj, cfg_t, pt = _models(name)
    lr = 1e-2
    bj, aj = jax_lora.partition_lora(pj)
    bt, at = partition_lora(pt)
    before = [(x, x.clone()) for x in tree_leaves(bt)]
    opt_j = jax_adamw.AdamW(lr=jax_adamw.constant_schedule(lr))
    opt_t = adamw.AdamW(lr=adamw.constant_schedule(lr))
    step_j = jax.jit(jax_train.make_lora_train_step(cfg_j, opt_j))
    step_t = train.make_lora_train_step(cfg_t, opt_t)
    sj, st = opt_j.init(aj), opt_t.init(at)
    for i, batch in enumerate(_batches(cfg_t, 3, 2, 24, seed=5)):
        if i == 0:
            gj = jax.grad(lambda ad: jax_train.loss_fn(
                jax_lora.combine_lora(bj, ad), cfg_j,
                {k: jnp.asarray(v) for k, v in batch.items()})[0])(aj)
            _, _, gt = train._value_and_grad(
                cfg_t, at, lambda ad: combine_lora(bt, ad),
                train.batch_to(batch, "cpu"), True)
            assert all(float(g.abs().max()) > 0 for g in tree_leaves(gt))
            _leafwise(_flat_t(gt, cfg_t), _flat_j(gj), TOL, "grad", True)
        aj, sj, mj = step_j(bj, aj, sj, batch)
        at, st, mt = step_t(bt, at, st, batch)
        for key in ("loss", "ce", "aux", "grad_norm"):
            _scalar(mt[key], mj[key], what=f"step {i} {key}")
    assert int(st.step) == int(sj.step) == 3
    _leafwise(_flat_t(at, cfg_t), _flat_j(aj), STEP_TOL * lr * 3, "adapter",
              own_scale=False)
    _leafwise(_flat_t(st.mu, cfg_t), _flat_j(sj.mu), MOMENT_TOL, "mu", True)
    _leafwise(_flat_t(st.nu, cfg_t), _flat_j(sj.nu), MOMENT_TOL, "nu", True)
    for x, copy in before:
        assert x.grad is None and not x.requires_grad
        assert torch.equal(x, copy)
    # the backbone's tensors are the very objects the model was built with
    assert all(a is b for a, b in zip(tree_leaves(bt),
                                      tree_leaves(partition_lora(pt)[0])))
    assert all(not x.requires_grad for x in tree_leaves(at))


def test_lora_step_in_bfloat16_tracks_reference():
    """The tiny CFG as the reference defines it, in bfloat16, 3 steps: the
    losses within 2^-7 and the gradient norms within 2^-5 relative.  Each
    op of the port's eager bfloat16 rounds its output where the
    reference's XLA fusions keep float32 (the largest differences seen:
    1.4e-4 and 9e-3 relative), and the adapters are rounded to bfloat16
    every step in both."""
    pj, pt = bridged(CFG_J, CFG, seed=0)
    bj, aj = jax_lora.partition_lora(pj)
    bt, at = partition_lora(pt)
    opt_j = jax_adamw.AdamW(lr=jax_adamw.constant_schedule(1e-2))
    opt_t = adamw.AdamW(lr=adamw.constant_schedule(1e-2))
    step_j = jax.jit(jax_train.make_lora_train_step(CFG_J, opt_j))
    step_t = train.make_lora_train_step(CFG, opt_t)
    sj, st = opt_j.init(aj), opt_t.init(at)
    for batch in _batches(CFG, 3, 2, 24, seed=5):
        aj, sj, mj = step_j(bj, aj, sj, batch)
        at, st, mt = step_t(bt, at, st, batch)
        assert abs(float(mt["loss"]) - float(mj["loss"])) <= \
            2.0 ** -7 * float(mj["loss"])
        assert abs(float(mt["grad_norm"]) - float(mj["grad_norm"])) <= \
            2.0 ** -5 * float(mj["grad_norm"])
    assert all(x.dtype == torch.bfloat16 for x in tree_leaves(at))
    assert all(x.dtype == torch.float32 for x in tree_leaves(st.mu))


def test_full_step_matches_reference():
    cfg_j, pj, cfg_t, pt = _models("tiny")
    lr = 3e-3
    opt_j = jax_adamw.AdamW(lr=jax_adamw.cosine_schedule(lr, 1, 4))
    opt_t = adamw.AdamW(lr=adamw.cosine_schedule(lr, 1, 4))
    step_j = jax.jit(jax_train.make_full_train_step(cfg_j, opt_j))
    step_t = train.make_full_train_step(cfg_t, opt_t)
    sj, st = opt_j.init(pj), opt_t.init(pt)
    for i, batch in enumerate(_batches(cfg_t, 2, 4, 16, seed=6)):
        pj, sj, mj = step_j(pj, sj, batch)
        pt, st, mt = step_t(pt, st, batch)
        for key in ("loss", "grad_norm"):
            _scalar(mt[key], mj[key], what=f"step {i} {key}")
    _leafwise(_flat_t(pt, cfg_t), _flat_j(pj), STEP_TOL * lr * 2, "params",
              own_scale=False)
    _leafwise(_flat_t(st.mu, cfg_t), _flat_j(sj.mu), MOMENT_TOL, "mu", True)
    _leafwise(_flat_t(st.nu, cfg_t), _flat_j(sj.nu), MOMENT_TOL, "nu", True)


# ------------------------------------------------------ optimizer and loss
def test_adamw_matches_manual_step():
    opt = adamw.AdamW(lr=adamw.constant_schedule(0.1), b1=0.9, b2=0.999,
                      weight_decay=0.0)
    p = {"w": torch.tensor([1.0, 2.0])}
    g = {"w": torch.tensor([0.5, -0.5])}
    new_p, st = opt.update(g, opt.init(p), p)
    # step 1: mhat = g, vhat = g^2, delta = g/(|g|+eps) = sign(g)
    np.testing.assert_allclose(new_p["w"].numpy(), [0.9, 2.1], atol=1e-4)
    assert st.step.dtype == torch.int32 and int(st.step) == 1


def test_adamw_handles_none_and_tuple_trees():
    opt = adamw.AdamW(lr=adamw.constant_schedule(0.01))
    p = {"a": torch.ones(3), "lora": None,
         "tail": (torch.ones(2), torch.ones(2)), "layers": [torch.ones(1)]}
    g = {"a": torch.ones(3), "lora": None,
         "tail": (torch.ones(2), torch.ones(2)), "layers": [torch.ones(1)]}
    new_p, st = opt.update(g, opt.init(p), p)
    assert new_p["lora"] is None and st.mu["lora"] is None
    assert isinstance(new_p["tail"], tuple) and len(new_p["tail"]) == 2
    assert isinstance(st.nu["layers"], list)
    assert p["a"].tolist() == [1.0, 1.0, 1.0]       # inputs untouched


def test_adamw_matches_reference_over_three_updates():
    """Weight decay, a cosine schedule in warmup, a float32 and a bfloat16
    leaf (rounded back every step), a None leaf and a tuple."""
    rng = np.random.default_rng(7)
    p_np = {"w": rng.standard_normal((5, 3)).astype(np.float32),
            "b": rng.standard_normal(7).astype(np.float32)}
    gs = [{"w": rng.standard_normal((5, 3)).astype(np.float32),
           "b": rng.standard_normal(7).astype(np.float32)} for _ in range(3)]
    pj = {"w": jnp.asarray(p_np["w"]),
          "t": (jnp.asarray(p_np["b"], jnp.bfloat16), None)}
    pt = {"w": torch.from_numpy(p_np["w"]),
          "t": (torch.from_numpy(p_np["b"]).to(torch.bfloat16), None)}
    opt_j = jax_adamw.AdamW(lr=jax_adamw.cosine_schedule(0.05, 5, 20),
                            weight_decay=0.1)
    opt_t = adamw.AdamW(lr=adamw.cosine_schedule(0.05, 5, 20),
                        weight_decay=0.1)
    sj, st = opt_j.init(pj), opt_t.init(pt)
    for g in gs:
        gj = {"w": jnp.asarray(g["w"]),
              "t": (jnp.asarray(g["b"], jnp.bfloat16), None)}
        gt = {"w": torch.from_numpy(g["w"]),
              "t": (torch.from_numpy(g["b"]).to(torch.bfloat16), None)}
        pj, sj = opt_j.update(gj, sj, pj)
        pt, st = opt_t.update(gt, st, pt)
    assert pt["t"][0].dtype == torch.bfloat16 and pt["t"][1] is None
    np.testing.assert_allclose(pt["w"].numpy(), np.asarray(pj["w"]),
                               rtol=0, atol=1e-6 * max(1.0, float(
                                   np.abs(np.asarray(pj["w"])).max())))
    want_b = np.asarray(pj["t"][0], np.float32)
    got_b = pt["t"][0].float().numpy()
    assert np.all(np.abs(got_b - want_b) <= 2.0 ** -8 * np.abs(want_b))
    for m_t, m_j in ((st.mu, sj.mu), (st.nu, sj.nu)):
        np.testing.assert_allclose(m_t["w"].numpy(), np.asarray(m_j["w"]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(m_t["t"][0].numpy(),
                                   np.asarray(m_j["t"][0]), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 50), (3, 20)])
def test_schedules_match_reference(warmup, total):
    lr_j = jax_adamw.cosine_schedule(0.3, warmup, total)
    lr_t = adamw.cosine_schedule(0.3, warmup, total)
    for s in (0, 1, warmup, (warmup + total) // 2, total, total + 5):
        got = lr_t(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        want = float(lr_j(jnp.asarray(s, jnp.int32)))
        assert abs(float(got) - want) <= 1e-6 * max(abs(want), 1e-30)
    const = adamw.constant_schedule(2e-3)(torch.tensor(4, dtype=torch.int32))
    assert const.dtype == torch.float32 and float(const) == float(
        jax_adamw.constant_schedule(2e-3)(jnp.asarray(4)))
    lr = adamw.cosine_schedule(1.0, warmup=10, total=100)
    assert float(lr(torch.tensor(0))) == pytest.approx(0.0)
    assert float(lr(torch.tensor(10))) == pytest.approx(1.0)
    assert float(lr(torch.tensor(100))) == pytest.approx(0.1, abs=1e-3)


def test_cross_entropy_and_global_norm_match_reference():
    rng = np.random.default_rng(8)
    logits = (rng.standard_normal((2, 6, 11)) * 3).astype(np.float32)
    labels = rng.integers(0, 11, (2, 6)).astype(np.int32)
    mask = (rng.random((2, 6)) < 0.6).astype(np.float32)
    for m in (None, mask, np.zeros_like(mask)):
        want = jax_train.cross_entropy(
            jnp.asarray(logits), jnp.asarray(labels),
            None if m is None else jnp.asarray(m))
        got = train.cross_entropy(torch.from_numpy(logits),
                                  torch.from_numpy(labels),
                                  None if m is None else torch.from_numpy(m))
        _scalar(got, want, 1e-6, "cross_entropy")
    # the reference's own case: uniform logits give log V, masked or not
    z = torch.zeros((1, 4, 8))
    lab = torch.zeros((1, 4), dtype=torch.int32)
    assert float(train.cross_entropy(z, lab)) == pytest.approx(np.log(8),
                                                               abs=1e-5)
    assert float(train.cross_entropy(
        z, lab, torch.tensor([[1.0, 1.0, 0.0, 0.0]]))) == pytest.approx(
        np.log(8), abs=1e-5)
    tree = {"a": logits, "b": (labels.astype(np.float32), None)}
    want = jax_train._global_norm(jax.tree_util.tree_map(jnp.asarray, tree))
    got = train._global_norm({"a": torch.from_numpy(logits),
                              "b": (torch.from_numpy(
                                  labels.astype(np.float32)), None)})
    _scalar(got, want, 1e-6, "global norm")


# ------------------------------------------------- the reference's behaviour
def _reference_init():
    """The reference's ``init_params(PRNGKey(0), CFG)`` (B = 0) bridged."""
    return bridged(CFG_J, CFG, seed=0, draw_b=False)[1]


def test_lora_step_only_touches_adapters():
    params = _reference_init()
    backbone, adapters = partition_lora(params)
    copies = [x.clone() for x in tree_leaves(backbone)]
    opt = adamw.AdamW(lr=adamw.constant_schedule(1e-2))
    step = train.make_lora_train_step(CFG, opt)
    toks = np.random.default_rng(1).integers(0, 128, (4, 16)).astype(
        np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    new_ad, _, m = step(backbone, adapters, opt.init(adapters), batch)
    assert np.isfinite(float(m["loss"]))
    # B starts at 0, so A's gradient is 0 at step 1, but B must move
    changed = any(float((a - b).abs().max()) > 0 for a, b in
                  zip(tree_leaves(adapters), tree_leaves(new_ad)))
    assert changed
    for x, c in zip(tree_leaves(backbone), copies):
        assert torch.equal(x, c) and x.grad is None


def test_full_training_reduces_loss():
    corpus = pipeline.synthetic_corpus(128, 20000, seed=3)
    _, hist = train.train_loop(
        CFG, _reference_init(), pipeline.lm_batches(corpus, 8, 32, seed=2),
        steps=90, lora_only=False,
        opt=adamw.AdamW(lr=adamw.cosine_schedule(3e-3, 5, 90)),
        log_every=1000, log_fn=lambda *_: None)
    assert hist[-1] < hist[0] - 0.15


def test_lora_finetune_reduces_loss_on_shifted_distribution():
    corpus = pipeline.synthetic_corpus(128, 20000, seed=3)
    params, _ = train.train_loop(
        CFG, _reference_init(), pipeline.lm_batches(corpus, 8, 32, seed=2),
        steps=80, lora_only=False,
        opt=adamw.AdamW(lr=adamw.cosine_schedule(3e-3, 5, 80)),
        log_every=1000, log_fn=lambda *_: None)
    corpus2 = pipeline.synthetic_corpus(128, 20000, seed=9)
    _, hist = train.train_loop(
        CFG, params, pipeline.lm_batches(corpus2, 8, 32, seed=1), steps=60,
        lora_only=True,
        opt=adamw.AdamW(lr=adamw.cosine_schedule(1e-2, 5, 60)),
        log_every=1000, log_fn=lambda *_: None)
    assert hist[-1] < hist[0] - 0.03


# -------------------------------------------------------------------- data
@pytest.mark.parametrize("vocab,length,seed", [(128, 20000, 3),
                                               (512, 5000, 9)])
def test_synthetic_corpus_and_batches_are_the_references(vocab, length,
                                                         seed):
    got = pipeline.synthetic_corpus(vocab, length, seed=seed)
    want = jax_pipeline.synthetic_corpus(vocab, length, seed=seed)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    extras = {"embeds": np.zeros((3, 2, 4), np.float32)}
    a = pipeline.take(pipeline.lm_batches(got, 3, 17, seed=seed,
                                          extras=extras), 5)
    b = jax_pipeline.take(jax_pipeline.lm_batches(want, 3, 17, seed=seed,
                                                  extras=extras), 5)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k])
    tok = pipeline.ByteTokenizer()
    ids = tok.encode("héllo")
    assert np.array_equal(ids, jax_pipeline.ByteTokenizer().encode("héllo"))
    assert tok.decode(list(ids) + [tok.EOS]) == "héllo"
