"""The port's examples (``repro_torch/examples``) against the reference's
(``examples/*.py``), line for line, on the CPU: the paper setup,
``serverless_sim``, ``quickstart`` and ``train_lora``.

Each test runs the reference example's own ``main()`` in-process and
captures what it prints, then runs the port's work function on the
reference's weights (carried over by ``checkpoint/bridge.py``) and its
draws.  Exact line equality throughout (``quickstart``'s tokens in
bfloat16 included), with two exceptions that the tests state: the port
keeps one leaf per layer where the reference stacks them, so only
``N == M`` is held on ``quickstart``'s ``zero-copy: N/M`` line; and
``train_lora``'s losses, each step a float32-accumulated bfloat16 product
of another framework, are held within 1e-3 absolute.
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import dataclasses
import re

import jax
import numpy as np
import pytest
import torch

from _example_runs import load_example, printed, run_main
from repro.checkpoint.store import _flatten
from repro.configs import get_smoke as jax_get_smoke
from repro.models import transformer as jtf
from repro_torch.checkpoint.bridge import params_from_flat
from repro_torch.configs import get_smoke
from repro_torch.examples import paper_setup, quickstart, serverless_sim
from repro_torch.examples import train_lora

bench_common = load_example("common", folder="benchmarks")

# ---------------------------------------------------------- paper setup
@pytest.mark.parametrize("pattern", paper_setup.PATTERNS)
def test_paper_workload_equals_reference(pattern):
    assert paper_setup.paper_workload(pattern, 600.0) == \
        bench_common.paper_workload(pattern, 600.0)


def test_paper_functions_cluster_and_policies_equal_reference():
    assert bench_common.PATTERNS == paper_setup.PATTERNS
    assert (bench_common.SLO_7B, bench_common.SLO_13B) == \
        (paper_setup.SLO_7B, paper_setup.SLO_13B)
    ours, ref = paper_setup.paper_functions(), bench_common.paper_functions()
    assert len(ours) == len(ref) == 8
    for a, b in zip(ours, ref):
        assert (a.fn_id, a.backbone_id, a.rate_hint) == \
            (b.fn_id, b.backbone_id, b.rate_hint)
        assert dataclasses.asdict(a.cfg) == dataclasses.asdict(b.cfg)
    for n in (1, 4):
        c, r = paper_setup.paper_cluster(n), bench_common.paper_cluster(n)
        assert [dataclasses.asdict(x) for x in c.nodes] == \
            [dataclasses.asdict(x) for x in r.nodes]
        assert len(c.gpus) == n and len(c.containers) == 2 * n
    for ours_p, ref_p in ((paper_setup.ALL_POLICIES,
                           bench_common.ALL_POLICIES),
                          (paper_setup.SERVERLESS_POLICIES,
                           bench_common.SERVERLESS_POLICIES)):
        assert [_policy(p) for p in ours_p] == [_policy(p) for p in ref_p]


def _policy(p):
    """A policy's fields, its artifact kinds by value (each package has
    its own ``Kind`` enum)."""
    return dict(dataclasses.asdict(p), preload_kinds=sorted(
        k.value for k in p.preload_kinds))


# ------------------------------------------------------- serverless_sim
def test_serverless_sim_prints_the_reference_lines(monkeypatch, capsys):
    want = run_main(load_example("serverless_sim"), ["--duration", "600"],
                    monkeypatch, capsys)
    rep = serverless_sim.main(["--duration", "600", "--device", "cpu"])
    assert printed(capsys) == want
    assert len(want) == 28
    assert set(rep["results"]) == set(paper_setup.PATTERNS)


# ----------------------------------------------------------- quickstart
def test_quickstart_prints_the_reference_lines(monkeypatch, capsys):
    want = run_main(load_example("quickstart"), [], monkeypatch, capsys)
    cfg_j = jax_get_smoke("llama2_7b").with_(name="demo-backbone")
    key = jax.random.PRNGKey(0)
    pj = jtf.init_params(key, cfg_j, lora_adapters=3)
    prompts = np.asarray(jax.random.randint(key, (3, 12), 0,
                                            cfg_j.vocab_size))
    cfg_t = get_smoke("llama2_7b").with_(name="demo-backbone")
    pt = params_from_flat(_flatten(pj), cfg_t, device="cpu")
    rep = quickstart.run(cfg_t, pt, torch.from_numpy(prompts), device="cpu")
    got = printed(capsys)
    assert len(got) == len(want) == 8
    zc = re.compile(r"zero-copy: (\d+)/(\d+) leaves shared between "
                    r"functions$")
    (n, m), = [zc.match(x).groups() for x in got if zc.match(x)]
    assert n == m and int(n) > 0
    assert [x for x in got if not zc.match(x)] == \
        [x for x in want if not zc.match(x)]
    assert rep["simulator"] == want[-2:]
    assert rep["tokens"] == [list(map(int, r.split(": ")[1].strip("[]")
                                      .split(", "))) for r in want[3:6]]


# ----------------------------------------------------------- train_lora
LOSS_TOL = 1e-3
_NUM = re.compile(r"-?\d+\.\d+")


def test_train_lora_tracks_the_reference(monkeypatch, capsys, tmp_path):
    flags = ["--steps", "20", "--lora-steps", "20", "--batch", "4",
             "--seq", "32"]
    want = run_main(load_example("train_lora"),
                    flags + ["--out", str(tmp_path / "ref")], monkeypatch,
                    capsys)
    cfg_j = jax_get_smoke("smollm_360m").with_(name="smol-demo",
                                                vocab_size=512)
    pj = jtf.init_params(jax.random.PRNGKey(0), cfg_j)
    cfg_t = get_smoke("smollm_360m").with_(name="smol-demo", vocab_size=512)
    pt = params_from_flat(_flatten(pj), cfg_t, device="cpu")
    rep = train_lora.run(cfg_t, pt, steps=20, lora_steps=20, batch=4,
                         seq=32, out=str(tmp_path / "port"))
    got = printed(capsys)
    assert len(got) == len(want) == 6
    # model and checkpoint lines: equal
    assert got[0] == want[0] and got[-1] == want[-1]
    # step, pretrain and fine-tune lines: same words, losses within 1e-3
    for g, w in zip(got[1:-1], want[1:-1]):
        assert _NUM.sub("#", g) == _NUM.sub("#", w)
        gn, wn = _NUM.findall(g), _NUM.findall(w)
        if g.startswith("step"):          # "step i loss L gnorm G"
            gn, wn = gn[:1], wn[:1]
        np.testing.assert_allclose(np.float64(gn), np.float64(wn), rtol=0,
                                   atol=LOSS_TOL)
    assert rep["tail"] < rep["head"]
    assert len(rep["history"]) == len(rep["history_ft"]) == 20
