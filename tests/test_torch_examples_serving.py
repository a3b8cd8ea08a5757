"""The port's two serving examples (``repro_torch/examples/
serve_multilora.py`` and ``serve_continuous.py``) against the reference's
(``examples/``), line for line, on the CPU.

Each test runs the reference example's own ``main()`` in-process, with
its clock pinned by monkeypatching names in the example module, and then
the port's work function on the reference's weights (carried over by
``checkpoint/bridge.py``), its draws and the same clock:

* ``serve_multilora --requests 8``: the reference's ``time`` becomes a
  ``FakeTimer`` of 50 ms steps, so both read T0 = 50 ms.  The profile line
  and every dispatch line (virtual time, function, batch size, output
  shape, first tokens, in bfloat16) are equal; the closing ``tok/s`` line
  is held to its form.
* ``serve_continuous --duration 5`` for ``llama2_7b`` and
  ``recurrentgemma_9b``: both runtimes read a ``FakeTimer``, so the
  virtual clock, and with it every scheduling decision and every printed
  time, is equal.  Every line is equal, and so are every request's greedy
  tokens and the whole event list.
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import functools
import re
import types

import jax
import numpy as np
import pytest
import torch

from _example_runs import load_example, printed, run_main
from conftest import FakeTimer
from repro.checkpoint.store import _flatten
from repro.configs import get_smoke as jax_get_smoke
from repro.models import transformer as jtf
from repro.serving import ContinuousRuntime as JaxRuntime
from repro_torch.checkpoint.bridge import params_from_flat
from repro_torch.configs import get_smoke
from repro_torch.core.lora import partition_lora
from repro_torch.examples import serve_continuous, serve_multilora

T0_STEP = 0.05


# ------------------------------------------------------- serve_multilora
def test_serve_multilora_prints_the_reference_lines(monkeypatch, capsys):
    ref = load_example("serve_multilora")
    monkeypatch.setattr(ref, "time", types.SimpleNamespace(
        perf_counter=FakeTimer(T0_STEP)))
    want = run_main(ref, ["--requests", "8"], monkeypatch, capsys)

    cfg_j = jax_get_smoke("llama2_7b").with_(name="serve-demo")
    key = jax.random.PRNGKey(0)
    pj = jtf.init_params(key, cfg_j, lora_adapters=4)
    profile = np.asarray(jax.random.randint(key, (1, 32), 0,
                                            cfg_j.vocab_size))

    def draw_prompts(served, b):
        return torch.from_numpy(np.asarray(jax.random.randint(
            jax.random.PRNGKey(served), (b, 32), 0, cfg_j.vocab_size)))

    cfg_t = get_smoke("llama2_7b").with_(name="serve-demo")
    pt = params_from_flat(_flatten(pj), cfg_t, device="cpu")
    rep = serve_multilora.run(cfg_t, pt, torch.from_numpy(profile),
                              draw_prompts, requests=8, adapters=4,
                              max_new=16, device="cpu",
                              clock=FakeTimer(T0_STEP))
    got = printed(capsys)
    assert want[0] == f"profile: T0={T0_STEP * 1000:.1f}ms " \
        f"α={T0_STEP * 100:.2f}ms B_max=8"
    assert len(got) == len(want) and got[:-1] == want[:-1]
    assert sum(d[2] for d in rep["dispatches"]) == rep["served"] == 8
    assert len(rep["dispatches"]) == len(want) - 3 > 1
    tail = re.compile(r"served 8 requests / 128 tokens in \d+\.\d\ds "
                      r"\(\d+\.\d tok/s on CPU\)$")
    assert tail.match(want[-1]) and tail.match(got[-1])


# ------------------------------------------------------ serve_continuous
def _port_adapter(flat, one, cfg):
    """The reference's single-adapter tree ``one`` (flat) as the port's
    adapter tree: the LoRA leaves of the full flat tree replaced by it,
    bridged, and split off."""
    return partition_lora(params_from_flat({**flat, **_flatten(one)}, cfg,
                                           device="cpu"))[1]


@pytest.mark.parametrize("arch", ["llama2_7b", "recurrentgemma_9b"])
def test_serve_continuous_prints_the_reference_lines(monkeypatch, capsys,
                                                     arch):
    ref = load_example("serve_continuous")
    monkeypatch.setattr(ref, "ContinuousRuntime", functools.partial(
        JaxRuntime, timer=FakeTimer()))
    ref_tokens, ref_events = {}, []
    replay = ref.replay_trace

    def recorded(*a, **kw):
        res, events = replay(*a, token_sink=ref_tokens, **kw)
        ref_events.extend(events)
        return res, events

    monkeypatch.setattr(ref, "replay_trace", recorded)
    flags = ["--arch", arch, "--duration", "5"]
    want = run_main(ref, flags, monkeypatch, capsys)

    cfg_j = jax_get_smoke(arch).with_(name="serve-continuous",
                                      dtype="float32")
    pj = jtf.init_params(jax.random.PRNGKey(0), cfg_j, lora_adapters=3)
    cfg_t = get_smoke(arch).with_(name="serve-continuous", dtype="float32")
    flat = _flatten(pj)
    pt = params_from_flat(flat, cfg_t, device="cpu")
    adapters = [_port_adapter(flat, ref._rand_adapter(pj, 100 + a), cfg_t)
                for a in range(3)]
    args = serve_continuous.build_parser().parse_args(
        flags + ["--device", "cpu"])
    rep = serve_continuous.run(args, cfg_t, pt, adapters, timer=FakeTimer())
    got = printed(capsys)

    assert got == want
    assert len(want) > 40
    assert rep["tokens"] == ref_tokens and len(ref_tokens) > 10
    assert [(e.t, e.kind, e.req_id, e.slot, e.detail)
            for e in rep["events"]] == \
        [(e.t, e.kind, e.req_id, e.slot, e.detail) for e in ref_events]
    assert rep["in_use_after_drain"] == 0
