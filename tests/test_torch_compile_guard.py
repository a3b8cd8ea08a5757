"""The port's CompileGuard over ``GraphedDispatch`` (the seven cases of
``tests/test_compile_guard.py``, with a capture in place of a jit
compile), on the CPU, where a dispatch runs its function and records the
key of every new input signature.  Plus a runtime replay mixing greedy
and sampled requests under ``{decode: 1, prefill: 1}``: sampling
parameters are data, never a new shape.
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.core.sampling import SamplingParams
from repro_torch.models import transformer as tf
from repro_torch.serving import (CompileBudgetExceeded, CompileGuard,
                                 ContinuousRuntime, GraphedDispatch,
                                 ServingConfig, replay_trace)
from repro_torch.serving.compile_guard import _cache_size


def _dispatch(fn):
    return GraphedDispatch(fn, "cpu")


def test_shape_unstable_dispatch_fails():
    f = _dispatch(lambda x: x * 2.0)
    with pytest.raises(CompileBudgetExceeded, match="compiled 2x"):
        with CompileGuard({"f": 1}) as guard:
            guard.watch("f", f)
            f(np.zeros((4,), np.float32))
            f(np.zeros((8,), np.float32))   # new shape -> new capture


def test_fixed_shape_replay_passes():
    f = _dispatch(lambda x: x + 1.0)
    with CompileGuard({"f": 1}) as guard:
        guard.watch("f", f)
        for i in range(4):
            out = f(np.full((4,), i, np.float32))
            assert out.tolist() == [i + 1.0] * 4
    assert guard.compiles("f") == 1
    # a dtype is part of the signature too
    with pytest.raises(CompileBudgetExceeded):
        with CompileGuard({"f": 0}) as guard:
            guard.watch("f", f)
            f(np.zeros((4,), np.float64))


def test_baseline_excludes_prior_compiles():
    f = _dispatch(lambda x: x - 1.0)
    f(np.zeros((4,), np.float32))           # pre-guard warmup
    with CompileGuard({"f": 0}) as guard:
        guard.watch("f", f)
        f(np.zeros((4,), np.float32))       # same key: no new capture
    assert guard.compiles("f") == 0


def test_attach_watches_runtime_dispatches():
    class FakeRuntime:
        def __init__(self):
            self._decode = _dispatch(lambda x: x * 2)
            self._prefill = _dispatch(lambda x: x * 3)

    rt = FakeRuntime()
    with CompileGuard({"decode": 1, "prefill": 1}, runtime=rt) as guard:
        rt._decode(np.zeros((2,), np.float32))
        rt._prefill(np.zeros((2,), np.float32))
    rep = guard.report()
    assert rep["decode_compiles"] == 1 and rep["decode_budget"] == 1
    assert rep["prefill_compiles"] == 1 and rep["prefill_budget"] == 1
    assert "backend_compiles" in rep


def test_body_exception_not_masked():
    f = _dispatch(lambda x: x / 2.0)
    with pytest.raises(RuntimeError, match="body failed"):
        with CompileGuard({"f": 0}) as guard:
            guard.watch("f", f)
            f(np.zeros((4,), np.float32))   # budget 0 already blown
            raise RuntimeError("body failed")


def test_unbudgeted_watch_reports_without_enforcing():
    f = _dispatch(lambda x: x * 5.0)
    with CompileGuard() as guard:
        guard.watch("f", f)
        f(np.zeros((2,), np.float32))
        f(np.zeros((6,), np.float32))       # 2 captures, nothing enforced
    assert guard.report()["f_compiles"] == 2
    assert "f_budget" not in guard.report()
    assert _cache_size(lambda x: x) is None   # no probe: not enforced


def test_max_total_counts_captures_process_wide():
    with pytest.raises(CompileBudgetExceeded, match="backend compiles"):
        with CompileGuard(max_total=0):
            _dispatch(lambda x: x @ x)(np.zeros((3, 3), np.float32))
    with CompileGuard(max_total=2) as guard:
        a, b = _dispatch(lambda x: x + 1), _dispatch(lambda x: x - 1)
        a(np.zeros((2,), np.float32))
        b(np.zeros((2,), np.float32))
        a(np.zeros((2,), np.float32))       # a known key: no capture
    assert guard.report()["backend_compiles"] == 2


def test_replay_and_inputs_advanced_in_place():
    """``replay()`` reruns the last key on its input buffers as the step
    left them; the caller's own arrays are never written."""
    def step(x, n):
        n.add_(1)
        return x * n

    f = _dispatch(step)
    x, n = np.ones((3,), np.float32), np.zeros((), np.float32)
    assert f(x, n).tolist() == [1.0] * 3
    assert [f.replay().tolist()[0] for _ in range(3)] == [2.0, 3.0, 4.0]
    assert float(n) == 0.0 and f._cache_size() == 1
    assert f.eager(x, n).tolist() == [1.0] * 3


def test_runtime_mixed_sampling_replay_captures_once():
    """Greedy, temperature, top-k and top-p requests in one replay, and a
    second replay on the same runtime: one decode and one prefill key."""
    cfg = get_smoke("llama2_7b").with_(dtype="float32")
    gen = torch.Generator()
    gen.manual_seed(0)
    params = tf.init_params(cfg, gen, "cpu", lora_adapters=2,
                            lora_b_scale=0.1)
    rt = ContinuousRuntime(cfg, params, ServingConfig(
        num_slots=4, block_size=8, num_blocks=32, max_blocks_per_slot=6,
        prefill_chunk=16, decode_chunk=4), device="cpu")
    rng = np.random.default_rng(0)
    work, prompts = [], {}
    for rid in range(6):
        prompts[rid] = rng.integers(0, cfg.vocab_size,
                                    int(rng.integers(5, 30))).astype(np.int32)
        work.append(dict(req_id=rid, fn_id=f"fn{rid % 2}",
                         arrival=0.001 * rid, prompt_len=len(prompts[rid]),
                         output_len=6, slo_ttft=100.0))
    sampling = {1: SamplingParams(temperature=0.8, top_k=5),
                2: SamplingParams(temperature=1.2, top_p=0.7, seed=3),
                4: SamplingParams(temperature=0.5, top_k=8, top_p=0.9)}
    with CompileGuard({"decode": 1, "prefill": 1}, runtime=rt) as guard:
        for _ in range(2):
            sink = {}
            res, _ = replay_trace(rt, work, {"fn0": 0, "fn1": 1},
                                  prompts=prompts, token_sink=sink,
                                  sampling=sampling)
            assert all(len(sink[w["req_id"]]) == 6 for w in work)
    rep = guard.report()
    assert rep["decode_compiles"] == 1 and rep["prefill_compiles"] == 1
    assert rt.stats["sampled_tokens"] == 2 * 3 * 6
    assert rt.metrics.gauge("decode_compiles").last == 1
    assert rt.metrics.gauge("prefill_compiles").last == 1
