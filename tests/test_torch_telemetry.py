"""The port's telemetry exporters (``Telemetry.span_sequence``,
``chrome_trace`` / ``write_chrome_trace``, ``write_metrics_json`` over
``ContinuousRuntime.metrics_snapshot``) against the reference's
(``repro.serving.telemetry``), on the trace of ``tests/test_telemetry.py``
replayed through both runtimes on the CPU under deterministic fake
clocks (SMOKE Llama, and Mixtral SMOKE whose window reclaims blocks).

Both runtimes take the same timer readings in the same order, so the span
sequences and the Chrome traces must be equal event for event, and the
metrics files must hold the same keys and the same counter values.
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import json

import numpy as np
import pytest
import torch

from conftest import FakeTimer, build_model, make_runtime
from repro.checkpoint.store import _flatten
from repro.serverless.traces import TraceSpec, make_workload
from repro.serving import Telemetry as JaxTelemetry
from repro.serving import replay_trace as jax_replay_trace
from repro.serving import write_metrics_json as jax_write_metrics_json
from repro_torch.checkpoint.bridge import params_from_flat
from repro_torch.configs import get_smoke
from repro_torch.serving import (ContinuousRuntime, ServingConfig, Telemetry,
                                 replay_trace, write_metrics_json)
from repro_torch.serving import telemetry as tm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """SMOKE-sized tensors: one intra-op thread (the test workers share the
    machine's cores); the count is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# arch -> prompt length of the trace: Mixtral's prompts decode past its
# 16-token window, so its replays reclaim blocks
ARCHS = {"llama2_7b": 12, "mixtral_8x22b": 24}


@pytest.fixture(scope="module")
def models():
    """arch -> (jax cfg, jax params, torch cfg, torch params)."""
    out = {}
    for arch in ARCHS:
        cfg_j, params = build_model(arch)
        cfg_t = get_smoke(arch).with_(dtype="float32")
        out[arch] = (cfg_j, params, cfg_t,
                     params_from_flat(_flatten(params), cfg_t, device="cpu"))
    return out


def _workload(prompt_len):
    specs = [TraceSpec(f"fn{i}", "bursty", 1.5, 4.0, prompt_len=prompt_len,
                       output_len=8, slo_ttft=30.0) for i in range(3)]
    return make_workload(specs, seed=11), {f"fn{i}": i for i in range(3)}


def _port_replay(cfg, params, tele, prompt_len):
    rt = ContinuousRuntime(cfg, params, ServingConfig(
        num_slots=4, block_size=8, num_blocks=32, max_blocks_per_slot=6,
        prefill_chunk=16, decode_chunk=4), device="cpu", timer=FakeTimer(),
        telemetry=tele)
    wl, fa = _workload(prompt_len)
    replay_trace(rt, [dict(w) for w in wl], fa, seed=3, slo_abandon=False,
                 telemetry=tele)
    return rt


def _ref_replay(cfg, params, tele, prompt_len):
    rt = make_runtime(cfg, params, timer=FakeTimer(), telemetry=tele)
    wl, fa = _workload(prompt_len)
    jax_replay_trace(rt, [dict(w) for w in wl], fa, seed=3,
                     slo_abandon=False, telemetry=tele)
    return rt


@pytest.fixture(scope="module")
def replays(models):
    """arch -> ((ref runtime, ref recorder), (port runtime, recorder))."""
    out = {}
    for arch, (cfg_j, pj, cfg_t, pt) in models.items():
        tj, tt = JaxTelemetry(), Telemetry()
        out[arch] = ((_ref_replay(cfg_j, pj, tj, ARCHS[arch]), tj),
                     (_port_replay(cfg_t, pt, tt, ARCHS[arch]), tt))
    return out


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_span_sequence_and_chrome_trace_equal_the_reference(replays, arch):
    (_, tj), (_, tt) = replays[arch]
    assert tt.spans and tt.span_sequence() == tj.span_sequence()
    assert tt.chrome_trace() == tj.chrome_trace()


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_chrome_trace_valid_json_monotone_per_track(replays, arch,
                                                    tmp_path):
    (_, tt) = replays[arch][1]
    path = tmp_path / "trace.json"
    tt.write_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    names = {e["args"]["name"] for e in events if e["ph"] == "M"}
    assert tm.TRACK_QUEUE in names and tm.TRACK_HOST in names
    assert tm.TRACK_HOST_WALL in names
    assert any(n.startswith("slot") for n in names)
    last_ts = {}
    for e in events:
        assert e["ph"] in ("X", "i", "M")
        if e["ph"] == "M":
            continue
        assert e["ts"] >= 0 and e.get("dur", 0) >= 0
        assert e["ts"] >= last_ts.get(e["tid"], -1.0), \
            f"ts not monotone on track {e['tid']}"
        last_ts[e["tid"]] = e["ts"]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_metrics_json_keys_equal_the_reference(replays, arch, tmp_path):
    (rt_j, _), (rt_t, _) = replays[arch]
    jax_write_metrics_json(rt_j.metrics_snapshot(), str(tmp_path / "j"))
    write_metrics_json(rt_t.metrics_snapshot(), str(tmp_path / "t"))
    want = json.loads((tmp_path / "j").read_text())
    got = json.loads((tmp_path / "t").read_text())
    assert sorted(got) == sorted(want)
    for section in ("counters", "gauges", "histograms"):
        assert sorted(got[section]) == sorted(want[section]), section
    assert got["counters"] == want["counters"]
    assert (got["spans"], got["instant_events"], got["dispatches"]) == \
        (want["spans"], want["instant_events"], want["dispatches"])
    assert 0.0 <= got["host_bubble_fraction"] <= 1.0
    if arch == "mixtral_8x22b":
        assert got["counters"]["reclaimed_blocks"] > 0


def test_span_sequence_deterministic(models):
    _, _, cfg, params = models["llama2_7b"]
    runs = []
    for _ in range(2):
        tele = Telemetry()
        _port_replay(cfg, params, tele, ARCHS["llama2_7b"])
        runs.append(tele)
    assert runs[0].span_sequence() == runs[1].span_sequence()
    assert runs[0].chrome_trace() == runs[1].chrome_trace()


def test_empty_recorder_exports_no_events():
    tele = Telemetry()
    assert tele.span_sequence() == []
    assert tele.chrome_trace() == {"traceEvents": [],
                                   "displayTimeUnit": "ms"}
    tele.record_dispatch("decode", 1.0, 1.5)
    tele.record_dispatch("decode", 2.0, 2.25)
    wall = [e for e in tele.chrome_trace()["traceEvents"] if e["ph"] == "X"]
    assert [e["name"] for e in wall] == [
        "device_execute:decode", "host_plan", "device_execute:decode"]
    np.testing.assert_allclose([e["dur"] for e in wall],
                               [0.5e6, 0.5e6, 0.25e6])
