"""The frozen yardsticks: counts, draws and the kernel classifier."""
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from servebench import arrivals as ar
from servebench import model, peaks, spec, traffic
from servebench.tracing import (TraceData, breakdown, in_spans, kernel_kind,
                                merge, overlap)

BENCH = Path(__file__).resolve().parents[1]
RNG = np.random.default_rng(7)


def _table(b, mb, bs, fill):
    tbl = np.full((b, mb), -1, np.int32)
    for i in range(b):
        n = RNG.integers(0, mb + 1) if fill is None else fill
        tbl[i, :n] = RNG.permutation(1000)[:n]
        if n > 2 and RNG.random() < 0.3:
            tbl[i, 0] = -1                  # a reclaimed leading block
    return tbl


@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("bs", [16, 12])
def test_paged_decode_counts_match_the_program(window, bs):
    from repro_torch.kernels.paged_attention import ops
    w = spec.work_module(BENCH, "paged_decode")
    b, mb, h, k, hd = 6, 9, 8, 2, 32
    tbl = _table(b, mb, bs, None)
    pos = RNG.integers(0, mb * bs, size=b).astype(np.int32)
    want = ops.work(torch.zeros(b, h, hd, dtype=torch.bfloat16),
                    torch.zeros(k, 1000, bs, hd, dtype=torch.bfloat16),
                    torch.zeros(k, 1000, bs, hd, dtype=torch.bfloat16),
                    torch.from_numpy(tbl), torch.from_numpy(pos),
                    window=window)
    got = w.work(tbl, pos, heads=h, kv_heads=k, head_dim=hd, block_size=bs,
                 elem_bytes=2, window=window)
    assert got == (want.flops, want.bytes)


@pytest.mark.parametrize("window", [None, 24])
def test_paged_prefill_counts_match_the_program(window):
    from repro_torch.kernels.paged_prefill import ops
    w = spec.work_module(BENCH, "paged_prefill")
    b, mb, bs, c, h, k, hd = 4, 10, 16, 32, 8, 2, 32
    tbl = _table(b, mb, bs, None)
    start = (RNG.integers(0, mb * bs - c, size=b) // bs * bs).astype(
        np.int32)
    q_pos = torch.from_numpy(start)[:, None] + torch.arange(c)[None]
    want = ops.work(torch.zeros(b, c, h, hd, dtype=torch.bfloat16),
                    torch.zeros(k, 1000, bs, hd, dtype=torch.bfloat16),
                    torch.zeros(k, 1000, bs, hd, dtype=torch.bfloat16),
                    torch.from_numpy(tbl), q_pos, window=window)
    got = w.work(tbl, start, c, heads=h, kv_heads=k, head_dim=hd,
                 block_size=bs, elem_bytes=2, window=window)
    assert got == (want.flops, want.bytes)


def test_sgmv_counts_match_the_program():
    from repro_torch.kernels.sgmv import ops
    w = spec.work_module(BENCH, "sgmv")
    r_rows, d, r, o, n = 37, 64, 16, 96, 6
    idx = RNG.integers(-1, n + 2, size=r_rows).astype(np.int32)
    want = ops.work(torch.zeros(r_rows, d, dtype=torch.bfloat16),
                    torch.zeros(n, d, r, dtype=torch.bfloat16),
                    torch.zeros(n, r, o, dtype=torch.bfloat16),
                    torch.from_numpy(idx))
    got = w.work(idx, d_in=d, d_out=o, rank=r, bank=n, elem_bytes=2)
    assert got == (want.flops, want.bytes)


@pytest.mark.parametrize("name", ["phi3-medium-4k", "mixtral8x22b-d8"])
def test_model_flops_per_token_is_twice_the_active_weights(name):
    """Against the program's own parameter count: 2 per active weight of
    the layers (embedding, LM head and norms left out), plus LoRA."""
    mf = spec.work_module(BENCH, "model_flops")
    config = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    config["name"] = name
    cfg = model.model_config(config)
    m = model.shapes(config)
    d, v = cfg.d_model, cfg.vocab_size
    layers = cfg.active_param_count() - v * d - d - v * d
    lora = sum(cfg.lora.rank * (i + o)
               for i, o in model.lora_sites(m).values())
    assert mf.per_token(m) == 2 * (layers + cfg.num_layers * lora)
    assert mf.lm_head(m) == 2 * d * v
    # causal attention: n tokens from position p see p+1 .. p+n keys
    att = mf.tokens(m, 10, 3, 0) - 3 * mf.per_token(m)
    assert att == 4 * cfg.head_dim_ * cfg.num_heads * cfg.num_layers * (
        11 + 12 + 13)


def test_bound_is_the_larger_of_bytes_and_operations():
    p = peaks.peaks_of("NVIDIA H100 80GB HBM3")
    assert peaks.bound_s(989e12, 0, p) == pytest.approx(1.0)
    assert peaks.bound_s(0, 3.35e12, p) == pytest.approx(1.0)
    with pytest.raises(KeyError):
        peaks.peaks_of("NVIDIA A100")


def test_stratified_draws():
    gaps = ar.exponential_quantiles(4000, 0.25)
    assert gaps.mean() == pytest.approx(0.25, rel=0.01)
    lens = ar.lognormal_quantiles(1001, 192, 0.8, 32, 1024)
    assert np.median(lens) == 192
    assert lens.min() >= 32 and lens.max() <= 1024
    shares = ar.zipf_shares(16, 1.0)
    assert shares[0] / shares[1] == pytest.approx(2.0)
    counts = ar.apportion(101, shares)
    assert sum(counts) == 101 and counts == sorted(counts, reverse=True)
    seq = ar.function_sequence(101, shares, np.random.default_rng(0))
    assert np.bincount(seq, minlength=16).tolist() == counts


def test_a_schedule_is_the_same_for_every_seed():
    mix = json.loads((BENCH / "traffic" / "chat-16fn.json").read_text())
    a = traffic.generate(mix, 32064, 1, 45.0)
    b = traffic.generate(mix, 32064, 2 ** 31 + 99, 45.0)
    assert [(r.due, r.fn, len(r.prompt), r.output_len) for r in a] == \
        [(r.due, r.fn, len(r.prompt), r.output_len) for r in b]
    assert any((x.prompt != y.prompt).any() for x, y in zip(a, b))
    by_fn = {}
    for r in a:
        pre = tuple(r.prompt[:mix["shared_prefix_tokens"]])
        assert by_fn.setdefault(r.fn, pre) == pre
    due = sum(1 for r in a if 0.0 <= r.due < 45.0)
    assert abs(due - 45.0 * mix["arrivals"]["rate_per_s"]) < 20
    again = traffic.generate(mix, 32064, 1, 45.0)
    assert all((x.prompt == y.prompt).all() for x, y in zip(a, again))


def test_without_a_schedule_seed_the_run_seed_orders_it():
    mix = json.loads((BENCH / "traffic" / "chat-16fn.json").read_text())
    del mix["schedule_seed"]
    a = traffic.generate(mix, 32064, 1, 45.0)
    b = traffic.generate(mix, 32064, 2, 45.0)
    assert sorted(len(r.prompt) for r in a) == \
        sorted(len(r.prompt) for r in b)
    assert [len(r.prompt) for r in a] != [len(r.prompt) for r in b]


def test_backlog_is_due_at_the_preroll_start():
    mix = json.loads((BENCH / "traffic" / "batch-8fn.json").read_text())
    reqs = traffic.generate(mix, 32768, 5, 45.0)
    assert len(reqs) == mix["arrivals"]["count"]
    assert {r.due for r in reqs} == {-mix["preroll_s"]}
    lens = [len(r.prompt) for r in reqs]
    assert min(lens) >= mix["prompt"]["min"]
    assert max(lens) <= mix["prompt"]["max"]


@pytest.mark.parametrize("name,kind", [
    ("void (anonymous namespace)::sgmv_bf16_kernel<16>(x)", "sgmv"),
    ("void rt::ring::paged_decode_kernel<128, 8>(CUtensorMap_st)",
     "paged_attention"),
    ("void rt::paged_prefill_kernel<128>(x)", "paged_prefill"),
    ("nvjet_tst_192x128_64x5_1x2_h_bz_coopB_NNT", "matmul"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32", "matmul"),
    ("Memcpy HtoD (Pinned -> Device)", "copy"),
    ("void at::native::elementwise_kernel<128, 4>(x)", "other"),
])
def test_kernel_kind(name, kind):
    assert kernel_kind(name) == kind


def test_interval_sums():
    busy = merge([(0.0, 1.0), (0.5, 2.0), (3.0, 4.0)])
    assert busy == [(0.0, 2.0), (3.0, 4.0)]
    assert overlap(busy, [(1.0, 3.5)]) == pytest.approx(1.5)
    ks = [("a", 0.1, 0.2), ("b", 0.3, 0.4), ("c", 1.2, 1.3)]
    assert in_spans(ks, [(0.0, 0.35), (1.0, 2.0)]) == [[0, 1], [2]]
    out = breakdown(TraceData(ks, 0, 0.0), [("decode", 0.0, 1.0)], 0.0, 2.0)
    assert out["device_ops"][0][1] == pytest.approx(0.1)
    gaps = dict(out["idle_gaps"])
    assert gaps["decode"] == pytest.approx(1.0)
    assert gaps["host outside runtime calls"] == pytest.approx(0.7)
    assert math.isclose(sum(gaps.values()) + 0.3, 2.0)


def test_host_clock_readings_end_where_the_profiler_starts():
    from types import SimpleNamespace as NS

    from servebench import readers
    calls = [NS(kind="decode", t0=float(t), t1=t + (0.1 if t < 5 else 0.2))
             for t in range(10)]
    ctx = readers.Context(config={"serving": {"decode_chunk": 4}},
                          shapes={}, seconds=10.0,
                          loop=NS(spans=calls, records={}), stats0={},
                          stats1={}, trace=None, peaks={}, bench_dir=None,
                          host_until=5.0)
    assert readers.decode_step_ms(ctx) == pytest.approx(25.0)
    ctx.host_until = float("inf")
    assert readers.decode_step_ms(ctx) == pytest.approx(37.5)
