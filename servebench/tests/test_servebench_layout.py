"""A configuration, a traffic mix and a per-layer metric are picked up by
name from files alone: a new one needs no edit of the harness."""
import json
import time

from servebench import spec
from servebench.run import run_cell
from servebench.tests import tiny

NEW_METRIC = '''"""A metric that no code of the harness names."""


def read(ctx):
    return float(len(ctx.loop.spans))
'''


def test_new_files_are_found_by_name(tmp_path):
    root = tiny.make_root(tmp_path, extra_metrics=[{
        "name": "spans_seen", "unit": "calls", "better": "higher",
        "source": "host_clock", "layer": "admission",
        "moves": "ttft_p50_ms", "workloads": ["tiny.chat"]}])
    (root / "servebench" / "metrics" / "spans_seen.py").write_text(
        NEW_METRIC)
    cell = spec.load_cell("tiny.chat", root)
    assert cell.config["model"]["d_model"] == tiny.CONFIG["model"][
        "d_model"]
    assert cell.traffic["name"] == "tiny-chat"
    assert "spans_seen" in [m["name"] for m in cell.per_layer]
    res = run_cell(cell, 2 ** 31 + 3, 1.5, True, "cpu", time.perf_counter())
    assert res["metrics"]["spans_seen"]["value"] > 0
    assert res["metrics"]["prefix_hit_share"]["unit"] == "%"
    assert "ttft_p95_ms" not in res["metrics"]      # a traced run's line
    assert list(res)[-1] == "compared"
    json.dumps(res)


def test_a_metric_without_a_reader_is_refused(tmp_path):
    root = tiny.make_root(tmp_path)
    try:
        spec.reader(root / "servebench", "no_such_metric")
    except FileNotFoundError:
        return
    raise AssertionError("a missing reader went unnoticed")
