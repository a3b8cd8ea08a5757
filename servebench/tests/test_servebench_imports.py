"""What the benchmark may import, and that BENCHMARK.json keeps to the
benchmark's contract as far as a file can show it."""
import ast
import json
import re
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path):
    """Top-level names of every import in a file (whole names)."""
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax_and_no_reference_package(path):
    bad = FORBIDDEN.intersection(_imports(path))
    assert not bad, f"{path} imports {bad}"
    if "reference" in path.relative_to(BENCH).parts:
        assert "repro_torch" not in set(_imports(path)), \
            f"{path}: the reference imports the program"


def test_whole_names_are_compared():
    """``repro_torch`` starts with ``repro`` and is allowed."""
    src = "import repro_torch.serving\nfrom repro_torch import kernels\n"
    p = BENCH / "tests" / "_probe_imports.txt"
    try:
        p.write_text(src)
        assert set(_imports(p)) == {"repro_torch"}
        assert not FORBIDDEN.intersection(_imports(p))
        p.write_text("from repro.models import config\n")
        assert FORBIDDEN.intersection(_imports(p)) == {"repro"}
    finally:
        p.unlink()


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_benchmark_json_keeps_to_the_contract():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= b["run_seconds"] <= 51
    cells = len(b["workloads"])
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in names
        names.add(c["name"])
        assert c["file"].startswith(b["paths"][0] + "/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == \
            c["reduced"]
        assert all(not k.endswith(("_dim", "_rank")) for k in c["reduced"])
    used = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["name"] not in names
        names.add(w["name"])
        assert w["config"] in {c["name"] for c in b["configs"]}
        assert (ROOT / b["paths"][0] / "traffic" /
                f"{w['traffic']}.json").is_file()
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        used.add(w["config"])
        e2e = [m["name"] for m in b["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]])
                   for m in b["per_layer"])
    assert used == {c["name"] for c in b["configs"]}
    assert 1 <= cells <= 24
    for m in b["end_to_end"]:
        assert NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    by_name = {m["name"]: m for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in by_name
        moved = by_name[m["moves"]].get("workloads")
        for w in m.get("workloads", []):
            assert moved is None or w in moved
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
