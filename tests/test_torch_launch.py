"""The port's serving launcher (``repro_torch.launch.serve``) on the CPU
against the reference's ``repro.launch.serve`` with the same flags.

Both draw arrivals from ``np.random.default_rng(0)`` and profile batches
with the same analytic latency model, so they must take the same batching
decisions: the printed schedule lines agree exactly.  Weights and prompts
come from different generators, so tokens are not compared here
(``tests/test_torch_engine.py`` holds the engine's tokens against the
reference on shared weights).
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import contextlib
import inspect
import io
import re
import sys

import pytest

from repro.launch import serve as jax_serve
from repro_torch.core.engine import InferenceEngine
from repro_torch.launch import serve
from repro_torch.models import cache

FLAGS = ["--requests", "8", "--prompt-len", "8", "--max-new", "4"]
LINE = re.compile(r"^t=\s*[\d.]+s\s+(fn\d+) batch=(\d+) -> \((\d+), (\d+)\)$")


def _schedule_lines(text):
    return [ln for ln in text.splitlines()
            if ln.startswith(("t=", "backbone "))]


@pytest.fixture(scope="module")
def reference_output():
    """What the reference launcher prints for FLAGS."""
    buf = io.StringIO()
    argv = sys.argv
    sys.argv = ["serve"] + FLAGS
    try:
        with contextlib.redirect_stdout(buf):
            jax_serve.main()
    finally:
        sys.argv = argv
    return buf.getvalue()


def test_launcher_takes_the_reference_schedule(reference_output, capsys):
    res = serve.main(["--device", "cpu"] + FLAGS)
    out = capsys.readouterr().out
    assert _schedule_lines(out) == _schedule_lines(reference_output)
    ref = [(m.group(1), int(m.group(2)))
           for m in map(LINE.match, reference_output.splitlines()) if m]
    assert res["schedule"] == ref and len(ref) > 1
    assert sum(b for _, b in res["schedule"]) == res["served"] == 8
    assert res["shapes"] == [(b, 4) for _, b in res["schedule"]]
    assert res["tokens"] == 8 * 4
    assert "served 8 requests, 32 tokens in" in out


def test_launcher_shares_one_backbone_and_launches_nothing_on_cpu(capsys):
    res = serve.main(["--device", "cpu", "--adapters", "3"] + FLAGS)
    capsys.readouterr()
    assert res["open_handles"] == 3
    ptrs = res["backbone_ptrs"]
    assert len(ptrs) == 3 and ptrs[0] and all(p == ptrs[0] for p in ptrs)
    assert set(res["launches"].values()) == {0}


def test_entry_points_default_to_the_card():
    assert serve.build_parser().parse_args([]).device == "cuda"
    for fn in (InferenceEngine.__init__, cache.init_cache):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
