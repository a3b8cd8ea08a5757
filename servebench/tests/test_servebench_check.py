"""What decides ``correct``: a sound run passes; the run with its timed
path broken underneath, and the float8 control, do not."""
import time

import numpy as np
import pytest
import torch

from servebench import spec
from servebench.reference.model import fp8
from servebench.run import run_cell
from servebench.tests import tiny

SEED = 2 ** 31 + 17


def _cell(tmp_path, config=tiny.CONFIG):
    return spec.load_cell("tiny.chat", tiny.make_root(tmp_path,
                                                      config=config))


@pytest.mark.parametrize("config", [tiny.CONFIG, tiny.MOE],
                         ids=["dense", "moe"])
def test_a_sound_run_is_correct(tmp_path, config):
    cell = _cell(tmp_path, dict(config, check=dict(
        config["check"], router_margin=0.1,
        limits={"max_logit_gap": 0.05} if config is tiny.CONFIG
        else {"routed_mean_logit_gap": 0.02})))
    res = run_cell(cell, SEED, 2.0, False, "cpu", time.perf_counter())
    assert res["correct"], res["compared"]
    assert res["counts"]["checked_tokens"] >= 20


def _alter_tokens(system):
    """A token altered where it is produced: every decode chunk hands back
    each row's first token moved half the vocabulary on, so every request
    that decodes serves an altered token."""
    rt, vocab = system.rt, system.cfg.vocab_size
    inner = rt.decode

    def decode():
        res = inner()
        if res is not None:
            for toks in res.emitted.values():
                if toks:
                    toks[0] = (toks[0] + vocab // 2) % vocab
        return res
    rt.decode = decode


def test_an_altered_token_is_not_correct(tmp_path):
    cell = _cell(tmp_path)
    res = run_cell(cell, SEED, 2.0, False, "cpu", time.perf_counter(),
                   fault=_alter_tokens)
    assert not res["correct"], res["compared"]


def test_the_control_reads_above_the_program(tmp_path):
    cell = _cell(tmp_path)
    res = run_cell(cell, SEED, 2.0, False, "cpu", time.perf_counter(),
                   control=True)
    assert res["control"]["max_logit_gap"] > res["readings"][
        "max_logit_gap"]
    assert res["control"]["mean_logit_gap"] > res["readings"][
        "mean_logit_gap"]


def test_fp8_rounding():
    x = torch.randn(64, 48, generator=torch.Generator().manual_seed(0))
    y = fp8(x, -1)
    rel = ((y - x).abs() / x.abs().amax(dim=-1, keepdim=True)).max()
    assert 0 < float(rel) <= 2 ** -4
    assert torch.equal(fp8(y, -1), y)


@pytest.mark.card
@pytest.mark.parametrize("workload", ["phi3m.chat-16fn",
                                      "mixtral8x22b-d8.batch-8fn"])
def test_the_control_fails_the_limit_at_the_cells_size(card, workload):
    """On the card, at the cell's own size and load: the program passes
    its limits and the float8 control fails one of them."""
    cell = spec.load_cell(workload)
    res = run_cell(cell, 2 ** 31 + 101, 8.0, False, "cuda",
                   time.perf_counter(), control=True)
    assert res["correct"], res["compared"]
    assert any(res["control"][name] > c["limit"]
               for name, c in res["compared"].items()), res["control"]
    assert np.isfinite(list(res["readings"].values())).all()
