"""The readers of the program's span stages: each reads its stage's seconds
over the window per pair written, and nothing where the program has no such
stage (a tree older than the stage)."""

import pytest

from benchmark import harness
from benchmark.harness import Context

STAGES = {
    "match_wait_s_per_pair": "matching wait",
    "match_select_s_per_pair": "matching select",
    "linearise_issue_s_per_pair": "gn linearise",
    "pcg_issue_s_per_pair": "pcg launch",
    "run_arap_prep_s_per_pair": "run_arap prep",
    "run_arap_write_s_per_pair": "run_arap write",
}
# seconds of a window of 12 pairs that has every stage
WINDOW = {"matching": 1.8, "matching wait": 0.6, "matching select": 1.14,
          "chunk dispatch": 9.0, "gn linearise": 6.0, "pcg launch": 1.2,
          "run_arap prep": 0.48, "run_arap solve": 30.0,
          "run_arap write": 0.24}


def _ctx(stages, pairs=12):
    return Context(pairs=pairs, stages=stages)


@pytest.mark.parametrize("name", sorted(STAGES))
def test_reader_with_and_without_its_stage(name):
    read = harness.metric_reader(name)
    stage = STAGES[name]
    assert read(_ctx(WINDOW)) == pytest.approx(WINDOW[stage] / 12)
    others = {k: v for k, v in WINDOW.items() if k != stage}
    assert read(_ctx(others)) is None
    assert read(_ctx(WINDOW, pairs=0)) is None


def test_the_splits_fit_their_lumps():
    def r(name):
        return harness.metric_reader(name)(_ctx(WINDOW))

    assert (r("match_wait_s_per_pair") + r("match_select_s_per_pair")
            <= r("match_s_per_pair") * 1.02)
    assert (r("linearise_issue_s_per_pair") + r("pcg_issue_s_per_pair")
            <= r("dispatch_s_per_pair"))
