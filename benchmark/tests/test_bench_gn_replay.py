"""The reader of the solver's stage "gn graph replay": its seconds over the
window per pair written, nothing where the program has no such stage (a
tree that issues every GN step eagerly), and with the eager GN stages it
fits inside the chunk dispatch that holds them."""

import pytest

from benchmark import harness
from benchmark.harness import Context

NAME = "gn_replay_s_per_pair"
STAGE = "gn graph replay"
# seconds of a window of 12 pairs whose GN steps are mostly replayed
WINDOW = {"chunk dispatch": 9.0, "gn linearise": 0.06, "pcg launch": 0.012,
          "gn graph capture": 0.02, "gn graph replay": 0.36}


def _ctx(stages, pairs=12):
    return Context(pairs=pairs, stages=stages)


@pytest.mark.parametrize("case", ["with", "without", "no_pairs"])
def test_reader_with_and_without_its_stage(case):
    read = harness.metric_reader(NAME)
    if case == "with":
        assert read(_ctx(WINDOW)) == pytest.approx(WINDOW[STAGE] / 12)
    elif case == "without":
        others = {k: v for k, v in WINDOW.items() if k != STAGE}
        assert read(_ctx(others)) is None
    else:
        assert read(_ctx(WINDOW, pairs=0)) is None


def test_the_replay_fits_the_dispatch():
    def r(name):
        return harness.metric_reader(name)(_ctx(WINDOW))

    assert (r("linearise_issue_s_per_pair") + r("pcg_issue_s_per_pair")
            + r(NAME) <= r("dispatch_s_per_pair"))
