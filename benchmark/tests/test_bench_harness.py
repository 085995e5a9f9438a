"""The harness's own bookkeeping: each job's sample drawn from the seed,
and what a run reports beside the metrics."""

import numpy as np

from benchmark.entries import common
from benchmark.tests import cut


def test_draw_sample_is_the_seeds():
    a = np.random.default_rng([123456789012, 2])
    b = np.random.default_rng([123456789012, 2])
    draws = [common.draw_sample(a, 24, 2) for _ in range(5)]
    assert draws == [common.draw_sample(b, 24, 2) for _ in range(5)]
    assert all(len(d) == 2 and d == sorted(set(d)) for d in draws)
    assert len({tuple(d) for d in draws}) > 1  # each job its own sample
    assert common.draw_sample(a, 3, 5) == [0, 1, 2]


def test_run_reports_missing_pairs_errors_and_builds():
    code, res = cut.run("sintel1024.passes")
    assert code == 0 and res["correct"] is True, res["compared"]
    assert list(res)[-1] == "compared"
    assert res["compared"]["pairs_missing"] == {"value": 0.0, "limit": 0.0}
    assert res["compared"]["entry_errors"] == {"value": 0.0, "limit": 0.0}
    assert isinstance(res["builds"], int)


def test_an_entry_that_fails_is_not_correct(monkeypatch):
    from arap_flow_tpu_torch.pipeline import run_arap

    real = run_arap.main
    monkeypatch.setattr(run_arap, "main", lambda argv: real(argv) or 1)
    code, res = cut.run("sintel1024.passes")
    assert code == 0
    assert res["compared"]["entry_errors"]["value"] >= 1
    assert res["correct"] is False


def test_probe_reads_the_program_and_the_control():
    from benchmark import probe

    (r,) = probe.readings("sintel1024.passes", [7], control=True,
                          device="cpu", cfg_override=cut.CUT,
                          wl_override=cut.SINTEL)
    assert r["written"] == r["attempted"]
    assert set(r["control"]) == set(r["program"])
    assert all(r["program"][k] <= v for k, v in cut.CUT["limits"].items())
