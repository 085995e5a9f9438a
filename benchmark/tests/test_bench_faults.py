"""A run with the timed path broken underneath comes out not correct:
the harness's look for a chip skipped, everything else as a run drives
it, at the CPU cut. Faults a generator can have: a solve step that
returns its state unchanged, half of a chunk's pairs left without
products, and an answer altered where it is produced."""

import pytest
import torch

from benchmark.tests import cut


def _unchanged_state(monkeypatch):
    from arap_flow_tpu_torch.ops import solver

    monkeypatch.setattr(solver, "gn_step", lambda x, *a, **k: (
        x, torch.zeros(x.shape[:-3], dtype=x.dtype)))


def _half_left_out(monkeypatch):
    from arap_flow_tpu_torch.pipeline import deform_tool, para_gen

    for mod, name in ((para_gen, "finish_pair"),
                      (deform_tool, "_write_result")):
        real, calls = getattr(mod, name), []

        def skip(*a, _real=real, _calls=calls, **k):
            _calls.append(1)
            if len(_calls) % 2 == 0:  # every second answer never written
                return [a[0].p.rgb1_gen, a[0].p.rgb2_gen, a[0].p.flow_gen] \
                    if hasattr(a[0], "p") else None
            return _real(*a, **k)

        monkeypatch.setattr(mod, name, skip)


def _altered(monkeypatch):
    from arap_flow_tpu_torch.models import arap
    from arap_flow_tpu_torch.ops import solver

    quant = arap._quantize_flow
    monkeypatch.setattr(arap, "_quantize_flow",
                        lambda f: quant(f + 0.5))  # crop path (para_gen)
    flow = solver.flow_from_state
    monkeypatch.setattr(solver, "flow_from_state",
                        lambda x, ops: flow(x, ops) + 0.5)  # run_arap


FAULTS = {"unchanged_state": _unchanged_state,
          "half_left_out": _half_left_out, "altered": _altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", sorted(cut.CELLS))
def test_fault_is_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    code, res = cut.run(cell)
    assert code == 0
    assert res["correct"] is False, res["compared"]
