"""The port's endurance tool (arap_flow_tpu_torch/tools/endurance.py) and
the para_gen knobs it reads, against the JAX package and scripts/.

- The tool's dataset against scripts/endurance.py's ``make_dataset``
  (loaded by path, with scripts/ on sys.path; it writes with PIL): masks
  equal, the decoded frames within PSNR >= 30 dB of each other (two JPEG
  encoders at quality 95).
- The tool end to end on the CPU at a cut (3 pairs, ``--block 3``, 2x2x40,
  a 1-pair warm cycle, the matcher at ``--match_downscale 2``: the CPU
  matcher at full size costs seconds a pair), with its gates run.
- ``CHUNK_STATS``: the same chunk sizes as the JAX package's batched loop
  over the same pairs (both loops' stages replaced by stand-ins;
  tests/test_torch_para_gen.py holds the record of a real run to JAX's).
- ``ARAP_MATCH_SUBBATCH`` read at import as JAX's (a subprocess of each
  package), and ``ARAP_WARMUP_FULL`` handing ``prewarm`` the whole bucket
  ladder as JAX's does (``prewarm`` replaced by a stand-in in both).
"""

import importlib.util
import json
import os
import os.path as osp
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from arap_flow_tpu.models.arap import CROP_BUCKETS as JAX_BUCKETS
from arap_flow_tpu.pipeline import para_gen as JP
from arap_flow_tpu_torch.io.image import load_mask, load_rgb
from arap_flow_tpu_torch.pipeline import para_gen as TP
from arap_flow_tpu_torch.tools import endurance as TE
from test_torch_para_gen import _make_tree

torch.set_num_threads(2)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


@pytest.fixture
def jax_endurance(monkeypatch):
    """scripts/endurance.py, loaded by its path."""
    monkeypatch.syspath_prepend(osp.join(REPO, "scripts"))
    spec = importlib.util.spec_from_file_location(
        "jax_endurance", osp.join(REPO, "scripts", "endurance.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a.astype(np.float64) - b) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def test_dataset_matches_scripts_endurance(jax_endurance, tmp_path,
                                           monkeypatch):
    """One frame a size block, so four frames take four sizes."""
    monkeypatch.setattr(jax_endurance, "BLOCK", 1)
    assert (TE.SIZES, (TE.H, TE.W)) == (jax_endurance.SIZES,
                                        (jax_endurance.H, jax_endurance.W))
    for t in range(40):
        assert TE._sizes(t, 1) == jax_endurance._sizes(t)
        assert TE._centers(t) == jax_endurance._centers(t)
        assert TE._nr_amp(*TE._sizes(t, 1)[1]) == jax_endurance._nr_amp(
            *jax_endurance._sizes(t)[1])
    n = 4
    jax_endurance.make_dataset(str(tmp_path / "j"), n)
    TE.make_dataset(str(tmp_path / "t"), n, block=1)
    for t in range(n):
        name = f"{t:05d}"
        jm = np.array(Image.open(tmp_path / "j" / "orgMasks" / "seq0"
                                 / f"{name}.png"))
        tm = load_mask(tmp_path / "t" / "orgMasks" / "seq0" / f"{name}.png")
        np.testing.assert_array_equal(tm, jm)
        assert set(np.unique(tm)) == {0, 1, 2}
        jf = np.array(Image.open(tmp_path / "j" / "orgRGB" / "seq0"
                                 / f"{name}.jpg"))
        tf = load_rgb(tmp_path / "t" / "orgRGB" / "seq0" / f"{name}.jpg")
        assert psnr(tf, jf) >= 30.0, (t, psnr(tf, jf))


def test_tool_end_to_end_on_cpu(tmp_path, capsys):
    out = tmp_path / "result.json"
    rc = TE.main(["--device", "cpu", "--pairs", "3", "--block", "3",
                  "--schedule", "2x2x40", "--warm", "1",
                  "--match_downscale", "2", "--out", str(out)])
    text = capsys.readouterr().out
    # every cut is printed
    for flag in ("--pairs 3", "--block 3", "--schedule 2x2x40", "--warm 1",
                 "--match_downscale 2"):
        assert f"endurance cut: {flag}" in text
    result = json.loads(out.read_text())
    assert rc == 0 and result["failures"] == [], result["failures"]
    assert result["dropped_pairs"] == [] and result["accuracy_checked"] == 1
    assert result["chunk_count"] == len(TP.CHUNK_STATS) >= 1
    assert sum(p for p, _, _ in TP.CHUNK_STATS) == 3
    assert result["rss"]["ok"] and result["rss"]["samples"] >= 4
    # no card: nothing planned or launched, no memory_reserved
    assert result["memory_reserved"] is None
    assert result["pcg_launch_shapes"] == {}
    assert result["builds_during_run"] == []
    assert json.loads(text.strip().splitlines()[-2]) == result


def test_failures_name_each_gate():
    ok = {"n_pairs": 100, "dropped_pairs": [3, 4], "accuracy_checked": 2,
          "accuracy_failures": [], "builds_during_run": [],
          "new_hw_after_warm": [], "rss": {"ok": True},
          "memory_reserved": None}
    assert TE.failures(ok) == []
    assert len(TE.failures(ok, max_dropped=1)) == 1
    bad = dict(ok, dropped_pairs=[1, 2, 3], accuracy_checked=0,
               builds_during_run=["libpcg-0.so"],
               new_hw_after_warm=["64x128"], rss={"ok": False},
               memory_reserved={"ok": False})
    assert len(TE.failures(bad)) == 6


@pytest.mark.parametrize("samples,ok", [
    ([(t, 100.0) for t in range(8)], True),
    ([(t, 100.0 + 10 * (t >= 6)) for t in range(8)], False),
    ([(t, 100.0 + 0.1 * t) for t in range(60)], True),
    ([(t, 100.0 + (t > 45) * 5.0) for t in range(60)], False),
    ([(0, 100.0), (1, 100.0)], False),
])
def test_bounded_is_scripts_endurance_rule(samples, ok):
    """Halves with 3% slack over >= 10 samples after settling (t > 30 s),
    else quarters with 5%; too few samples fail."""
    assert TE.bounded(samples, 30.0)["ok"] is ok


def _empty_tree(root, n_frames):
    """Empty frame and mask files: enough for scan_pairs, with every
    decode, match and solve replaced by stand-ins."""
    for d in ("orgRGB", "orgMasks"):
        os.makedirs(osp.join(root, d, "seq0"))
        for t in range(n_frames):
            open(osp.join(root, d, "seq0", f"{t:05d}.png"), "w").close()


@pytest.mark.parametrize("n_pairs,narap", [(3, 1), (9, 4), (21, 4), (4, 2)])
def test_chunk_stats_match_jax(tmp_path, monkeypatch, n_pairs, narap):
    """Both batched loops over the same pairs, their chunk stages replaced
    by stand-ins that do nothing (JAX's loop is its own code, no compile):
    one CHUNK_STATS entry a collected chunk, the same sizes in the same
    order (the half-size first chunk included), end times in order."""
    inp = str(tmp_path / "in")
    _empty_tree(inp, n_pairs + 1)

    def nothing(*a, **k):
        return []

    stats = {}
    for name, mod, extra in (("jax", JP, {}),
                             ("torch", TP, {"device": "cpu"})):
        for fn in ("prep_chunk_dispatch_match", "prep_chunk_finish",
                   "dispatch_chunk_batched", "collect_chunk_batched"):
            monkeypatch.setattr(mod, fn, nothing)
        mod.main_pipeline(mod.PipelineFlags(
            input=inp, output=str(tmp_path / name), mode="batched",
            narap=narap, **extra))
        stats[name] = list(mod.CHUNK_STATS)
    sizes = [p for p, _, _ in stats["torch"]]
    assert sizes == [p for p, _, _ in stats["jax"]]
    assert sizes == [len(c) for c in TP.plan_chunks(list(range(n_pairs)),
                                                    2 * narap)]
    ends = [t for _, _, t in stats["torch"]]
    assert ends == sorted(ends) and all(w >= 0 for _, w, _ in stats["torch"])


def test_match_subbatch_default_as_jax():
    assert "ARAP_MATCH_SUBBATCH" not in os.environ
    assert TP.MATCH_SUBBATCH == JP.MATCH_SUBBATCH == 4


def test_match_subbatch_env_as_jax():
    """ARAP_MATCH_SUBBATCH, read when para_gen is imported, in one process
    importing both packages with it set; the port's first chunk is a whole
    number of its sub-batches, as JAX's loop computes it
    (para_gen.py:891-892)."""
    value = "2"
    env = {k: v for k, v in os.environ.items() if k != "ARAP_MATCH_SUBBATCH"}
    env["JAX_PLATFORMS"] = "cpu"
    env["ARAP_MATCH_SUBBATCH"] = value
    code = ("import json\n"
            "from arap_flow_tpu.pipeline import para_gen as J\n"
            "from arap_flow_tpu_torch.pipeline import para_gen as T\n"
            "chunk = 6\n"
            "first = max(J.MATCH_SUBBATCH, (chunk // 2) // J.MATCH_SUBBATCH"
            " * J.MATCH_SUBBATCH)\n"
            "print(json.dumps([J.MATCH_SUBBATCH, T.MATCH_SUBBATCH, first, "
            "[len(c) for c in T.plan_chunks(list(range(20)), chunk)]]))\n")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    j, t, first, chunks = json.loads(proc.stdout.strip().splitlines()[-1])
    assert j == t == int(value)
    assert chunks[0] == first == 2 and sum(chunks) == 20


class _Stop(Exception):
    pass


@pytest.mark.parametrize("value,full", [(None, False), ("1", True),
                                        ("0", False), ("off", False)])
def test_warmup_full_env_as_jax(tmp_path, monkeypatch, value, full):
    """--warmup hands prewarm the 31 crop buckets under ARAP_WARMUP_FULL
    (not "", "0" or "off"), else None (the common buckets), in both
    packages; the stand-in stops the run there."""
    if value is None:
        monkeypatch.delenv("ARAP_WARMUP_FULL", raising=False)
    else:
        monkeypatch.setenv("ARAP_WARMUP_FULL", value)
    inp = str(tmp_path / "in")
    _make_tree(inp, n_frames=2)
    seen = {}
    for name, mod, extra in (("jax", JP, {}), ("torch", TP,
                                               {"device": "cpu"})):
        def stand_in(cfg, weights, buckets=None, **kw):
            seen[name] = buckets
            raise _Stop

        monkeypatch.setattr(mod, "prewarm", stand_in)
        flags = mod.PipelineFlags(input=inp, output=str(tmp_path / name),
                                  mode="batched", warmup=True, **extra)
        with pytest.raises(_Stop):
            mod.main_pipeline(flags)
    def norm(buckets):
        return None if buckets is None else [tuple(b) for b in buckets]

    want = norm(JAX_BUCKETS) if full else None
    assert norm(seen["torch"]) == norm(seen["jax"]) == want
    assert want is None or len(want) == 31
