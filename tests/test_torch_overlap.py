"""para_gen's host overlap changes no product.

The depth-2 batched loop (prep on a worker thread, chunk k+1's matcher
ahead of chunk k's solves, chunk k−1 written while chunk k solves), the
simple mode's one-ahead prep and the native asynchronous writer against
serial references (below: every chunk or pair prepped, solved and written
before the next starts, in uniform chunks) with synchronous writes, on the
CPU with the same seed:

- at the same chunks, every product file and the list file are
  byte-identical, in both modes;
- with the half-size first chunk (which changes which problems share a
  batch), the flows agree within 1e-3 px, and the list file, the masks and
  the background draws (inpRGB) are the same.

The tree: 96×160 JPEG frames (the port's encoder) with two moving boxes
and a pool of JPEG backgrounds, at a 2×2×40 schedule. Each pipeline run is
made once per module and shared by the tests that read it.
"""

import os
import os.path as osp

import numpy as np
import pytest
import torch

from arap_flow_tpu_torch.io import flo as TF
from arap_flow_tpu_torch.io.image import save_image
from arap_flow_tpu_torch.ops.solver import SolverConfig
from arap_flow_tpu_torch.pipeline import para_gen as TP
from arap_flow_tpu_torch.utils import transfer
from arap_flow_tpu_torch.utils.profiling import StageTimer

torch.set_num_threads(2)

H, W = 96, 160
SHORT = SolverConfig(num_anneal=2, gn_iters=2, max_pcg_iters=40,
                     pcg_iters=40.0)


def _tree(root, n_frames):
    rng = np.random.default_rng(1)
    tex = np.kron(rng.uniform(60, 255, (H // 8 + 2, W // 8 + 2, 3)),
                  np.ones((8, 8, 1)))[:H, :W].astype(np.uint8)
    bg = (tex[::-1, ::-1] // 3).copy()
    for d in ("orgRGB/seq0", "orgMasks/seq0", "bg"):
        os.makedirs(osp.join(root, d))
    for i in range(3):
        save_image(osp.join(root, "bg", f"b{i}.jpg"),
                   rng.integers(0, 255, (50 + 10 * i, 90, 3)).astype(np.uint8))
    yy, xx = np.mgrid[0:H, 0:W]
    for t in range(n_frames):
        img = bg.copy()
        mask = np.zeros((H, W), np.uint8)
        for k, (y0, x0, dy, dx) in enumerate(((16, 20, 2, 3),
                                              (50, 100, 1, -2))):
            y, x = y0 + dy * t, x0 + dx * t
            ob = (yy >= y) & (yy < y + 30) & (xx >= x) & (xx < x + 36)
            img[ob] = tex[yy[ob] - dy * t, xx[ob] - dx * t]
            mask[ob] = k + 1
        save_image(osp.join(root, "orgRGB", "seq0", f"{t:05d}.jpg"), img,
                   quality=98)
        save_image(osp.join(root, "orgMasks", "seq0", f"{t:05d}.png"), mask)


def serial_batched(flags, chunks, n_pairs, deformer, bgpool, device,
                   writer, mesh=None):
    """The batched loop without overlap, in uniform chunks of 2·narap
    pairs: each chunk matched, prepped, solved, collected and written
    before the next starts."""
    cfg, weights = deformer.cfg, deformer.weights
    pairs = [p for ch in chunks for p in ch]
    size = max(flags.narap, 1) * 2
    triples = []
    for i in range(0, len(pairs), size):
        ch = pairs[i : i + size]
        handles = TP.prep_chunk_dispatch_match(flags, ch)
        prepped = TP.prep_chunk_finish(flags, ch, handles, weights, bgpool)
        inflight = TP.dispatch_chunk_batched(prepped, cfg, weights, device,
                                             mesh)
        triples += TP.collect_chunk_batched(inflight, cfg, weights, device,
                                            writer)
    return triples


def serial_simple(flags, pairs, deformer, bgpool, writer):
    """Simple mode with each pair's prep inline, before its solve."""
    triples = []
    for p in pairs:
        try:
            work = TP.prep_pair(flags, p, bgpool)
            triples.append(" ".join(TP.solve_pair(work, deformer, writer)))
        except (RuntimeError, *TP._DECODE_ERRORS):
            continue
    return triples


def _files(out):
    found = {}
    for root, _, files in os.walk(out):
        for f in files:
            path = osp.join(root, f)
            found[osp.relpath(path, out)] = path
    return found


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """run(mode, serial, subbatch) -> (list lines relative to the output,
    {relative path: file}, the run's stage counts), made once a module.
    The pipeline runs with `--narap 1` (chunks of 2 pairs); the serial
    references write synchronously, the pipeline through the native
    writer."""
    base = tmp_path_factory.mktemp("ov")
    inp = str(base / "in")
    _tree(inp, n_frames=4)
    done = {}

    def get(mode, serial, subbatch=TP.MATCH_SUBBATCH):
        key = (mode, serial, subbatch)
        if key not in done:
            out = str(base / "_".join(map(str, key)))
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("ARAP_ASYNC_IO", "0" if serial else "1")
                mp.setattr(TP, "MATCH_SUBBATCH", subbatch)
                mp.setattr(TP, "TIMER", StageTimer())
                if serial:
                    mp.setattr(TP, "_run_batched", serial_batched)
                    mp.setattr(TP, "_run_simple", serial_simple)
                # the matcher on a 4×-pooled image: its CPU search at full
                # size would take most of the test's time
                flags = TP.PipelineFlags(
                    input=inp, output=out, multseg=True, seed=0, mode=mode,
                    narap=1, device="cpu", bg_dir=osp.join(inp, "bg"),
                    match_downscale=4)
                lines = TP.main_pipeline(flags, solver_cfg=SHORT)
                counts = dict(TP.TIMER.counts)
            rel = [" ".join(osp.relpath(p, out) for p in line.split(" "))
                   for line in lines]
            done[key] = (rel, _files(out), counts)
        return done[key]

    return get


@pytest.mark.parametrize("mode", ["batched", "simple"])
def test_overlap_and_writer_change_no_byte(run, mode):
    """With matcher sub-batches of 4 there is no ramp-up (its first chunk
    would be a whole sub-batch, larger than a chunk of 2), so both loops
    see the same chunks [2, 1]."""
    assert TP.plan_chunks(list(range(3)), 2) == [[0, 1], [2]]
    on, fa, counts = run(mode, serial=False)
    if mode == "batched":  # the overlapped loop's stages, chunk by chunk
        assert {"chunk phaseA", "chunk prep-wait", "chunk dispatch",
                "chunk collect+finish", "D2H fetch",
                "host paste"} <= set(counts)
        assert counts["chunk prep-wait"] == 2
        assert counts["chunk collect+finish"] == 3
    off, fb, _ = run(mode, serial=True)
    assert on == off and len(on) == 3
    assert sorted(fa) == sorted(fb) and len(fa) >= 6 * 3 + 1
    for rel in fa:
        if rel == "all_files.list":  # absolute paths: compared above
            continue
        with open(fa[rel], "rb") as a, open(fb[rel], "rb") as b:
            assert a.read() == b.read(), rel


def test_ramp_up_chunk_within_1e3(run):
    """With one-pair matcher sub-batches the ramp-up's first chunk is one
    pair: chunks [1, 2] against the serial reference's [2, 1]."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TP, "MATCH_SUBBATCH", 1)
        assert TP.plan_chunks(list(range(3)), 2) == [[0], [1, 2]]
    on, fa, counts = run("batched", serial=False, subbatch=1)
    assert counts["chunk prep-wait"] == 2
    off, fb, _ = run("batched", serial=True, subbatch=1)
    assert on == off and len(on) == 3
    assert sorted(fa) == sorted(fb)
    for rel in fa:
        if rel.startswith("Flow"):
            ua, va = TF.flow_read(fa[rel])
            ub, vb = TF.flow_read(fb[rel])
            assert max(np.abs(ua - ub).max(), np.abs(va - vb).max()) < 1e-3
        elif rel.split(osp.sep)[0] in ("inpRGB", "inpMasks", "wMasks",
                                       "tmpCnstr"):
            with open(fa[rel], "rb") as a, open(fb[rel], "rb") as b:
                assert a.read() == b.read(), rel


def test_cpu_fetch_is_plain():
    t = torch.arange(6, dtype=torch.int16).reshape(2, 3)
    assert transfer.mark("cpu") is None
    (got,) = transfer.fetch([t], None)
    np.testing.assert_array_equal(got, t.numpy())
    assert transfer.fetch([], None) == []


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_fetch_waits_for_its_producer_only(cuda_device):
    """A fetch after a mark returns, with the marked values, while work
    enqueued after the mark (a spin of a few hundred ms) still runs."""
    import time

    x = torch.arange(1 << 20, device=cuda_device, dtype=torch.float32)
    y = x * 2
    # first use: the thread's side stream and a pinned block
    transfer.fetch([y], transfer.mark(cuda_device))
    ready = transfer.mark(cuda_device)
    torch.cuda._sleep(500_000_000)
    t0 = time.perf_counter()
    (got,) = transfer.fetch([y], ready)
    waited = time.perf_counter() - t0
    spin_running = not torch.cuda.current_stream(cuda_device).query()
    torch.cuda.synchronize()
    spun = time.perf_counter() - t0
    print(f"fetch returned after {waited:.4f} s; the spin ended after "
          f"{spun:.4f} s")
    np.testing.assert_array_equal(got, (x * 2).cpu().numpy())
    assert spin_running and waited < spun
    with pytest.raises(ValueError):
        transfer.fetch([y], None)
