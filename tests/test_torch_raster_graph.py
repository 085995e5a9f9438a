"""The replayed rasterizer (``ops/rasterize.py``: ``rasterize_replayed``)
and the uploads that do not wait for the device (``utils/transfer.upload``).

On CUDA tensors a layout's first rasterization runs eagerly, its second is
captured as a CUDA graph and replayed, and every later one is replayed. The
CPU tests hold the CPU route to the plain ``rasterize`` and the upload to a
plain copy; the card tests hold every replay bitwise to ``rasterize`` on the
same inputs.
"""

import numpy as np
import pytest
import torch

from arap_flow_tpu_torch.ops import graphs as G
from arap_flow_tpu_torch.ops import rasterize as R
from arap_flow_tpu_torch.utils import profiling, transfer

STAGES = ("raster graph capture", "raster graph replay")


def _inputs(H, W, seed, device):
    """A warped grid moved by up to 2 px, colours, and a mask with a
    seeded inset object."""
    g = torch.Generator().manual_seed(seed)
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                            torch.arange(W, dtype=torch.float32),
                            indexing="ij")
    warp = torch.stack([xs, ys]) + 2.0 * torch.rand((2, H, W), generator=g)
    rgb = torch.floor(255.0 * torch.rand((3, H, W), generator=g))
    mask = torch.ones((H, W))
    top, left = (int(v) for v in torch.randint(1, 5, (2,), generator=g))
    mask[top:H - top, left:W - left] = 0.0
    return tuple(t.to(device) for t in (warp, rgb, mask))


def _counts():
    return {k: profiling.TIMER.counts[k] for k in STAGES}


@pytest.mark.parametrize("seed", [0, 1])
def test_cpu_route_is_the_plain_rasterizer(seed):
    G.registry("raster").clear()
    c0 = _counts()
    args = _inputs(24, 40, seed, "cpu")
    for _ in range(3):
        wrgb, wmask = R.rasterize_replayed(*args)
        ref = R.rasterize(*args)
        assert torch.equal(wrgb, ref[0]) and torch.equal(wmask, ref[1])
    assert G.registry("raster") == {}
    assert _counts() == c0


def test_layout_tells_apart_what_changes_the_launches():
    t = torch.zeros((2, 8, 16))
    assert G.layout(t) == G.layout(torch.ones((2, 8, 16)))
    for other in (torch.zeros((2, 8, 17)), t.double(),
                  t.transpose(-1, -2).contiguous().transpose(-1, -2)):
        assert G.layout(other) != G.layout(t)


def test_registries_are_per_kind_and_per_thread():
    import threading

    G.registry("raster")["k"] = G.SEEN
    assert "k" not in G.registry("gn step")
    seen = []
    t = threading.Thread(target=lambda: seen.append(dict(G.registry("raster"))))
    t.start()
    t.join()
    assert seen == [{}]
    G.registry("raster").clear()


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.float32, np.bool_])
def test_upload_on_the_cpu_is_a_copy(dtype):
    a = (np.arange(24).reshape(2, 3, 4) % 3).astype(dtype)
    t = transfer.upload(a, "cpu")
    assert t.device.type == "cpu" and t.dtype == torch.from_numpy(a).dtype
    assert np.array_equal(t.numpy(), a)
    a[0, 0, 0] = 1 - a[0, 0, 0]
    assert not np.array_equal(t.numpy(), a)  # no shared memory


def test_upload_takes_a_read_only_view():
    a = np.arange(12, dtype=np.int16).reshape(3, 4).T
    a.flags.writeable = False
    assert np.array_equal(transfer.upload(a, "cpu").numpy(), a)


# ---- on the card ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    G.registry("raster").clear()
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("H,W", [(96, 128), (436, 1024)])
def test_replays_bitwise_the_eager_rasterizer(cuda_device, H, W):
    """One eager call, one capture, then replays: every call on new data
    gives ``rasterize``'s products on that data."""
    c0 = _counts()
    for seed in range(5):
        args = _inputs(H, W, seed, cuda_device)
        wrgb, wmask = R.rasterize_replayed(*args)
        ref = R.rasterize(*args)
        assert torch.equal(wrgb, ref[0]) and torch.equal(wmask, ref[1])
    d = {k: _counts()[k] - c0[k] for k in STAGES}
    assert d == {"raster graph capture": 1, "raster graph replay": 4}


@pytest.mark.cuda
def test_outputs_read_before_the_next_replay_keep(cuda_device):
    """The canvas loop's use: each replay's outputs cast to new tensors
    right after it, several calls of two layouts enqueued before any is
    read."""
    shapes = [(64, 96), (80, 96)]
    for s in shapes:  # meet and capture both layouts
        for seed in range(2):
            R.rasterize_replayed(*_inputs(*s, seed, cuda_device))
    got, refs = [], []
    for seed in range(6):
        args = _inputs(*shapes[seed % 2], 10 + seed, cuda_device)
        wrgb, wmask = R.rasterize_replayed(*args)
        got.append((wrgb.to(torch.uint8), wmask.to(torch.uint8)))
        refs.append(args)
    for (wrgb, wmask), args in zip(got, refs):
        ref = R.rasterize(*args)
        assert torch.equal(wrgb, ref[0].to(torch.uint8))
        assert torch.equal(wmask, ref[1].to(torch.uint8))


@pytest.mark.cuda
def test_upload_on_the_card(cuda_device):
    for dtype in (np.uint8, np.int16, np.float32, np.bool_):
        a = (np.arange(4096).reshape(64, 64) % 3).astype(dtype)
        t = transfer.upload(a, cuda_device)
        assert t.device == cuda_device
        assert np.array_equal(t.cpu().numpy(), a)
