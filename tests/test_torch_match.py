"""The port's matcher against the JAX package's: the ZNCC search (plain
version and wrapper) against ``_search(_zscore(·))`` and the Pallas kernel
in interpret mode, the pyramid flow, the device grid selection, the host
selection and the full ``match_images``, on numpy-seeded inputs: shifts,
and the warps of tests/test_matching.py (rotation, scale, non-rigid, 25°
through the hypotheses, the 60% stretch and its identity-only control)
with that file's recovery gates.

Tolerances: scores within 2e-4 and the same argmax on > 97% of pixels
(tests/test_pallas_match.py: the box sums are taken in another order, so
near-exact ties between offsets may flip). Whole matches: the kept grid
points may differ on at most 3% of their union, and ≥ 97% of the shared
points have identical integer targets. The host selection copies are held
bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.signal import convolve2d

from arap_flow_tpu.ops import matching as JM
from arap_flow_tpu.ops.pallas_match import zncc_search as jax_zncc
from arap_flow_tpu_torch.ops import matching as TM
from arap_flow_tpu_torch.ops import zncc as TZ

torch.set_num_threads(2)


def _mk(shape, seed):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=shape).astype(np.float32)
    k = np.ones((3, 3), np.float32) / 9.0
    return convolve2d(base, k, mode="same").astype(np.float32)


def _mk_pair(H, W, dy, dx, seed):
    """tests/test_pallas_match.py's fixture."""
    a = _mk((H + 40, W + 40), seed)
    p1 = a[20 : 20 + H, 20 : 20 + W]
    p2 = a[20 + dy : 20 + dy + H, 20 + dx : 20 + dx + W]
    return np.ascontiguousarray(p1), np.ascontiguousarray(p2)


def _texture(H, W, seed=0):
    """tests/test_matching.py's texture."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((H // 4 + 2, W // 4 + 2))
    up = np.kron(base, np.ones((4, 4)))[:H, :W]
    g = up + rng.standard_normal((H, W)) * 0.3
    g = (g - g.min()) / (np.ptp(g) + 1e-9) * 255
    return np.repeat(g[:, :, None], 3, axis=2).astype(np.uint8)


def _shifted(im, dx, dy):
    return np.roll(np.roll(im, dy, axis=0), dx, axis=1)


@pytest.mark.parametrize("radius", [2, 5])
def test_plain_matches_jax_search(radius):
    p1, p2 = _mk_pair(48, 64, 3, -2, 0)
    ru, rv, rs = (np.asarray(a) for a in JM._search(
        JM._zscore(jnp.asarray(p1), 12), JM._zscore(jnp.asarray(p2), 12),
        radius, 12))
    ku, kv, ks = (np.asarray(a) for a in jax_zncc(
        jnp.asarray(p1), jnp.asarray(p2), radius, patch=12, interpret=True))
    du, dv, sc = (t.numpy() for t in TZ.zncc_search_plain(
        torch.tensor(p1), torch.tensor(p2), radius))
    for u, v, s in ((ru, rv, rs), (ku, kv, ks)):
        assert np.abs(sc - s).max() < 2e-4
        assert ((du == u) & (dv == v)).mean() > 0.97


def test_plain_batch_shares_the_reference():
    """p1 (N1) against p2 (N1·G): plane b searches against p1[b // G]."""
    pairs = [_mk_pair(32, 40, 1, 2, s) for s in (1, 2)]
    p1 = torch.tensor(np.stack([p[0] for p in pairs]))
    p2 = torch.tensor(np.stack([pairs[0][1], pairs[0][0], pairs[1][1],
                                pairs[1][0]]))
    du, dv, sc = TZ.zncc_search_plain(p1, p2, 3)
    for b in range(4):
        one = TZ.zncc_search_plain(p1[b // 2], p2[b], 3)
        for got, ref in zip((du[b], dv[b], sc[b]), one):
            torch.testing.assert_close(got, ref, rtol=0, atol=0)
    # a plane against itself: every pixel scores ~1 at offset 0
    assert torch.all(du[1] == 0) and torch.all(dv[1] == 0)


def test_plain_zscore_is_precise_on_raw_planes():
    """The float64 z-score of a raw 0..255 plane equals a direct per-pixel
    computation; the search's argmax is the shift."""
    rng = np.random.default_rng(3)
    g = (np.kron(rng.uniform(0, 255, (10, 12)), np.ones((8, 8)))
         + rng.normal(0, 5, (80, 96))).astype(np.float32)
    z = TZ.zscore(torch.tensor(g), 12).numpy()
    gp = np.pad(g.astype(np.float64), ((6, 5), (6, 5)))
    for y, x in ((0, 0), (40, 50), (79, 95), (7, 90)):
        win = gp[y : y + 12, x : x + 12]
        mu = win.mean()
        var = max((win * win).mean() - mu * mu, 1e-4)
        assert abs(z[y, x] - (g[y, x] - mu) / np.sqrt(var)) < 1e-5
    du, dv, _ = TZ.zncc_search_plain(torch.tensor(g),
                                     torch.tensor(np.roll(g, (2, -3), (0, 1))),
                                     4)
    inner = (slice(12, -12), slice(12, -12))
    assert (du.numpy()[inner] == -3).mean() > 0.95
    assert (dv.numpy()[inner] == 2).mean() > 0.95


def test_wrapper_on_cpu_is_plain_and_not_counted():
    p1, p2 = (torch.tensor(a) for a in _mk_pair(24, 40, 1, 1, 4))
    before = dict(TZ.LAUNCHES)
    for got, ref in zip(TZ.zncc_search(p1, p2, 2),
                        TZ.zncc_search_plain(p1, p2, 2)):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert TZ.LAUNCHES == before


def test_wrapper_refuses_other_devices_and_bad_batches():
    p1, p2 = (torch.tensor(a) for a in _mk_pair(24, 40, 1, 1, 5))
    with pytest.raises(ValueError, match="no kernel"):
        TZ.zncc_search(p1.to("meta"), p2.to("meta"), 2)
    with pytest.raises(ValueError):
        TZ.zncc_search(torch.stack([p1, p1]), torch.stack([p2] * 3), 2)


@pytest.mark.parametrize("rotations", [(0.0,), JM.DEFAULT_ROTATIONS])
def test_pyramid_flow_matches_jax(rotations):
    im1 = _texture(96, 128, 1)
    im2 = _shifted(im1, 5, -3)
    g1, g2 = (im.astype(np.float32)[..., 0] for im in (im1, im2))
    jf, js = (np.asarray(a) for a in JM.pyramid_flow(
        jnp.asarray(g1), jnp.asarray(g2), radius=16, levels=2,
        rotations=rotations))
    tf, ts = TM.pyramid_flow(torch.tensor(g1), torch.tensor(g2), radius=16,
                             levels=2, rotations=rotations)
    same = (tf.numpy() == jf).all(axis=0)
    assert same.mean() > 0.97
    assert np.abs(ts.numpy() - js)[same].max() < 2e-4


def test_match_grid_matches_jax():
    im1 = _texture(96, 112, 2)
    im2 = _shifted(im1, -4, 6)
    r1, r2 = (np.ascontiguousarray(im.transpose(2, 0, 1)) for im in (im1, im2))
    j = [np.asarray(a) for a in JM.match_grid(
        jnp.asarray(r1), jnp.asarray(r2), radius=24, levels=1)]
    t = [a.numpy() for a in TM.match_grid(torch.tensor(r1), torch.tensor(r2),
                                          radius=24, levels=1)]
    same = (t[0] == j[0]) & (t[1] == j[1])
    assert same.mean() > 0.97
    assert np.abs(t[2] - j[2])[same].max() < 2e-4
    assert np.abs(t[3] - j[3])[same].max() < 1e-4


def _compare_matches(j, t):
    """The kept grid points differ on ≤ 3% of their union; ≥ 97% of the
    shared ones have identical integer targets."""
    kj = {tuple(r[:2]): r for r in j}
    kt = {tuple(r[:2]): r for r in t}
    shared = set(kj) & set(kt)
    union = set(kj) | set(kt)
    assert len(shared) >= 0.97 * len(union), (len(shared), len(union))
    same = np.mean([np.array_equal(kj[k][2:4], kt[k][2:4]) for k in shared])
    assert same >= 0.97, same


@pytest.mark.parametrize("case", [
    dict(size=(96, 128), shift=(7, -4), kw=dict(radius=16, levels=2)),
    dict(size=(144, 176), shift=(3, 2), kw=dict()),
    dict(size=(144, 176), shift=(-6, 5), kw=dict(downscale=2)),
    dict(size=(120, 136), shift=(2, 4), kw=dict(radius=20, levels=1),
         roi=True),
])
def test_match_images_matches_jax(case):
    H, W = case["size"]
    im1 = _texture(H, W, H + W)
    im2 = _shifted(im1, *case["shift"])
    kw = dict(case["kw"])
    if case.get("roi"):
        roi = np.zeros((H, W), np.uint8)
        roi[20:90, 30:110] = 1
        kw["roi_mask"] = roi
    j = JM.match_images(im1, im2, **kw)
    t = TM.match_images(im1, im2, device="cpu", **kw)
    assert t.dtype == np.float32 and t.shape[1] == 5 and len(j) > 50
    _compare_matches(j, t)
    if case.get("roi"):
        assert np.all(roi[t[:, 1].astype(int), t[:, 0].astype(int)] != 0)


def _warp_bilinear(im, mapx, mapy):
    """tests/test_matching.py's inverse-map bilinear warp (edge clamp)."""
    H, W = im.shape[:2]
    x0 = np.clip(np.floor(mapx).astype(int), 0, W - 1)
    y0 = np.clip(np.floor(mapy).astype(int), 0, H - 1)
    x1 = np.minimum(x0 + 1, W - 1)
    y1 = np.minimum(y0 + 1, H - 1)
    fx = np.clip(mapx - x0, 0, 1)[..., None]
    fy = np.clip(mapy - y0, 0, 1)[..., None]
    out = (im[y0, x0] * (1 - fx) * (1 - fy) + im[y0, x1] * fx * (1 - fy)
           + im[y1, x0] * (1 - fx) * fy + im[y1, x1] * fx * fy)
    return out.astype(im.dtype)


def _about_centre(H, W, a, b, c, d):
    """Forward and inverse maps of the linear map [[a, b], [c, d]] about the
    frame's centre."""
    cy, cx = H / 2, W / 2
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    X, Y = xx - cx, yy - cy
    det = a * d - b * c
    return ((a * X + b * Y + cx, c * X + d * Y + cy),
            ((d * X - b * Y) / det + cx, (-c * X + a * Y) / det + cy))


def _warp_case(name):
    """(im1, im2, forward map, match_images keywords) of the warps of
    tests/test_matching.py: 5° rotation, 8% scale, the sinusoidal non-rigid
    warp, 25° through the rotation hypotheses and the 60% stretch."""
    if name in ("rotation-5", "rotation-25"):
        H, W, seed = 128, 160, 7 if name == "rotation-5" else 10
        th = np.deg2rad(5.0 if name == "rotation-5" else 25.0)
        fwd, inv = _about_centre(H, W, np.cos(th), -np.sin(th), np.sin(th),
                                 np.cos(th))
        kw = dict(radius=16 if name == "rotation-5" else 40, levels=2)
    elif name == "scale-8":
        H, W, seed = 128, 160, 8
        fwd, inv = _about_centre(H, W, 1.08, 0.0, 0.0, 1.08)
        kw = dict(radius=16, levels=2)
    elif name == "nonrigid":
        H, W, seed = 128, 160, 9
        yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
        ux = 3.0 * np.sin(2 * np.pi * yy / 45.0)
        vy = 2.5 * np.cos(2 * np.pi * xx / 50.0)
        fwd, inv = (xx + ux, yy + vy), (xx - ux, yy - vy)
        kw = dict(radius=16, levels=2)
    else:  # "stretch-60" and its identity-only control
        H, W, seed = 128, 192, 13
        fwd, inv = _about_centre(H, W, 1.6, 0.0, 0.0, 1.6)
        kw = dict(radius=48, levels=2, rotations=(
            JM.STRETCH_HYPOTHESES if name == "stretch-60" else (0.0,)))
    im1 = _texture(H, W, seed)
    return im1, _warp_bilinear(im1, *inv), fwd, dict(kw, stride=4)


def _recovery(m, fwd, margin):
    """End-point errors of the matches with a source at least `margin` px
    inside the frame against the forward map, and those matches' count."""
    fx, fy = fwd
    H, W = fx.shape
    x1, y1 = m[:, 0].astype(int), m[:, 1].astype(int)
    keep = ((x1 >= margin) & (x1 < W - margin) & (y1 >= margin)
            & (y1 < H - margin))
    m, x1, y1 = m[keep], x1[keep], y1[keep]
    err = np.hypot(m[:, 2] - m[:, 0] - (fx[y1, x1] - x1),
                   m[:, 3] - m[:, 1] - (fy[y1, x1] - y1))
    return err, len(m)


@pytest.mark.parametrize("name", ["rotation-5", "scale-8", "nonrigid",
                                  "rotation-25", "stretch-60",
                                  "stretch-60-identity-only"])
def test_match_images_warps_match_jax(name):
    """tests/test_matching.py's warps through both matchers: the port's
    matches held to the JAX package's (``_compare_matches``), then to the
    JAX tests' own recovery gates."""
    im1, im2, fwd, kw = _warp_case(name)
    j = JM.match_images(im1, im2, **kw)
    t = TM.match_images(im1, im2, device="cpu", **kw)
    _compare_matches(j, t)
    if name in ("rotation-5", "scale-8", "nonrigid"):
        assert len(t) > 50
        err, _ = _recovery(t, fwd, 12)
        assert np.median(err) < 1.5, np.median(err)
        assert (err < 2.0).mean() > 0.6, (err < 2.0).mean()
    elif name == "rotation-25":
        err, _ = _recovery(t, fwd, 0)
        assert len(t) > 150, len(t)
        assert np.median(err) < 1.5, np.median(err)
        assert (err < 2.0).mean() > 0.7, (err < 2.0).mean()
    else:
        def median_and_count(m):
            err, n = _recovery(m, fwd, 16)
            return (float(np.median(err)) if n >= 10 else np.inf), n

        med_s, n_s = median_and_count(
            t if name == "stretch-60" else TM.match_images(
                im1, im2, device="cpu",
                **dict(kw, rotations=JM.STRETCH_HYPOTHESES)))
        assert n_s > 50 and med_s < 2.0, (med_s, n_s)
        if name != "stretch-60":  # the identity-only bank does measurably
            med_id, n_id = median_and_count(t)  # worse: the bank recovers it
            assert med_id > 2.0 * med_s or n_id <= 50, (med_id, n_id)


def test_dispatch_multi_equals_per_pair():
    pairs = []
    for k in range(3):
        im = _texture(96, 112, 10 + k)
        pairs.append((im, _shifted(im, 2 - k, k)))
    hs = TM.match_images_dispatch_multi(pairs, radius=16, levels=1,
                                        device="cpu")
    for (a, b), h in zip(pairs, hs):
        one = TM.match_images(a, b, radius=16, levels=1, device="cpu")
        np.testing.assert_array_equal(TM.match_images_fetch(h), one)


def test_host_selection_copies_bit_equal():
    rng = np.random.default_rng(11)
    for gh, gw, n_bad in ((20, 30, 40), (70, 80, 300)):  # k-NN / grid window
        u = np.round(rng.normal(3, 0.5, (gh, gw))).astype(np.float32)
        v = np.round(rng.normal(-2, 0.5, (gh, gw))).astype(np.float32)
        flat = rng.choice(gh * gw, n_bad, replace=False)
        u.ravel()[flat] += rng.uniform(-30, 30, n_bad).astype(np.float32)
        sc = rng.uniform(0, 1, (gh, gw)).astype(np.float32)
        fb = rng.uniform(0, 2, (gh, gw)).astype(np.float32)
        roi = (rng.uniform(size=(gh * 4, gw * 4)) > 0.2).astype(np.uint8)
        for kw in (dict(), dict(roi=roi), dict(coherence=False),
                   dict(off=1, step=2)):
            args = (u, v, sc, fb, gh * 4, gw * 4, 4, 1.5, 0.3, 100)
            np.testing.assert_array_equal(TM._select_from_grids(*args, **kw),
                                          JM._select_from_grids(*args, **kw))
        keep = sc > 0.2
        np.testing.assert_array_equal(TM._coherence_keep(keep, u, v),
                                      JM._coherence_keep(keep, u, v))


@pytest.mark.parametrize("hw", [(480, 854), (64, 80), (150, 100), (36, 40),
                                (300, 2000)])
def test_clamp_match_params_equal(hw):
    for radius, levels in ((100, 3), (16, 2), (50, 4)):
        assert TM.clamp_match_params(*hw, radius, 12, levels) == (
            JM.clamp_match_params(*hw, radius, 12, levels))


def test_constants_and_write_matches_equal(tmp_path):
    assert TM.DEFAULT_ROTATIONS == JM.DEFAULT_ROTATIONS
    assert TM.STRETCH_HYPOTHESES == JM.STRETCH_HYPOTHESES
    m = np.random.default_rng(12).uniform(0, 90, (17, 5)).astype(np.float32)
    TM.write_matches(tmp_path / "t.txt", m)
    JM.write_matches(tmp_path / "j.txt", m)
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()


def _raw_pair(H, W, r, dy, dx, seed):
    a = _mk((H + 2 * r + 8, W + 2 * r + 8), seed) * 40 + 120
    p1 = a[r + 4 : r + 4 + H, r + 4 : r + 4 + W]
    p2 = a[r + 4 + dy : r + 4 + dy + H, r + 4 + dx : r + 4 + dx + W]
    return np.ascontiguousarray(p1), np.ascontiguousarray(p2)


def _jax_subpatch(p1, p2, r, budget_div):
    """JAX's _search_subpatch under jit (eagerly it dispatches op by op)."""
    fn = jax.jit(lambda a, b: JM._search_subpatch(a, b, r, 12, budget_div))
    return [np.asarray(a) for a in fn(jnp.asarray(p1), jnp.asarray(p2))]


def _assert_search_close(t, j):
    """Scores within 2e-4; (du, dv) equal but on ties (where the two
    packages' best scores agree within 2e-4 and the offsets differ)."""
    (tu, tv, ts), (ju, jv, js) = t, j
    assert np.abs(ts - js).max() < 2e-4
    same = (tu == ju) & (tv == jv)
    assert same.mean() >= 0.99, same.mean()


@pytest.fixture
def small_budget(monkeypatch):
    """Both packages' vectorised-search budget cut to 2^18 elements, so
    that small planes reach either side of the subpatch budget."""
    for mod in (JM, TM):
        monkeypatch.setattr(mod, "_SEARCH_VEC_BUDGET", 1 << 18)


@pytest.mark.parametrize("shape, budget_div, fits", [
    ((30, 40, 6), 1, False),   # 169·1200 = 202,800 > 2^18 // 3 = 87,381
    ((16, 20, 4), 1, True),    # 81·320 = 25,920
    ((16, 20, 4), 4, False),   # > 87,381 // 4 = 21,845
    ((12, 16, 3), 4, True),    # 49·192 = 9,408
    ((12, 16, 3), 10, False),  # > 2,912
])
def test_subpatch_takes_jax_search(shape, budget_div, fits, small_budget,
                                   monkeypatch):
    """The same decision as JAX on each side of the budget (the JAX
    fallback calls its rigid _search, the port's zncc_search), and the same
    result: scores within 2e-4, (du, dv) equal but on ties."""
    H, W, r = shape
    assert TM.subpatch_fits(H, W, r, budget_div) == fits
    rigid = {"jax": 0, "port": 0}
    for name, mod, fn in (("jax", JM, "_search"), ("port", TM, "zncc_search")):
        real = getattr(mod, fn)

        def spy(*a, _real=real, _n=name, **k):
            rigid[_n] += 1
            return _real(*a, **k)

        monkeypatch.setattr(mod, fn, spy)
    p1, p2 = _raw_pair(H, W, r, 2, -1, H + r)
    j = _jax_subpatch(p1, p2, r, budget_div)
    t = [a.numpy() for a in TM._search_subpatch(
        torch.tensor(p1), torch.tensor(p2), r, 12, budget_div)]
    assert rigid == {"jax": int(not fits), "port": int(not fits)}
    _assert_search_close(t, j)


def test_subpatch_budget_is_jax_coarse_rule():
    """At 854×480, levels 3, radius 100 (coarse 60×106, r = 13): the
    default bank on one pair falls back, rotations=(0.0,) does not."""
    assert TM._SEARCH_VEC_BUDGET == JM._SEARCH_VEC_BUDGET
    assert not TM.subpatch_fits(60, 106, 13, len(TM.DEFAULT_ROTATIONS) * 2)
    assert TM.subpatch_fits(60, 106, 13, 1 * 2)


def test_subpatch_search_at_the_coarse_shape_matches_jax():
    """The 854×480 frame's coarse level: 60×106 at r = 13, in budget."""
    p1, p2 = _raw_pair(60, 106, 13, 3, -5, 31)
    j = _jax_subpatch(p1, p2, 13, 2)
    t = [a.numpy() for a in TM._search_subpatch(
        torch.tensor(p1), torch.tensor(p2), 13, 12, 2)]
    _assert_search_close(t, j)


@pytest.mark.parametrize("rotations", [(0.0,), JM.DEFAULT_ROTATIONS])
def test_match_images_subpatch_matches_jax(rotations):
    """subpatch=True through match_images (tests/test_matching.py's
    translation gate): the coarse split-and-rescore search, then the rigid
    refine levels; the same matches as JAX."""
    im1 = _texture(96, 112, 21)
    im2 = _shifted(im1, 6, -4)
    kw = dict(radius=16, levels=1, subpatch=True, rotations=rotations)
    j = JM.match_images(im1, im2, **kw)
    t = TM.match_images(im1, im2, device="cpu", **kw)
    assert len(t) > 50
    _compare_matches(j, t)
    d = t[:, 2:4] - t[:, 0:2]
    assert np.median(d[:, 0]) == 6 and np.median(d[:, 1]) == -4


def test_pyramid_flow_bidir_and_match_fields_match_jax():
    im1 = _texture(80, 96, 22)
    im2 = _shifted(im1, -3, 5)
    g1, g2 = (im.astype(np.float32)[..., 0] for im in (im1, im2))
    kw = dict(radius=12, levels=1)
    jf, js = (np.asarray(a) for a in JM.pyramid_flow_bidir(
        jnp.asarray(g1), jnp.asarray(g2), **kw))
    tf, ts = TM.pyramid_flow_bidir(torch.tensor(g1), torch.tensor(g2), **kw)
    assert tf.shape == (2, 2, 80, 96) and ts.shape == (2, 80, 96)
    same = (tf.numpy() == jf).all(axis=1)
    assert same.mean() > 0.97
    assert np.abs(ts.numpy() - js)[same].max() < 2e-4
    # match_fields: gray conversion, then the same two lanes
    r1, r2 = (np.ascontiguousarray(im.transpose(2, 0, 1)).astype(np.float32)
              for im in (im1, im2))
    mf, ms = TM.match_fields(torch.tensor(r1), torch.tensor(r2), **kw)
    jmf, jms = (np.asarray(a) for a in JM.match_fields(
        jnp.asarray(r1), jnp.asarray(r2), **kw))
    same = (mf.numpy() == jmf).all(axis=1)
    assert same.mean() > 0.97
    assert np.abs(ms.numpy() - jms)[same].max() < 2e-4
    # the dense host selection
    args = (80, 96, 4, 1.5, 0.3, 12)
    tsel = TM._select_matches(mf[0].numpy(), mf[1].numpy(), ms[0].numpy(),
                              *args)
    np.testing.assert_array_equal(
        tsel, JM._select_matches(mf[0].numpy(), mf[1].numpy(),
                                 ms[0].numpy(), *args))
    _compare_matches(JM._select_matches(jmf[0], jmf[1], jms[0], *args), tsel)
    assert np.median(tsel[:, 2] - tsel[:, 0]) == -3
    assert np.median(tsel[:, 3] - tsel[:, 1]) == 5


def test_match_images_batched_is_per_pair():
    pairs = [(im, _shifted(im, 2, -1)) for im in
             (_texture(48, 64, 23), _texture(48, 64, 24))]
    got = TM.match_images_batched(pairs, radius=12, levels=1, device="cpu")
    assert len(got) == 2
    for (a, b), m in zip(pairs, got):
        np.testing.assert_array_equal(
            m, TM.match_images(a, b, radius=12, levels=1, device="cpu"))


def test_zncc_calls_counts_the_searches(monkeypatch):
    """One zncc_search call per search level, whatever the pair count."""
    calls = []
    real = TM.zncc_search

    def counting(*args, **kwargs):
        calls.append(args[1].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(TM, "zncc_search", counting)
    rgb = torch.tensor(np.stack([_texture(96, 112, 14 + k).transpose(2, 0, 1)
                                 for k in range(3)]))
    TM.match_grid_multi(rgb, rgb.flip(0), radius=16, levels=2)
    assert len(calls) == TM.zncc_calls(2) == 3
    assert calls[0][0] == 2 * 3 * len(TM.DEFAULT_ROTATIONS)  # lanes × bank
    assert [c[0] for c in calls[1:]] == [6, 6]
