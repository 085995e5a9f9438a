"""The port's procedural textures (ops/textures.py) and texture_gen against
the JAX package's.

Both packages draw each texture's values from keys of one stream: the JAX
package from ``jax.random``, the port from ``utils.prng``, its replay on
the host (tests/test_torch_prng.py). The pure parts are held first on
values drawn here with the JAX functions' own key splits (the family
functions at arap_flow_tpu/ops/textures.py:78-185, ``render``'s splits and
``fold_in``s at :250-266); then the port's draws are held equal to those,
and ``render``, ``random_texture`` and texture_gen's files to JAX's from
the same keys and seeds, end to end.

Tolerances: the lattice hash bitwise; drawn values bitwise; fields within
1e-5 (XLA's and torch's sin/cos and pow differ in the last bits); uint8
images equal on >= 99.9% of pixels and elsewhere within 1. Ports of
tests/test_textures.py's distribution checks hold the renders too.
"""

import colorsys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arap_flow_tpu.ops import textures as JT
from arap_flow_tpu_torch.ops import textures as TT
from arap_flow_tpu_torch.utils import prng

torch.set_num_threads(2)


def _ju(k, lo, hi) -> float:
    return float(jax.random.uniform(k, (), minval=lo, maxval=hi))


def _jsalt(k) -> int:
    return int(jax.random.randint(k, (), 0, 10000))


def jax_field_params(family: str, key) -> dict:
    """The values the JAX family function draws from `key`."""
    if family == "brick":
        k1, k2, k3 = jax.random.split(key, 3)
        bh = jax.random.uniform(k1, (), minval=20.0, maxval=60.0)
        bw = bh * jax.random.uniform(k2, (), minval=1.5, maxval=3.5)
        return {"bh": float(bh), "bw": float(bw), "salt": _jsalt(k3)}
    if family == "wave":
        k1, k2, k3 = jax.random.split(key, 3)
        return {"scale": _ju(k1, 30.0, 150.0), "distort": _ju(k2, 0.0, 8.0),
                "salt": _jsalt(k3)}
    k1, k2 = jax.random.split(key)
    if family == "magic":
        return {"scale": _ju(k1, 60.0, 250.0), "turb": _ju(k2, 1.0, 3.0)}
    if family == "checker":
        return {"size": _ju(k1, 20.0, 120.0), "salt": _jsalt(k2)}
    lo, hi = {"noise": (20.0, 200.0), "musgrave": (40.0, 300.0),
              "voronoi": (40.0, 160.0)}[family]
    return {"scale": _ju(k1, lo, hi), "salt": _jsalt(k2)}


# the lamp's saturation as JAX's jitted render computes it (XLA folds
# 0.25 · sqrt(2) and fuses the multiply-add: eager JAX is an ulp away on
# some keys)
_jax_lamp_s = jax.jit(
    lambda ks: jnp.clip(0.35 + 0.25 * jax.random.normal(ks, ()), 0.0, 1.0))


def jax_render_params(family: str, key, H: int, W: int) -> dict:
    """The values JAX's ``render`` draws from `key`."""
    kf, kc1, kc2, kl = jax.random.split(key, 4)

    def hs(k):
        kh, ks = jax.random.split(k)
        return (_ju(kh, 0.0, 1.0), _ju(ks, 0.0, 1.0))

    kh, ks = jax.random.split(jax.random.fold_in(kl, 3))
    lamp_s = _jax_lamp_s(ks)
    return {
        "field": jax_field_params(family, kf), "c1": hs(kc1), "c2": hs(kc2),
        "lx": _ju(kl, 0.0, float(W)),
        "ly": _ju(jax.random.fold_in(kl, 1), 0.0, float(H)),
        "lz": float(jax.random.uniform(jax.random.fold_in(kl, 2), (),
                                       minval=0.4, maxval=1.2) * W),
        "lamp": (_ju(kh, 0.0, 1.0), float(lamp_s)),
    }


def assert_uint8_close(a: np.ndarray, b: np.ndarray) -> None:
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    assert a.shape == b.shape
    assert (d == 0).mean() >= 0.999, (d != 0).mean()
    assert d.max() <= 1


def test_hash01_bitwise_with_negative_lattice():
    ix = np.arange(-150, 150, dtype=np.int32)[:, None] * np.ones((1, 300),
                                                                np.int32)
    iy = ix.T * 7 - 3
    for salt in (0, 17, 9999, 10021):
        want = np.asarray(JT._hash01(jnp.asarray(ix), jnp.asarray(iy),
                                     jnp.int32(salt)))
        got = TT._hash01(torch.tensor(ix), torch.tensor(iy), salt).numpy()
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


@pytest.mark.parametrize("family", TT.FAMILIES)
def test_field_matches_jax(family):
    H, W = 96, 128
    for seed in (0, 1):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(JT._FAMILY_FNS[family](key, H, W))
        got = TT.field(family, jax_field_params(family, key), H, W, "cpu")
        assert got.dtype == torch.float32 and got.shape == (H, W)
        assert np.abs(got.numpy() - want).max() <= 1e-5


@pytest.mark.parametrize("family", TT.FAMILIES)
def test_render_matches_jax(family):
    H, W = 72, 96
    key = jax.random.PRNGKey(3)
    want = np.asarray(JT.render(key, family, H, W))
    got = TT.render_params(family, jax_render_params(family, key, H, W),
                           H, W, "cpu")
    assert got.dtype == torch.uint8
    assert_uint8_close(got.numpy(), want)


def test_colour_transforms_match_jax():
    x = np.linspace(0.0, 1.0, 1001, dtype=np.float32)
    for jf, tf in ((JT.srgb_to_linear, TT.srgb_to_linear),
                   (JT.linear_to_srgb, TT.linear_to_srgb)):
        np.testing.assert_allclose(tf(torch.tensor(x)).numpy(),
                                   np.asarray(jf(jnp.asarray(x))), atol=1e-6)
    h, s = np.random.default_rng(0).uniform(size=(2, 64)).astype(np.float32)
    np.testing.assert_allclose(
        TT.hsv_to_rgb(torch.tensor(h), torch.tensor(s), 1.0).numpy(),
        np.asarray(JT.hsv_to_rgb(jnp.asarray(h), jnp.asarray(s), 1.0)),
        atol=1e-6)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 3])
def test_draws_equal_jax(seed):
    """The port's draws from a key are the values JAX's render draws."""
    for fam in TT.FAMILIES:
        want = jax_render_params(fam, jax.random.PRNGKey(seed), 72, 96)
        assert TT.draw_render_params(fam, 72, 96, prng.key(seed)) == want


def test_lamp_colour_is_jax_jitted_render_lamp():
    """The lamp's drawn hue and saturation give, bitwise, the colour JAX's
    jitted ``_lamp_color_linear`` makes from the same key, over 2000 keys
    (the saturation is the one value that a fused multiply-add decides)."""
    seeds = np.arange(2000)
    keys = jax.vmap(lambda s: jax.random.fold_in(
        jax.random.split(jax.random.PRNGKey(s), 4)[3], 3))(
            jnp.asarray(seeds, jnp.uint32))
    want = np.asarray(jax.jit(jax.vmap(JT._lamp_color_linear))(keys))
    hs = np.array([TT.draw_render_params("noise", 8, 8, prng.key(int(s)))
                   ["lamp"] for s in seeds], np.float32)
    colour = jax.jit(jax.vmap(lambda h, s: JT.srgb_to_linear(
        JT.hsv_to_rgb(h, s, jnp.float32(1.0)))))
    np.testing.assert_array_equal(np.asarray(colour(hs[:, 0], hs[:, 1])),
                                  want)


@pytest.mark.parametrize("seed", [1, 4])
def test_render_and_random_texture_match_jax(seed):
    """render(key, family) and random_texture(key) from one key, end to end
    (72×96, the render cases' shape: JAX's compiled renders are reused)."""
    H, W = 72, 96
    key, jkey = prng.key(seed), jax.random.PRNGKey(seed)
    for fam in TT.FAMILIES:
        assert_uint8_close(TT.render(key, fam, H, W, device="cpu").numpy(),
                           np.asarray(JT.render(jkey, fam, H, W)))
    for s in range(seed, seed + 4):
        assert_uint8_close(
            TT.random_texture(prng.key(s), H, W, device="cpu").numpy(),
            np.asarray(JT.random_texture(jax.random.PRNGKey(s), H, W)))


def test_texture_gen_writes_jax_files(tmp_path):
    """texture_gen --num 7 --size 96 72 --seed 0: JAX's names and images."""
    from arap_flow_tpu.pipeline import texture_gen as JG
    from arap_flow_tpu_torch.io.image import load_rgb
    from arap_flow_tpu_torch.pipeline import texture_gen as TG

    args = ["--num", "7", "--size", "96", "72", "--seed", "0"]
    JG.main(["--output", str(tmp_path / "j"), *args])
    TG.main(["--output", str(tmp_path / "t"), *args, "--device", "cpu"])
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == names
    assert len(names) == 7
    for n in names:
        assert_uint8_close(load_rgb(tmp_path / "t" / n),
                           load_rgb(tmp_path / "j" / n))


def test_texture_gen_picks_jax_families(tmp_path):
    from arap_flow_tpu.pipeline import texture_gen as JG
    from arap_flow_tpu_torch.pipeline import texture_gen as TG

    # 96×72, the render cases' shape: JAX's compiled renders are reused
    args = ["--num", "6", "--size", "96", "72", "--seed", "5",
            "--families", "checker", "brick"]
    JG.main(["--output", str(tmp_path / "j"), *args])
    TG.main(["--output", str(tmp_path / "t"), *args, "--device", "cpu"])
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == names
    assert [n.split("_")[2][:-4] for n in names] == TG.family_sequence(
        6, 5, ["checker", "brick"])
    from arap_flow_tpu_torch.io.image import load_rgb

    img = load_rgb(tmp_path / "t" / names[0])
    fam = names[0].split("_")[2][:-4]
    np.testing.assert_array_equal(
        img, TT.render(prng.key(5 * 100003), fam, 72, 96,
                       device="cpu").numpy())
    assert_uint8_close(img, load_rgb(tmp_path / "j" / names[0]))


def test_cli_needs_cuda_by_default(tmp_path):
    from arap_flow_tpu_torch.pipeline import texture_gen as TG

    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        TG.main(["--output", str(tmp_path), "--num", "1", "--size", "8", "8"])


# ---------------------------------------------------------------------------
# The port's own renders: tests/test_textures.py's checks
# ---------------------------------------------------------------------------


def _key(seed: int) -> tuple:
    return prng.key(seed)


def _render(seed, family, H, W):
    return TT.render(_key(seed), family, H, W, device="cpu").numpy()


@pytest.mark.parametrize("family", TT.FAMILIES)
def test_family_renders(family):
    img = _render(3, family, 72, 96)
    assert img.shape == (72, 96, 3) and img.dtype == np.uint8
    assert img.std() > 4.0, family
    assert img.max() > 40, family


def test_deterministic_and_seeded():
    a = _render(5, "voronoi", 48, 64)
    np.testing.assert_array_equal(a, _render(5, "voronoi", 48, 64))
    assert (a != _render(6, "voronoi", 48, 64)).any()


def test_random_texture_draws_family_then_values():
    """The family from randint(key, 0, 7), the texture from fold_in(key, 7)
    (JAX's random_texture)."""
    k = _key(11)
    fam = TT.FAMILIES[prng.randint(k, 0, len(TT.FAMILIES))]
    assert fam == TT.FAMILIES[int(jax.random.randint(
        jax.random.PRNGKey(11), (), 0, len(TT.FAMILIES)))]
    want = TT.render(prng.fold_in(k, 7), fam, 32, 40, device="cpu")
    got = TT.random_texture(_key(11), 32, 40, device="cpu")
    assert torch.equal(got, want)


def test_srgb_golden_triple():
    """hsv(.4, .8, 1) linearised: the reference's documented values
    (texture_gen.py:152-160)."""
    rgb = TT.hsv_to_rgb(0.4, 0.8, 1.0).double().numpy()
    np.testing.assert_allclose(rgb, colorsys.hsv_to_rgb(0.4, 0.8, 1.0),
                               atol=1e-6)
    lin = TT.srgb_to_linear(torch.tensor(rgb, dtype=torch.float32)).double()
    np.testing.assert_allclose(
        lin.numpy(), [0.03310476657088504, 1.0, 0.23302199930143835],
        atol=2e-6)


def test_srgb_roundtrip_and_range():
    x = torch.linspace(0.0, 1.0, 257)
    lin = TT.srgb_to_linear(x)
    back = TT.linear_to_srgb(lin)
    np.testing.assert_allclose(back.numpy(), x.numpy(), atol=1e-5)
    enc = TT.linear_to_srgb(x)
    assert (lin.diff() > 0).all() and (enc.diff() > 0).all()
    assert lin[128] < x[128] < enc[128]


def test_hsv_matches_colorsys():
    rng = np.random.default_rng(0)
    for _ in range(50):
        h, s, v = rng.uniform(size=3)
        got = TT.hsv_to_rgb(float(h), float(s), float(v)).double().numpy()
        np.testing.assert_allclose(got, colorsys.hsv_to_rgb(h, s, v),
                                   atol=1e-6)


def test_render_colors_are_value1_srgb():
    p99 = [np.percentile(_render(seed, "checker", 64, 64).max(axis=-1), 99)
           for seed in range(6)]
    assert np.mean(p99) > 120.0, p99


def _fields(family, H=96, W=128):
    return [TT.field(family, TT.draw_params(family, _key(s)), H, W,
                     "cpu").numpy() for s in (0, 1, 2, 3)]


def test_checker_is_bimodal():
    for f in _fields("checker", 192, 256):
        assert np.mean((f < 0.05) | (f > 0.95)) > 0.95
        assert np.mean(f > 0.95) > 0.05 and np.mean(f < 0.05) > 0.05


def test_brick_mortar_fraction():
    for f in _fields("brick", 256, 384):
        mortar = np.mean(f == 0.0)
        assert 0.05 < mortar < 0.6, mortar
        bricks = f[f > 0.0]
        assert bricks.min() >= 0.3 - 1e-6 and bricks.max() <= 1.0 + 1e-6
        assert len(np.unique(np.round(bricks, 4))) > 3


def test_noise_fbm_statistics():
    fields = _fields("noise")
    assert 0.3 < np.mean([f.mean() for f in fields]) < 0.7
    assert 0.03 < np.mean([f.std() for f in fields]) < 0.35


def test_musgrave_ridged_nonnegative():
    for f in _fields("musgrave"):
        assert f.min() >= 0.0
        assert f.std() > 0.02
        assert np.percentile(f, 10) < f.mean()


def test_voronoi_distance_field():
    for f in _fields("voronoi", 256, 384):
        assert f.min() < 0.2
        assert 0.0 <= f.min() and f.max() <= 1.0
        assert f.std() > 0.05


def test_wave_band_distribution():
    """Sine bands: more mass near 0 and 1 than in the middle band."""
    extreme, middle = 0.0, 0.0
    for f in _fields("wave"):
        extreme += np.mean((f < 0.15) | (f > 0.85))
        middle += np.mean((f > 0.425) & (f < 0.575))
    assert extreme > middle, (extreme, middle)


def test_magic_bounded_and_varied():
    for f in _fields("magic"):
        assert f.min() >= -1e-6 and f.max() <= 1.0 + 1e-6
        assert f.std() > 0.05


def test_field_spatial_structure():
    """Every family's field is spatially correlated, not white noise."""
    for name in TT.FAMILIES:
        f = TT.field(name, TT.draw_params(name, _key(9)), 96, 128,
                     "cpu").numpy().astype(np.float64)
        a = f[:, :-1].ravel() - f.mean()
        b = f[:, 1:].ravel() - f.mean()
        denom = np.sqrt((a * a).sum() * (b * b).sum())
        corr = (a * b).sum() / denom if denom > 0 else 1.0
        assert corr > 0.5, (name, corr)


def test_draws_within_jax_ranges():
    """The port draws each parameter from the JAX package's range, and
    draws JAX's value from the same key."""
    ranges = {"brick": {"bh": (20, 60)}, "checker": {"size": (20, 120)},
              "magic": {"scale": (60, 250), "turb": (1, 3)},
              "musgrave": {"scale": (40, 300)}, "noise": {"scale": (20, 200)},
              "voronoi": {"scale": (40, 160)},
              "wave": {"scale": (30, 150), "distort": (0, 8)}}
    for fam, rs in ranges.items():
        for s in range(20):
            p = TT.draw_params(fam, _key(s))
            assert p == jax_field_params(fam, jax.random.PRNGKey(s)), (fam, s)
            for k, (lo, hi) in rs.items():
                assert lo <= p[k] < hi, (fam, k, p[k])
            if "salt" in p:
                assert 0 <= p["salt"] < 10000
            if fam == "brick":
                assert 1.5 * p["bh"] <= p["bw"] < 3.5 * p["bh"] + 1e-3
