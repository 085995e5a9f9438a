"""Procedural random textures (ops/textures.py of the JAX package): the seven
Cycles texture families of the reference's Blender renderer
(texture_gen.py: Brick, Checker, Magic, Musgrave, Noise, Voronoi, Wave,
with a random point light, texture_gen.py:175-281, 311-326), synthesised
as scalar fields over the image grid in plain torch on an explicit device.

Each family and `render` come in two parts:

- a draw, ``draw_params(family, key)`` and ``draw_render_params(family,
  H, W, key)``, which takes every random value from a key of
  ``utils.prng`` (the JAX package's ``jax.random`` stream, replayed on the
  host) with the JAX functions' own splits and ``fold_in``s, and returns a
  dict of Python floats and ints (float32 values where JAX draws float32);
- a pure part, ``field(family, params, H, W, device)`` and
  ``render_params(family, params, H, W, device)``, which computes the
  texture from those values on `device`.

So one key gives JAX's values, and the same texture on whichever device
renders it; ``render(key, family, H, W)`` and ``random_texture(key, H,
W)`` take JAX's arguments in JAX's order (tests/test_torch_textures.py
holds the draws and the images to JAX's).

``_hash01`` is the JAX package's uint32 lattice hash, computed in int64
with each product kept below 2^63 and every step masked to 32 bits.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils import prng

FAMILIES = ("brick", "checker", "magic", "musgrave", "noise", "voronoi", "wave")

_M32 = 0xFFFFFFFF


def _grid(H: int, W: int, device):
    gy, gx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                            torch.arange(W, dtype=torch.float32, device=device),
                            indexing="ij")
    return gx, gy


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a · c) mod 2^32 for int64 `a` in [0, 2^32) and a 32-bit constant:
    the constant's 16-bit halves keep each product below 2^48."""
    hi, lo = c >> 16, c & 0xFFFF
    return ((((a * hi) & 0xFFFF) << 16) + a * lo) & _M32


def _hash01(ix: torch.Tensor, iy: torch.Tensor, salt) -> torch.Tensor:
    """The lattice hash -> [0, 1) float32, bitwise the JAX package's uint32
    arithmetic. Negative coordinates wrap as a uint32 cast does."""
    ix = ix.to(torch.int64) & _M32
    iy = iy.to(torch.int64) & _M32
    salt = torch.as_tensor(salt, dtype=torch.int64, device=ix.device) & _M32
    h = (_mul32(ix, 0x85EBCA6B) ^ _mul32(iy, 0xC2B2AE35)
         ^ _mul32(salt, 0x27D4EB2F))
    h = h ^ (h >> 15)
    h = _mul32(h, 0x2C1B3C6D)
    h = h ^ (h >> 12)
    h = _mul32(h, 0x297A2D39)
    h = h ^ (h >> 15)
    return h.to(torch.float32) / float(2 ** 32)


def _value_noise(gx, gy, scale, salt):
    """Bilinear value noise at lattice scale `scale`."""
    x = gx / scale
    y = gy / scale
    ix = torch.floor(x).to(torch.int32)
    iy = torch.floor(y).to(torch.int32)
    fx = x - ix
    fy = y - iy
    # smoothstep
    ux = fx * fx * (3.0 - 2.0 * fx)
    uy = fy * fy * (3.0 - 2.0 * fy)
    v00 = _hash01(ix, iy, salt)
    v01 = _hash01(ix + 1, iy, salt)
    v10 = _hash01(ix, iy + 1, salt)
    v11 = _hash01(ix + 1, iy + 1, salt)
    return (v00 * (1 - ux) * (1 - uy) + v01 * ux * (1 - uy)
            + v10 * (1 - ux) * uy + v11 * ux * uy)


def _fbm(gx, gy, scale, salt, octaves=5, gain=0.5):
    out = torch.zeros_like(gx)
    amp = 1.0
    norm = 0.0
    for o in range(octaves):
        out = out + amp * _value_noise(gx, gy, scale / (2.0 ** o), salt + o)
        norm += amp
        amp *= gain
    return out / norm


def _f32(v, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def noise_field(p, H, W, device):
    """Cycles Noise analogue: fbm at a random scale."""
    gx, gy = _grid(H, W, device)
    return _fbm(gx, gy, _f32(p["scale"], device), p["salt"])


def musgrave_field(p, H, W, device):
    """Musgrave analogue: ridged multifractal of value noise."""
    gx, gy = _grid(H, W, device)
    scale = _f32(p["scale"], device)
    out = torch.zeros_like(gx)
    amp = 1.0
    for o in range(5):
        n = _value_noise(gx, gy, scale / (2.0 ** o), p["salt"] + 17 + o)
        out = out + amp * (1.0 - torch.abs(2.0 * n - 1.0)) ** 2
        amp *= 0.55
    return out / 2.2


def checker_field(p, H, W, device):
    """Checker with a random cell size and a value-noise wobble."""
    gx, gy = _grid(H, W, device)
    size = _f32(p["size"], device)
    wob = (_value_noise(gx, gy, 80.0, p["salt"]) - 0.5) * size * 0.3
    cx = torch.floor((gx + wob) / size).to(torch.int32)
    cy = torch.floor((gy + wob) / size).to(torch.int32)
    return ((cx + cy) % 2).to(torch.float32)


def brick_field(p, H, W, device):
    """Brick analogue: staggered rows with mortar lines and a random shade
    per brick."""
    gx, gy = _grid(H, W, device)
    bh = _f32(p["bh"], device)
    bw = _f32(p["bw"], device)
    mortar = 0.08
    row = torch.floor(gy / bh)
    offs = torch.where(row.to(torch.int32) % 2 == 0, 0.0, bw / 2)
    fx = (gx + offs) / bw
    fy = gy / bh
    mx = torch.abs(fx - torch.floor(fx) - 0.5) > (0.5 - mortar)
    my = torch.abs(fy - torch.floor(fy) - 0.5) > (0.5 - mortar)
    shade = _hash01(torch.floor(fx).to(torch.int32), row.to(torch.int32),
                    p["salt"])
    return torch.where(mx | my, 0.0, 0.3 + 0.7 * shade)


def voronoi_field(p, H, W, device):
    """Voronoi distance to the nearest cell seed, clipped to [0, 1]."""
    gx, gy = _grid(H, W, device)
    scale = _f32(p["scale"], device)
    salt = p["salt"]
    x = gx / scale
    y = gy / scale
    ix = torch.floor(x).to(torch.int32)
    iy = torch.floor(y).to(torch.int32)
    best = torch.full(gx.shape, torch.inf, device=device)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            px = ix + dx + _hash01(ix + dx, iy + dy, salt)
            py = iy + dy + _hash01(ix + dx, iy + dy, salt + 1)
            d = (x - px) ** 2 + (y - py) ** 2
            best = torch.minimum(best, d)
    return torch.clamp(torch.sqrt(best), 0.0, 1.0)


def wave_field(p, H, W, device):
    """Wave analogue: diagonal sine bands distorted by fbm."""
    gx, gy = _grid(H, W, device)
    scale = _f32(p["scale"], device)
    base = (gx + gy * 0.3) / scale
    d = _fbm(gx, gy, scale, p["salt"]) * _f32(p["distort"], device)
    return 0.5 + 0.5 * torch.sin((base + d) * 2.0 * math.pi)


def magic_field(p, H, W, device):
    """Magic analogue: an iterated trig swirl (Blender's magic node)."""
    gx, gy = _grid(H, W, device)
    scale = _f32(p["scale"], device)
    turb = _f32(p["turb"], device)
    x = gx / scale * 2 * math.pi
    y = gy / scale * 2 * math.pi
    a = torch.sin(x + torch.sin(y * turb))
    b = torch.cos(y + torch.cos(x * turb) * turb)
    for _ in range(2):
        a, b = torch.sin(a * turb + b), torch.cos(b * turb - a)
    return 0.5 + 0.25 * (a + b)


_FIELDS = {
    "brick": brick_field,
    "checker": checker_field,
    "magic": magic_field,
    "musgrave": musgrave_field,
    "noise": noise_field,
    "voronoi": voronoi_field,
    "wave": wave_field,
}


def _uniform(key, lo: float, hi: float) -> float:
    """One float32 uniform in [lo, hi) drawn from `key`."""
    return float(prng.uniform(key, lo, hi))


def _salt(key) -> int:
    return prng.randint(key, 0, 10000)


def _scale_salt(lo: float, hi: float):
    """The draw of a family with a scale in [lo, hi) and a lattice salt."""
    def draw(key) -> dict:
        k1, k2 = prng.split(key)
        return {"scale": _uniform(k1, lo, hi), "salt": _salt(k2)}
    return draw


def _brick_draw(key) -> dict:
    k1, k2, k3 = prng.split(key, 3)
    bh = prng.uniform(k1, 20.0, 60.0)
    bw = bh * prng.uniform(k2, 1.5, 3.5)  # a float32 product, as in JAX
    return {"bh": float(bh), "bw": float(bw), "salt": _salt(k3)}


def _checker_draw(key) -> dict:
    k1, k2 = prng.split(key)
    return {"size": _uniform(k1, 20.0, 120.0), "salt": _salt(k2)}


def _magic_draw(key) -> dict:
    k1, k2 = prng.split(key)
    return {"scale": _uniform(k1, 60.0, 250.0), "turb": _uniform(k2, 1.0, 3.0)}


def _wave_draw(key) -> dict:
    k1, k2, k3 = prng.split(key, 3)
    return {"scale": _uniform(k1, 30.0, 150.0),
            "distort": _uniform(k2, 0.0, 8.0), "salt": _salt(k3)}


# each family's random parameters: the JAX package's draws, key splits
# included (textures.py:78-185)
_DRAWS = {
    "brick": _brick_draw,
    "checker": _checker_draw,
    "magic": _magic_draw,
    "musgrave": _scale_salt(40.0, 300.0),
    "noise": _scale_salt(20.0, 200.0),
    "voronoi": _scale_salt(40.0, 160.0),
    "wave": _wave_draw,
}


def draw_params(family: str, key) -> dict:
    """The random parameters of one `family` field, drawn from `key` (a
    ``utils.prng`` key) as the JAX family function draws them."""
    return _DRAWS[family](key)


def field(family: str, params: dict, H: int, W: int, device) -> torch.Tensor:
    """The (H, W) float32 field of `family` from its parameters."""
    return _FIELDS[family](params, H, W, device)


def srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    """Piecewise sRGB EOTF (texture_gen.py:142-149): sampled colours are
    sRGB and are linearised before shading."""
    c = torch.as_tensor(c, dtype=torch.float32)
    a = 0.055
    return torch.where(c <= 0.04045, c / 12.92, ((c + a) / (1 + a)) ** 2.4)


def linear_to_srgb(c: torch.Tensor) -> torch.Tensor:
    """Inverse of srgb_to_linear (texture_gen.py:133-140), applied to the
    shaded linear image on output."""
    c = torch.as_tensor(c, dtype=torch.float32)
    a = 0.055
    return torch.where(c <= 0.0031308, 12.92 * c,
                       (1 + a) * torch.clamp(c, min=1e-12) ** (1 / 2.4) - a)


def hsv_to_rgb(h, s, v) -> torch.Tensor:
    """colorsys.hsv_to_rgb, vectorised; returns a (..., 3) stack."""
    h = torch.as_tensor(h, dtype=torch.float32)
    s = torch.as_tensor(s, dtype=torch.float32, device=h.device)
    v = torch.as_tensor(v, dtype=torch.float32, device=h.device)
    k = (torch.stack([torch.full_like(h, 5.0), torch.full_like(h, 3.0),
                      torch.full_like(h, 1.0)], dim=-1) + h[..., None] * 6.0
         ) % 6.0
    f = torch.clamp(torch.minimum(k, torch.clamp(4.0 - k, max=1.0)), 0.0, 1.0)
    return v[..., None] * (1.0 - s[..., None] * f)


def _colour_linear(hs, device) -> torch.Tensor:
    """An sRGB colour of hue and saturation `hs` and value 1, linearised."""
    return srgb_to_linear(hsv_to_rgb(_f32(hs[0], device), _f32(hs[1], device),
                                     1.0))


def _hue_sat(key) -> tuple:
    """A uniform hue and saturation (random_color, texture_gen.py:163-173)."""
    kh, ks = prng.split(key)
    return (_uniform(kh, 0.0, 1.0), _uniform(ks, 0.0, 1.0))


def draw_render_params(family: str, H: int, W: int, key) -> dict:
    """The random values of one `render`, drawn from `key` with the JAX
    render's splits: the family's parameters, two material colours
    (uniform hue and saturation, texture_gen.py:163-173), the point light's
    position above the plane and its colour (uniform hue, saturation
    clamp(N(0.35, 0.25), 0, 1), texture_gen.py:99-100, :318-320)."""
    kf, kc1, kc2, kl = prng.split(key, 4)
    p = {"field": draw_params(family, kf), "c1": _hue_sat(kc1),
         "c2": _hue_sat(kc2)}
    p["lx"] = _uniform(kl, 0.0, float(W))
    p["ly"] = _uniform(prng.fold_in(kl, 1), 0.0, float(H))
    p["lz"] = float(prng.uniform(prng.fold_in(kl, 2), 0.4, 1.2)
                    * np.float32(W))
    kh, ks = prng.split(prng.fold_in(kl, 3))
    lamp_s = np.clip(prng.normal_affine(ks, 0.25, 0.35), np.float32(0.0),
                     np.float32(1.0))  # as JAX's jitted render computes it
    p["lamp"] = (_uniform(kh, 0.0, 1.0), float(lamp_s))
    return p


def render_params(family: str, params: dict, H: int, W: int,
                  device) -> torch.Tensor:
    """One (H, W, 3) uint8 texture from its values: the family field
    through the two-colour gradient (shaded in linear RGB), the point
    light's falloff and colour, then the sRGB output transform, truncated
    to uint8."""
    f = torch.clamp(field(family, params["field"], H, W, device), 0.0, 1.0)
    c1 = _colour_linear(params["c1"], device)
    c2 = _colour_linear(params["c2"], device)
    rgb = f[..., None] * c1 + (1.0 - f[..., None]) * c2
    lx, ly, lz = (_f32(params[k], device) for k in ("lx", "ly", "lz"))
    lamp = _colour_linear(params["lamp"], device)
    gx, gy = _grid(H, W, device)
    d2 = ((gx - lx) ** 2 + (gy - ly) ** 2 + lz ** 2) / (lz ** 2)
    light = torch.clamp(1.6 / d2, 0.25, 1.6)
    out = torch.clamp(rgb * lamp * light[..., None], 0.0, 1.0)
    return (torch.clamp(linear_to_srgb(out), 0.0, 1.0) * 255.0).to(torch.uint8)


def render(key, family: str, H: int = 720, W: int = 1280, *,
           device) -> torch.Tensor:
    """Draw one texture's values from `key` and render it on `device`:
    (H, W, 3) uint8, the JAX package's ``render(key, family, H, W)``."""
    return render_params(family, draw_render_params(family, H, W, key),
                         H, W, device)


def random_texture(key, H: int = 720, W: int = 1280, *,
                   device) -> torch.Tensor:
    """Render a texture of a uniformly drawn family: the family from
    ``randint(key, 0, 7)``, the texture from ``fold_in(key, 7)``, as the
    JAX package's ``random_texture``."""
    fam = FAMILIES[prng.randint(key, 0, len(FAMILIES))]
    return render(prng.fold_in(key, 7), fam, H, W, device=device)
