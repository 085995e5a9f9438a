"""The card tests' constants recorded from the JAX package, which the
card's machine does not have (tests/torch_card.py): the texture families'
draws and 64x96 render checksums (``TEX_JAX_DRAWS``, ``TEX_JAX_SUMS``),
texture_gen's first family and checksums (``TEXGEN_JAX_FIRST``) and the
per-object flow errors of the JAX package's own dmo_gen run on the mask
tree (``DMO_JAX_ERRS``), with the DMO flow gate built on them.

The tests hold the texture constants to JAX's draws and renders, the
untracked object to the near-uniform texture JAX draws for it, and the
gate to the card's readings and to wrong flows. ``DMO_JAX_ERRS`` itself
comes from a JAX dmo_gen run at 19x8x400 on the CPU (about 18 minutes),
too long for a test: run as a script, this file prints every constant, and
``--dmo`` adds the DMO errors:

    JAX_PLATFORMS=cpu python tests/test_torch_smoke_constants.py [--dmo]
"""

import os
import sys
import tempfile
import zlib

import jax
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_card as C  # noqa: E402
from arap_flow_tpu.ops import textures as JT  # noqa: E402
from test_torch_textures import jax_render_params  # noqa: E402


def jax_draws(i: int, fam: str) -> dict:
    return jax_render_params(fam, jax.random.PRNGKey(80 + i), C.TEX_H,
                             C.TEX_W)


def jax_sums(i: int, fam: str) -> tuple:
    return C.texture_sums(np.asarray(JT.render(jax.random.PRNGKey(80 + i),
                                               fam, 64, 96)))


@pytest.mark.parametrize("i,fam", list(enumerate(JT.FAMILIES)))
def test_phase_8a_constants_are_jax(i, fam):
    assert C.TEX_JAX_DRAWS[fam] == jax_draws(i, fam)
    assert C.TEX_JAX_SUMS[fam] == jax_sums(i, fam)


def jax_texture_gen_first(seed: int) -> tuple:
    """The JAX package's texture_gen at `seed`: the first image's family
    (its numpy draw) and the checksums of that family's 64x96 render from
    the first image's key, PRNGKey(seed * 100003)."""
    rng = np.random.default_rng(seed)
    fam = list(JT.FAMILIES)[rng.integers(0, len(JT.FAMILIES))]
    return fam, C.texture_sums(np.asarray(JT.render(
        jax.random.PRNGKey(seed * 100003), fam, 64, 96)))


def test_phase_11d_constant_is_jax():
    assert C.TEXGEN_JAX_FIRST == jax_texture_gen_first(C.TEXGEN_SEED)


def _jax_dmo_texture(obj: int) -> np.ndarray:
    """The texture the JAX package's dmo_gen draws for the mask tree's
    object ``obj``
    (0 the background) at seed 0, and its family."""
    from arap_flow_tpu.pipeline import dmo_gen

    seq_seed = zlib.crc32(b"seq0") % 100000  # dmo_gen.assemble's, seed 0
    return dmo_gen._texture_for(seq_seed * 1000 + obj, C.FRAME_H, C.FRAME_W)


@pytest.mark.parametrize("obj", [1, 2])
def test_phase_8b_untracked_object_is_jax_near_uniform_texture(obj):
    """DMO_UNTRACKED names the objects whose JAX texture is near-uniform:
    object 1's (every channel's standard deviation below 10 grey levels
    inside the object), not object 2's."""
    tex = _jax_dmo_texture(obj).astype(np.float64)
    yy, xx = np.mgrid[0:C.FRAME_H, 0:C.FRAME_W]
    sel = C.pipe_object(obj - 1, 0, yy, xx)
    # dmo_gen samples the object's texture at its frame position + (H/2, W/2)
    patch = tex[C.FRAME_H // 2:C.FRAME_H // 2 + C.FRAME_H,
                C.FRAME_W // 2:C.FRAME_W // 2 + C.FRAME_W][sel]
    near_uniform = bool((patch.std(axis=0) < 10.0).all())
    assert near_uniform == (obj in C.DMO_UNTRACKED), patch.std(axis=0)


# dmo_gen's readings on the card (NVIDIA H100 80GB HBM3, 700 W) on the
# mask tree: median |flow - fd*t| by (fd, pair, object)
CARD_DMO_ERRS = {
    (1, 0, 1): 5.8624, (1, 0, 2): 0.8785, (1, 1, 1): 4.2926,
    (1, 1, 2): 0.5549, (1, 2, 1): 5.5131, (1, 2, 2): 1.1347,
    (1, 3, 1): 3.6302, (1, 3, 2): 1.1461, (2, 0, 1): 10.8438,
    (2, 0, 2): 0.7412, (2, 1, 1): 11.9482, (2, 1, 2): 1.6106,
    (2, 2, 1): 12.7189, (2, 2, 2): 0.5865,
}


@pytest.mark.parametrize("fd,t,obj", sorted(C.DMO_JAX_ERRS))
def test_phase_8b_flow_gate(fd, t, obj):
    """The gate passes the card's reading at every object-pair and fails a
    flow that moves the object the wrong way, by the other object's
    motion, or not at all where JAX tracks it, and an error that is not
    finite."""
    assert set(CARD_DMO_ERRS) == set(C.DMO_JAX_ERRS)
    assert C.dmo_flow_gate(fd, t, obj, CARD_DMO_ERRS[(fd, t, obj)]) is None
    motion = [fd * np.array(m[2], float) for m in C.PIPE_OBJECTS]
    own, other = motion[obj - 1], motion[2 - obj]
    wrong = {"reversed": 2 * np.hypot(*own),
             "other object's": np.hypot(*(own - other)),
             "nan": float("nan")}
    if obj not in C.DMO_UNTRACKED:
        wrong["none"] = np.hypot(*own)
        ref = C.DMO_JAX_ERRS[(fd, t, obj)]
        wrong["JAX's + 0.6 px"] = ref + 0.6
    for what, err in wrong.items():
        assert C.dmo_flow_gate(fd, t, obj, float(err)) is not None, what


def jax_dmo_errs() -> dict:
    """Each object's median |flow - fd*(dx, dy)| of the JAX package's
    dmo_gen on the mask tree (set 0, seed 0, batched multseg,
    19x8x400)."""
    from arap_flow_tpu.io.flo import flow_read
    from arap_flow_tpu.io.image import load_mask
    from arap_flow_tpu.ops.solver import SolverConfig
    from arap_flow_tpu.pipeline import dmo_gen

    with tempfile.TemporaryDirectory() as tmp:
        masks, out = os.path.join(tmp, "masks"), os.path.join(tmp, "out")
        C.make_mask_tree(masks)
        dmo_gen.run(masks, out, fds=list(C.DMO_FDS), seed=0, multseg=True,
                    mode="batched", solver_cfg=SolverConfig())
        errs = {}
        for fd in C.DMO_FDS:
            for t in range(C.PIPE_FRAMES - fd):
                mk = load_mask(os.path.join(masks, "orgMasks", "seq0",
                                            f"{t:05d}.png"))
                u, v = flow_read(os.path.join(out, f"fd{fd}", "Flow", "seq0",
                                              f"{t:05d}.flo"))
                for k, (_, _, (dx, dy)) in enumerate(C.PIPE_OBJECTS):
                    obj = mk == k + 1
                    errs[(fd, t, k + 1)] = round(float(np.median(np.hypot(
                        u[obj] - fd * dx, v[obj] - fd * dy))), 3)
    return errs


if __name__ == "__main__":
    for i, fam in enumerate(JT.FAMILIES):
        print(f"{fam}: draws {jax_draws(i, fam)}; sums {jax_sums(i, fam)}")
    print("TEXGEN_JAX_FIRST =", jax_texture_gen_first(C.TEXGEN_SEED))
    if "--dmo" in sys.argv:
        print("DMO_JAX_ERRS =", jax_dmo_errs())
