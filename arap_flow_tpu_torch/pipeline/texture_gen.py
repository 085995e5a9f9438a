"""Random-texture dataset renderer (pipeline/texture_gen.py of the JAX
package): the seven procedural texture families of ``ops.textures``, each
with a random two-colour gradient and point light, rendered on --device and
written as PNGs.

    python -m arap_flow_tpu_torch texture_gen --output DIR --num 100 \\
        [--size 1280 720] [--seed 0] [--families brick checker ...] \\
        [--prefix texture] [--device cuda]

The family of image i comes from a numpy Generator seeded with --seed and
its values from the key ``prng.key(seed·100003 + i)``, as in the JAX
package, so one seed gives the JAX package's files: the same names and
the same images.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp

import numpy as np

from ..io.image import save_image
from ..ops.textures import FAMILIES, render
from ..utils import prng
from ..utils.config import cli_device


def family_sequence(num: int, seed: int, families) -> list:
    """The family of each of `num` images (the JAX package's numpy draw)."""
    rng = np.random.default_rng(seed)
    return [families[rng.integers(0, len(families))] for _ in range(num)]


def main(argv=None):
    p = argparse.ArgumentParser(description="Procedural random texture renderer")
    p.add_argument("--output", required=True)
    p.add_argument("--num", type=int, default=100)
    p.add_argument("--size", nargs=2, type=int, default=[1280, 720],
                   help="[width] [height]")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--families", nargs="*", default=list(FAMILIES),
                   choices=list(FAMILIES))
    p.add_argument("--prefix", default="texture")
    p.add_argument("--device", default="cuda",
                   help="torch device that renders (default cuda)")
    a = p.parse_args(argv)
    device = cli_device(a.device)

    os.makedirs(a.output, exist_ok=True)
    W, H = a.size
    for i, fam in enumerate(family_sequence(a.num, a.seed, a.families)):
        key = prng.key(a.seed * 100003 + i)
        img = render(key, fam, H, W, device=device).cpu().numpy()
        save_image(osp.join(a.output, f"{a.prefix}_{i:05d}_{fam}.png"), img)
        if (i + 1) % 25 == 0:
            print(f"{i + 1}/{a.num}")
    print("Done")


if __name__ == "__main__":
    main()
