"""Scaling over several devices (parallel/ of the JAX package).

The JAX package expresses the reference's round-robin multi-GPU process
farm (para_gen.py:441-445, 560-567) as a device mesh with two axes; here a
``Mesh`` is a (data, space) array of ``torch.device``s:

- ``data``: frame pairs and segments split over devices, each owning whole
  problems, with no communication during a solve (``mesh.py``);
- ``space``: image rows split over devices, with 1-row halos for the
  stencil and summed PCG dot products, for a frame larger than one device
  (``spatial.py``; off by default).
"""

from .mesh import Mesh, make_mesh, shard_batch, solve_batch_sharded  # noqa: F401
from .spatial import solve_spatial  # noqa: F401
