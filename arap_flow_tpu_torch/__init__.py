"""arap_flow_tpu_torch — the PyTorch + CUDA port of ``arap_flow_tpu``.

The ARAP deform path (constraints + mask -> annealed Gauss-Newton/PCG solve ->
flow -> forward rasterization -> .flo/PNG) runs on one NVIDIA H100. The
resident PCG, the one TPU kernel on that path, is a hand-written CUDA kernel
(``csrc/pcg.cu``, built with nvcc on first use by ``_build.py``); everything
else is plain torch. The layout mirrors ``arap_flow_tpu``, module for module:

- ``io``        .flo codec, constraint files, PNG/mask IO (numpy copies).
- ``ops``       stencil, ARAP energy operators, PCG kernel wrapper, GN solver,
                rasterizer.
- ``models``    ``ArapDeformer`` and the batched canvas solve/raster.
- ``pipeline``  ``BatchRunner`` and the deform / warp CLIs.
- ``utils``     ``FrameworkConfig`` (``ARAP_*`` env vars), ``StageTimer``.

The package imports torch and numpy only; it never imports jax or
``arap_flow_tpu``. The device is always explicit: functions take tensors or a
``device=`` argument, and the CLIs take ``--device`` (default ``cuda``).
"""

__version__ = "0.1.0"
