"""arap_flow_tpu_torch — the PyTorch + CUDA port of ``arap_flow_tpu``.

The dataset pipeline (``para_gen``: frames + masks -> ZNCC matching ->
constraint filter -> annealed Gauss-Newton/PCG solve per segment -> forward
rasterization -> .flo/PNG) and the ARAP deform path run on one NVIDIA H100.
The two TPU kernels on that path are hand-written CUDA kernels, built with
nvcc on first use by ``_build.py``: the resident PCG (``csrc/pcg.cu``) and
the fused z-score + ZNCC search (``csrc/zncc.cu``); everything else is plain
torch. The layout mirrors ``arap_flow_tpu``, module for module:

- ``io``        .flo codec, matcher output and constraint files, the
                constraint filter, a PNG codec and mask conventions.
- ``ops``       stencil, ARAP energy operators, PCG and ZNCC kernel
                wrappers, GN solver, rasterizer, the pyramid matcher.
- ``models``    ``ArapDeformer`` and the batched canvas solve/raster.
- ``pipeline``  ``BatchRunner`` and the para_gen / generate / run_arap /
                run_warp / deform / warp CLIs.
- ``utils``     ``FrameworkConfig`` (``ARAP_*`` env vars), ``StageTimer``.

The package imports torch and numpy only (PIL inside the few functions that
resize or read non-PNG images); it never imports jax or ``arap_flow_tpu``.
The device is always explicit: functions take tensors or a ``device=``
argument, and the CLIs take ``--device`` (default ``cuda``).
"""

__version__ = "0.1.0"
