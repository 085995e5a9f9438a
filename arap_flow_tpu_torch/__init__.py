"""arap_flow_tpu_torch — the PyTorch + CUDA port of ``arap_flow_tpu``.

The dataset pipeline (``para_gen``: frames + masks -> ZNCC matching ->
constraint filter -> annealed Gauss-Newton/PCG solve per segment -> forward
rasterization -> .flo/PNG) and the ARAP deform path run on one NVIDIA H100.
The TPU kernels are hand-written CUDA kernels, built with nvcc on first use
by ``_build.py``: the PCG (``csrc/pcg.cu``), the fused whole-schedule
solver (``csrc/fused_solver.cu``) and the fused z-score + ZNCC search
(``csrc/zncc.cu``). The host library (``native/src/arap_native.cpp``: the
exact splat, the .flo codec, the threaded writer, the JPEG codec) is built
with g++ the same way; everything else is plain torch and numpy. The layout
mirrors ``arap_flow_tpu``, module for module:

- ``io``        .flo codec, matcher output and constraint files, the
                constraint filter, PNG and JPEG IO, PIL-exact resizes and
                mask conventions.
- ``native``    the host library's Python surface and the numpy plain
                version of its splat.
- ``ops``       stencil, ARAP energy operators, PCG and ZNCC kernel
                wrappers, GN solver, rasterizer, the pyramid matcher, the
                two-level warm start.
- ``models``    ``ArapDeformer`` and the batched canvas solve/raster.
- ``parallel``  device meshes: a batch split over devices (``data``), the
                rows of a frame split over devices (``space``).
- ``pipeline``  ``BatchRunner`` and the para_gen / generate / run_arap /
                run_warp / deform / warp CLIs.
- ``utils``     ``FrameworkConfig`` (``ARAP_*`` env vars), ``StageTimer``,
                device-to-host copies on a side stream.

The package imports torch and numpy only (PIL inside the functions that
read or write a format neither codec handles); it never imports jax or
``arap_flow_tpu``.
The device is always explicit: functions take tensors or a ``device=``
argument, and the CLIs take ``--device`` (default ``cuda``).
"""

__version__ = "0.1.0"
