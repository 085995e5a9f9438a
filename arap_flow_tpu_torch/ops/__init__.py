"""Device compute path: stencil, energy operators, PCG, solver, rasterizer."""
