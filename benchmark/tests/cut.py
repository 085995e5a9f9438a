"""A cut of both cells that the CPU runs in seconds: small frames, few
frames, a short schedule, and limits set for that cut."""

DAVIS = {"height": 144, "width": 192, "sequences": [3, 2], "sample_pairs": 3,
         "objects": [
             {"id": 1, "start": 0.0, "scale": 1.0, "nonrigid": 0,
              "sizes": [[20, 30], [24, 36], [28, 40]],
              "centre_y": [2, 40, 60, 0], "centre_x": [3, 50, 70, 0]},
             {"id": 2, "start": 1.0, "scale": 1.0, "nonrigid": 3.0,
              "sizes": [[36, 40], [38, 44]],
              "centre_y": [2, 95, 105, 1], "centre_x": [2, 130, 140, 2]}]}
SINTEL = {"height": 96, "width": 160, "frames": 2, "sample_pairs": 4,
          "objects": [
              {"id": 1, "start": 0.0, "scale": 1.0, "nonrigid": 0,
               "sizes": [[20, 60]], "centre_y": [2, 30, 40, 0],
               "centre_x": [3, 70, 90, 0]},
              {"id": 2, "start": 0.0, "scale": 1.0, "nonrigid": 3.0,
               "sizes": [[36, 40]], "centre_y": [1, 55, 58, 0],
               "centre_x": [2, 100, 110, 0]}]}
# 2 x 2 x 30: far from converged, so the program and the reference part
# by more than at the full schedule; limits for this cut only
CUT = {"schedule": [2, 2, 30],
       "limits": {"flow_epe_px": 0.1, "wmask_mismatch": 0.01,
                  "wrgb_mean_abs": 1.0, "sample_missing": 0.0}}
CELLS = {"davis480.seq24": DAVIS, "sintel1024.passes": SINTEL}


def run(cell: str, seed: int = 123456789012, trace: bool = False):
    """One harness run of `cell` on the CPU at the cut: (code, result)."""
    import time

    from benchmark import harness

    limits = dict(CUT["limits"])
    if cell.startswith("davis"):
        limits["inp_max_abs"] = 0.0
    return harness.run_cell(cell, seed, 0.1, trace, time.time(),
                            device="cpu", require_chip=False,
                            cfg_override={**CUT, "limits": limits},
                            wl_override=CELLS[cell])
