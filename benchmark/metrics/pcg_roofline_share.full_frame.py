"""pcg_roofline_share.full_frame: pcg_roofline_share's reading in the cells
of whole-frame solves, whose end-to-end metric is pairs_per_s.full_frame:
its runs spread a tenth as much as the crop path's, so it takes a bound of
its own."""

from benchmark.harness import metric_reader

read = metric_reader("pcg_roofline_share")
