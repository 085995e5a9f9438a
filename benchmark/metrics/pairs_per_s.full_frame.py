"""pairs_per_s.full_frame: pairs_per_s's reading in the cells of whole-frame
solves, whose end-to-end metric is pairs_per_s.full_frame: its runs spread
a tenth as much as the crop path's, so it takes a bound of its own."""

from benchmark.harness import metric_reader

read = metric_reader("pairs_per_s")
