"""The general code of the benchmark: the manifest and its files
(manifest), the inputs made from the seed (inputs), the systems under
test (systems), the spans and the device trace (spans, trace), the least
time of the formal solution (work), the comparison with the plain
reference (check) and one run of a cell (runner)."""
