"""The benchmark of svscope_tpu_torch's localGraph engine on the H100.

`run.py` runs one cell of BENCHMARK.json once.  Everything that belongs to
one configuration, traffic mix, per-layer metric or cell's correctness
limits lives in a file of its own (configs/, traffic/, metrics/, limits/),
found by the name BENCHMARK.json gives.  The plain reference that decides
`correct` is in reference/ and imports nothing of the program.
"""
