"""The plain reference of the localGraph engine: what a window's Raw.bed row
must be.  It imports neither jax, svscope_tpu nor svscope_tpu_torch, and
takes nothing the program made: it aligns the windows' reads itself
(`poa.py`, a frozen copy of the NumPy POA oracle), selects the feature
columns and clusters the reads itself (`msa.py`, `em.py`) and builds the
row (`pipeline.py`).  This package file imports nothing, so the worker
processes that run the alignments import NumPy alone."""
