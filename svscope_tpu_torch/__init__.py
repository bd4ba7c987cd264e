"""svscope_tpu_torch — the PyTorch/CUDA port of svscope_tpu for NVIDIA Hopper.

The JAX package `svscope_tpu` stays the reference; this package mirrors its
layout so each module's counterpart is easy to find:

  utils/   device resolution and dtype map (replaces utils/jaxcfg.py)
  ops/     the POA aligner: plain torch version (poa_device.py), the
           hand-written CUDA kernel's wrapper (poa_align.py, source in
           csrc/poa_align.cu) and the batched multi-window MSA driver
           (poa_batch.py)
  models/  the 45-slot folded EM with BIC model selection (mixture.py)
  engine/  per-window decision and the localGraph driver
  cli.py   the `localGraph` subcommand

The port imports `torch` and never `jax`.  JAX-free modules of
`svscope_tpu` (io, native, engine.datamaker, utils.seq, ops.poa) are
imported unchanged.
"""

__version__ = "0.1.0"
