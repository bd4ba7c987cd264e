"""svscope_tpu_torch — the PyTorch/CUDA port of svscope_tpu for NVIDIA Hopper.

The JAX package `svscope_tpu` stays the reference; this package mirrors its
layout so each module's counterpart is easy to find:

  io/      BAM/BGZF/FASTA readers and writers (copies)
  native/  ctypes bindings of the host C++ engines, whose sources are the
           port's own copies in csrc/host/ (POA, BAM scan, Ward clustering),
           built with g++ at first use into csrc/_build/
  utils/   device resolution (replaces utils/jaxcfg.py), the nvcc build,
           sequence and interval helpers (copies)
  ops/     the POA aligners (K1, and K3/K4/K5 of the fused build), the NW
           alignment statistics (K2, nw_kernel.py / nw_batch.py) and the
           NumPy oracles (poa.py, nw.py); kernels in csrc/*.cu, each with
           its plain torch version
  models/  the 45-slot folded EM (mixture.py) and the random forest
           (forest.py, with its own copy of the artifact)
  engine/  window payloads, per-window decision, the localGraph engine and
           the AlnFeature stage (features.py)
  out/     VCF emission, merge and adjustment (copies)
  parallel/ the scale-out: a device tuple that splits the engine's batched
           dispatches (dataparallel.py) and the multi-process window stream
           (shard.py); ops/poa_sharded.py
           is the column-sharded wavefront of oversized windows
  cli.py   every subcommand of the JAX CLI
  graft_entry.py  the per-K EM forward and the scale-out dry run

The port imports `torch` and never `jax`, and nothing of `svscope_tpu`: the
modules of the JAX package that never import JAX are copied here, and only
their imports changed.
"""

__version__ = "0.1.0"
