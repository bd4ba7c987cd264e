"""Scale-out of the port (counterpart of svscope_tpu/parallel/).

  dataparallel  the process-wide device tuple ("mesh") that splits every
                batched dispatch's window axis, and the cross-device sums
  mesh          the example EM batch of graft_entry's forward (the
                read-parallel EM itself lives in models/mixture)
  shard         the multi-process window stream (gloo rendezvous, one card
                a process, host-0 merge through the filesystem)

One process drives a tuple of its local devices, as the JAX package's
shard_map drives `jax.local_devices()`: batches are split in Python, each
chunk launched on its device before any is fetched, and the only
cross-device traffic is plain tensor copies (peer copies over NVLink on a
multi-GPU node).  No NCCL collective is used.
"""
