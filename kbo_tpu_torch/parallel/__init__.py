"""Multi-device execution: device meshes, sharded batches, result merge
(counterpart of kbo_tpu/parallel)."""
