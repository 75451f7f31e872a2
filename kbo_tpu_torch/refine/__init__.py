"""Map refinement orchestration of the port (counterpart of kbo_tpu/refine)."""
