"""Host reference implementations of the pipeline operations."""
