"""Run statistics."""
