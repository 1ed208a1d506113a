"""Utilities: debug dumps, checkpointing, profiling."""
