"""Utilities (reference L11): kernel profiler, receiver checkpointing,
compile-cache placement."""
