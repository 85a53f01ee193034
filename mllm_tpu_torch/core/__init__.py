"""Checkpoint config and weight readers (copied from mllm_tpu.core, jax-free)."""
