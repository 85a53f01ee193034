"""Tokenizers and chat templates, copied from mllm_tpu.tokenizers (pure Python, numpy, regex)."""
