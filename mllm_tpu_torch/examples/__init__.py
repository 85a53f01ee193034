"""The demo CLIs: counterparts of the JAX repo's `examples/` scripts, run as
`python -m mllm_tpu_torch.examples.<name>`.

`demo_llm` is the text demo with every flag; the per-family `demo_*` modules
are its aliases (some add a default flag); `demo_sd` / `demo_qwen_sd` run
speculative decoding. Every CLI runs on the card unless `--device cpu` is
given, and has `main(argv=None)`, which returns what it generated.
"""
