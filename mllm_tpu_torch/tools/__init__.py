"""The model-file and check tools: counterparts of the JAX repo's `tools/`
scripts, run as `python -m mllm_tpu_torch.tools.<name>`: `convertor`
(safetensors / torch .bin -> `.mllm`, and the vocab), `quantizer` (`.mllm`
f32 -> ggml blocks), `rotate` (the v/o rotation before quantizing), `ci`
(the staged smoke test with its one-line JSON report), `reference_parity`
(the C++ engine's golden ids from deterministic checkpoints) and
`make_tiny_fixtures` (two tiny HF directories; a CPU tool that needs
`transformers`)."""
