"""The demo CLIs: counterparts of the JAX repo's `examples/` scripts, run as
`python -m mllm_tpu_torch.examples.<name>`.

`demo_llm` is the text demo with every flag; the per-family `demo_*` modules
are its aliases (some add a default flag); `demo_sd` / `demo_qwen_sd` run
speculative decoding. The vision-language demos (`demo_qwen2_vl` with its
alias `demo_showui`, `demo_qwen2_5_vl`, `demo_phi3v`, `demo_fuyu`) and
`demo_opt` decode greedily after an image (or text) prefill; the encoders'
(`demo_clip`, `demo_vit`, `demo_bert`, `demo_imagebind` with its alias
`demo_imagebind_1mod`) print scores; `train_lora` fine-tunes LoRA adapters.
Every CLI runs on the card unless `--device cpu` is given, and has
`main(argv=None)`, which returns what it generated, scored or trained.
"""
