"""demo_qwen_sd: counterpart of `examples/demo_qwen_sd.py` of the JAX repo
(the reference's suffix-automaton speculative decoding), an alias of
`demo_sd`; add --compiled for the loop on the device.

  python -m mllm_tpu_torch.examples.demo_qwen_sd -m <model_dir> [demo_sd flags]
"""

from .demo_sd import main

if __name__ == "__main__":
    main()
