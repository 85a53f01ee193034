"""demo_phi3: counterpart of `examples/demo_phi3.py` of the JAX repo, an alias
of `demo_llm`, which reads the family from the checkpoint's config.json.

  python -m mllm_tpu_torch.examples.demo_phi3 -m <model_dir> [demo_llm flags]
"""

from .demo_llm import alias_main

DEFAULTS = ()


def main(argv=None) -> dict:
    return alias_main(argv, DEFAULTS)


if __name__ == "__main__":
    main()
