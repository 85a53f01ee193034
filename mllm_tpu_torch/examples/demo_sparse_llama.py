"""demo_sparse_llama: counterpart of `examples/demo_sparse_llama.py` of the JAX repo, an alias
of `demo_llm`, which reads the family from the checkpoint's config.json.
Defaults to `--sparse 0.0` (the variant this demo exists for).

  python -m mllm_tpu_torch.examples.demo_sparse_llama -m <model_dir> [demo_llm flags]
"""

from .demo_llm import alias_main

DEFAULTS = ('--sparse', '0.0')


def main(argv=None) -> dict:
    return alias_main(argv, DEFAULTS)


if __name__ == "__main__":
    main()
