"""demo_openelm: counterpart of `examples/demo_openelm.py` of the JAX repo, an alias
of `demo_llm`, which reads the family from the checkpoint's config.json.
Neither package's `generate` drives OpenELM (its model has no
`hidden_states` / `logits`), and neither registry builds one: on an OpenELM
directory this demo raises NotImplementedError, as the JAX one does.

  python -m mllm_tpu_torch.examples.demo_openelm -m <model_dir> [demo_llm flags]
"""

from .demo_llm import alias_main

DEFAULTS = ()


def main(argv=None) -> dict:
    return alias_main(argv, DEFAULTS)


if __name__ == "__main__":
    main()
