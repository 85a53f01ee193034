"""demo_smallthinker_mbp: counterpart of `examples/demo_smallthinker_mbp.py` of the JAX repo, an alias
of `demo_llm`, which reads the family from the checkpoint's config.json.
Defaults to `--mbp 2` (the variant this demo exists for).

  python -m mllm_tpu_torch.examples.demo_smallthinker_mbp -m <model_dir> [demo_llm flags]
"""

from .demo_llm import alias_main

DEFAULTS = ('--mbp', '2')


def main(argv=None) -> dict:
    return alias_main(argv, DEFAULTS)


if __name__ == "__main__":
    main()
