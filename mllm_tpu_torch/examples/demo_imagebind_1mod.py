"""demo_imagebind_1mod: counterpart of `examples/demo_imagebind_1mod.py` of
the JAX repo, which runs `demo_imagebind` as it is (its docstring speaks of
one tower; its code inserts no flag, and neither does this alias).

  python -m mllm_tpu_torch.examples.demo_imagebind_1mod -i image.jpg [demo_imagebind flags]
"""

from . import demo_imagebind


def main(argv=None) -> dict:
    return demo_imagebind.main(argv)


if __name__ == "__main__":
    main()
