"""demo_showui: counterpart of `examples/demo_showui.py` of the JAX repo.

ShowUI is a Qwen2-VL-architecture UI-grounding model; this is
`demo_qwen2_vl` with the reference demo's grounding prompt as the default.

  python -m mllm_tpu_torch.examples.demo_showui -m <showui_dir> -i screenshot.png \\
      [--prompt "click the search box"] [demo_qwen2_vl flags]
"""

import sys

from . import demo_qwen2_vl

GROUNDING = ("Based on the screenshot of the page, I give a text description "
             "and you give its corresponding location. The coordinate "
             "represents a clickable location [x, y] for an element, which "
             "is a relative coordinate on the screenshot, scaled from 0 to 1.")
INSERTED = ("--prompt", GROUNDING)  # what the JAX wrapper puts in front unless --prompt is given


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    if INSERTED[0] not in argv:
        argv[0:0] = list(INSERTED)
    return demo_qwen2_vl.main(argv)


if __name__ == "__main__":
    main()
