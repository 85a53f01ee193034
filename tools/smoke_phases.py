"""Run some of chip_smoke.py's phases alone on the card: the device line, the
kernel build, then each named phase that takes only the device
(`phase_slice_<name>(dev)`), with its seconds.

    python3 tools/smoke_phases.py train parallel
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402


def main(names) -> None:
    cs.phase_device()
    dev = torch.device("cuda", 0)
    cs.phase_build()
    for name in names:
        cs.timed_phase(f"slice_{name}", lambda: getattr(cs, f"phase_slice_{name}")(dev))


if __name__ == "__main__":
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    main(sys.argv[1:])
