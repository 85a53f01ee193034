"""Run some of chip_smoke.py's phases alone on the card: the device line, the
kernel build, then each named phase with its seconds: a phase that takes only
the device (`phase_slice_<name>(dev)`), `kvq` (slice_kvq over the int8 model
that slice_int8 builds first, untimed), `quant_rows` (the kernel check's
quantized attention rows at head_dim 128 and 256 and the device-scalar rows
of the split 256 kernel, int8 and int4), or `tp_rows` (the kernel check's
rows at tensor parallelism's head splits and int4 cuts, `tp_split_rows` and
`tp_int4_split_rows`).

    python3 tools/smoke_phases.py train parallel
    python3 tools/smoke_phases.py quant_rows kvq cli entry
    python3 tools/smoke_phases.py tp_rows parallel
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402


def quant_rows(dev) -> None:
    g = torch.Generator(device=dev).manual_seed(1234)
    cs.quant_attention_rows(dev, g, cs.QUANT_FLASH_ROWS, cs.QUANT_DECODE_ROWS)
    cs.quant_attention_rows(dev, g, cs.QUANT_FLASH_ROWS_256, cs.QUANT_DECODE_ROWS, cs.WIDE_GEO, "@256",
                            route_sdpa=True)
    for bits in (8, 4):
        cs.quant_device_scalar_row(dev, g, cs.WIDE_GEO, cs.WIDE_SCALAR_ROW, bits)


def main(names) -> None:
    cs.phase_device()
    dev = torch.device("cuda", 0)
    cs.phase_build()
    for name in names:
        if name == "quant_rows":
            cs.timed_phase("quant_rows", lambda: quant_rows(dev))
        elif name == "tp_rows":
            g = torch.Generator(device=dev).manual_seed(1234)
            cs.timed_phase("tp_rows", lambda: (cs.tp_split_rows(dev, g), cs.tp_int4_split_rows(dev, g)))
        elif name == "kvq":
            _, model8 = cs.phase_slice_quant(dev, "int8", keep=True)
            cs.timed_phase("slice_kvq", lambda: cs.phase_slice_kvq(dev, model8))
            del model8
            torch.cuda.empty_cache()
        else:
            cs.timed_phase(f"slice_{name}", lambda: getattr(cs, f"phase_slice_{name}")(dev))


if __name__ == "__main__":
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    main(sys.argv[1:])
