"""Probes of the quantized prefill attention kernel: copies of
`csrc/flash_attention_quant.cu` (and the consumer header it includes) with
one part of the work taken out, timed beside the kernel on the main rows.

    python3 tools/flash_quant_probes.py [--out build/kernels/probes] [--reps 3]

Each probe is a copy of the csrc directory with a text substitution (the
script fails if a pattern is not found, so a probe never runs a stale copy):

  idle      the consumers issue no products (every tile is skipped): the
            producer's loads and conversion alone set the time;
  noconv    the converters write zeros and read nothing: the consumers, the
            ring and the loads alone;
  nomath    the converters load and store as the kernel does but do no
            arithmetic: the shared-memory traffic without the conversion;
  cpscales  the scales of a raw stage come by 4-byte cp.async from the first
            producer warp (32 arrivals) instead of a TMA box.

The probes' outputs are wrong by design (their max |kernel - plain| is
printed and ignored). Then `tools/attention_tune.py --kernel flash_quant
--rows main` times the kernel, the probes and the bf16 kernel over the same
keys (`bf16`), in turns.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "mllm_tpu_torch", "csrc")
QUANT = "flash_attention_quant.cu"
HEADER = "flash_attention.cuh"

PROBES = {
    "idle": [(HEADER, "  const int it_a = min(ntiles, max(0, (wlo - kb0) / kBK));",
              "  const int it_a = ntiles;")],
    "noconv": [(QUANT, "        const uint4 c = scaled_chunk(int8_pair(w[k].x), int8_pair(w[k].x >> 8), int8_pair(w[k].y),\n"
                       "                                     int8_pair(w[k].y >> 8), s[k]);",
                "        const uint4 c = zero;"),
               (QUANT, "      w[k] = *reinterpret_cast<const uint2*>(src + (j0 + k) * RS * G::kDS);\n"
                       "      s[k] = sc[(j0 + k) * RS];",
                "      w[k] = make_uint2(0u, 0u);\n      s[k] = 0.f;"),
               (QUANT, "        const uint4 lo_c = scaled_chunk(nibble_pair(w[k].x), nibble_pair(w[k].x >> 8), nibble_pair(w[k].y),\n"
                       "                                        nibble_pair(w[k].y >> 8), s[k]);\n"
                       "        const uint4 hi_c = scaled_chunk(nibble_pair(w[k].x >> 4), nibble_pair(w[k].x >> 12),\n"
                       "                                        nibble_pair(w[k].y >> 4), nibble_pair(w[k].y >> 12), s[k]);",
                "        const uint4 lo_c = zero, hi_c = zero;")],
    "nomath": [(QUANT, "        const uint4 c = scaled_chunk(int8_pair(w[k].x), int8_pair(w[k].x >> 8), int8_pair(w[k].y),\n"
                       "                                     int8_pair(w[k].y >> 8), s[k]);",
                "        const uint4 c = make_uint4(w[k].x, w[k].y, __float_as_uint(s[k]), w[k].x);"),
               (QUANT, "        const uint4 lo_c = scaled_chunk(nibble_pair(w[k].x), nibble_pair(w[k].x >> 8), nibble_pair(w[k].y),\n"
                       "                                        nibble_pair(w[k].y >> 8), s[k]);\n"
                       "        const uint4 hi_c = scaled_chunk(nibble_pair(w[k].x >> 4), nibble_pair(w[k].x >> 12),\n"
                       "                                        nibble_pair(w[k].y >> 4), nibble_pair(w[k].y >> 12), s[k]);",
                "        const uint4 lo_c = make_uint4(w[k].x, w[k].y, __float_as_uint(s[k]), w[k].x);\n"
                "        const uint4 hi_c = make_uint4(w[k].y, w[k].x, __float_as_uint(s[k]), w[k].y);")],
    "cpscales": [(QUANT, "    tma_load_1d(st + G::kRawRowsBytes, m ? tm_vs : tm_ks, bar, plane * p.Skv + key0);\n  };",
                  "  };\n  auto issue_scales = [&](int q) {  // the first warp: 4-byte cp.async, one arrival a lane\n"
                  "    uint8_t* st = raw + (q % R) * G::kRawStage;\n"
                  "    const int m = (q / H) % 2, key0 = c.kb0 + (q / (2 * H)) * kBK + (q % H) * kRawRows;\n"
                  "    const float* scales = m ? scales_v : scales_k;\n"
                  "    for (int i = ptid; i < kRawRows; i += 32) {\n"
                  "      const int j = key0 + i;\n"
                  "      const bool ok = j >= c.lo && j < c.hi;\n"
                  "      cp_async_4(reinterpret_cast<float*>(st + G::kRawRowsBytes) + i,\n"
                  "                 scales + (ok ? (long)plane * p.Skv + j : 0), ok);\n"
                  "    }\n"
                  "    cp_async_mbar_arrive(&raw_full[q % R]);\n"
                  "  };"),
                 (QUANT, "    mbar_arrive_expect_tx(bar, G::kRawStage);", "    mbar_expect_tx(bar, G::kRawRowsBytes);"),
                 (QUANT, "  if (ptid == 0)\n    for (int q = 0; q < min(R, parts); ++q) issue(q);",
                  "  if (ptid == 0)\n    for (int q = 0; q < min(R, parts); ++q) issue(q);\n"
                  "  if (ptid < 32)\n    for (int q = 0; q < min(R, parts); ++q) issue_scales(q);"),
                 (QUANT, "          if (ptid == 0) issue(q + R);",
                  "          if (ptid == 0) issue(q + R);\n          if (ptid < 32) issue_scales(q + R);"),
                 (QUANT, "    for (int i = 0; i < G::kRaw; ++i) mbar_init(&raw_full[i], 1);",
                  "    for (int i = 0; i < G::kRaw; ++i) mbar_init(&raw_full[i], 32);"),
                 (QUANT, "  using G = Geo<D, kInt4>;\n  constexpr int R = G::kRaw, H = G::kParts, kDH = D / kSwz;",
                  "  using G = Geo<D, kInt4>;\n  constexpr int R = G::kRaw, H = G::kParts, kDH = D / kSwz;\n"
                  "  const float* scales_k = reinterpret_cast<const float*>(p.scales_k);\n"
                  "  const float* scales_v = reinterpret_cast<const float*>(p.scales_v);"),
                 (HEADER, "  float scale_log2;  // the factor of the f32 scores",
                  "  const void* scales_k;\n  const void* scales_v;\n  float scale_log2;  // the factor of the f32 scores"),
                 (QUANT, "window, (Sq + kBQ - 1) / kBQ, 1.f, static_cast<const int*>(q_offset_dev)};",
                  "window, (Sq + kBQ - 1) / kBQ, ks, vs, 1.f, static_cast<const int*>(q_offset_dev)};")],
}


def make_probe(name: str, out: str) -> str:
    """A copy of csrc with the probe's substitutions; returns its directory."""
    dst = os.path.join(out, name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(CSRC, dst)
    for file, old, new in PROBES[name]:
        path = os.path.join(dst, file)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            raise ValueError(f"probe {name}: the pattern to replace is not in {file} exactly once:\n{old}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return dst


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "kernels", "probes"))
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    variants = ["--variant", f"new={CSRC}"]
    for name in PROBES:
        variants += ["--variant", f"{name}={make_probe(name, args.out)}"]
    variants += ["--variant", "bf16=x"]
    cmd = [sys.executable, os.path.join(ROOT, "tools", "attention_tune.py"), "--kernel", "flash_quant",
           "--rows", "main", "--reps", str(args.reps), *variants]
    sys.exit(subprocess.call(cmd))


if __name__ == "__main__":
    main()
