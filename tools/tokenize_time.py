"""Host time of encoding the served prompts with the port's tokenizer, beside
the JAX package's native merge core where that package can be imported.

    python3 tools/tokenize_time.py [--repeats 5]

The tokenizer is chip_smoke.synthetic_tokenizer at the Qwen2-VL-2B
vocabulary (151936 entries, byte-level BPE with merges, seed 11 as in the
smoke's slice_containers), written to a temporary tokenizer.json and loaded
through `from_tokenizer_json`. The prompts are chip_smoke.prompt_texts at
SERVE_LENS (17-300 tokens, what slice_serve sends). For each tokenizer it
prints one JSON line: the load seconds, then for every prompt its token
count and the median over --repeats of the encode time cold (the word cache
emptied first) and warm (the same text again), and the sums over the eight
prompts. The JAX package's ByteLevelBPE builds its native merge table on its
first encode; that one-off time is printed apart (`native_table_ms`). A
machine without `mllm_tpu` and JAX prints the port's line only. Then the
host's CPU model, and the card's name and power limit where `nvidia-smi`
answers.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from mllm_tpu_torch.tokenizers.hf_json import from_tokenizer_json  # noqa: E402

VOCAB = 151936


def encode_times(tok, texts, repeats: int) -> dict:
    """Per prompt: tokens, median cold and warm encode ms."""
    rows = []
    for text in texts:
        cold, warm = [], []
        for _ in range(repeats):
            tok._cache.clear()
            t0 = time.perf_counter()
            ids = tok.encode(text, bos=True)
            cold.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            tok.encode(text, bos=True)
            warm.append((time.perf_counter() - t0) * 1e3)
        rows.append(dict(tokens=len(ids), cold_ms=float(np.median(cold)), warm_ms=float(np.median(warm))))
    return dict(prompts=rows, cold_ms_sum=sum(r["cold_ms"] for r in rows),
                warm_ms_sum=sum(r["warm_ms"] for r in rows))


def jax_loader():
    """The JAX package's `from_tokenizer_json`, or None where it does not import."""
    try:
        from mllm_tpu.tokenizers.hf_json import from_tokenizer_json as load
        from mllm_tpu.utils import native
    except ImportError:
        return None, False
    return load, native.available()


def cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return "unknown"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "tokenizer.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump(chip_smoke.synthetic_tokenizer(VOCAB, seed=11), f, ensure_ascii=False)
        t0 = time.perf_counter()
        port = from_tokenizer_json(path)
        load_s = time.perf_counter() - t0
        texts = chip_smoke.prompt_texts(port, chip_smoke.SERVE_LENS, seed=21)
        print(json.dumps(dict(tokenizer="port (pure Python merges)", load_s=load_s,
                              **encode_times(port, texts, args.repeats))), flush=True)
        load, native = jax_loader()
        if load is not None:
            t0 = time.perf_counter()
            ref = load(path)
            load_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            ref.encode("warm up the native table", bos=True)
            table_ms = (time.perf_counter() - t0) * 1e3
            res = encode_times(ref, texts, args.repeats)
            same = all(ref.encode(t, bos=True) == port.encode(t, bos=True) for t in texts)
            print(json.dumps(dict(tokenizer="mllm_tpu (native merge core)" if native else "mllm_tpu (Python)",
                                  load_s=load_s, native_table_ms=table_ms, ids_equal_to_port=same, **res)),
                  flush=True)
    print(json.dumps(dict(host_cpu=cpu_model(), cores=os.cpu_count())), flush=True)
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        smi = ""
    print(smi or "no nvidia-smi", flush=True)


if __name__ == "__main__":
    main()
