"""CI smoke test: the framework end to end on the card (or the CPU when
asked), one machine-readable report. Counterpart of `tools/ci.py` of the JAX
repo (itself the counterpart of the reference's device-farm smoke runner).

  python -m mllm_tpu_torch.tools.ci [--device cuda|cpu] [--dryrun]

Stages: device probe, tiny-model build, prefill + decode generate (greedy),
int8 quantized decode, tokenizer round trip, image preprocess, KV-cache
advance, and with `--dryrun` the multi-rank dry run
(`python -m mllm_tpu_torch.parallel.dryrun --device <the same>`). Each
stage is isolated: a failure records the error and the remaining stages
still run. The report is one JSON line; the process exits 1 when any stage
failed (in process: `main` raises SystemExit(1) after printing it). Runs on
the card unless `--device cpu`; without a card the default raises before any
stage.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

from ..examples._demo_common import add_device_arg, device

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DRYRUN_BUDGET_S = 580


def _stage(report, name, fn):
    t0 = time.perf_counter()
    try:
        detail = fn() or {}
        report["stages"][name] = {"ok": True,
                                  "ms": round((time.perf_counter() - t0) * 1e3, 1),
                                  **detail}
    except Exception as e:  # noqa: BLE001 - recorded in the report, which then fails the run
        report["stages"][name] = {"ok": False,
                                  "ms": round((time.perf_counter() - t0) * 1e3, 1),
                                  "error": f"{type(e).__name__}: {e}",
                                  "trace": traceback.format_exc(limit=3)}


@torch.no_grad()
def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_arg(ap)
    ap.add_argument("--dryrun", action="store_true", help="also run the multi-rank dry run")
    args = ap.parse_args(argv)
    dev = device(args.device)

    from ..core.config import TextConfig
    from ..models.transformer import CausalLM

    report = {"tool": "mllm_tpu_torch-ci-smoke", "stages": {}}

    def probe():
        report["platform"] = dev.type
        if dev.type == "cuda":
            return {"devices": torch.cuda.device_count(), "kind": torch.cuda.get_device_name(dev)}
        return {"devices": 1, "kind": "cpu"}

    _stage(report, "device", probe)

    cfg = TextConfig(vocab_size=256, hidden_size=128, intermediate_size=256,
                     num_hidden_layers=2, num_attention_heads=4,
                     num_key_value_heads=2, max_position_embeddings=256,
                     eos_token_id=-7)
    state = {}

    def build():
        state["model"] = CausalLM.init(cfg, device=dev, dtype=torch.bfloat16,
                                       generator=torch.Generator(device=dev).manual_seed(0))
        return {"params": sum(t.numel() for t in state["model"].state_dict().values())}

    _stage(report, "build", build)

    def _generate(model, new_tokens):
        from ..generation.generate import generate
        from ..generation.sampling import SamplingConfig

        ids = np.arange(16, dtype=np.int64)[None, :] % cfg.vocab_size
        cache = model.init_cache(1, 256, torch.bfloat16)
        res, _ = generate(model, ids, cache,
                          SamplingConfig(max_new_tokens=new_tokens, min_new_tokens=new_tokens))
        toks = res.tokens
        assert len(toks) >= new_tokens and all(t >= 0 for t in toks), toks
        return {"tokens": len(toks), "ttft_ms": round(res.ttft_s * 1e3, 1)}

    _stage(report, "generate", lambda: _generate(state["model"], 8))

    def quantized():
        from ..ops.quantize_model import quantize_model

        # the port quantizes in place; the JAX tool quantizes a copy
        return _generate(quantize_model(copy.deepcopy(state["model"]), "int8", min_size=1), 4)

    _stage(report, "int8_decode", quantized)

    def tokenizer():
        from ..tokenizers.base import text_to_byte_units
        from ..tokenizers.bpe import ByteLevelBPE

        text = "ci smoke"
        units = sorted(set(text_to_byte_units(text)))
        vocab = {u: i for i, u in enumerate(units)}
        tok = ByteLevelBPE(vocab, list(units), {})
        ids = tok.encode_ordinary(text)
        assert tok.decode(ids) == text, tok.decode(ids)
        return {"ids": len(ids)}

    _stage(report, "tokenizer", tokenizer)

    def image():
        from ..processor.image import smart_resize

        h, w = smart_resize(480, 640, factor=28)
        assert h % 28 == 0 and w % 28 == 0
        return {"resized": [h, w]}

    _stage(report, "image_preprocess", image)

    def kv_cache():
        cache = state["model"].init_cache(1, 64, torch.bfloat16)
        assert int(cache.pos) == 0
        cache2 = cache.advance(5)
        assert int(cache2.pos) == 5

    _stage(report, "kv_cache", kv_cache)

    def multichip_dryrun():
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (_ROOT, os.environ.get("PYTHONPATH")) if p))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "mllm_tpu_torch.parallel.dryrun", "--device", dev.type],
                              cwd=_ROOT, env=env, capture_output=True, text=True, timeout=DRYRUN_BUDGET_S)
        elapsed = time.perf_counter() - t0
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert "dryrun OK" in proc.stdout, proc.stdout[-500:]
        return {"elapsed_s": round(elapsed, 1), "budget_s": DRYRUN_BUDGET_S}

    if args.dryrun:
        _stage(report, "multichip_dryrun", multichip_dryrun)

    report["ok"] = all(s["ok"] for s in report["stages"].values())
    print(json.dumps(report), flush=True)
    if not report["ok"]:
        raise SystemExit(1)
    return report


if __name__ == "__main__":
    main()
