"""Offline quantizer: `.mllm` f32 -> quantized `.mllm`. Counterpart of
`tools/quantizer.py` of the JAX repo (the reference quantizer's flag ->
dtype map and its per-tensor skip rules: norms, biases and embeddings stay
f32), on the port's copy of the ggml quantizers (`core/dtypes.py`).

  python -m mllm_tpu_torch.tools.quantizer model.mllm model_q4_k.mllm Q4_K

Supported: Q4_0, Q8_0, Q2_0, Q4_K, Q6_K, Q2_K, Q3_K, Q8_K and the
row-interleaved Q4_0_4_4. Pure numpy on the host: it launches nothing on a
device.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..core import dtypes as dt
from ..core.param_loader import MllmWriter, ParamLoader

SKIP_SUBSTRINGS = (
    "norm", "ln_", "layernorm", "bias", "rotary", "position", "pos_embed",
    "cls_token", "logit_scale", "embed_tokens", "token_embedding", "lm_head.bias",
)

QUANTIZERS = {
    "Q4_0": (dt.quant_q4_0, dt.DataType.Q4_0),
    "Q8_0": (dt.quant_q8_0, dt.DataType.Q8_0),
    "Q4_K": (dt.quant_q4_k, dt.DataType.Q4_K),
    "Q6_K": (dt.quant_q6_k, dt.DataType.Q6_K),
    "Q2_0": (dt.quant_q2_0, dt.DataType.Q2_0),
    "Q2_K": (dt.quant_q2_k, dt.DataType.Q2_K),
    "Q3_K": (dt.quant_q3_k, dt.DataType.Q3_K),
    "Q8_K": (dt.quant_q8_k, dt.DataType.Q8_K),
}
DTYPES = (*QUANTIZERS, "Q4_0_4_4")


def should_quantize(name: str, n_elems: int) -> bool:
    low = name.lower()
    if any(s in low for s in SKIP_SUBSTRINGS):
        return False
    return n_elems % 256 == 0 and n_elems >= 1 << 14


def hidden_dim(src: ParamLoader) -> int:
    """The hidden width H of a flat container (it stores no shapes), found
    the reference's way: the first f32 `model*norm` tensor (not q/k norms)."""
    for name in src:
        if ("model" in name and "norm" in name and "k" not in name
                and "q" not in name and src[name].dtype == dt.DataType.F32):
            return src[name].size // 4
    raise SystemExit("Q4_0_4_4: no `model*norm` tensor to infer hidden dim from")


def row_width(name: str, n_elems: int, hidden: int) -> int:
    """A weight's row width: H, or n_elems / H for the down-projection family."""
    return n_elems // hidden if any(s in name for s in ("w2", "down_proj", "down")) else hidden


def quantize_q4_0_4x4_file(inp: str, outp: str) -> tuple:
    """GemmPack row-interleaved Q4_0 writer (the reference's QuantWriter):
    rows of `row_width` under the hidden width of the pre-scan; tensors
    whose row width is not a multiple of 32, or whose row count is not a
    multiple of 4, stay f32. Returns (quantized, kept)."""
    src = ParamLoader(inp)
    hidden = hidden_dim(src)
    writer = MllmWriter(outp)
    nq = nf = 0
    for name in src:
        e = src[name]
        arr = src.raw(name).view(np.float32) if e.dtype == dt.DataType.F32 else None
        if arr is None or not should_quantize(name, arr.size):
            writer.add(name, bytes(src.raw(name)), e.dtype)
            nf += 1
            continue
        k = row_width(name, arr.size, hidden)
        if k % 32 or arr.size % (4 * k):
            writer.add(name, bytes(src.raw(name)), dt.DataType.F32)
            nf += 1
            continue
        writer.add(name, dt.quant_q4_0_4x4(arr, k).tobytes(), dt.DataType.Q4_0_4_4)
        nq += 1
    writer.write()
    print(f"quantized {nq} tensors to Q4_0_4_4 (hidden={hidden}), kept {nf} -> {outp}")
    return nq, nf


def quantize_file(inp: str, outp: str, dtype: str) -> tuple:
    """Every f32 tensor the skip rules allow as `dtype` blocks; the others
    copied as they are. Returns (quantized, kept)."""
    if dtype == "Q4_0_4_4":
        return quantize_q4_0_4x4_file(inp, outp)
    quant, kind = QUANTIZERS[dtype]
    src = ParamLoader(inp)
    writer = MllmWriter(outp)
    nq = nf = 0
    for name in src:
        e = src[name]
        if e.dtype != dt.DataType.F32:
            writer.add(name, bytes(src.raw(name)), e.dtype)
            nf += 1
            continue
        arr = src.raw(name).view(np.float32)
        if should_quantize(name, arr.size):
            writer.add(name, quant(arr).tobytes(), kind)
            nq += 1
        else:
            writer.add(name, bytes(src.raw(name)), dt.DataType.F32)
            nf += 1
    writer.write()
    print(f"quantized {nq} tensors to {dtype}, kept {nf} as-is -> {outp}")
    return nq, nf


def main(argv=None) -> tuple:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("dtype", choices=DTYPES)
    args = ap.parse_args(argv)
    return quantize_file(args.input, args.output, args.dtype)


if __name__ == "__main__":
    main()
