"""Checkpoint convertor: HF safetensors / torch .bin -> `.mllm` container.
Counterpart of `tools/convertor.py` of the JAX repo (the reference's
converter: the same magic 20012 container, every tensor f32), plus the vocab
export (magic 23333).

  python -m mllm_tpu_torch.tools.convertor --input <hf_dir_or_file> --output model.mllm
  python -m mllm_tpu_torch.tools.convertor --input <hf_dir> --output vocab.mllm --vocab

Works on the host alone: it launches nothing on a device.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..core.dtypes import DataType
from ..core.param_loader import MllmWriter, SafetensorsLoader, write_vocab


def convert_weights(inp: str, out: str) -> int:
    """Every tensor of `inp` as f32 into the `.mllm` file `out`; returns how many."""
    writer = MllmWriter(out)
    if inp.endswith(".bin") or inp.endswith(".pt"):
        import torch

        sd = torch.load(inp, map_location="cpu", weights_only=True)
        items = ((k, v.float().numpy()) for k, v in sd.items())
    else:
        loader = SafetensorsLoader(inp)
        items = ((name, loader.load(name, None, np.float32)) for name in loader)
    n = 0
    for name, arr in items:
        writer.add(name, np.ascontiguousarray(arr, np.float32), DataType.F32)
        n += 1
    writer.write()
    print(f"wrote {n} tensors -> {out}")
    return n


def convert_vocab(inp: str, out: str) -> int:
    """The tokenizer.json's tokens (and scores) of `inp` as a `.mllm` vocab file."""
    from ..tokenizers.hf_json import from_tokenizer_json

    tok = from_tokenizer_json(inp)
    scores = getattr(tok, "scores", None)
    write_vocab(out, tok.id_to_token, scores)
    print(f"wrote vocab ({len(tok.id_to_token)} tokens) -> {out}")
    return len(tok.id_to_token)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--vocab", action="store_true", help="export vocab instead of weights")
    args = ap.parse_args(argv)
    if args.vocab:
        return convert_vocab(args.input, args.output)
    return convert_weights(args.input, args.output)


if __name__ == "__main__":
    main()
