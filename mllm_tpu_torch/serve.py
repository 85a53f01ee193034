"""OpenAI-style HTTP server over the port's engines: the counterpart of the
JAX package's `examples/serve.py`.

    python -m mllm_tpu_torch.serve -m <model_dir> [-p 8000] [--engine continuous|window|sd]
        [--kv bf16|int8|int4] [--paged N] [--prefix-cache N] [-q int8|int8-a8|int4|int4-mixed]

    curl localhost:8000/v1/completions -d '{"prompt": "hello", "max_tokens": 32}'
    curl localhost:8000/v1/chat/completions -d '{"messages": [{"role": "user", "content": "hi"}]}'
    curl localhost:8000/metrics

Three schedulers:
  --engine continuous (default): `ContinuousFrontend`, slot batching
    (`generation/engine.py`) on the engine's own loop thread, pipelined, each
    decode window a replayed CUDA graph on the card;
  --engine window: `Engine`, requests arriving within a window are left-pad
    batched through one `ragged_batched_generate`;
  --engine sd: `SpeculativeFrontend`, one stream at a time through
    `speculative_generate` (latency).

`make_handler` serves /v1/completions and /v1/chat/completions (the chat
template by model_type, `stop` truncation, SSE streaming with the
mid-codepoint hold-back), /metrics (Prometheus text) and /healthz. A
Qwen2-VL / Qwen2.5-VL model on the continuous engine also takes images and
videos: `image_b64` (a base64 image), a chat part {"type": "image_url",
"image_url": {"url": "data:image/...;base64,..."}} or `video_b64` (a list of
base64 frames); the VL processor resizes each to the fixed `--image-size`
square (one tower shape for every request), applies its chat template with
the vision tokens around the users' text and the engine serves the request
in a shared slot. Images need PIL (imported when one is decoded). An image
or video sent to a model without a vision tower, or to the window or sd
engine, answers 400. Importing this module starts nothing; `main` loads the
model and serves.

    curl localhost:8000/v1/chat/completions -d '{"messages": [{"role": "user", "content": [
        {"type": "text", "text": "What is in the picture?"},
        {"type": "image_url", "image_url": {"url": "data:image/png;base64,iVBOR..."}}]}]}'


Differences from the JAX server, each deliberate: the frontends record the
time to the first token as the first token reaches the host (the JAX
continuous frontend records the whole request's time there), streamed
requests are counted in the metrics too, and each frontend takes the metrics
registry it writes (the process-wide one by default).
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from .ops.quantize_model import MODES
from .utils.log import get_logger
from .utils.metrics import GLOBAL, GenerationMetrics, Metrics

NO_VISION = "this server takes no images or videos: the model has no vision tower, or the engine is not continuous"


class _Frontend:
    """Metrics shared by the three schedulers."""

    def __init__(self, model, tok, cfg, metrics: Metrics | None):
        self.model = model
        self.tok = tok
        self.cfg = cfg
        self.metrics = metrics if metrics is not None else GLOBAL
        self.genmetrics = GenerationMetrics(self.metrics)

    def _relay(self, stream: queue.Queue, n_prompt: int, t0: float, out: queue.Queue, whole: bool,
               timeout: float = 600.0):
        """Read a per-token stream (None ends it) on a thread of its own;
        record the request's metrics when it ends. whole=True puts the token
        list on `out` at the end, otherwise each token as it comes, then None.
        An exception read from the stream, or no token for `timeout` seconds,
        goes on `out` in place of the rest."""

        def run():
            toks, ttft = [], None
            try:
                while True:
                    t = stream.get(timeout=timeout)
                    if isinstance(t, Exception):
                        raise t
                    if t is None:
                        break
                    if ttft is None:
                        ttft = time.perf_counter() - t0
                    toks.append(t)
                    if not whole:
                        out.put(t)
            except Exception as e:  # noqa: BLE001 - handed to the request's handler
                get_logger().exception("request failed")
                out.put(e)
                return
            total = time.perf_counter() - t0
            self._done(n_prompt, len(toks), total if ttft is None else ttft, total)
            out.put(toks if whole else None)

        threading.Thread(target=run, daemon=True).start()
        return out

    def _done(self, n_prompt: int, n_new: int, ttft_s: float, total_s: float) -> None:
        self.genmetrics.record(n_prompt, n_new, ttft_s, total_s)


DECODE_WINDOW = 32  # decode steps a replayed window graph (the best or within 1.5 % of it: PERF.md, PR 10)


class ContinuousFrontend(_Frontend):
    """ContinuousEngine scheduling (on its loop thread, pipelined, decode
    windows of DECODE_WINDOW steps) and serving metrics. A model with a
    vision tower also takes images and videos (`submit_image`), resized to
    image_size x image_size (None: each image's own smart_resize grid)."""

    def __init__(self, model, tok, cfg, max_len=2048, max_batch=8, kv_dtype="bf16",
                 prefix_cache=0, paged=0, metrics: Metrics | None = None, image_size=None):
        from .generation.engine import ContinuousEngine

        super().__init__(model, tok, cfg, metrics)
        self.engine = ContinuousEngine(model, slots=max_batch, max_len=max_len,
                                       eos_token_id=getattr(tok, "eos_token_id", None),
                                       kv_dtype=kv_dtype, prefix_cache=prefix_cache, paged=paged,
                                       decode_window=DECODE_WINDOW, pipeline=True)
        self.vl_proc = None
        if hasattr(model, "visual"):
            from .processor.image import Qwen2VLImageProcessor
            from .processor.qwen2_vl import Qwen2VLProcessor

            ip = Qwen2VLImageProcessor(fixed_resolution=(image_size, image_size) if image_size else None)
            self.vl_proc = Qwen2VLProcessor(tok, image_processor=ip, image_token_id=model.cfg.image_token_id,
                                            video_token_id=model.cfg.video_token_id)

    def submit_image(self, text: str, image, max_tokens, video=None, sampling=None) -> tuple[queue.Queue, int]:
        """A multimodal request: an image (or `video`, a list of frames; each
        an RGB uint8 array or encoded bytes) and the user's text through the
        VL processor, served by the engine in a shared slot. Returns (a queue
        that receives the token list, the prompt's tokens)."""
        if video is not None:
            out = self.vl_proc(self.vl_proc.chat_text(text, video=True), videos=video)
        else:
            out = self.vl_proc(self.vl_proc.chat_text(text), images=[image])
        n_prompt = int(out.input_ids.shape[1])
        t0 = time.perf_counter()
        stream = self.engine.submit_vl(out, max_tokens, sampling=sampling)
        return self._relay(stream, n_prompt, t0, queue.Queue(), whole=True), n_prompt

    def submit(self, prompt_ids, max_tokens, sampling=None) -> queue.Queue:
        """A queue that receives the request's token list when it ends."""
        t0 = time.perf_counter()
        stream = self.engine.submit(prompt_ids, max_tokens, sampling=sampling)
        return self._relay(stream, len(prompt_ids), t0, queue.Queue(), whole=True)

    def submit_stream(self, prompt_ids, max_tokens, sampling=None) -> queue.Queue:
        """A queue of the request's tokens as they reach the host, then None."""
        t0 = time.perf_counter()
        stream = self.engine.submit(prompt_ids, max_tokens, sampling=sampling)
        return self._relay(stream, len(prompt_ids), t0, queue.Queue(), whole=False)

    def _done(self, n_prompt, n_new, ttft_s, total_s):
        active = sum(r is not None for r in self.engine.req)
        self.metrics.set("mllm_last_batch_size", max(active, 1))
        self.metrics.set("mllm_prefix_tokens_reused", self.engine.prefix_tokens_reused)
        super()._done(n_prompt, n_new, ttft_s, total_s)

    def stop(self):
        self.engine.stop()


class SpeculativeFrontend(_Frontend):
    """Single-stream speculative decoding (--engine sd): suffix-automaton
    drafts and one verify forward a step, greedy; requests run one after
    another, each at SD speed. Exports the acceptance as `mllm_sd_acceptance`."""

    def __init__(self, model, tok, cfg, max_len=2048, max_draft=8, metrics: Metrics | None = None):
        super().__init__(model, tok, cfg, metrics)
        self.max_len = max_len
        self.max_draft = max_draft
        self._lock = threading.Lock()

    def _run(self, prompt_ids, max_tokens, out: queue.Queue, whole: bool):
        from .generation.speculative import speculative_generate

        t0 = time.perf_counter()
        stream: queue.Queue = queue.Queue()
        self._relay(stream, len(prompt_ids), t0, out, whole)
        try:
            with self._lock:  # one stream at a time (latency mode)
                cache = self.model.init_cache(1, self.max_len, torch.bfloat16)
                _, _, stats = speculative_generate(self.model, np.asarray(prompt_ids, np.int64)[None], cache,
                                                   max_tokens, max_draft=self.max_draft, callback=stream.put)
        except Exception as e:  # noqa: BLE001 - handed to the request's handler (the relay logs it)
            stream.put(e)
            return
        self.metrics.set("mllm_sd_acceptance", round(float(stats.acceptance), 4))
        stream.put(None)

    def submit(self, prompt_ids, max_tokens, sampling=None) -> queue.Queue:
        out: queue.Queue = queue.Queue()
        threading.Thread(target=self._run, args=(prompt_ids, max_tokens, out, True), daemon=True).start()
        return out

    def submit_stream(self, prompt_ids, max_tokens, sampling=None) -> queue.Queue:
        out: queue.Queue = queue.Queue()
        threading.Thread(target=self._run, args=(prompt_ids, max_tokens, out, False), daemon=True).start()
        return out


class Engine(_Frontend):
    """The window batcher (--engine window): requests that arrive within
    `window_ms` of the first are left-pad batched through one
    `ragged_batched_generate`, with the first request's sampling settings, and
    fanned back out."""

    def __init__(self, model, tok, cfg, max_len=2048, window_ms=30, max_batch=8,
                 metrics: Metrics | None = None):
        super().__init__(model, tok, cfg, metrics)
        self.max_len = max_len
        self.window_ms = window_ms
        self.max_batch = max_batch
        self.q: queue.Queue = queue.Queue()
        threading.Thread(target=self._loop, daemon=True).start()

    def submit(self, prompt_ids, max_tokens: int, sampling=None) -> queue.Queue:
        done: queue.Queue = queue.Queue()
        self.q.put((prompt_ids, max_tokens, done, time.perf_counter(), sampling))
        return done

    def _loop(self):
        from .generation.generate import ragged_batched_generate
        from .generation.sampling import SamplingConfig

        while True:
            first = self.q.get()
            batch = [first]
            deadline = time.perf_counter() + self.window_ms / 1000.0
            while len(batch) < self.max_batch and time.perf_counter() < deadline:
                try:
                    batch.append(self.q.get(timeout=max(deadline - time.perf_counter(), 0.001)))
                except queue.Empty:
                    break
            cfg0 = batch[0][4] or SamplingConfig()
            t0 = time.perf_counter()
            try:
                cache = self.model.init_cache(len(batch), self.max_len, torch.bfloat16)
                toks, n_valid, _ = ragged_batched_generate(
                    self.model, [np.asarray(b[0]) for b in batch], cache,
                    SamplingConfig(max_new_tokens=max(b[1] for b in batch), do_sample=cfg0.do_sample,
                                   temperature=cfg0.temperature, top_k=cfg0.top_k, top_p=cfg0.top_p))
            except Exception as e:  # noqa: BLE001 - handed to each request's handler
                get_logger().exception("batch failed")
                for b in batch:
                    b[2].put(e)
                continue
            dt = time.perf_counter() - t0
            self.metrics.set("mllm_last_batch_size", len(batch))
            for i, (pids, mt, done, t_in, _) in enumerate(batch):
                out = toks[i, : min(int(n_valid[i]), mt)].tolist()
                self.genmetrics.record(len(pids), len(out), dt, time.perf_counter() - t_in)
                done.put(out)


def _messages_text(req: dict) -> tuple[list, bool, str | None]:
    """OpenAI-style messages with list contents flattened to their text
    parts, whether any part was an image, and the base64 payload of the last
    data-URI image part (None when there is none)."""
    messages, image, b64 = [], False, None
    for m in req.get("messages", []):
        content = m.get("content", "")
        if isinstance(content, list):
            texts = []
            for part in content:
                if part.get("type") == "text":
                    texts.append(part.get("text", ""))
                elif part.get("type") == "image_url":
                    image = True
                    url = (part.get("image_url") or {}).get("url", "")
                    if url.startswith("data:") and "," in url:
                        b64 = url.split(",", 1)[1]
            content = "\n".join(texts)
        messages.append({**m, "content": content})
    return messages, image, b64


def make_handler(engine):
    """The request handler class of a `ThreadingHTTPServer` over `engine` (a
    frontend above: `submit`, optionally `submit_stream`, `tok`, `cfg`,
    `metrics`)."""
    from .generation.sampling import SamplingConfig
    from .tokenizers.chat_templates import render

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code: int, body: bytes = b"", ctype: str | None = None):
            self.send_response(code)
            if ctype:
                self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _error(self, code: int, msg: str):
            self._send(code, json.dumps({"error": msg}).encode(), "application/json")

        def do_GET(self):
            if self.path == "/metrics":
                self._send(200, engine.metrics.to_prometheus().encode(), "text/plain")
            elif self.path == "/healthz":
                self._send(200, b"ok")
            else:
                self._send(404)

        def do_POST(self):
            if self.path not in ("/v1/completions", "/v1/chat/completions"):
                self._send(404)
                return
            n = int(self.headers.get("Content-Length", 0))
            try:
                req = json.loads(self.rfile.read(n) or b"{}")
            except (json.JSONDecodeError, ValueError):
                self._error(400, "invalid JSON body")
                return
            try:
                text, vision, sampling, stop, max_tokens = self._fields(req)
            except (AttributeError, TypeError, ValueError) as e:
                self._error(400, f"bad request: {e}")
                return
            if vision is not None:
                if getattr(engine, "vl_proc", None) is None:
                    self._error(400, NO_VISION)
                    return
                try:
                    q, n_prompt = self._submit_vision(text, vision, max_tokens, sampling)
                except (RuntimeError, ValueError, OSError) as e:  # undecodable or too long, or no PIL
                    self._error(400, f"bad image request: {e}")
                    return
                ids = np.zeros(n_prompt, np.int64)  # for the usage report
            else:
                ids = np.asarray(engine.tok.encode(text, bos=True), np.int64)
                stream = bool(req.get("stream")) and hasattr(engine, "submit_stream")
                try:
                    q = (engine.submit_stream if stream else engine.submit)(ids, max_tokens, sampling=sampling)
                except ValueError as e:  # a prompt the engine cannot take (longer than its cache)
                    self._error(400, str(e))
                    return
                if stream:
                    self._stream_response(q, stop)
                    return
            out_ids = q.get()
            if isinstance(out_ids, Exception):
                self._error(500, f"{type(out_ids).__name__}: {out_ids}")
                return
            text_out = engine.tok.decode(out_ids)
            for ss in stop:  # OpenAI `stop`: truncate at the first occurrence
                i = text_out.find(ss)
                if i >= 0:
                    text_out = text_out[:i]
            resp = {
                "object": "text_completion",
                "choices": [{"text": text_out, "index": 0,
                             "finish_reason": "length" if len(out_ids) >= max_tokens else "stop"}],
                "usage": {"prompt_tokens": len(ids), "completion_tokens": len(out_ids)},
            }
            self._send(200, json.dumps(resp).encode(), "application/json")

        def _submit_vision(self, text: str, vision: dict, max_tokens: int, sampling):
            """Decode the request's image (or video frames) and submit it."""
            import base64

            from .processor.image import load_image

            if vision.get("video"):
                frames = [load_image(base64.b64decode(f)) for f in vision["video"]]
                return engine.submit_image(text, None, max_tokens, video=frames, sampling=sampling)
            if not vision.get("image"):
                raise ValueError("an image_url part must be a base64 data URI")
            return engine.submit_image(text, load_image(base64.b64decode(vision["image"])), max_tokens,
                                       sampling=sampling)

        def _fields(self, req: dict):
            """(prompt text, the vision payload: None, or {"image": base64 or
            None, "video": [base64 frames] or None}, SamplingConfig, stop
            strings, max_tokens) of a request body; raises on a field of the
            wrong type or out of range. With an image or video, the text is the
            users' messages joined (the VL processor applies its own template)."""
            if not isinstance(req, dict):
                raise TypeError("the body must be a JSON object")
            image_b64, video_b64 = req.get("image_b64"), req.get("video_b64")
            if video_b64 is not None and not isinstance(video_b64, list):
                raise TypeError("video_b64 must be a list of base64 frames")
            has_image = False
            if self.path.endswith("chat/completions"):
                messages, has_image, part_b64 = _messages_text(req)
                image_b64 = image_b64 or part_b64
            vision = ({"image": image_b64, "video": video_b64}
                      if has_image or image_b64 or video_b64 else None)
            if not self.path.endswith("chat/completions"):
                text = str(req.get("prompt", ""))
            elif vision is not None:
                text = "\n".join(m["content"] for m in messages if m.get("role") == "user")
            else:
                text = render(getattr(engine.cfg, "text", engine.cfg).model_type, messages)
            temp = float(req.get("temperature", 0.0))
            sampling = SamplingConfig(do_sample=temp > 0, temperature=temp or 0.7,
                                      top_k=int(req.get("top_k", 0)), top_p=float(req.get("top_p", 0.0)))
            stop = req.get("stop") or []
            stop = [stop] if isinstance(stop, str) else [str(ss) for ss in stop]
            max_tokens = int(req.get("max_tokens", 64))
            if max_tokens < 1:
                raise ValueError(f"max_tokens must be at least 1, got {max_tokens}")
            return text, vision, sampling, stop, max_tokens

        def _stream_response(self, q, stop):
            """OpenAI-style SSE from the token queue `q`: one `data: {...}`
            chunk per text delta, then `data: [DONE]`. Deltas re-decode the
            accumulated ids, and a text that ends mid-codepoint (U+FFFD) waits
            for the next token, as does a tail that may begin a `stop` string;
            what is held back when the last token comes is sent then. So the
            chunks add up to the plain response's text, `stop` cut at the
            earliest occurrence of any of its strings (the JAX server drops
            the held-back tail, may send the start of a stop string, and cuts
            at the last of the stop strings that occurs). A failure ends the
            stream with an error chunk."""
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            toks, sent, last = [], "", False
            while not last:
                t = q.get()
                if isinstance(t, Exception):
                    self.wfile.write(f"data: {json.dumps({'error': f'{type(t).__name__}: {t}'})}\n\n".encode())
                    break
                if t is None:
                    last = True
                else:
                    toks.append(t)
                full = engine.tok.decode(toks)
                if not last and full.endswith("\ufffd"):  # mid-codepoint: wait for more
                    continue
                delta = full[len(sent):]
                probe = sent + delta
                cut = min((i for i in (probe.find(ss) for ss in stop) if i >= 0), default=None)
                if cut is not None:
                    delta = probe[:cut][len(sent):]
                elif not last:  # hold back a tail that may begin a stop string
                    hold = max((n for ss in stop for n in range(1, len(ss)) if probe.endswith(ss[:n])), default=0)
                    delta = probe[len(sent):len(probe) - hold]
                if delta:
                    chunk = {"object": "text_completion.chunk", "choices": [{"text": delta, "index": 0}]}
                    self.wfile.write(f"data: {json.dumps(chunk)}\n\n".encode())
                    self.wfile.flush()
                    sent += delta
                if cut is not None:
                    break
            self.wfile.write(b"data: [DONE]\n\n")
            self.wfile.flush()

    return Handler


def make_frontend(kind: str, model, tok, cfg, *, max_len=2048, max_batch=8, kv_dtype="bf16",
                  paged=0, prefix_cache=0, window_ms=30, metrics: Metrics | None = None, image_size=None):
    """The frontend of `--engine kind` ("continuous", "window" or "sd")."""
    if kind == "sd":
        return SpeculativeFrontend(model, tok, cfg, max_len, metrics=metrics)
    if kind == "continuous":
        return ContinuousFrontend(model, tok, cfg, max_len, max_batch, kv_dtype=kv_dtype,
                                  prefix_cache=prefix_cache, paged=paged, metrics=metrics,
                                  image_size=image_size)
    if kind == "window":
        return Engine(model, tok, cfg, max_len, window_ms, max_batch, metrics=metrics)
    raise ValueError(f"unknown engine {kind!r}")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m mllm_tpu_torch.serve", description=__doc__.split("\n")[0])
    ap.add_argument("-m", "--model", required=True, help="HF-style model directory (safetensors or .mllm, "
                    "with a tokenizer.json)")
    ap.add_argument("-p", "--port", type=int, default=8000)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("-l", "--limits", type=int, default=2048, help="KV-cache length a request")
    ap.add_argument("-q", "--quant", choices=MODES, default=None)
    ap.add_argument("--batch-window-ms", type=int, default=30)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--engine", choices=["continuous", "window", "sd"], default="continuous",
                    help="continuous = slot batching (throughput); window = lockstep micro-batching; "
                         "sd = single-stream speculative decoding (latency)")
    ap.add_argument("--kv", choices=["bf16", "int8", "int4"], default="bf16", help="serving KV-cache dtype")
    ap.add_argument("--paged", type=int, default=0, metavar="BLOCKS",
                    help="paged KV cache: 128-token blocks reserved a request from a BLOCKS-sized pool; "
                         "0 = a dense cache a slot")
    ap.add_argument("--prefix-cache", type=int, default=0, metavar="N",
                    help="keep the KV of the last N admitted prompts; a request sharing a bucket-aligned "
                         "prefix skips its prefill")
    ap.add_argument("--image-size", type=int, default=448, metavar="PX",
                    help="vision-language models: every image is resized to PX x PX (a multiple of 28), "
                         "one vision-tower shape for every request; 0 = each image's own smart_resize grid")
    return ap.parse_args(argv)


def main(argv=None):
    from .models.registry import auto_model
    from .utils.log import log_info

    args = parse_args(argv)
    model, tok, cfg = auto_model(args.model, dtype=torch.bfloat16, quant=args.quant)
    if tok is None:
        raise SystemExit(f"{args.model} holds no tokenizer.json: the server needs one")
    engine = make_frontend(args.engine, model, tok, cfg, max_len=args.limits, max_batch=args.max_batch,
                           kv_dtype=args.kv, paged=args.paged, prefix_cache=args.prefix_cache,
                           window_ms=args.batch_window_ms, image_size=args.image_size or None)
    server = ThreadingHTTPServer((args.host, args.port), make_handler(engine))
    log_info("serving", model=os.path.abspath(args.model), port=server.server_address[1],
             quant=args.quant or "bf16", engine=args.engine)
    server.serve_forever()


if __name__ == "__main__":
    main()
