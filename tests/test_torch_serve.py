"""The port's serving front end (`mllm_tpu_torch/serve.py`) and metrics
(`mllm_tpu_torch/utils/metrics.py`) on the CPU.

- metrics: the cases of tests/test_metrics.py, and `cost_table` raising
  (it compiles with XLA in the JAX package: ROADMAP Queue 1 item 15).
- the server: `make_handler` over each frontend, served by a
  ThreadingHTTPServer on 127.0.0.1, port 0, for a tiny f32 model bridged
  from a JAX CausalLM and a synthetic byte-level tokenizer:
  /v1/completions, /v1/chat/completions (the chat template by model_type),
  SSE (reassembled text equal to the plain response), `stop`, 400 on a bad
  JSON body and on an image to a model with no vision tower, 404, /metrics
  and /healthz. The continuous frontend's greedy tokens equal the JAX
  `ContinuousEngine`'s on the same weights (f32 caches: exactly); the window
  and SD frontends' equal the port's own ragged_batched_generate and
  generate.
- vision-language serving: a tiny Qwen2-VL (the JAX `init`s, bridged) behind
  the continuous frontend at a fixed 56 px image size: a PNG chat request
  (data-URI image_url), `image_b64` and `video_b64` completions answer 200
  with the tokens of the JAX `vl_generate` over the JAX processor's output for
  the same image and text (exactly, f32); the window engine answers 400.
"""

import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mllm_tpu.core.config import TextConfig as JaxTextConfig
from mllm_tpu.generation import engine as jeng
from mllm_tpu.models.transformer import CausalLM as JaxCausalLM
from mllm_tpu_torch import serve
from mllm_tpu_torch.core.config import TextConfig
from mllm_tpu_torch.generation.generate import generate, ragged_batched_generate
from mllm_tpu_torch.generation.sampling import SamplingConfig
from mllm_tpu_torch.models.bridge import causal_lm_from_jax_params
from mllm_tpu_torch.nn import attention as port_attention
from mllm_tpu_torch.tokenizers.chat_templates import render
from mllm_tpu_torch.tokenizers.hf_json import from_tokenizer_json
from mllm_tpu_torch.utils.metrics import GenerationMetrics, Metrics, cost_table

CPU = torch.device("cpu")
CFG_KW = dict(vocab_size=512, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256,
              bos_token_id=1, eos_token_id=-9)  # never sampled: fixed-length outputs
PROMPTS = ["Hello world, this is a test.", "the quick brown fox jumps over the lazy dog " * 2,
           "你好，世界"]
MAX_LEN = 256
NEW = 6


# ---------------------------------------------------------------------------
# metrics (tests/test_metrics.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", autouse=True)
def kernel_route_at_small_head_dim():
    """This file's models have head_dim 16, which the port's route sends
    to `sdpa` (the kernels take 64 and 128): here it reaches the kernels'
    plain versions, so the loops drive the wrappers as they do on the card."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_attention, "KERNEL_HEAD_DIMS", (16, 64, 128))
        yield


def test_counters_gauges_histograms():
    m = Metrics()
    m.inc("reqs")
    m.inc("reqs", 2)
    m.set("batch", 8)
    for v in [1.0, 2.0, 3.0, 4.0]:
        m.observe("lat", v)
    snap = m.snapshot()
    assert snap["counters"]["reqs"] == 3
    assert snap["gauges"]["batch"] == 8
    assert snap["histograms"]["lat"]["count"] == 4
    assert snap["histograms"]["lat"]["mean"] == 2.5


def test_prometheus_format():
    m = Metrics()
    m.inc("mllm.requests")
    m.observe("mllm.ttft", 0.5)
    text = m.to_prometheus()
    assert "mllm_requests 1.0" in text
    assert 'mllm_ttft{quantile="0.5"} 0.5' in text
    assert "mllm_ttft_count 1" in text


def test_timer():
    m = Metrics()
    with m.timer("op"):
        pass
    assert m.snapshot()["histograms"]["op"]["count"] == 1


def test_generation_metrics():
    m = Metrics()
    GenerationMetrics(m).record(prompt_tokens=100, new_tokens=50, ttft_s=0.1, total_s=1.1)
    snap = m.snapshot()
    assert snap["counters"]["mllm_generated_tokens_total"] == 50
    assert abs(snap["histograms"]["mllm_decode_tokens_per_second"]["mean"] - 49.0) < 1e-6


def test_cost_table_is_not_ported():
    """cost_table counts the aten operations a call runs (held against the JAX
    one in tests/test_torch_profiling.py): the identity on a numpy array runs
    none and counts nothing, under the JAX keys."""
    assert cost_table(lambda a: a, np.zeros(3)) == {
        "flops": 0.0, "bytes_accessed": 0.0, "roofline_compute_ms": 0.0, "roofline_memory_ms": 0.0,
        "bound": "compute"}


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(JAX CausalLM, the port's on the same f32 weights, tokenizer, cfg)."""
    jm = JaxCausalLM.init(jax.random.PRNGKey(5), JaxTextConfig(**CFG_KW))
    params = {k: np.asarray(v) for k, v in jm.parameters().items()}
    cfg = TextConfig(**CFG_KW)
    tm = causal_lm_from_jax_params(params, cfg, CPU)
    path = tmp_path_factory.mktemp("tok") / "tokenizer.json"
    path.write_text(json.dumps(chip_smoke.synthetic_tokenizer(cfg.vocab_size, seed=5)), encoding="utf-8")
    return jm, tm, from_tokenizer_json(path), cfg


class Server:
    """A frontend served on 127.0.0.1, port 0, on a thread."""

    def __init__(self, frontend):
        self.frontend = frontend
        self.records = chip_smoke.recording(frontend)
        self.srv = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(frontend))
        self.port = self.srv.server_address[1]
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()

    def request(self, path, body=None, raw=None):
        """(status, body bytes); raw sends these bytes as the body."""
        data = raw if raw is not None else None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{self.port}{path}", data=data,
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        if hasattr(self.frontend, "stop"):
            self.frontend.stop()


@pytest.fixture(scope="module")
def continuous(setup):
    _, tm, tok, cfg = setup
    server = Server(serve.ContinuousFrontend(tm, tok, cfg, max_len=MAX_LEN, max_batch=4, kv_dtype=torch.float32,
                                             metrics=Metrics()))
    yield server
    server.close()


def _complete(server, prompt, **kw):
    status, body = server.request("/v1/completions", {"prompt": prompt, "max_tokens": NEW, **kw})
    assert status == 200
    return json.loads(body)


def test_completions_match_the_jax_engine(setup, continuous):
    jm, _, tok, _ = setup
    replies = [None] * len(PROMPTS)

    def post(i):
        replies[i] = _complete(continuous, PROMPTS[i])

    threads = [threading.Thread(target=post, args=(i,)) for i in range(len(PROMPTS))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    got = {tuple(ids.tolist()): out for ids, out in continuous.records}
    eng = jeng.ContinuousEngine(jm, slots=4, max_len=MAX_LEN, prompt_bucket=128, kv_dtype=jnp.float32,
                                start_thread=False, eos_token_id=-9)
    qs = {p: eng.submit(np.asarray(tok.encode(p, bos=True), np.int32), NEW) for p in PROMPTS}
    for _ in range(2 * NEW):
        eng.step()
    for p, reply in zip(PROMPTS, replies):
        ids = tok.encode(p, bos=True)
        want = jeng.collect(qs[p], timeout=5)
        assert got[tuple(ids)] == want
        assert reply["choices"][0]["text"] == tok.decode(want)
        assert reply["choices"][0]["finish_reason"] == "length"
        assert reply["usage"] == {"prompt_tokens": len(ids), "completion_tokens": NEW}


def test_chat_renders_the_template(setup, continuous):
    _, tm, tok, cfg = setup
    messages = [{"role": "system", "content": "Be brief."},
                {"role": "user", "content": [{"type": "text", "text": "Hi"}, {"type": "text", "text": "there"}]}]
    status, body = continuous.request("/v1/chat/completions", {"messages": messages, "max_tokens": NEW})
    assert status == 200
    text = render(cfg.model_type, [messages[0], {"role": "user", "content": "Hi\nthere"}])
    ids, out = continuous.records[-1]
    assert ids.tolist() == tok.encode(text, bos=True)
    assert json.loads(body)["choices"][0]["text"] == tok.decode(out)


def test_stream_equals_plain_and_stop_truncates(continuous):
    plain = _complete(continuous, PROMPTS[0])["choices"][0]["text"]
    status, body = continuous.request("/v1/completions", {"prompt": PROMPTS[0], "max_tokens": NEW, "stream": True})
    assert status == 200 and body.decode().endswith("data: [DONE]\n\n")
    assert chip_smoke.sse_text(body) == plain
    stop = plain[len(plain) // 2: len(plain) // 2 + 2]
    cut = plain[: plain.find(stop)]
    assert _complete(continuous, PROMPTS[0], stop=stop)["choices"][0]["text"] == cut
    status, body = continuous.request("/v1/completions", {"prompt": PROMPTS[0], "max_tokens": NEW, "stream": True,
                                                          "stop": [stop]})
    assert chip_smoke.sse_text(body) == cut


def test_bad_requests(continuous):
    assert continuous.request("/v1/completions", raw=b"{not json")[0] == 400
    for body in ([1, 2], {"prompt": "a", "max_tokens": "many"}, {"prompt": "a", "max_tokens": 0},
                 {"messages": "hi"}, {"prompt": "a", "temperature": [1]}):
        status, reply = continuous.request("/v1/chat/completions" if "messages" in body else "/v1/completions",
                                           body)
        assert status == 400 and json.loads(reply)["error"].startswith("bad request"), body
    image = {"messages": [{"role": "user", "content": [{"type": "image_url", "image_url": {"url": "data:,x"}}]}]}
    for path, body in (("/v1/chat/completions", image), ("/v1/completions", {"prompt": "a", "image_b64": "eA=="}),
                       ("/v1/completions", {"prompt": "a", "video_b64": ["eA=="]})):
        status, reply = continuous.request(path, body)  # a model with no vision tower
        assert status == 400 and "no vision tower" in json.loads(reply)["error"]
    assert continuous.request("/v1/nothing", {"prompt": "a"})[0] == 404
    assert continuous.request("/nothing")[0] == 404
    status, reply = continuous.request("/v1/completions", {"prompt": "x " * MAX_LEN})  # longer than the cache
    assert status == 400 and "max_len" in json.loads(reply)["error"]


def test_a_failed_request_answers_500(setup):
    """A request whose generation raises (here: the SD cache is too short for
    it) gets a 500 with the error, plain or streamed; the frontend serves on."""
    _, tm, tok, cfg = setup
    server = Server(serve.make_frontend("sd", tm, tok, cfg, max_len=100, metrics=Metrics()))
    try:
        status, reply = server.request("/v1/completions", {"prompt": PROMPTS[0], "max_tokens": NEW})
        assert status == 500 and "KV cache overflow" in json.loads(reply)["error"]
        status, reply = server.request("/v1/completions", {"prompt": PROMPTS[0], "max_tokens": NEW, "stream": True})
        assert status == 200 and "KV cache overflow" in reply.decode()
        assert server.request("/healthz") == (200, b"ok")
    finally:
        server.close()


def test_metrics_and_health(continuous):
    before = continuous.frontend.metrics.snapshot()["counters"].get("mllm_requests_total", 0)
    _complete(continuous, PROMPTS[1])
    status, body = continuous.request("/metrics")
    text = body.decode()
    assert status == 200 and f"mllm_requests_total {before + 1}" in text
    assert f"mllm_ttft_seconds_count {int(before) + 1}" in text and "mllm_last_batch_size" in text
    assert continuous.request("/healthz") == (200, b"ok")


@pytest.mark.parametrize("kind", ["window", "sd"])
def test_window_and_sd_frontends(setup, kind):
    _, tm, tok, cfg = setup
    server = Server(serve.make_frontend(kind, tm, tok, cfg, max_len=MAX_LEN, metrics=Metrics()))
    try:
        replies = [_complete(server, p) for p in PROMPTS[:2]]
    finally:
        server.close()
    for p, reply in zip(PROMPTS[:2], replies):
        ids = np.asarray(tok.encode(p, bos=True))
        if kind == "window":
            toks, n, _ = ragged_batched_generate(tm, [ids], tm.init_cache(1, MAX_LEN, torch.bfloat16),
                                                 SamplingConfig(max_new_tokens=NEW))
            want = toks[0, : int(n[0])].tolist()
        else:
            want, _ = generate(tm, ids, tm.init_cache(1, MAX_LEN, torch.bfloat16), SamplingConfig(max_new_tokens=NEW))
            want = want.tokens
        assert reply["choices"][0]["text"] == tok.decode(want)
        assert reply["usage"]["completion_tokens"] == NEW
    if kind == "sd":
        assert 0.0 <= server.frontend.metrics.snapshot()["gauges"]["mllm_sd_acceptance"] <= 1.0


def test_command_line():
    args = serve.parse_args(["-m", "some/dir"])
    assert (args.port, args.engine, args.kv, args.quant, args.paged, args.prefix_cache) == \
        (8000, "continuous", "bf16", None, 0, 0)
    args = serve.parse_args(["-m", "d", "-q", "int8-a8", "--engine", "sd", "--kv", "int4", "--paged", "64",
                             "--image-size", "448"])
    assert (args.quant, args.engine, args.kv, args.paged) == ("int8-a8", "sd", "int4", 64)
    assert serve.parse_args(["-m", "d", "-q", "int4-mixed"]).quant == "int4-mixed"
    with pytest.raises(SystemExit):
        serve.parse_args(["-m", "d", "-q", "nf4"])


class _BytesTok:
    """Token i is the byte string PIECES[i]; text is their UTF-8 decode."""

    PIECES = [b"he", b"llo", b" w", b"\xc3", b"\xa9", b"or", b"ld", b"\xe4\xbd"]

    def encode(self, text, bos=False):
        return [0]

    def decode(self, ids):
        return b"".join(self.PIECES[i] for i in ids).decode("utf-8", errors="replace")


class _ScriptedFrontend:
    """Answers every request with the same tokens."""

    def __init__(self, toks):
        self.toks, self.tok, self.metrics = toks, _BytesTok(), Metrics()
        self.cfg = TextConfig(**CFG_KW)

    def submit(self, ids, max_tokens, sampling=None):
        import queue

        q = queue.Queue()
        q.put(list(self.toks))
        return q

    def submit_stream(self, ids, max_tokens, sampling=None):
        import queue

        q = queue.Queue()
        for t in self.toks + [None]:
            q.put(t)
        return q


@pytest.mark.parametrize("toks,stop", [
    ([0, 1, 2, 3, 4, 5, 6], []),          # é split over two tokens
    ([0, 1, 2, 5, 6, 7], []),             # ends mid-codepoint: the tail is sent at the end
    ([0, 1, 2, 5, 6], ["lo w"]),          # a stop string across three chunks
    ([0, 1, 2, 5, 6], ["xyz", "ld", "o"]),  # the earliest of the stop strings
])
def test_stream_chunks_add_up_to_the_plain_text(toks, stop):
    server = Server(_ScriptedFrontend(toks))
    try:
        body = {"prompt": "p", "max_tokens": 16, "stop": stop}
        plain = json.loads(server.request("/v1/completions", body)[1])["choices"][0]["text"]
        status, raw = server.request("/v1/completions", {**body, "stream": True})
    finally:
        server.close()
    assert status == 200 and chip_smoke.sse_text(raw) == plain
    chunks = [json.loads(line[len("data: "):])["choices"][0]["text"] for line in raw.decode().split("\n")
              if line.startswith("data: {")]
    assert not any(c.endswith("\ufffd") for c in chunks[:-1])  # held back while a codepoint is open


# ---------------------------------------------------------------------------
# vision-language serving
# ---------------------------------------------------------------------------

VL_SIZE = 56  # px: the fixed serving resolution (grid (1, 4, 4), 4 image tokens)


@pytest.fixture(scope="module")
def vl_setup(tmp_path_factory):
    """(JAX Qwen2-VL, the port's on the same f32 weights, the port's and the
    JAX tokenizer of one tokenizer.json whose last ids are the vision tokens)."""
    from mllm_tpu.models import qwen2_vl as jvl
    from mllm_tpu.tokenizers.hf_json import from_tokenizer_json as jax_tokenizer
    from mllm_tpu_torch.models import qwen2_vl as tvl
    from mllm_tpu_torch.models.bridge import qwen2_vl_from_jax_params

    specials = chip_smoke.TOKENIZER_SPECIALS + chip_smoke.VL_SPECIALS
    vocab = CFG_KW["vocab_size"]
    ids = {t: vocab - len(specials) + i for i, t in enumerate(specials)}
    path = tmp_path_factory.mktemp("vltok") / "tokenizer.json"
    path.write_text(json.dumps(chip_smoke.synthetic_tokenizer(vocab, seed=7, specials=specials)), encoding="utf-8")
    kw = dict(CFG_KW, model_type="qwen2", attention_bias=True)
    vkw = dict(depth=1, embed_dim=32, hidden_size=CFG_KW["hidden_size"], num_heads=4)
    ckw = dict(image_token_id=ids["<|image_pad|>"], video_token_id=ids["<|video_pad|>"],
               vision_start_token_id=ids["<|vision_start|>"], mrope_section=(2, 3, 3))
    jvc = jvl.Qwen2VLVisionConfig(**vkw)
    jm = jvl.Qwen2VLForConditionalGeneration(jvl.Qwen2VLVisionTower.init(jax.random.PRNGKey(8), jvc),
                                             JaxCausalLM.init(jax.random.PRNGKey(9), JaxTextConfig(**kw)),
                                             jvl.Qwen2VLConfig(text=JaxTextConfig(**kw), vision=jvc, **ckw))
    tcfg = tvl.Qwen2VLConfig(text=TextConfig(**kw), vision=tvl.Qwen2VLVisionConfig(**vkw), **ckw)
    tm = qwen2_vl_from_jax_params({k: np.asarray(v) for k, v in jm.parameters().items()}, tcfg, CPU, vision_eps=1e-5)
    return jm, tm, from_tokenizer_json(path), jax_tokenizer(path)


def _png(seed: int) -> bytes:
    import io

    from PIL import Image

    img = np.random.default_rng(seed).integers(0, 256, (70, 90, 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def _jax_vl_tokens(vl_setup, text: str, frames: list, video: bool = False) -> list:
    """The JAX processor (at the server's fixed size) and the JAX vl_generate."""
    import io

    from PIL import Image

    from mllm_tpu.models import qwen2_vl as jvl
    from mllm_tpu.processor.image import Qwen2VLImageProcessor
    from mllm_tpu.processor.qwen2_vl import Qwen2VLProcessor

    jm, _, _, jtok = vl_setup
    proc = Qwen2VLProcessor(jtok, image_processor=Qwen2VLImageProcessor(fixed_resolution=(VL_SIZE, VL_SIZE)),
                            image_token_id=jm.cfg.image_token_id, video_token_id=jm.cfg.video_token_id)
    imgs = [np.asarray(Image.open(io.BytesIO(f)).convert("RGB")) for f in frames]
    out = (proc(proc.chat_text(text, video=True), videos=imgs) if video
           else proc(proc.chat_text(text), images=[imgs[0]]))
    toks, _ = jvl.vl_generate(jm, out, jm.init_cache(1, MAX_LEN, jnp.float32), max_new_tokens=NEW)
    return toks


@pytest.fixture(scope="module")
def vl_server(vl_setup):
    _, tm, tok, _ = vl_setup
    server = Server(serve.ContinuousFrontend(tm, tok, tm.cfg, max_len=MAX_LEN, max_batch=2, kv_dtype=torch.float32,
                                             metrics=Metrics(), image_size=VL_SIZE))
    yield server
    server.close()


def test_vl_chat_png_request(vl_setup, vl_server):
    import base64

    png = _png(1)
    url = "data:image/png;base64," + base64.b64encode(png).decode()
    body = {"messages": [{"role": "user", "content": [{"type": "text", "text": "What is in the picture?"},
                                                      {"type": "image_url", "image_url": {"url": url}}]}],
            "max_tokens": NEW}
    status, reply = vl_server.request("/v1/chat/completions", body)
    assert status == 200, reply
    reply = json.loads(reply)
    want = _jax_vl_tokens(vl_setup, "What is in the picture?", [png])
    assert reply["choices"][0]["text"] == vl_setup[2].decode(want)
    assert reply["usage"]["completion_tokens"] == NEW and reply["usage"]["prompt_tokens"] > 4


def test_vl_image_and_video_completions(vl_setup, vl_server):
    import base64

    frames = [_png(2), _png(3)]
    status, reply = vl_server.request("/v1/completions", {"prompt": "describe", "max_tokens": NEW,
                                                          "image_b64": base64.b64encode(frames[0]).decode()})
    assert status == 200
    assert json.loads(reply)["choices"][0]["text"] == vl_setup[2].decode(_jax_vl_tokens(vl_setup, "describe",
                                                                                         frames[:1]))
    status, reply = vl_server.request("/v1/completions", {
        "prompt": "what happens?", "max_tokens": NEW, "video_b64": [base64.b64encode(f).decode() for f in frames]})
    assert status == 200
    want = _jax_vl_tokens(vl_setup, "what happens?", frames, video=True)
    assert json.loads(reply)["choices"][0]["text"] == vl_setup[2].decode(want)
    status, reply = vl_server.request("/v1/completions", {"prompt": "x", "image_b64": "bm90IGFuIGltYWdl"})
    assert status == 400 and "bad image request" in json.loads(reply)["error"]
    _complete(vl_server, PROMPTS[0])  # text requests share the VL model's slots


def test_vl_model_on_the_window_engine_answers_400(vl_setup):
    import base64

    _, tm, tok, _ = vl_setup
    server = Server(serve.make_frontend("window", tm, tok, tm.cfg, max_len=MAX_LEN, metrics=Metrics()))
    try:
        status, reply = server.request("/v1/completions", {"prompt": "a",
                                                           "image_b64": base64.b64encode(_png(4)).decode()})
    finally:
        server.close()
    assert status == 400 and "no vision tower" in json.loads(reply)["error"]
