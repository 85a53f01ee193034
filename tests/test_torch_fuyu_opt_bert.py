"""The port's Fuyu, OPT and BERT (`mllm_tpu_torch.models.fuyu` / `opt` /
`bert`, and `loading.py`'s interleaved q/k/v) on the CPU against the JAX
package on the same checkpoints and against transformers (the JAX tests'
tiny checkpoints: tests/test_fuyu_gemma.py, tests/test_opt_bert_stablelm.py).

Tiny geometries: Fuyu's Persimmon LM 32 wide, 2 layers, 4 heads, partial
rotary 0.5, q/k LayerNorms, relu^2, 8 px images of 4 px patches; OPT 32 wide,
2 layers, 4 heads (pre- and post-norm); BERT 32 wide, 2 layers, 4 heads, a
WordPiece tokenizer.json trained on a few sentences. Inputs from numpy seeds,
everything in f32.

Tolerances: logits (BERT: hidden states and sentence embeddings) within 1e-4
x max |value| of JAX, 8 greedy tokens equal; transformers within the JAX
tests' 2e-3 (3e-3 for Fuyu, as tests/test_fuyu_gemma.py).
"""

import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mllm_tpu.core.param_loader import SafetensorsLoader as JaxLoader
from mllm_tpu.models import bert as jbert
from mllm_tpu.models import fuyu as jfuyu
from mllm_tpu.models import opt as jopt
from mllm_tpu_torch.models import bert as tbert
from mllm_tpu_torch.models import fuyu as tfuyu
from mllm_tpu_torch.models import opt as topt
from mllm_tpu_torch.models.bridge import bert_from_jax_params, fuyu_from_jax_params, opt_from_jax_params
from mllm_tpu_torch.models.registry import auto_model, auto_model_any

from test_torch_llava_phi3v import REL_TOL, jax_greedy, port_greedy, rel

CPU = torch.device("cpu")
IMG_TOK = 60
N_NEW = 8


def _params(jm):
    return {k: np.asarray(v) for k, v in jm.parameters().items()}


# ---------------------------------------------------------------------------
# Fuyu
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_fuyu(tmp_path_factory):
    import transformers

    torch.manual_seed(0)
    cfg = transformers.FuyuConfig(
        text_config=dict(model_type="persimmon", vocab_size=128, hidden_size=32, intermediate_size=64,
                         num_hidden_layers=2, num_attention_heads=4, max_position_embeddings=64,
                         partial_rotary_factor=0.5, qk_layernorm=True, hidden_act="relu2", rope_theta=10000.0,
                         tie_word_embeddings=False),
        hidden_size=32, patch_size=4, num_channels=3, image_token_id=IMG_TOK)
    hf = transformers.FuyuForCausalLM(cfg).eval()
    d = tmp_path_factory.mktemp("fuyu")
    hf.save_pretrained(d)
    return hf, str(d)


FUYU_IDS = np.array([[1, 5, IMG_TOK, IMG_TOK, IMG_TOK, IMG_TOK, 9]], np.int64)


def test_fuyu_matches_jax_and_transformers(tiny_fuyu):
    hf, d = tiny_fuyu
    jm = jfuyu.load_fuyu(JaxLoader(d), jfuyu.fuyu_config_from_hf(d), jnp.float32)
    tm, kind = auto_model_any(d, torch.float32, device=CPU)
    assert kind == "fuyu" and isinstance(tm, tfuyu.FuyuForCausalLM)
    c = tm.cfg.text
    assert c.qk_norm and c.rope_partial == 0.5 and c.norm_type == "layernorm" and c.hidden_act == "relu2"
    blk = tm.lm.blocks[0]
    assert blk.mlp.up_proj is None and blk.attn.q_norm.bias is not None and blk.attn.q_proj.bias is not None
    img = np.random.default_rng(0).standard_normal((3, 8, 8)).astype(np.float32)
    patches = tfuyu.patchify_image(img, 4)
    np.testing.assert_array_equal(patches, jfuyu.patchify_image(img, 4))
    jl, jc = jm(jnp.asarray(FUYU_IDS, jnp.int32), jm.init_cache(1, 32, jnp.float32),
                image_patches=jnp.asarray(patches), last_only=False)
    with torch.no_grad():
        tl, tc = tm(torch.from_numpy(FUYU_IDS), tm.init_cache(1, 32, torch.float32),
                    image_patches=torch.from_numpy(patches), last_only=False)
        assert rel(tl, jl) < REL_TOL
        assert port_greedy(tm, tl, tc, N_NEW) == jax_greedy(jm, jl, jc, N_NEW)
        ref = hf(input_ids=torch.from_numpy(FUYU_IDS), image_patches=torch.from_numpy(patches[None, None]),
                 image_patches_indices=torch.tensor([[-1, -1, 0, 1, 2, 3, -1]])).logits
        torch.testing.assert_close(tl, ref, rtol=3e-3, atol=3e-3)
        bridged = fuyu_from_jax_params(_params(jm), tm.cfg, CPU)
        bl, _ = bridged(torch.from_numpy(FUYU_IDS), bridged.init_cache(1, 32, torch.float32),
                        image_patches=torch.from_numpy(patches), last_only=False)
        assert rel(bl, tl) < 1e-6


def test_interleaved_qkv_split(tiny_fuyu):
    """loading.py's interleaved q/k/v: rows [H, (q, k, v), hd] of the fused
    weight and bias become q_proj, k_proj, v_proj, head by head."""
    from mllm_tpu_torch.core.param_loader import SafetensorsLoader

    _, d = tiny_fuyu
    tm, _ = auto_model_any(d, torch.float32, device=CPU)
    ld = SafetensorsLoader(d)
    base = "language_model.model.layers.1.self_attn.query_key_value"
    w = torch.from_numpy(np.array(ld.load(base + ".weight", (4, 3, 8, 32), np.float32)))
    b = torch.from_numpy(np.array(ld.load(base + ".bias", (4, 3, 8), np.float32)))
    attn = tm.lm.blocks[1].attn
    for j, lin in enumerate((attn.q_proj, attn.k_proj, attn.v_proj)):
        assert torch.equal(lin.weight, w[:, j].reshape(32, 32)) and torch.equal(lin.bias, b[:, j].reshape(32))


# ---------------------------------------------------------------------------
# OPT
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[True, False], ids=["pre_norm", "post_norm"])
def tiny_opt(request, tmp_path_factory):
    import transformers

    torch.manual_seed(0)
    cfg = transformers.OPTConfig(vocab_size=128, hidden_size=32, ffn_dim=64, num_hidden_layers=2,
                                 num_attention_heads=4, max_position_embeddings=64,
                                 do_layer_norm_before=request.param, word_embed_proj_dim=32)
    hf = transformers.OPTForCausalLM(cfg).eval()
    d = tmp_path_factory.mktemp("opt")
    hf.save_pretrained(d)
    return hf, str(d)


OPT_IDS = np.array([[2, 5, 17, 42, 99, 7]], np.int64)


def test_opt_matches_jax_and_transformers(tiny_opt):
    hf, d = tiny_opt
    jm = jopt.load_opt(JaxLoader(d), jopt.opt_config_from_hf(d))
    tm, kind = auto_model_any(d, torch.float32, device=CPU)
    assert kind == "opt" and isinstance(tm, topt.OPTForCausalLM)
    jl, jc = jm(jnp.asarray(OPT_IDS, jnp.int32), jm.init_cache(1, 32, jnp.float32), last_only=False)
    with torch.no_grad():
        tl, tc = tm(torch.from_numpy(OPT_IDS), tm.init_cache(1, 32, torch.float32), last_only=False)
        assert rel(tl, jl) < REL_TOL
        toks = port_greedy(tm, tl, tc, N_NEW)
        assert toks == jax_greedy(jm, jl, jc, N_NEW)
        torch.testing.assert_close(tl, hf(torch.from_numpy(OPT_IDS)).logits, rtol=2e-3, atol=2e-3)
        hf_toks = hf.generate(torch.from_numpy(OPT_IDS), max_new_tokens=N_NEW, do_sample=False,
                              eos_token_id=None, pad_token_id=1)[0, OPT_IDS.shape[1]:].tolist()
        assert toks == hf_toks
        bridged = opt_from_jax_params(_params(jm), tm.cfg, CPU)
        bl, _ = bridged(torch.from_numpy(OPT_IDS), bridged.init_cache(1, 32, torch.float32), last_only=False)
        assert rel(bl, tl) < 1e-6


def test_opt_attention_goes_through_attend(tiny_opt, monkeypatch):
    """Prefill and each decode step reach `nn.attention.attend` (the flash
    and decode kernels on the card), once a layer, with q pre-scaled and
    scale 1, the cache's head as q_offset and head + S as the length."""
    _, d = tiny_opt
    tm, _ = auto_model_any(d, torch.float32, device=CPU)
    calls = []
    real = topt.attend
    monkeypatch.setattr(topt, "attend", lambda q, k, v, **kw: calls.append((q.shape[1], int(kw["q_offset"]),
                                                                          int(kw["kv_valid_len"]), kw["scale"]))
                        or real(q, k, v, **kw))
    with torch.no_grad():
        _, c = tm(torch.from_numpy(OPT_IDS), tm.init_cache(1, 32, torch.float32))
        tm(torch.tensor([[3]]), c)
    assert calls == [(6, 0, 6, 1.0)] * 2 + [(1, 6, 7, 1.0)] * 2


# ---------------------------------------------------------------------------
# BERT
# ---------------------------------------------------------------------------

CORPUS = ["the quick brown fox jumps over the lazy dog", "a sentence embedding model reads text",
          "mean pooling over the valid tokens", "hello world, this is a wordpiece tokenizer"]


@pytest.fixture(scope="module")
def tiny_bert(tmp_path_factory):
    import transformers
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers

    d = tmp_path_factory.mktemp("bert")
    tok = Tokenizer(models.WordPiece(unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.train_from_iterator(CORPUS * 10, trainers.WordPieceTrainer(
        vocab_size=120, special_tokens=["[PAD]", "[UNK]", "[CLS]", "[SEP]"], show_progress=False))
    tok.save(str(d / "tokenizer.json"))
    torch.manual_seed(0)
    cfg = transformers.BertConfig(vocab_size=max(128, tok.get_vocab_size()), hidden_size=32, intermediate_size=64,
                                  num_hidden_layers=2, num_attention_heads=4, max_position_embeddings=32,
                                  type_vocab_size=2)
    hf = transformers.BertModel(cfg).eval()
    hf.save_pretrained(d)
    return hf, str(d)


BERT_IDS = np.array([[2, 5, 9, 11, 3, 0, 0], [2, 17, 4, 3, 0, 0, 0]], np.int64)
BERT_MASK = (np.arange(7)[None] < np.array([[5], [4]])).astype(np.int64)


def test_bert_matches_jax_and_transformers(tiny_bert):
    hf, d = tiny_bert
    jm = jbert.load_bert(JaxLoader(d), jbert.bert_config_from_hf(d))
    tm, tok, cfg = auto_model(d, torch.float32, device=CPU)
    assert isinstance(tm, tbert.BertModel) and cfg is tm.cfg
    from tokenizers import Tokenizer

    ref_tok = Tokenizer.from_file(d + "/tokenizer.json")
    assert tok.encode("the lazy fox jumps") == ref_tok.encode("the lazy fox jumps").ids
    ids, mask = torch.from_numpy(BERT_IDS), torch.from_numpy(BERT_MASK)
    jh = jm(jnp.asarray(BERT_IDS, jnp.int32), jnp.asarray(BERT_MASK, jnp.int32))
    je = jm.sentence_embedding(jnp.asarray(BERT_IDS, jnp.int32), jnp.asarray(BERT_MASK, jnp.int32))
    with torch.no_grad():
        th = tm(ids, mask)
        te = tm.sentence_embedding(ids, mask)
        ref = hf(ids, attention_mask=mask).last_hidden_state
    valid = BERT_MASK.astype(bool)
    assert rel(th.numpy()[valid], np.asarray(jh)[valid]) < REL_TOL
    assert rel(te, je) < REL_TOL
    torch.testing.assert_close(th[mask.bool()], ref[mask.bool()], rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(torch.linalg.norm(te, dim=-1).numpy(), 1.0, rtol=1e-6)
    bridged = bert_from_jax_params(_params(jm), tm.cfg, CPU)
    with torch.no_grad():
        assert torch.equal(bridged.sentence_embedding(ids, mask), te)


def test_bert_prefixed_checkpoint(tmp_path):
    """A `BertForMaskedLM`-style checkpoint (`bert.` names) loads the same encoder."""
    import transformers

    torch.manual_seed(1)
    cfg = transformers.BertConfig(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=1,
                                  num_attention_heads=4, max_position_embeddings=16)
    hf = transformers.BertForMaskedLM(cfg).eval()
    hf.save_pretrained(tmp_path)
    model, kind = auto_model_any(str(tmp_path), torch.float32, device=CPU)
    assert kind == "bert"
    ids = torch.tensor([[2, 7, 9, 3]])
    with torch.no_grad():
        torch.testing.assert_close(model(ids, torch.ones_like(ids)),
                                   hf.bert(ids, attention_mask=torch.ones_like(ids)).last_hidden_state,
                                   rtol=2e-3, atol=2e-3)
