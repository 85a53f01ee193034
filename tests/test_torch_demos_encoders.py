"""The port's encoder demos (`mllm_tpu_torch.examples.demo_clip`, `demo_vit`,
`demo_bert`, `demo_imagebind`, `demo_imagebind_1mod`) against the JAX
package, run in process with `--device cpu` on tiny checkpoints in f32 (the
demos' dtype): CLIP and ViT as `tests/test_torch_clip_vit.py` builds them
(towers 32 wide, 2 layers), BERT as `tests/test_torch_fuyu_opt_bert.py`
(a WordPiece tokenizer.json trained on a few sentences), ImageBind at
`tests/test_torch_imagebind_audio.py`'s TINY widths on the JAX `init`
weights carried across through `models/bridge.py` (the two packages' random
inits differ), with a WAV written by numpy.

The JAX side is its own functions called as each JAX demo calls them. CLIP
probabilities, ViT top-k probabilities, BERT cosines and ImageBind scores
within 1e-4 of JAX's; the ViT labels, the CLIP / BERT token ids and the
ImageBind hash ids equal. `demo_imagebind_1mod` inserts no flag, as its
JAX file inserts none (read from `examples/demo_imagebind_1mod.py`).
"""

import json
import os
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mllm_tpu.core.param_loader import SafetensorsLoader as JaxLoader
from mllm_tpu.models import bert as jbert
from mllm_tpu.models import clip as jclip
from mllm_tpu.models import imagebind as jib
from mllm_tpu.models import vit as jvit
from mllm_tpu.models.registry import open_loader as jax_open_loader
from mllm_tpu.processor import image as jimage
from mllm_tpu.processor.audio import ImageBindAudioProcessor as JaxAudioProcessor
from mllm_tpu.tokenizers.hf_json import auto_tokenizer as jax_auto_tokenizer
from mllm_tpu_torch.examples import demo_bert, demo_clip, demo_imagebind, demo_imagebind_1mod, demo_vit
from mllm_tpu_torch.models import imagebind as tib
from mllm_tpu_torch.models.bridge import imagebind_from_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
TOL = 1e-4
V = 300
TEXTS = ["a photo of a cat", "a photo of a dog", "Two birds"]
IB_TINY = dict(vision_hidden=32, vision_heads=4, vision_ffn=64, patch=14, patch_time=2, img_hw=28, time_frames=2,
               vision_blocks=2, text_hidden=32, text_heads=4, text_ffn=64, vocab_size=100, max_positions=16,
               text_blocks=2, audio_hidden=32, audio_heads=4, audio_ffn=64, audio_kernel=16, audio_stride=10,
               audio_h=128, audio_w=204, audio_blocks=2, audio_clips=3, head_dim=24)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tmp_path_factory.mktemp("demos_enc")


@pytest.fixture(scope="module")
def image(root):
    from PIL import Image

    Image.fromarray(np.random.default_rng(0).integers(0, 256, (40, 52, 3), np.uint8)).save(root / "img.png")
    return str(root / "img.png")


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.abs(got - want).max() <= tol, (got, want)


@pytest.fixture(scope="module")
def clip_dir(root):
    import transformers

    torch.manual_seed(0)
    cfg = transformers.CLIPConfig(
        text_config_dict=dict(vocab_size=V, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                              num_attention_heads=4, max_position_embeddings=32, eos_token_id=V - 1),
        vision_config_dict=dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
                                image_size=28, patch_size=14),
        projection_dim=24)
    d = root / "clip"
    transformers.CLIPModel(cfg).eval().save_pretrained(d)
    with open(d / "tokenizer.json", "w", encoding="utf-8") as f:
        json.dump(chip_smoke.synthetic_tokenizer(V, 5, specials=("<|startoftext|>", "<|endoftext|>")), f,
                  ensure_ascii=False)
    return str(d)


def test_demo_clip_probabilities_equal_jax(clip_dir, image, capsys):
    got = demo_clip.main(["-m", clip_dir, "-i", image, "--texts", *TEXTS, "--device", "cpu"])
    cfg = jclip.clip_config_from_hf(clip_dir)
    jm = jclip.load_clip(JaxLoader(clip_dir), cfg, jnp.float32)
    tok = jax_auto_tokenizer(clip_dir)
    bos, eos = tok.token_to_id["<|startoftext|>"], tok.token_to_id["<|endoftext|>"]
    seqs = [[bos] + tok.encode(t.lower()) + [eos] for t in TEXTS]
    ids = np.full((len(seqs), max(map(len, seqs))), eos, np.int32)
    for i, s in enumerate(seqs):
        ids[i, : len(s)] = s
    assert got["ids"] == ids.tolist()
    pixel = jimage.ClipImageProcessor(size=cfg.vision.image_size, crop=cfg.vision.image_size)(image)
    want = np.asarray(jax.nn.softmax(jm(jnp.asarray(ids), jnp.asarray(pixel)), axis=-1))[0]
    _close(got["probs"], want)
    assert abs(sum(got["probs"]) - 1) < 1e-5
    lines = capsys.readouterr().out.splitlines()
    assert lines[-len(TEXTS):] == [f"  {p:6.3f}  {t}" for t, p in zip(TEXTS, got["probs"])]


@pytest.fixture(scope="module")
def vit_dir(root):
    import transformers

    torch.manual_seed(0)
    cfg = transformers.ViTConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
                                 image_size=32, patch_size=16, num_labels=5, initializer_range=0.2,
                                 id2label={i: f"class_{i}" for i in range(5)},
                                 label2id={f"class_{i}": i for i in range(5)})
    d = root / "vit"
    transformers.ViTForImageClassification(cfg).eval().save_pretrained(d)
    return str(d)


def test_demo_vit_top_k_equals_jax(vit_dir, image, root, capsys):
    from PIL import Image

    second = str(root / "img2.png")
    Image.fromarray(np.random.default_rng(1).integers(0, 256, (48, 30, 3), np.uint8)).save(second)
    got = demo_vit.main(["-m", vit_dir, "-i", image, second, "--top-k", "3", "--device", "cpu"])
    cfg, n_labels, id2label = jvit.vit_config_from_hf(vit_dir)
    jm = jvit.load_vit_classifier(jax_open_loader(vit_dir), cfg, n_labels, jnp.float32, id2label)

    def proc(path):
        x = jimage.resize(jimage.load_image(path), cfg.image_size, cfg.image_size, "bilinear")
        return jimage.rescale_normalize(x, (0.5, 0.5, 0.5), (0.5, 0.5, 0.5)).transpose(2, 0, 1)[None]

    want = jm.classify(jnp.asarray(np.concatenate([proc(image), proc(second)])), 3)
    assert len(got["preds"]) == 2
    for g, w in zip(got["preds"], want):
        assert [lbl for lbl, _ in g] == [lbl for lbl, _ in w]
        _close([p for _, p in g], [p for _, p in w])
    assert f"{second}: " in capsys.readouterr().out


@pytest.fixture(scope="module")
def bert_dir(root):
    import transformers
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers

    from test_torch_fuyu_opt_bert import CORPUS

    d = root / "bert"
    d.mkdir()
    tok = Tokenizer(models.WordPiece(unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.train_from_iterator(CORPUS * 10, trainers.WordPieceTrainer(
        vocab_size=120, special_tokens=["[PAD]", "[UNK]", "[CLS]", "[SEP]"], show_progress=False))
    tok.save(str(d / "tokenizer.json"))
    torch.manual_seed(0)
    cfg = transformers.BertConfig(vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                  num_attention_heads=4, max_position_embeddings=32, type_vocab_size=2)
    transformers.BertModel(cfg).eval().save_pretrained(d)
    return str(d)


def test_demo_bert_cosines_equal_jax(bert_dir, capsys):
    texts = ["the quick brown fox", "a sentence embedding model reads text", "hello world"]
    got = demo_bert.main(["-m", bert_dir, "--texts", *texts, "--device", "cpu"])
    cfg = jbert.bert_config_from_hf(bert_dir)
    jm = jbert.load_bert(jax_open_loader(bert_dir), cfg, jnp.float32)
    tok = jax_auto_tokenizer(bert_dir)
    cls, sep = tok.token_to_id.get("[CLS]", 101), tok.token_to_id.get("[SEP]", 102)
    seqs = [[cls] + tok.encode(t) + [sep] for t in texts]
    ids = np.zeros((3, max(map(len, seqs))), np.int32)
    mask = np.zeros_like(ids)
    for i, s in enumerate(seqs):
        ids[i, : len(s)] = s
        mask[i, : len(s)] = 1
    assert got["ids"] == ids.tolist() and got["mask"] == mask.tolist()
    emb = np.asarray(jm.sentence_embedding(jnp.asarray(ids), jnp.asarray(mask)))
    _close(got["cosine"], emb @ emb.T)
    out = capsys.readouterr().out
    assert "cosine similarity:" in out and f"  [2] {texts[2]!r}" in out


def _write_wav(path, seed: int, sr: int = 16000) -> str:
    data = (np.random.default_rng(seed).standard_normal(sr * 3) * 6000).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(data.tobytes())
    return str(path)


@pytest.fixture
def tiny_imagebind(monkeypatch):
    """The demos' ImageBindConfig() at TINY widths, and `init` giving the JAX
    init's weights (PRNGKey(0), as the JAX demo) through the bridge. Returns
    the JAX model."""
    jcfg = jib.ImageBindConfig(**IB_TINY)
    jm = jib.ImageBindModel.init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    params = {k: np.asarray(v) for k, v in jm.parameters().items()}
    tiny = tib.ImageBindConfig(**IB_TINY)
    monkeypatch.setattr(tib, "ImageBindConfig", lambda: tiny)
    monkeypatch.setattr(tib.ImageBindModel, "init", staticmethod(
        lambda cfg, *, device, dtype, generator: imagebind_from_jax_params(params, cfg, device, dtype)))
    return jm


def _jax_imagebind(jm, image, texts, audio):
    """The JAX demo's inputs and call, after its model is built."""
    cfg = jib.ImageBindConfig(**IB_TINY)
    pix = jimage.ClipImageProcessor(size=cfg.img_hw, crop=cfg.img_hw)(image)
    patches = jib.patchify_video(np.repeat(pix[:, :, None], cfg.time_frames, axis=2), cfg.patch, cfg.patch_time)
    ids = np.zeros((len(texts), 8), np.int32)
    eot = np.zeros(len(texts), np.int32)
    for i, t in enumerate(texts):
        toks = [abs(hash(w)) % (cfg.vocab_size - 2) for w in t.split()][:7]
        ids[i, : len(toks)] = toks
        ids[i, len(toks)] = cfg.vocab_size - 1
        eot[i] = len(toks)
    fb = (JaxAudioProcessor()(audio) if audio
          else np.zeros((cfg.audio_clips, 1, cfg.audio_h, cfg.audio_w), np.float32))
    vt, va = jm(jnp.asarray(ids), jnp.asarray(eot), jnp.asarray(patches), jnp.asarray(fb))
    return ids, np.asarray(vt)[0], np.asarray(va)[0]


@pytest.mark.parametrize("audio", [True, False], ids=["wav", "no_audio"])
def test_demo_imagebind_scores_equal_jax(tiny_imagebind, image, root, audio, capsys):
    texts = ["a dog.", "a car", "a very small bird"]
    wav = _write_wav(root / "clip.wav", 0) if audio else None
    got = demo_imagebind.main(["-i", image, "--texts", *texts, "--device", "cpu"]
                              + (["--audio", wav] if audio else []))
    ids, vt, va = _jax_imagebind(tiny_imagebind, image, texts, wav)
    assert got["ids"] == ids.tolist()
    _close(got["vision_text"], vt)
    _close(got["vision_audio"], va)
    out = capsys.readouterr().out
    assert "(random weights demo" in out and "vision x text:" in out and "vision x audio:" in out


def test_demo_imagebind_refuses_a_weights_directory(image, tmp_path):
    with pytest.raises(SystemExit, match="checkpoint loading for ImageBind lands with the convertor"):
        demo_imagebind.main(["-m", str(tmp_path), "-i", image, "--device", "cpu"])


def test_demo_imagebind_1mod_inserts_what_its_jax_file_inserts(tiny_imagebind, image):
    with open(os.path.join(REPO, "examples", "demo_imagebind_1mod.py")) as f:
        src = f.read()
    assert "sys.argv[1:1]" not in src and "demo_imagebind.main()" in src  # the JAX alias inserts no flag
    argv = ["-i", image, "--device", "cpu"]
    one, full = demo_imagebind_1mod.main(argv), demo_imagebind.main(argv)
    assert {k: v for k, v in one.items() if k != "score_s"} == {k: v for k, v in full.items() if k != "score_s"}


@pytest.mark.parametrize("demo,argv", [(demo_clip, ["-m", "unused", "-i", "x.png"]),
                                       (demo_vit, ["-m", "unused", "-i", "x.png"]),
                                       (demo_bert, ["-m", "unused"]),
                                       (demo_imagebind, ["-i", "x.png"]),
                                       (demo_imagebind_1mod, ["-i", "x.png"])])
def test_encoder_demos_need_a_card_unless_cpu_is_asked(demo, argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="found none"):
        demo.main(argv)
