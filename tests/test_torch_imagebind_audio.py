"""The port's audio front end (`mllm_tpu_torch.processor.audio`, a copy of
the JAX package's numpy module) and ImageBind (`models.imagebind`) on the CPU
against the JAX package.

The audio copy is held bit for bit: fbank, the mel banks, resampling, the
clip sampler and the ImageBind processor on a seeded waveform give the same
arrays as `mllm_tpu.processor.audio`. ImageBind at tiny widths (towers 32
wide, 2 blocks, 4 heads, 28 px frames of 14 px patches, the real 128 x 204
fbank geometry, a 100-entry vocabulary; tests/test_imagebind.py's TINY) on
the JAX `ImageBindModel.init` weights through the bridge, in f32: the three
embeddings and the two score matrices within 1e-4 relative.
"""

import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mllm_tpu.models import imagebind as jib
from mllm_tpu.processor import audio as jaudio
from mllm_tpu_torch.models import imagebind as tib
from mllm_tpu_torch.models.bridge import imagebind_from_jax_params
from mllm_tpu_torch.processor import audio as taudio

CPU = torch.device("cpu")
REL_TOL = 1e-4


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _write_wav(path, data_int16, sr):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(np.asarray(data_int16, "<i2").tobytes())


@pytest.mark.parametrize("bins", [80, 128])
def test_fbank_bit_equal(bins):
    x = (np.random.default_rng(bins).standard_normal(16000 * 2) * 3000).astype(np.float32)
    cfg = dict(num_bins=bins)
    got = taudio.fbank(x, taudio.FbankConfig(**cfg))
    want = jaudio.fbank(x, jaudio.FbankConfig(**cfg))
    assert got.dtype == want.dtype and got.shape == want.shape == (198, bins)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(taudio.kaldi_mel_banks(bins, 512, 16000), jaudio.kaldi_mel_banks(bins, 512, 16000))


def test_resample_and_clips_bit_equal():
    from fractions import Fraction

    x = (np.random.default_rng(3).standard_normal(22050) * 1000).astype(np.float32)
    np.testing.assert_array_equal(taudio.resample_poly(x, 16000, 22050), jaudio.resample_poly(x, 16000, 22050))
    args = (Fraction(2), Fraction(3), Fraction(7, 2))
    assert taudio.get_clip_timepoints(*args) == jaudio.get_clip_timepoints(*args)
    np.testing.assert_array_equal(taudio.mel_scale(np.arange(5.0) * 100), jaudio.mel_scale(np.arange(5.0) * 100))


def test_imagebind_processor_bit_equal(tmp_path):
    sr = 22050  # resampled to 16 kHz
    _write_wav(tmp_path / "a.wav", (np.random.default_rng(0).standard_normal(sr * 5) * 8000).astype(np.int16), sr)
    got = taudio.ImageBindAudioProcessor()(tmp_path / "a.wav")
    assert got.shape == (3, 1, 128, 204)
    np.testing.assert_array_equal(got, jaudio.ImageBindAudioProcessor()(tmp_path / "a.wav"))
    y, sr2 = taudio.read_wav(tmp_path / "a.wav")
    assert sr2 == sr and y.dtype == np.float32


TINY = dict(vision_hidden=32, vision_heads=4, vision_ffn=64, patch=14, patch_time=2, img_hw=28, time_frames=2,
            vision_blocks=2, text_hidden=32, text_heads=4, text_ffn=64, vocab_size=100, max_positions=16,
            text_blocks=2, audio_hidden=32, audio_heads=4, audio_ffn=64, audio_kernel=16, audio_stride=10,
            audio_h=128, audio_w=204, audio_blocks=2, audio_clips=3, head_dim=24)


@pytest.fixture(scope="module")
def pair():
    jm = jib.ImageBindModel.init(jax.random.PRNGKey(0), jib.ImageBindConfig(**TINY))
    cfg = tib.ImageBindConfig(**TINY)
    tm = imagebind_from_jax_params({k: np.asarray(v) for k, v in jm.parameters().items()}, cfg, CPU)
    return jm, tm


def _inputs(seed):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((2, 3, 2, 28, 28)).astype(np.float32)
    patches = tib.patchify_video(frames, 14, 2)
    np.testing.assert_array_equal(patches, jib.patchify_video(frames, 14, 2))
    ids = np.array([[5, 9, 2, 99, 0, 0], [7, 3, 99, 0, 0, 0], [4, 4, 4, 4, 4, 99]], np.int64)
    eot = np.array([3, 2, 5], np.int64)
    fb = rng.standard_normal((2 * 3, 1, 128, 204)).astype(np.float32)
    return patches, ids, eot, fb


def test_imagebind_matches_jax(pair):
    jm, tm = pair
    patches, ids, eot, fb = _inputs(0)
    jv, jt, ja = (jm.vision_model(jnp.asarray(patches)), jm.text_model(jnp.asarray(ids), jnp.asarray(eot)),
                  jm.audio_model(jnp.asarray(fb)))
    jvt, jva = jm(jnp.asarray(ids), jnp.asarray(eot), jnp.asarray(patches), jnp.asarray(fb))
    with torch.no_grad():
        tv, tt, ta = (tm.vision_model(torch.from_numpy(patches)),
                      tm.text_model(torch.from_numpy(ids), torch.from_numpy(eot)), tm.audio_model(torch.from_numpy(fb)))
        tvt, tva = tm(torch.from_numpy(ids), torch.from_numpy(eot), torch.from_numpy(patches), torch.from_numpy(fb))
    assert tv.shape == (2, 24) and tt.shape == (3, 24) and ta.shape == (2, 24)
    assert tvt.shape == (2, 3) and tva.shape == (2, 2)
    for got, want in ((tv, jv), (tt, jt), (ta, ja), (tvt, jvt), (tva, jva)):
        assert rel(got, want) < REL_TOL
    np.testing.assert_allclose(torch.linalg.norm(tv, dim=-1).numpy(), 1.0, rtol=1e-5)
    np.testing.assert_allclose(tvt.sum(-1).numpy(), 1.0, rtol=1e-5)


def test_audio_patch_embedding_is_the_convolution(pair):
    """The audio tower's unfold-and-product patch embedding equals the
    stride-10 VALID convolution it stands for."""
    _, tm = pair
    fb = torch.from_numpy(_inputs(1)[3])
    a = tm.audio_model
    k, st = a.cfg.audio_kernel, a.cfg.audio_stride
    conv = torch.nn.functional.conv2d(fb, a.patch_weight, stride=st)  # [N, D, nh, nw]
    p = fb.unfold(2, k, st).unfold(3, k, st).permute(0, 2, 3, 1, 4, 5).reshape(fb.shape[0], -1, k * k)
    ours = p @ a.patch_weight.reshape(a.patch_weight.shape[0], -1).T
    assert ours.shape[1] + 1 == a.cfg.audio_seq
    torch.testing.assert_close(ours, conv.flatten(2).transpose(1, 2), rtol=1e-5, atol=1e-5)


def test_imagebind_init_runs():
    """ImageBindModel.init draws the JAX init's distributions and scores."""
    cfg = tib.ImageBindConfig(**TINY)
    m = tib.ImageBindModel.init(cfg, device=CPU, generator=torch.Generator().manual_seed(4))
    assert float(m.text_model.pos_embed.std()) == pytest.approx(0.01, rel=0.1)
    assert not m.vision_model.cls_token.any()
    patches, ids, eot, fb = _inputs(2)
    with torch.no_grad():
        vt, va = m(torch.from_numpy(ids), torch.from_numpy(eot), torch.from_numpy(patches), torch.from_numpy(fb))
    assert torch.isfinite(vt).all() and torch.isfinite(va).all()
