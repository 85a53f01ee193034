"""Audio front end: WAV -> resample -> kaldi-style log-mel fbank -> clips.
Copied from `mllm_tpu/processor/audio.py` (numpy and the standard library
only, on the host), so the port imports nothing of the JAX package.

25 ms frames, 10 ms shift, povey window, preemphasis 0.97, kaldi mel banks,
natural log; the ImageBind packaging is three 2 s clips of 204 frames x 128
bins, normalized with mean -4.268 and std 9.138.
"""

from __future__ import annotations

import math
import struct
import wave
from dataclasses import dataclass
from fractions import Fraction
from typing import Optional

import numpy as np


def read_wav(path) -> tuple[np.ndarray, int]:
    """Returns (samples float32 [n] in int16 range, sample_rate). Multi-channel
    is averaged."""
    with wave.open(str(path), "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32)
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 65536.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) * 256.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if ch > 1:
        data = data.reshape(-1, ch).mean(axis=1)
    return data, sr


def resample_poly(x: np.ndarray, target_sr: int, orig_sr: int) -> np.ndarray:
    """Polyphase-style resampling via windowed-sinc interpolation."""
    if target_sr == orig_sr:
        return x
    g = math.gcd(target_sr, orig_sr)
    up, down = target_sr // g, orig_sr // g
    # windowed-sinc low-pass at min(pi/up, pi/down)
    n_out = int(len(x) * up / down)
    t_out = np.arange(n_out, dtype=np.float64) * down / up  # positions in input samples
    width = 16
    idx = np.floor(t_out).astype(np.int64)
    out = np.zeros(n_out, np.float64)
    cutoff = min(1.0, up / down)
    for k in range(-width, width + 1):
        j = idx + k
        valid = (j >= 0) & (j < len(x))
        delta = t_out - j
        h = cutoff * np.sinc(cutoff * delta) * _hann(delta / (width + 1))
        out += np.where(valid, x[np.clip(j, 0, len(x) - 1)] * h, 0.0)
    return out.astype(np.float32)


def _hann(u):
    v = np.clip(u, -1.0, 1.0)
    return 0.5 * (1.0 + np.cos(np.pi * v))


def mel_scale(f):
    return 1127.0 * np.log(1.0 + f / 700.0)


def inverse_mel_scale(m):
    return 700.0 * (np.exp(m / 1127.0) - 1.0)


def kaldi_mel_banks(num_bins: int, fft_size: int, sample_rate: int,
                    low_freq: float = 20.0, high_freq: float = 0.0) -> np.ndarray:
    """Kaldi triangular mel bank [num_bins, fft_size//2+1]."""
    if high_freq <= 0:
        high_freq = sample_rate / 2 + high_freq
    n_fft_bins = fft_size // 2
    fft_bin_width = sample_rate / fft_size
    mel_low = mel_scale(low_freq)
    mel_high = mel_scale(high_freq)
    delta = (mel_high - mel_low) / (num_bins + 1)
    banks = np.zeros((num_bins, n_fft_bins + 1), np.float32)
    for b in range(num_bins):
        left, center, right = mel_low + b * delta, mel_low + (b + 1) * delta, mel_low + (b + 2) * delta
        for i in range(n_fft_bins):
            mel = mel_scale(fft_bin_width * i)
            if left < mel < right:
                banks[b, i] = (mel - left) / (center - left) if mel <= center else (right - mel) / (right - center)
    return banks


@dataclass
class FbankConfig:
    num_bins: int = 80
    sample_rate: int = 16000
    frame_length_ms: float = 25.0
    frame_shift_ms: float = 10.0
    preemphasis: float = 0.97
    remove_dc: bool = True
    window: str = "povey"
    use_log: bool = True
    dither: float = 0.0


def fbank(x: np.ndarray, cfg: FbankConfig = FbankConfig()) -> np.ndarray:
    """Log-mel filterbank features [num_frames, num_bins] (kaldi semantics,
    snip_edges=True)."""
    frame_len = int(cfg.sample_rate / 1000 * cfg.frame_length_ms)
    shift = int(cfg.sample_rate / 1000 * cfg.frame_shift_ms)
    if len(x) < frame_len:
        return np.zeros((0, cfg.num_bins), np.float32)
    n_frames = 1 + (len(x) - frame_len) // shift
    idx = np.arange(frame_len)[None, :] + shift * np.arange(n_frames)[:, None]
    frames = x[idx].astype(np.float64)

    if cfg.dither > 0:
        frames = frames + cfg.dither * np.random.standard_normal(frames.shape)
    if cfg.remove_dc:
        frames = frames - frames.mean(axis=1, keepdims=True)
    if cfg.preemphasis > 0:
        pre = np.concatenate([frames[:, :1], frames[:, :-1]], axis=1)
        frames = frames - cfg.preemphasis * pre

    n = np.arange(frame_len)
    if cfg.window == "povey":
        win = (0.5 - 0.5 * np.cos(2 * np.pi * n / (frame_len - 1))) ** 0.85
    elif cfg.window == "hanning":
        win = 0.5 - 0.5 * np.cos(2 * np.pi * n / (frame_len - 1))
    else:
        win = np.hamming(frame_len)
    frames = frames * win

    fft_size = 1
    while fft_size < frame_len:
        fft_size *= 2
    spec = np.fft.rfft(frames, n=fft_size, axis=1)
    power = np.abs(spec).astype(np.float64) ** 2

    banks = kaldi_mel_banks(cfg.num_bins, fft_size, cfg.sample_rate)
    mel = power @ banks.T
    if cfg.use_log:
        mel = np.log(np.maximum(mel, np.finfo(np.float32).eps))
    return mel.astype(np.float32)


def get_clip_timepoints(clip_duration_s: Fraction, clips_per_video: Fraction,
                        duration_s: Fraction) -> list[tuple[Fraction, Fraction]]:
    """Constant-clips sampler (pytorchvideo ConstantClipsPerVideoSampler
    semantics)."""
    out = []
    max_start = max(duration_s - clip_duration_s, Fraction(0))
    n = int(clips_per_video)
    for i in range(n):
        start = (max_start * i) / max(n - 1, 1)
        out.append((start, start + clip_duration_s))
    return out


@dataclass
class ImageBindAudioProcessor:
    """WAV -> 3 clips of [1, 128, 204] normalized log-mel."""

    num_bins: int = 128
    sample_rate: int = 16000
    num_frames: int = 204
    clip_duration_s: int = 2
    clips_per_video: int = 3
    mean: float = -4.268
    std: float = 9.138

    def __call__(self, path) -> np.ndarray:
        data, sr = read_wav(path)
        data = resample_poly(data, self.sample_rate, sr)
        dur = Fraction(len(data), self.sample_rate)
        points = get_clip_timepoints(
            Fraction(self.clip_duration_s), Fraction(self.clips_per_video), dur
        )
        cfg = FbankConfig(num_bins=self.num_bins, sample_rate=self.sample_rate)
        clips = []
        for s, e in points:
            a = int(float(s * self.sample_rate))
            b = int(float(e * self.sample_rate))
            feats = fbank(data[a:b], cfg)  # [T, bins]
            # pad/trim to num_frames
            if feats.shape[0] < self.num_frames:
                pad = np.zeros((self.num_frames - feats.shape[0], self.num_bins), np.float32)
                feats = np.concatenate([feats, pad])
            feats = feats[: self.num_frames]
            feats = (feats.T - self.mean) / self.std  # [bins, T]
            clips.append(feats[None])  # [1, bins, T]
        return np.stack(clips)  # [clips, 1, bins, frames]
