"""Log-mel spectrogram front end (Whisper preprocessing), PyTorch.

Port of ``tpu_voice_agent/audio/mel.py``. The filterbank and the windowed
DFT matrices are the same numpy arrays, bit for bit; the STFT stays two
fp32 matmuls of the framed audio against them (not ``torch.stft``), so both
packages do the same arithmetic: reflect pad n_fft // 2, frames at ``hop``,
power spectrum, mel projection, log10, a clamp at the global max - 8, then
(x + 4) / 4.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..utils.compilewatch import watch_compiles


@dataclass(frozen=True)
class MelConfig:
    sample_rate: int = 16_000
    n_fft: int = 400
    hop: int = 160
    n_mels: int = 80
    fmin: float = 0.0
    fmax: float = 8_000.0


def _hz_to_mel(f: np.ndarray | float) -> np.ndarray:
    """Slaney mel scale (linear below 1 kHz, log above)."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    f_safe = np.maximum(f, 1e-10)  # keep log() quiet for the linear branch
    return np.where(f >= min_log_hz, min_log_mel + np.log(f_safe / min_log_hz) / logstep, mels)


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), f_sp * m)


@lru_cache(maxsize=4)
def mel_filterbank(cfg: MelConfig) -> np.ndarray:
    """(n_bins, n_mels) triangular Slaney filterbank with area normalization."""
    n_bins = cfg.n_fft // 2 + 1
    fft_freqs = np.linspace(0, cfg.sample_rate / 2, n_bins)
    mel_pts = np.linspace(_hz_to_mel(cfg.fmin), _hz_to_mel(cfg.fmax), cfg.n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    fb = np.zeros((n_bins, cfg.n_mels))
    for m in range(cfg.n_mels):
        lo, ctr, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-10)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
        # Slaney area normalization
        fb[:, m] *= 2.0 / (hi - lo)
    return fb.astype(np.float32)


@lru_cache(maxsize=4)
def _dft_matrices(cfg: MelConfig) -> tuple[np.ndarray, np.ndarray]:
    """Windowed real-DFT matrices (n_fft, n_bins): cos and -sin, with the
    Hann window folded in so the STFT is exactly two matmuls."""
    n = cfg.n_fft
    n_bins = n // 2 + 1
    window = np.hanning(n + 1)[:-1]
    t = np.arange(n)[:, None]
    k = np.arange(n_bins)[None, :]
    angle = -2.0 * np.pi * t * k / n
    cos_m = (np.cos(angle) * window[:, None]).astype(np.float32)
    sin_m = (np.sin(angle) * window[:, None]).astype(np.float32)
    return cos_m, sin_m


@lru_cache(maxsize=8)
def _tables(cfg: MelConfig, device: torch.device):
    """The DFT matrices and filterbank as fp32 tensors on ``device``, made
    once per (config, device)."""
    cos_m, sin_m = _dft_matrices(cfg)
    return tuple(torch.from_numpy(a).to(device) for a in (cos_m, sin_m, mel_filterbank(cfg)))


@watch_compiles("audio.log_mel_spectrogram")
@torch.no_grad()
def log_mel_spectrogram(audio: torch.Tensor, cfg: MelConfig = MelConfig()) -> torch.Tensor:
    """audio (n_samples,) float32 in [-1, 1] -> (n_frames, n_mels) float32 on
    the audio's device."""
    cos_m, sin_m, fb = _tables(cfg, audio.device)
    pad = cfg.n_fft // 2
    x = torch.nn.functional.pad(audio.float()[None, None], (pad, pad), mode="reflect")[0, 0]
    frames = x.unfold(0, cfg.n_fft, cfg.hop)  # (n_frames, n_fft)
    re = frames @ cos_m
    im = frames @ sin_m
    power = re * re + im * im  # (n_frames, n_bins)
    mel = torch.clamp(power @ fb, min=1e-10)
    log_spec = torch.log10(mel)
    log_spec = torch.maximum(log_spec, log_spec.max() - 8.0)
    return (log_spec + 4.0) / 4.0


def pcm16_to_float(data: bytes) -> np.ndarray:
    """PCM16LE bytes -> float32 [-1, 1] (the web client's wire format)."""
    return np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
