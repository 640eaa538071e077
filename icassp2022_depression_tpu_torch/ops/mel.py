"""Log-mel spectrogram frontend (port of :mod:`icassp2022_depression_tpu.ops.mel`).

``frame -> Hann window -> rFFT -> |.|^2 -> mel filterbank matmul -> log
floor``, the reference's ``log(max(1e-6, librosa melspectrogram))``
(``Classification/audio_features_whole.py:60-61``).  The filterbank and
the window are host-side numpy, copied from the JAX package; the spectrum
is ``torch.fft.rfft`` (cuFFT on the card, as the JAX package leaves its
FFT to XLA).  Every function takes a leading batch of rows, so a whole
length bucket is one pass.

librosa-compatible settings: n_fft=2048, hop=512, centred frames with
reflect padding, periodic Hann window, power=2, Slaney mel scale with
Slaney area normalisation, fmin=0, fmax=sr/2.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def hz_to_mel(frequencies, htk: bool = False):
    frequencies = np.asanyarray(frequencies, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + frequencies / 700.0)
    # Slaney formula: linear below 1 kHz, log above.
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (frequencies - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = frequencies >= min_log_hz
    mels = np.where(
        log_region,
        min_log_mel + np.log(np.maximum(frequencies, 1e-10) / min_log_hz) / logstep,
        mels,
    )
    return mels


def mel_to_hz(mels, htk: bool = False):
    mels = np.asanyarray(mels, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = mels >= min_log_mel
    freqs = np.where(log_region,
                     min_log_hz * np.exp(logstep * (mels - min_log_mel)),
                     freqs)
    return freqs


@functools.lru_cache(maxsize=16)
def mel_filterbank(sr: int, n_fft: int, n_mels: int,
                   fmin: float = 0.0, fmax: float | None = None,
                   htk: bool = False) -> np.ndarray:
    """Dense [n_mels, 1 + n_fft//2] triangular filterbank with Slaney
    normalisation (librosa.filters.mel semantics).  Cached per geometry;
    callers must not write to the returned array."""
    if fmax is None:
        fmax = sr / 2.0
    n_bins = 1 + n_fft // 2
    fft_freqs = np.linspace(0.0, sr / 2.0, n_bins)
    mel_pts = np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts, htk)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    # Slaney area normalisation
    enorm = 2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def hann_window(n: int) -> np.ndarray:
    """Periodic Hann (scipy get_window('hann', n, fftbins=True))."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float32)


def power_spectrogram(y: torch.Tensor, n_fft: int = 2048, hop: int = 512,
                      center: bool = True) -> torch.Tensor:
    """[..., T] waveforms -> [..., frames, 1 + n_fft//2] power spectrogram."""
    if center:
        lead = y.shape[:-1]
        y = F.pad(y.reshape(-1, 1, y.shape[-1]), (n_fft // 2, n_fft // 2),
                  mode="reflect").reshape(*lead, -1)
    frames = y.unfold(-1, n_fft, hop)                      # [..., F, n_fft]
    window = torch.from_numpy(hann_window(n_fft)).to(y.device)
    spec = torch.fft.rfft(frames * window, dim=-1)
    return (spec.real.square() + spec.imag.square()).to(torch.float32)


def log_mel(y: torch.Tensor, sr: int = 16000, n_fft: int = 2048,
            hop: int = 512, n_mels: int = 80, log_floor: float = 1e-6,
            center: bool = True) -> torch.Tensor:
    """[..., T] waveforms -> [..., frames, n_mels] log-mel, exactly the
    reference's ``log(max(1e-6, melspectrogram(...).T))``."""
    spec = power_spectrogram(y, n_fft, hop, center)            # [..., F, bins]
    fb = torch.from_numpy(mel_filterbank(sr, n_fft, n_mels)).to(y.device)
    mel = torch.matmul(spec, fb.t())
    return torch.log(torch.clamp_min(mel, log_floor))


def frame_mask(lengths: torch.Tensor, max_frames: int, hop: int = 512,
               center: bool = True, n_fft: int = 2048) -> torch.Tensor:
    """Valid-frame mask [B, max_frames] for a batch of padded waveforms with
    true sample counts ``lengths`` [B] (ragged batching support)."""
    if center:
        nf = 1 + lengths // hop
    else:
        nf = 1 + (lengths - n_fft) // hop
    frames = torch.arange(max_frames, device=lengths.device)
    return frames[None, :] < nf[:, None]
