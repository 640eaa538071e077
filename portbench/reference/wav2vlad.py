"""Plain wav2vlad: librosa-style log-mel, then NetVLAD with a freshly drawn
set of weights per utterance (``Classification/audio_features_whole.py``
of the published code, lines 34 and 57-72).

One utterance at a time, at its own length: centred frames with reflect
padding, a periodic Hann window, the power spectrum, a Slaney mel
filterbank, ``log(max(1e-6, mel))``; NetVLAD's softmax assignment,
residual aggregation, intra-normalisation, global L2 and projection.  The
weights of the utterance at ``ordinal`` are drawn from
``fold_in(PRNGKey(seed), ordinal)`` by :mod:`.threefry`.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import precision, threefry


def _hz_to_mel(f):
    f = np.asanyarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_mel = 1000.0 / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= 1000.0,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / 1000.0)
                    / logstep, mels)


def _mel_to_hz(m):
    m = np.asanyarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_mel = 1000.0 / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    1000.0 * np.exp(logstep * (m - min_log_mel)), f_sp * m)


def mel_filterbank(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """[n_mels, 1 + n_fft // 2] Slaney-normalised triangles, fmin 0, fmax
    sr / 2 (``librosa.filters.mel`` defaults)."""
    fft_freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2.0),
                                n_mels + 2))
    fdiff = np.diff(hz)
    ramps = hz[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    w = np.maximum(0.0, np.minimum(lower, upper))
    w *= (2.0 / (hz[2:n_mels + 2] - hz[:n_mels]))[:, None]
    return w.astype(np.float32)


def log_mel(wave: np.ndarray, frontend: dict, device, prec: str):
    """One waveform (any numeric dtype, used as float32 values) -> [frames,
    n_mels] on ``device``."""
    n_fft, hop = frontend["n_fft"], frontend["hop_length"]
    y = np.pad(np.asarray(wave, dtype=np.float32), n_fft // 2,
               mode="reflect")
    frames = torch.from_numpy(y).to(device).unfold(0, n_fft, hop)
    window = torch.from_numpy((0.5 - 0.5 * np.cos(
        2.0 * np.pi * np.arange(n_fft) / n_fft)).astype(np.float32)).to(
            device)
    spec = torch.fft.rfft(frames * window, dim=-1)
    power = spec.real.square() + spec.imag.square()
    fb = torch.from_numpy(mel_filterbank(frontend["sample_rate"], n_fft,
                                         frontend["n_mels"])).to(device)
    mel = precision.matmul(power, fb.t(), prec)
    return torch.log(torch.clamp_min(mel, frontend["log_floor"]))


def netvlad_weights(seed: int, ordinal: int, d: int, k: int,
                    out: int) -> dict:
    """The utterance's NetVLAD weights (loupe's normal initialisers)."""
    key = threefry.fold_in(threefry.prng_key(seed), ordinal)
    k1, k2, k3, k4 = threefry.split(key, 4)
    s_in = np.float32(1.0) / np.sqrt(np.float32(d))
    s_out = np.float32(1.0) / np.sqrt(np.float32(k))
    return {"cluster_w": threefry.normal(k1, (d, k)) * s_in,
            "cluster_b": threefry.normal(k2, (k,)) * s_in,
            "cluster_w2": threefry.normal(k3, (1, d, k))[0] * s_in,
            "hidden_w": threefry.normal(k4, (d * k, out)) * s_out}


def netvlad(w: dict, x: torch.Tensor, prec: str) -> torch.Tensor:
    """[frames, D] -> [output_dim]."""
    dev = x.device
    cw, cb, cw2, hw = (torch.from_numpy(np.ascontiguousarray(w[n])).to(dev)
                       for n in ("cluster_w", "cluster_b", "cluster_w2",
                                 "hidden_w"))
    assign = torch.softmax(precision.matmul(x, cw, prec) + cb, dim=-1)
    a = assign.sum(dim=0, keepdim=True) * cw2                   # [D, K]
    vlad = precision.matmul(x.t(), assign, prec) - a
    vlad = vlad / torch.clamp_min(vlad.norm(dim=0, keepdim=True), 1e-12)
    flat = vlad.reshape(-1)
    flat = flat / torch.clamp_min(flat.norm(), 1e-12)
    return precision.matmul(flat[None, :], hw, prec)[0]


def wav2vlad(waves, ordinals, frontend: dict, device,
             prec: str = "fp32") -> np.ndarray:
    """Utterances with their NetVLAD ordinals -> [N, output_dim] float32."""
    d, k = frontend["n_mels"], frontend["netvlad_clusters"]
    out = frontend["netvlad_output_dim"]
    weights = {}
    feats = []
    for wave, ordinal in zip(waves, ordinals):
        if ordinal not in weights:
            weights[ordinal] = netvlad_weights(frontend["netvlad_seed"],
                                               ordinal, d, k, out)
        lm = log_mel(wave, frontend, device, prec)
        feats.append(netvlad(weights[ordinal], lm, prec).cpu().numpy())
    return np.stack(feats) if feats else np.zeros((0, out), np.float32)
