"""VGGish audio embedding (port of
:mod:`icassp2022_depression_tpu.models.vggish`).

The reference defines ``to_vggish_embedds`` (waveform -> TF1 slim VGGish
-> PCA postprocessor, ``Classification/audio_features_whole.py:39-55``)
as the alternative to wav2vlad.  Here:

* :func:`waveform_to_examples`: VGGish's own frontend on the host, numpy,
  a verbatim copy of the JAX package's (resample to 16 kHz, 25 ms / 10 ms
  magnitude STFT with a symmetric Hann window, 64 HTK-mel bins in
  [125, 7500] Hz, ``log(mel + 0.01)``, non-overlapping 0.96 s examples
  ``[N, 96, 64]``), so both packages feed the network the same bits;
* :class:`VGGish`: the conv stack (64-128-256x2-512x2, 3x3 convolutions,
  max-pooling after convs 0, 1, 3 and 5) and the 12288-4096-4096-128 FCs,
  ReLU after every layer, on cuDNN with TF32 off
  (:func:`..ops.nn.no_tf32_convs`);
* :class:`Postprocessor`: PCA projection, clip to [-2, 2], uint8
  (``vggish_postprocess`` semantics), numpy.

The JAX package keeps its params as a tree ``{"convs": [{"w": HWIO, "b"}],
"fcs": [{"w": [in, out], "b"}]}`` and flattens the NHWC feature map before
the first FC.  :func:`..models.porting.vggish_state_dict_from_jax` maps
such a tree onto :class:`VGGish`'s ``state_dict`` (OIHW convolutions,
``[out, in]`` linears), and :meth:`VGGish.forward` permutes its NCHW map
to NHWC before flattening, so the first FC reads its rows in the order
they were trained for.

Weights: a bundle written by ``scripts/convert_vggish.py`` (:func:`load_npz`,
auto-loaded from :func:`default_weights_path`), the released TF checkpoint
(:func:`from_tf_checkpoint`, needs tensorflow), or the seeded stand-in
(:func:`init`: the JAX package's draw, bit for bit, on the port's
threefry).
"""

from __future__ import annotations

import functools
import os
import sys
from pathlib import Path
from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from icassp2022_depression_tpu_torch.ops import mel as mel_ops
from icassp2022_depression_tpu_torch.ops import prng
from icassp2022_depression_tpu_torch.ops.nn import no_tf32_convs
from icassp2022_depression_tpu_torch.utils.device import resolve_device

SAMPLE_RATE = 16000
STFT_WINDOW = 400   # 25 ms
STFT_HOP = 160      # 10 ms
NUM_MEL_BINS = 64
MEL_MIN_HZ = 125.0
MEL_MAX_HZ = 7500.0
LOG_OFFSET = 0.01
EXAMPLE_FRAMES = 96  # 0.96 s of 10 ms frames
EMBEDDING_SIZE = 128

_CONV_CHANNELS = [(1, 64), (64, 128), (128, 256), (256, 256),
                  (256, 512), (512, 512)]
#: pool after these conv indices (VGG-ish layout: 1, 1, 2, 2 convs/block)
_POOL_AFTER = {0, 1, 3, 5}
_FC_DIMS = [(EXAMPLE_FRAMES // 16 * NUM_MEL_BINS // 16 * 512, 4096),
            (4096, 4096), (4096, EMBEDDING_SIZE)]


# -- host frontend: a verbatim copy of the JAX package's ---------------------

def resample(x: np.ndarray, sr: int, target_sr: int = SAMPLE_RATE) -> np.ndarray:
    """Linear-interpolation resampler (host-side, matches scipy within the
    tolerance the log-mel frontend cares about)."""
    if sr == target_sr:
        return x
    n_out = int(round(len(x) * target_sr / sr))
    t_in = np.arange(len(x)) / sr
    t_out = np.arange(n_out) / target_sr
    return np.interp(t_out, t_in, x).astype(x.dtype)


def _is_pcm_scaled(x: np.ndarray) -> bool:
    """True when the waveform carries raw int16-scale samples (integer
    dtype, or integral-valued floats bounded by 32767, what the wav
    readers produce).  Amplitude alone cannot decide this: a quiet PCM
    clip peaking at |1| is indistinguishable from full-scale normalised
    audio by range."""
    if np.issubdtype(x.dtype, np.integer):
        return True
    if len(x) == 0 or float(np.max(np.abs(x), initial=0.0)) > 32767:
        return False
    probe = x[:: max(1, len(x) // 64)]
    if not np.all(probe == np.round(probe)):
        return False
    return bool(np.all(x == np.round(x)))


def waveform_to_examples(x: np.ndarray, sr: int) -> np.ndarray:
    """[T] waveform (any rate) -> [N, 96, 64] log-mel examples.

    Raw int16-scale PCM is normalised by 32768 like upstream
    ``wavfile_to_examples``; already-normalised float audio passes
    through.  The frame window is upstream ``mel_features``'s symmetric
    Hann (``np.hanning``), not the periodic Hann of the wav2vlad frontend.
    """
    x = np.asarray(x)
    if _is_pcm_scaled(x):
        x = np.asarray(x, np.float32) / 32768.0  # int16 scale -> [-1, 1]
    x = np.asarray(x, np.float32)
    x = resample(x, sr)
    n_frames = 1 + (len(x) - STFT_WINDOW) // STFT_HOP if len(x) >= STFT_WINDOW else 0
    if n_frames <= 0:
        return np.zeros((0, EXAMPLE_FRAMES, NUM_MEL_BINS), np.float32)
    idx = np.arange(n_frames)[:, None] * STFT_HOP + np.arange(STFT_WINDOW)
    window = np.hanning(STFT_WINDOW).astype(np.float32)
    frames = x[idx] * window
    spec = np.abs(np.fft.rfft(frames, n=512, axis=-1))  # magnitude, fft 512
    log_mel = np.log(spec @ _vggish_mel_matrix().T + LOG_OFFSET)
    n_examples = log_mel.shape[0] // EXAMPLE_FRAMES
    return log_mel[:n_examples * EXAMPLE_FRAMES].reshape(
        n_examples, EXAMPLE_FRAMES, NUM_MEL_BINS).astype(np.float32)


@functools.lru_cache(maxsize=1)
def _vggish_mel_matrix() -> np.ndarray:
    """VGGish's own mel weight matrix [64, 257]: unnormalised triangles
    interpolated in mel space (``vggish_input``'s
    ``spectrogram_to_mel_matrix``), with the DC bin zeroed."""
    n_bins = 1 + 512 // 2
    spec_mel = mel_ops.hz_to_mel(
        np.linspace(0.0, SAMPLE_RATE / 2.0, n_bins), htk=True)
    edges = np.linspace(mel_ops.hz_to_mel(MEL_MIN_HZ, htk=True),
                        mel_ops.hz_to_mel(MEL_MAX_HZ, htk=True),
                        NUM_MEL_BINS + 2)
    fb = np.zeros((NUM_MEL_BINS, n_bins), np.float32)
    for i in range(NUM_MEL_BINS):
        lo, ctr, hi = edges[i], edges[i + 1], edges[i + 2]
        lower = (spec_mel - lo) / (ctr - lo)
        upper = (hi - spec_mel) / (hi - ctr)
        fb[i] = np.maximum(0.0, np.minimum(lower, upper))
    fb[:, 0] = 0.0   # the DC bin contributes nothing
    return fb


# -- the network ------------------------------------------------------------

def init(key: torch.Tensor) -> dict:
    """The seeded stand-in: the JAX package's ``vggish.init(PRNGKey(s))``
    on the port's threefry (``prng.prng_key(s)``), bit for bit, as a JAX
    layout tree (HWIO convolutions, ``[in, out]`` FCs, zero biases) of
    float32 tensors on the key's device."""
    keys = prng.split(key, len(_CONV_CHANNELS) + len(_FC_DIMS))
    zeros = functools.partial(torch.zeros, dtype=torch.float32,
                              device=key.device)
    params = {"convs": [], "fcs": []}
    for i, (cin, cout) in enumerate(_CONV_CHANNELS):
        bound = 1.0 / np.sqrt(cin * 9)
        params["convs"].append({
            "w": prng.uniform(keys[i], (3, 3, cin, cout), -bound, bound),
            "b": zeros((cout,))})
    for j, (din, dout) in enumerate(_FC_DIMS):
        bound = 1.0 / np.sqrt(din)
        params["fcs"].append({
            "w": prng.uniform(keys[len(_CONV_CHANNELS) + j], (din, dout),
                              -bound, bound),
            "b": zeros((dout,))})
    return params


class VGGish(nn.Module):
    """[N, 96, 64] log-mel examples -> [N, 128] embeddings."""

    def __init__(self):
        super().__init__()
        self.convs = nn.ModuleList(nn.Conv2d(cin, cout, 3, padding=1)
                                   for cin, cout in _CONV_CHANNELS)
        self.fcs = nn.ModuleList(nn.Linear(din, dout)
                                 for din, dout in _FC_DIMS)

    def forward(self, examples: torch.Tensor) -> torch.Tensor:
        x = examples[:, None]                                   # NCHW
        with no_tf32_convs():
            for i, conv in enumerate(self.convs):
                x = torch.relu(conv(x))
                if i in _POOL_AFTER:
                    x = F.max_pool2d(x, 2, 2)
        # the JAX package flattens NHWC: [N, 6, 4, 512]
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        for fc in self.fcs:
            x = torch.relu(fc(x))
        return x


def from_params(params: Mapping, device=None) -> VGGish:
    """A JAX-layout param tree (tensors or arrays, nested or with
    '/'-joined keys) -> :class:`VGGish` on ``device`` (None: the first
    card), in eval mode."""
    from icassp2022_depression_tpu_torch.models import porting

    device = resolve_device(device)
    with torch.device("meta"):   # no throwaway init of the 50 M-float FC
        model = VGGish()
    model.load_state_dict(porting.vggish_state_dict_from_jax(params),
                          strict=True, assign=True)
    return model.to(device).eval()


def resolve(params=None, seed: int = 0, device=None) -> VGGish:
    """The network an entry point runs: a :class:`VGGish` as given (moved
    to ``device``), a JAX-layout param tree (:func:`from_params`), or,
    for None, the seeded stand-in at ``seed`` drawn on ``device``, with
    its stderr banner.  ``device`` None is the first card."""
    device = resolve_device(device)
    if isinstance(params, VGGish):
        return params.to(device).eval()
    if params is None:
        warn_standin_weights()
        params = init(prng.prng_key(seed, device))
    return from_params(params, device)


class Postprocessor:
    """PCA + clip + uint8 quantise (``vggish_postprocess.Postprocessor``)."""

    def __init__(self, pca_matrix: np.ndarray, pca_means: np.ndarray,
                 clip_min: float = -2.0, clip_max: float = 2.0):
        self.pca_matrix = np.asarray(pca_matrix, np.float32)
        self.pca_means = np.asarray(pca_means, np.float32).reshape(-1, 1)
        self.clip_min, self.clip_max = clip_min, clip_max

    def __call__(self, embeddings: np.ndarray) -> np.ndarray:
        applied = np.dot(self.pca_matrix,
                         (np.asarray(embeddings).T - self.pca_means)).T
        clipped = np.clip(applied, self.clip_min, self.clip_max)
        quantized = ((clipped - self.clip_min) *
                     (255.0 / (self.clip_max - self.clip_min)))
        return quantized.astype(np.uint8)


#: slim variable scopes in the released vggish_model.ckpt, in stack order
_TF_CONV_SCOPES = ["vggish/conv1", "vggish/conv2",
                   "vggish/conv3/conv3_1", "vggish/conv3/conv3_2",
                   "vggish/conv4/conv4_1", "vggish/conv4/conv4_2"]
_TF_FC_SCOPES = ["vggish/fc1/fc1_1", "vggish/fc1/fc1_2", "vggish/fc2"]


def from_tf_checkpoint(ckpt_path) -> dict:
    """The released TF-slim checkpoint -> a JAX-layout param tree of numpy
    arrays (slim stores HWIO convolutions and ``[in, out]`` FCs, the
    tree's layouts).  Needs tensorflow, for the checkpoint reader only."""
    import tensorflow as tf  # local: heavy import, converter-only

    reader = tf.train.load_checkpoint(str(ckpt_path))

    def tensors(scope):
        return {"w": np.asarray(reader.get_tensor(f"{scope}/weights"),
                                np.float32),
                "b": np.asarray(reader.get_tensor(f"{scope}/biases"),
                                np.float32)}

    params = {"convs": [tensors(s) for s in _TF_CONV_SCOPES],
              "fcs": [tensors(s) for s in _TF_FC_SCOPES]}
    for i, ((cin, cout), conv) in enumerate(zip(_CONV_CHANNELS,
                                                params["convs"])):
        if conv["w"].shape != (3, 3, cin, cout):
            raise ValueError(f"conv {i}: got {conv['w'].shape}, want "
                             f"(3, 3, {cin}, {cout})")
    if params["fcs"][-1]["w"].shape[1] != EMBEDDING_SIZE:
        raise ValueError(f"last FC gives {params['fcs'][-1]['w'].shape[1]} "
                         f"values, want {EMBEDDING_SIZE}")
    return params


def default_weights_path() -> Optional[Path]:
    """The bundle to auto-load, in the JAX package's order: the
    ``ICASSP_VGGISH_WEIGHTS`` env var, then ``~/.cache/icassp2022_tpu/
    vggish.npz``.  None when neither exists."""
    env = os.environ.get("ICASSP_VGGISH_WEIGHTS")
    if env and Path(env).exists():
        return Path(env)
    cached = Path.home() / ".cache" / "icassp2022_tpu" / "vggish.npz"
    if cached.exists():
        return cached
    return None


def load_npz(path, device=None):
    """A bundle written by ``scripts/convert_vggish.py`` (the JAX
    package's ``checkpoints.save``: ``convs/{i}/{w,b}``, ``fcs/{j}/{w,b}``
    and optionally ``pca/{matrix,means}``) -> (:class:`VGGish` on
    ``device``, None: the first card; :class:`Postprocessor` or None)."""
    p = str(path)
    if not p.endswith(".npz"):
        p += ".npz"
    with np.load(p) as z:
        flat = {k: z[k] for k in z.files}
    params = {"convs": [], "fcs": []}
    for group in ("convs", "fcs"):
        i = 0
        while f"{group}/{i}/w" in flat:
            params[group].append({"w": flat[f"{group}/{i}/w"],
                                  "b": flat[f"{group}/{i}/b"]})
            i += 1
    if len(params["convs"]) != len(_CONV_CHANNELS) \
            or len(params["fcs"]) != len(_FC_DIMS):
        raise ValueError(f"{p}: not a VGGish bundle (keys e.g. "
                         f"{sorted(flat)[:5]})")
    post = (Postprocessor(flat["pca/matrix"], flat["pca/means"])
            if "pca/matrix" in flat else None)
    return from_params(params, device), post


def load_pca_params(pca_params_path) -> Postprocessor:
    """Released ``vggish_pca_params.npz`` -> :class:`Postprocessor`
    (``audio_features_whole.py:32,44``)."""
    with np.load(pca_params_path) as z:
        return Postprocessor(z["pca_eigen_vectors"], z["pca_means"])


def warn_standin_weights() -> None:
    """Unmissable stderr notice that seeded stand-in VGGish weights are in
    use instead of the released checkpoint.  Suppressed by
    ``ICASSP_SUPPRESS_STANDIN_WARNING=1``."""
    if os.environ.get("ICASSP_SUPPRESS_STANDIN_WARNING"):
        return
    print("\n".join([
        "=" * 72,
        "WARNING: no converted VGGish bundle found - using PRNG",
        "stand-in conv weights.  VGGish features will be deterministic",
        "and self-consistent but NOT comparable to features from the",
        "released vggish_model.ckpt the reference uses.  Convert real",
        "weights with scripts/convert_vggish.py and set",
        "ICASSP_VGGISH_WEIGHTS (or pass --vggish-ckpt).",
        "=" * 72,
    ]), file=sys.stderr, flush=True)


def to_vggish_embedds(model: VGGish, x: np.ndarray, sr: int,
                      postprocessor: Optional[Postprocessor] = None
                      ) -> np.ndarray:
    """The reference path: waveform -> examples -> [N, 128] embeddings
    (postprocessed when given), float32 numpy
    (``audio_features_whole.py:39-55``)."""
    examples = waveform_to_examples(x, sr)
    if examples.shape[0] == 0:
        return np.zeros((0, EMBEDDING_SIZE), np.float32)
    device = next(model.parameters()).device
    with torch.inference_mode():
        emb = model(torch.from_numpy(examples).to(device)).cpu().numpy()
    if postprocessor is not None:
        emb = postprocessor(emb).astype(np.float32)
    return emb
