"""Serving predictor: raw audio -> features -> model forward (port of
:mod:`icassp2022_depression_tpu.serving.predictors`, audio tasks).

:class:`Predictor` serves ``audio_clf`` and ``audio_reg``: three raw
answers per speaker -> wav2vlad features (:mod:`..frontend.audio`) ->
:class:`..models.audio_net.AudioNet` -> ``{"label", "depressed",
"probs"}`` (clf) or ``{"sds_score"}`` (reg).  Features stay on the device
between extraction and the forward; per-speaker features are memoised in
a content-addressed LRU (:class:`_FeatureCache`); the forward batch is
padded to a power of two, as in the JAX package, and runs under
``torch.inference_mode()``.  On a card the GRU recurrence runs in the
hand-written CUDA kernel (``rnn_backend="auto"``).

Not ported yet: serving the text and fusion tasks (the port trains them,
but a served request needs the text frontend, ``ROADMAP.md`` Queue 1,
item 13), the VGGish embedder, reference ``.pt`` checkpoints, the DAIC
predictor and the HTTP transport.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import List, Optional, Sequence

import numpy as np
import torch

from icassp2022_depression_tpu_torch import config as C
from icassp2022_depression_tpu_torch.frontend import audio as audio_fe
from icassp2022_depression_tpu_torch.models import porting
from icassp2022_depression_tpu_torch.models.audio_net import AudioNet
from icassp2022_depression_tpu_torch.train import checkpoints
from icassp2022_depression_tpu_torch.utils import shapes

TASKS = ("audio_clf", "text_clf", "fuse_clf",
         "audio_reg", "text_reg", "fuse_reg")
AUDIO_TASKS = ("audio_clf", "audio_reg")


def _pow2(n: int) -> int:
    """Power-of-two batch bucket: requests of varying sizes reuse a
    handful of shapes."""
    return shapes.next_pow2(n)


def _format_outputs(out: np.ndarray, clf: bool, reg_key: str) -> List[dict]:
    """Raw model outputs [N, C] -> one result dict per row (the serving
    result schema, identical to the JAX package's)."""
    results = []
    for row in out:
        if clf:
            label = int(np.argmax(row))
            results.append({"label": label, "depressed": bool(label == 1),
                            "probs": row.tolist()})
        else:
            results.append({reg_key: float(row[0])})
    return results


def _check_task(task: str) -> None:
    if task in AUDIO_TASKS:
        return
    if task in TASKS:
        raise NotImplementedError(
            f"task {task!r}: serving the text and fusion models needs the "
            "text frontend, which arrives with the text-frontend slice of "
            "the port (ROADMAP.md Queue 1, item 13)")
    raise ValueError(f"task must be one of {TASKS}, got {task!r}")


def model_config(task: str) -> C.RNNConfig:
    _check_task(task)
    return (C.AUDIO_CLF if task == "audio_clf" else C.AUDIO_REG).model


def default_device() -> torch.device:
    """The first card when there is one, else the CPU."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


class _FeatureCache:
    """Content-addressed LRU of per-speaker features (device tensors), so
    repeat traffic for the same speaker skips extraction."""

    def __init__(self, max_entries: int = 256):
        self.max_entries = max_entries
        self._store: OrderedDict[str, torch.Tensor] = OrderedDict()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def key(parts) -> str:
        h = hashlib.blake2b(digest_size=16)
        for p in parts:
            if isinstance(p, str):
                h.update(p.encode("utf-8"))
            elif p is None:
                h.update(b"\x00none")
            else:
                a = np.ascontiguousarray(p)
                h.update(str(a.dtype).encode())
                h.update(str(a.shape).encode())
                h.update(a.tobytes())
            h.update(b"\x1f")
        return h.hexdigest()

    def get(self, key: str):
        if key in self._store:
            self._store.move_to_end(key)
            self.hits += 1
            return self._store[key]
        self.misses += 1
        return None

    def put(self, key: str, value: torch.Tensor) -> None:
        self._store[key] = value
        self._store.move_to_end(key)
        while len(self._store) > self.max_entries:
            self._store.popitem(last=False)


class Predictor:
    """Loads one trained audio model and serves end-to-end predictions."""

    def __init__(self, model: AudioNet, task: str,
                 frontend_cfg: C.FrontendConfig = C.FrontendConfig(),
                 feature_cache_entries: int = 256,
                 audio_embedder: str = "netvlad", device=None):
        """``model`` is moved to ``device`` (default: the first card if
        there is one, else the CPU) and put in eval mode."""
        _check_task(task)
        if audio_embedder != "netvlad":
            raise NotImplementedError(
                f"audio_embedder={audio_embedder!r}: the VGGish embedder "
                "arrives with the VGGish slice of the port")
        self.task = task
        self.frontend_cfg = frontend_cfg
        self.audio_embedder = audio_embedder
        self.device = torch.device(device) if device is not None \
            else default_device()
        self.model = model.to(self.device).eval()
        self.feature_cache = _FeatureCache(feature_cache_entries)
        #: the checkpoint's JSON sidecar (set by :meth:`from_checkpoint`)
        self.meta: dict = {}

    @classmethod
    def from_checkpoint(cls, path, task: str, model_cfg=None, **kw):
        """Load an npz checkpoint in the JAX package's layout (written by
        either package).  ``model_cfg`` overrides the task's preset model
        config; the JSON sidecar, when present, is kept as ``meta``."""
        mcfg = model_cfg if model_cfg is not None else model_config(task)
        tree = checkpoints.load(path)
        model = AudioNet(mcfg)
        model.load_state_dict(porting.audio_net_state_dict_from_jax(tree,
                                                                    mcfg),
                              strict=True)
        predictor = cls(model, task, **kw)
        try:
            predictor.meta = checkpoints.load_meta(path)
        except FileNotFoundError:
            pass
        return predictor

    # -- feature extraction -------------------------------------------------

    def audio_features(self, waveforms_per_speaker: Sequence[Sequence],
                       sample_rates: Sequence[Sequence[int]],
                       ordinal_bases: Optional[Sequence[int]] = None
                       ) -> np.ndarray:
        """[[w_pos, w_neu, w_neg], ...] -> [N, 3, 256] wav2vlad features.

        By default every speaker uses ordinals (0, 1, 2), so a speaker gets
        the same features alone or in any batch; ``ordinal_bases`` (3 x
        corpus position) reproduces a corpus speaker's training-time
        features (the ``cli predict`` path)."""
        keys = self._audio_keys(waveforms_per_speaker, sample_rates,
                                ordinal_bases)
        rows = self._audio_feature_rows(waveforms_per_speaker, sample_rates,
                                        ordinal_bases, keys)
        return self._stack_rows(rows).cpu().numpy()

    def _stack_rows(self, rows) -> torch.Tensor:
        """[3, D] rows -> [N, 3, D] (zero speakers is a valid request)."""
        if not rows:
            return torch.zeros((0, 3, self.frontend_cfg.netvlad_output_dim),
                               dtype=torch.float32, device=self.device)
        return torch.stack(rows)

    def _audio_keys(self, waveforms_per_speaker, sample_rates,
                    ordinal_bases):
        if waveforms_per_speaker is None or sample_rates is None:
            raise ValueError(
                f"task {self.task!r} needs 3 waveforms (+ sample rates) per "
                "speaker; got None")
        return [
            _FeatureCache.key(
                ["audio", self.audio_embedder,
                 str(0 if ordinal_bases is None else ordinal_bases[i]),
                 str(list(sample_rates[i]))] + list(waveforms_per_speaker[i]))
            for i in range(len(waveforms_per_speaker))]

    def _audio_feature_rows(self, waveforms_per_speaker, sample_rates,
                            ordinal_bases, keys):
        """Cache-aware extraction -> list of per-speaker [3, D] device
        tensors."""
        rows: list = [None] * len(keys)
        todo = []
        for i, key in enumerate(keys):
            cached = self.feature_cache.get(key)
            if cached is not None:
                rows[i] = cached
            else:
                todo.append(i)
        if todo:
            flat_w = [w for i in todo for w in waveforms_per_speaker[i]]
            flat_sr = [sr for i in todo for sr in sample_rates[i]]
            base = [0 if ordinal_bases is None else ordinal_bases[i]
                    for i in todo]
            ordinals = [b + k for b in base for k in range(3)]
            with torch.inference_mode():
                feats = audio_fe.extract_batch(flat_w, flat_sr,
                                               self.frontend_cfg,
                                               ordinals=ordinals,
                                               device=self.device)
            feats = feats.reshape(len(todo), 3, -1)
            for row, i in enumerate(todo):
                rows[i] = feats[row].clone()
                self.feature_cache.put(keys[i], rows[i])
        return rows

    # -- prediction ---------------------------------------------------------

    def predict_features(self, audio_feats) -> np.ndarray:
        """Model forward on features [N, 3, D] (numpy or tensor) -> raw
        outputs [N, C] as numpy.  The batch is padded to a power of two."""
        x = torch.as_tensor(audio_feats, dtype=torch.float32,
                            device=self.device)
        n = x.shape[0]
        bucket = _pow2(n)
        with torch.inference_mode():
            if bucket > n:
                x = torch.cat([x, x.new_zeros((bucket - n,) + x.shape[1:])])
            out = self.model(x)
        return out[:n].cpu().numpy()

    def predict_batch(self, waveforms_per_speaker=None, sample_rates=None,
                      texts_per_speaker=None, ordinal_bases=None
                      ) -> List[dict]:
        """Raw inputs -> one result dict per speaker (transcripts are
        accepted for the JAX package's signature and unused by audio
        tasks)."""
        keys = self._audio_keys(waveforms_per_speaker, sample_rates,
                                ordinal_bases)
        af = self._stack_rows(self._audio_feature_rows(
            waveforms_per_speaker, sample_rates, ordinal_bases, keys))
        out = self.predict_features(af)
        return _format_outputs(out, self.task.endswith("clf"), "sds_score")

    def predict_speaker(self, waveforms=None, sample_rates=None,
                        texts=None, ordinal_base: Optional[int] = None
                        ) -> dict:
        """Single speaker: 3 waveforms -> result."""
        return self.predict_batch(
            [waveforms] if waveforms is not None else None,
            [sample_rates] if sample_rates is not None else None,
            [texts] if texts is not None else None,
            [ordinal_base] if ordinal_base is not None else None)[0]

    def warmup(self, batch_sizes: Sequence[int] = (1, 2, 4),
               utt_seconds: float = 4.0, sr: int = 16000) -> None:
        """Run the standard serving shapes once with synthetic traffic
        (first-use costs: kernel build, cuFFT plans, allocator growth)."""
        rng = np.random.default_rng(0)
        for n in batch_sizes:
            self.predict_batch(
                [[np.round(rng.standard_normal(int(sr * utt_seconds))
                           * 2000).astype(np.int16) for _ in range(3)]
                 for _ in range(n)],
                [[sr] * 3] * n)
