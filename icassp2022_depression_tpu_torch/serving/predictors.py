"""Serving predictor: raw audio and transcripts -> features -> model forward
(port of :mod:`icassp2022_depression_tpu.serving.predictors`, the EATD
tasks).

:class:`Predictor` serves all six tasks: three raw answers per speaker ->
wav2vlad features (:mod:`..frontend.audio`) and/or three transcripts ->
segmented -> sentence embeddings (:func:`..frontend.text.make_embedder`:
the char-CNN + LSTMP biLM of a converted ELMo bundle, or the seeded
stand-in) -> :class:`..models.audio_net.AudioNet`,
:class:`..models.text_net.TextNet` or :class:`..models.fusion.FusionNet`
-> ``{"label", "depressed", "probs"}`` (clf) or ``{"sds_score"}`` (reg).
Features stay on the device between extraction and the forward;
per-speaker features are memoised in a content-addressed LRU
(:class:`_FeatureCache`); the forward batch is padded to a power of two,
as in the JAX package, and runs under ``torch.inference_mode()``.  On a
card the recurrences run in the hand-written CUDA kernels
(``rnn_backend="auto"``).

The device is the caller's choice: without one, :func:`default_device`
takes the first card and raises when there is none (``device="cpu"`` runs
everything on the plain versions).

Checkpoints are npz files of either package or the reference's ``.pt``
pickles (:meth:`Predictor.from_checkpoint` dispatches on the extension).
Not ported yet: the VGGish embedder, the DAIC predictor and the HTTP
transport.
"""

from __future__ import annotations

import hashlib
import sys
from collections import OrderedDict
from typing import List, Optional, Sequence

import numpy as np
import torch

from icassp2022_depression_tpu_torch import config as C
from icassp2022_depression_tpu_torch.frontend import audio as audio_fe
from icassp2022_depression_tpu_torch.frontend import text as text_fe
from icassp2022_depression_tpu_torch.models import elmo, porting
from icassp2022_depression_tpu_torch.train import checkpoints
from icassp2022_depression_tpu_torch.utils import shapes
from icassp2022_depression_tpu_torch.utils.device import (  # noqa: F401
    default_device,
    resolve_device,
)

TASKS = ("audio_clf", "text_clf", "fuse_clf",
         "audio_reg", "text_reg", "fuse_reg")


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


def model_config(task: str):
    """The task's preset model config (``RNNConfig`` or ``FusionConfig``)."""
    if task not in TASKS:
        raise ValueError(f"task must be one of {TASKS}, got {task!r}")
    branch, track = task.split("_")
    preset = {"audio": "AUDIO", "text": "TEXT", "fuse": "FUSE"}[branch]
    cfg = getattr(C, f"{preset}_{track.upper()}")
    return cfg if branch == "fuse" else cfg.model


def model_kind(task: str) -> str:
    """'audio' | 'text' | 'fusion': the model a task runs."""
    return {"audio": "audio", "text": "text", "fuse": "fusion"}[
        task.split("_")[0]]


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
    """Loads one trained model and serves end-to-end predictions."""

    def __init__(self, model, task: str,
                 frontend_cfg: C.FrontendConfig = C.FrontendConfig(),
                 feature_cache_entries: int = 256,
                 audio_embedder: str = "netvlad", device=None,
                 elmo_cfg=elmo.ElmoConfig(), elmo_params=None, seed: int = 0,
                 elmo_weights: Optional[str] = "auto",
                 segmenter: str = "auto"):
        """``model`` (:class:`AudioNet`, :class:`TextNet` or
        :class:`FusionNet`) is moved to ``device`` (default: the first
        card, see :func:`default_device`) and put in eval mode.

        The text and fusion tasks resolve their sentence embedder as
        ``extract-text`` does (:func:`..frontend.text.make_embedder`):
        explicit ``elmo_params`` (+ ``elmo_cfg``), else the bundle of
        ``elmo_weights`` (a path, or ``"auto"``: ``ICASSP_ELMO_WEIGHTS``;
        None: the seeded stand-in at ``seed``).  ``segmenter`` must be the
        one extraction used; :meth:`from_checkpoint` adopts the
        checkpoint's."""
        if task not in TASKS:
            raise ValueError(f"task must be one of {TASKS}, got {task!r}")
        if audio_embedder != "netvlad":
            raise NotImplementedError(
                f"audio_embedder={audio_embedder!r}: the VGGish embedder "
                "arrives with the VGGish slice of the port")
        self.task = task
        self.frontend_cfg = frontend_cfg
        self.audio_embedder = audio_embedder
        self.segmenter = segmenter
        self.device = resolve_device(device)
        #: provenance id of the resolved text embedder (the id scheme of
        #: the extraction sidecars)
        self.embedder_id: Optional[str] = None
        self._text_embed = None
        self._text_dim = 0
        if not task.startswith("audio"):
            # an unknown segmenter fails here, not on the first request
            text_fe.get_segmenter(segmenter)
            self._text_embed, self._text_dim, self.embedder_id = \
                text_fe.make_embedder(params=elmo_params, cfg=elmo_cfg,
                                      seed=seed, elmo_weights=elmo_weights,
                                      with_id=True, device=self.device)
            if (elmo_weights == "auto"
                    and self.embedder_id.startswith("elmo_bundle")):
                print("Predictor: auto-loaded the converted ELMo bundle - "
                      "the served checkpoint must have been trained on "
                      "features from this embedder (pass elmo_weights="
                      "None to force the PRNG encoder)", file=sys.stderr)
        self.model = model.to(self.device).eval()
        self.feature_cache = _FeatureCache(feature_cache_entries)
        #: the checkpoint's JSON sidecar (set by :meth:`from_checkpoint`)
        self.meta: dict = {}

    @classmethod
    def from_checkpoint(cls, path, task: str, model_cfg=None, **kw):
        """Load an npz checkpoint in the JAX package's layout (written by
        either package).  ``model_cfg`` overrides the task's preset model
        config; the JSON sidecar, when present, is kept as ``meta``.  When
        the sidecar records the text embedder / segmenter of the training
        features (``text_embedder`` / ``text_segmenter``), the segmenter is
        adopted unless ``segmenter`` is passed, and a mismatch of either
        warns on stderr."""
        if str(path).endswith(".pt"):
            # a reference pickle: read through the restricted unpickler,
            # then served as a reference-trained model (with its warning)
            return cls.from_torch_state_dict(
                porting.load_reference_pt(path), task, model_cfg, **kw)
        mcfg = model_cfg if model_cfg is not None else model_config(task)
        model = checkpoints.load_model(checkpoints.load(path),
                                       model_kind(task), mcfg, "cpu")
        try:
            meta = checkpoints.load_meta(path)
        except (FileNotFoundError, ValueError):
            meta = {}
        expected = meta.get("text_embedder")
        trained_seg = meta.get("text_segmenter")
        if trained_seg and "segmenter" not in kw \
                and not task.startswith("audio"):
            kw = dict(kw, segmenter=trained_seg)
            if trained_seg != "auto":
                print(f"Predictor: adopting segmenter '{trained_seg}' "
                      "recorded by the checkpoint's training features",
                      file=sys.stderr)
        predictor = cls(model, task, **kw)
        predictor.meta = meta
        if (expected and predictor.embedder_id
                and expected != predictor.embedder_id):
            print(f"WARNING: checkpoint {path} was trained on features "
                  f"from embedder '{expected}' but serving resolved "
                  f"'{predictor.embedder_id}' - predictions will be "
                  "meaningless; pass matching elmo_weights",
                  file=sys.stderr)
        if (trained_seg and predictor.segmenter != trained_seg
                and not task.startswith("audio")):
            print(f"WARNING: checkpoint {path} was trained on features "
                  f"segmented by '{trained_seg}' but serving uses "
                  f"'{predictor.segmenter}' - text features will not "
                  "match training", file=sys.stderr)
        return predictor

    @classmethod
    def from_torch_state_dict(cls, sd, task: str, model_cfg=None, **kw):
        """Serve a model trained by the reference: ``sd`` is its state
        dict (tensors or arrays, e.g. from
        :func:`..models.porting.load_reference_pt`).

        The reference's text and fusion models were trained on pretrained
        ELMoForManyLangs features: when such a task resolves the seeded
        stand-in encoder, a warning says its predictions mean nothing."""
        mcfg = model_cfg if model_cfg is not None else model_config(task)
        kind = model_kind(task)
        model = checkpoints.load_model(
            porting.tree_from_reference(sd, kind, mcfg), kind, mcfg, "cpu")
        predictor = cls(model, task, **kw)
        if (not task.startswith("audio") and predictor.embedder_id
                and predictor.embedder_id.startswith("prng")):
            print("WARNING: serving a reference-trained text/fusion model "
                  "on the PRNG-initialised text encoder - it does NOT "
                  "match the pretrained ELMo features the reference model "
                  "was trained on (pass elmo_params or a converted "
                  "bundle)", file=sys.stderr)
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

    def _stack_rows(self, rows, dim: Optional[int] = None) -> torch.Tensor:
        """[3, D] rows -> [N, 3, D] (zero speakers is a valid request)."""
        if not rows:
            return torch.zeros(
                (0, 3, self.frontend_cfg.netvlad_output_dim
                 if dim is None else dim),
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

    def text_features(self, texts_per_speaker: Sequence[Sequence[str]]
                      ) -> np.ndarray:
        """[[pos, neu, neg], ...] transcripts -> [N, 3, D] sentence
        embeddings."""
        return self._stack_rows(self._text_feature_rows(texts_per_speaker),
                                dim=self._text_dim).cpu().numpy()

    def _text_feature_rows(self, texts_per_speaker):
        """Cache-aware embedding -> list of per-speaker [3, D] device
        tensors (the text twin of :meth:`_audio_feature_rows`): the cold
        speakers' 3 answers each are segmented and embedded in one call."""
        if texts_per_speaker is None or any(
                ts is None for ts in texts_per_speaker):
            raise ValueError(
                f"task {self.task!r} needs 3 transcripts per speaker; "
                "got None (speaker has no transcript files?)")
        keys = [_FeatureCache.key(["text"] + list(ts))
                for ts in texts_per_speaker]
        rows: list = [None] * len(keys)
        todo = []
        for i, key in enumerate(keys):
            cached = self.feature_cache.get(key)
            if cached is not None:
                rows[i] = cached
            else:
                todo.append(i)
        if todo:
            sentences = [text_fe.tokenize(t, segmenter=self.segmenter)
                         for i in todo for t in texts_per_speaker[i]]
            flat = self._text_embed(sentences).reshape(len(todo), 3, -1)
            for row, i in enumerate(todo):
                rows[i] = flat[row].clone()
                self.feature_cache.put(keys[i], rows[i])
        return rows

    # -- prediction ---------------------------------------------------------

    def _pad_batch(self, x, total: int) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        if total > x.shape[0]:
            x = torch.cat([x, x.new_zeros((total - x.shape[0],)
                                          + x.shape[1:])])
        return x

    def predict_features(self, audio_feats=None, text_feats=None
                         ) -> np.ndarray:
        """Model forward on features [N, 3, D] (numpy or tensor; audio,
        text, or both for the fusion) -> raw outputs [N, C] as numpy.  The
        batch is padded to a power of two."""
        n = (audio_feats if audio_feats is not None else text_feats).shape[0]
        bucket = _pow2(n)
        with torch.inference_mode():
            if self.task.startswith("fuse"):
                tf, af = self.model.pretrained_feature(
                    self._pad_batch(audio_feats, bucket),
                    self._pad_batch(text_feats, bucket))
                out = self.model(torch.cat([tf, af], dim=-1))
            elif self.task.startswith("audio"):
                out = self.model(self._pad_batch(audio_feats, bucket))
            else:
                out = self.model(self._pad_batch(text_feats, bucket))
        return out[:n].cpu().numpy()

    def predict_batch(self, waveforms_per_speaker=None, sample_rates=None,
                      texts_per_speaker=None, ordinal_bases=None
                      ) -> List[dict]:
        """Raw inputs -> one result dict per speaker: waveforms for the
        audio and fusion tasks, transcripts for the text and fusion
        tasks."""
        af = tf = None
        if not self.task.startswith("text"):
            keys = self._audio_keys(waveforms_per_speaker, sample_rates,
                                    ordinal_bases)
            af = self._stack_rows(self._audio_feature_rows(
                waveforms_per_speaker, sample_rates, ordinal_bases, keys))
        if not self.task.startswith("audio"):
            tf = self._stack_rows(self._text_feature_rows(texts_per_speaker),
                                  dim=self._text_dim)
        out = self.predict_features(af, tf)
        return _format_outputs(out, self.task.endswith("clf"), "sds_score")

    def predict_speaker(self, waveforms=None, sample_rates=None,
                        texts=None, ordinal_base: Optional[int] = None
                        ) -> dict:
        """Single speaker: 3 waveforms and/or 3 transcripts -> result."""
        return self.predict_batch(
            [waveforms] if waveforms is not None else None,
            [sample_rates] if sample_rates is not None else None,
            [texts] if texts is not None else None,
            [ordinal_base] if ordinal_base is not None else None)[0]

    def warmup(self, batch_sizes: Sequence[int] = (1, 2, 4),
               utt_seconds: float = 4.0, sr: int = 16000) -> None:
        """Run the standard serving shapes once with synthetic traffic
        (first-use costs: kernel build, cuFFT plans, allocator growth).
        The transcripts differ per speaker and batch size, so the feature
        cache does not skip the larger embedding batches."""
        rng = np.random.default_rng(0)
        for n in batch_sizes:
            kw = {}
            if not self.task.startswith("text"):
                kw["waveforms_per_speaker"] = [
                    [np.round(rng.standard_normal(int(sr * utt_seconds))
                              * 2000).astype(np.int16) for _ in range(3)]
                    for _ in range(n)]
                kw["sample_rates"] = [[sr] * 3] * n
            if not self.task.startswith("audio"):
                kw["texts_per_speaker"] = [
                    [f"warm {n} {i} 你 好", f"warm {n} {i} 还 可以",
                     f"warm {n} {i} 有点 累"] for i in range(n)]
            self.predict_batch(**kw)
