"""Serving predictor: raw audio and transcripts -> features -> model forward
(port of :mod:`icassp2022_depression_tpu.serving.predictors`, the EATD
tasks).

:class:`Predictor` serves all six tasks: three raw answers per speaker ->
wav2vlad features, or per-answer mean-pooled VGGish embeddings
(``audio_embedder="vggish"``, :func:`..frontend.audio.
vggish_embed_waveforms`), and/or three transcripts ->
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
(``rnn_backend="auto"``).  A :meth:`Predictor.predict_batch` call is the
profiling region ``serve/call`` (:mod:`..utils.profiling`), the root of
``serve/cache_key`` (the blake2b keys), ``serve/audio`` and
``serve/text`` (the lookups and the cold speakers' extraction),
``serve/forward`` (up to the forward's enqueue) and ``serve/readback``
(the wait for the device and the copy).

The device is the caller's choice: without one, :func:`default_device`
takes the first card and raises when there is none (``device="cpu"`` runs
everything on the plain versions).

Checkpoints are npz files of either package or the reference's ``.pt``
pickles (:meth:`Predictor.from_checkpoint` dispatches on the extension).
:class:`DaicPredictor` serves the DAIC models of :mod:`..train.daic` (a raw
interview session, or its response signals, -> PHQ8); the HTTP front is
:mod:`.transport`.
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
from icassp2022_depression_tpu_torch.frontend import daic as daic_fe
from icassp2022_depression_tpu_torch.frontend import text as text_fe
from icassp2022_depression_tpu_torch.models import elmo, porting, vggish
from icassp2022_depression_tpu_torch.train import checkpoints
from icassp2022_depression_tpu_torch.utils import profiling, shapes
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
                 segmenter: str = "auto", vggish_params=None,
                 vggish_postprocessor=None):
        """``model`` (:class:`AudioNet`, :class:`TextNet` or
        :class:`FusionNet`) is moved to ``device`` (default: the first
        card, see :func:`default_device`) and put in eval mode.

        ``audio_embedder="vggish"`` serves models trained on ``extract-audio
        --embedder vggish`` features: ``vggish_params`` (a
        :class:`..models.vggish.VGGish` or a JAX-layout param tree) or, at
        the first request, the bundle :func:`..models.vggish.
        default_weights_path` finds (its PCA postprocessor too), else the
        seeded stand-in at ``seed``, as extraction resolves them;
        ``vggish_postprocessor`` must be the one extraction used.

        The text and fusion tasks resolve their sentence embedder as
        ``extract-text`` does (:func:`..frontend.text.make_embedder`):
        explicit ``elmo_params`` (+ ``elmo_cfg``), else the bundle of
        ``elmo_weights`` (a path, or ``"auto"``: ``ICASSP_ELMO_WEIGHTS``;
        None: the seeded stand-in at ``seed``).  ``segmenter`` must be the
        one extraction used; :meth:`from_checkpoint` adopts the
        checkpoint's."""
        if task not in TASKS:
            raise ValueError(f"task must be one of {TASKS}, got {task!r}")
        if audio_embedder not in ("netvlad", "vggish"):
            raise ValueError(f"audio_embedder must be 'netvlad' or "
                             f"'vggish', got {audio_embedder!r}")
        self.task = task
        self.frontend_cfg = frontend_cfg
        self.audio_embedder = audio_embedder
        self.segmenter = segmenter
        self.device = resolve_device(device)
        self._seed = seed
        self._vggish = vggish_params
        self._vggish_postprocessor = vggish_postprocessor
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
        """[[w_pos, w_neu, w_neg], ...] -> [N, 3, D] features (wav2vlad,
        D = 256, or VGGish, D = 128).

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
        """[3, D] rows -> [N, 3, D] (zero speakers is a valid request;
        ``dim`` None: the audio embedder's width)."""
        if not rows:
            if dim is None:
                dim = (vggish.EMBEDDING_SIZE
                       if self.audio_embedder == "vggish"
                       else self.frontend_cfg.netvlad_output_dim)
            return torch.zeros((0, 3, dim), dtype=torch.float32,
                               device=self.device)
        return torch.stack(rows)

    def _vggish_model(self) -> vggish.VGGish:
        """The VGGish network, resolved at the first request as
        ``extract-audio --embedder vggish`` resolves it."""
        if self._vggish is None:
            bundle = vggish.default_weights_path()
            if bundle is not None:
                self._vggish, bundle_post = vggish.load_npz(bundle,
                                                            self.device)
                if self._vggish_postprocessor is None:
                    self._vggish_postprocessor = bundle_post
                print(f"Predictor: auto-loaded VGGish bundle {bundle} - the "
                      "served checkpoint must have been trained on features "
                      "from this embedder", file=sys.stderr)
        self._vggish = vggish.resolve(self._vggish, self._seed, self.device)
        return self._vggish

    def _embed_audio(self, flat_w, flat_sr, ordinals) -> torch.Tensor:
        """Cold answers -> [n, D] features on the device: wav2vlad at the
        utterance ``ordinals``, or mean-pooled VGGish embeddings."""
        if self.audio_embedder == "vggish":
            emb = audio_fe.vggish_embed_waveforms(
                self._vggish_model(), flat_w, flat_sr,
                self._vggish_postprocessor)
            return torch.from_numpy(emb).to(self.device)
        with torch.inference_mode():
            return audio_fe.extract_batch(flat_w, flat_sr,
                                          self.frontend_cfg,
                                          ordinals=ordinals,
                                          device=self.device)

    def _audio_keys(self, waveforms_per_speaker, sample_rates,
                    ordinal_bases):
        if waveforms_per_speaker is None or sample_rates is None:
            raise ValueError(
                f"task {self.task!r} needs 3 waveforms (+ sample rates) per "
                "speaker; got None")
        if len(sample_rates) != len(waveforms_per_speaker) or any(
                len(w) != 3 or len(sr) != 3 for w, sr in
                zip(waveforms_per_speaker, sample_rates)):
            raise ValueError("every speaker needs exactly 3 waveforms and "
                             "3 sample rates (positive, neutral, negative)")
        with profiling.annotate("serve/cache_key"):
            return [
                _FeatureCache.key(
                    ["audio", self.audio_embedder,
                     str(0 if ordinal_bases is None else ordinal_bases[i]),
                     str(list(sample_rates[i]))]
                    + list(waveforms_per_speaker[i]))
                for i in range(len(waveforms_per_speaker))]

    def _audio_feature_rows(self, waveforms_per_speaker, sample_rates,
                            ordinal_bases, keys):
        """Cache-aware extraction -> list of per-speaker [3, D] device
        tensors."""
        with profiling.annotate("serve/audio", self.device):
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
                feats = self._embed_audio(flat_w, flat_sr, ordinals).reshape(
                    len(todo), 3, -1)
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
        with profiling.annotate("serve/cache_key"):
            keys = [_FeatureCache.key(["text"] + list(ts))
                    for ts in texts_per_speaker]
        with profiling.annotate("serve/text", self.device):
            rows: list = [None] * len(keys)
            todo = []
            for i, key in enumerate(keys):
                cached = self.feature_cache.get(key)
                if cached is not None:
                    rows[i] = cached
                else:
                    todo.append(i)
            if todo:
                with profiling.annotate("text/segment"):
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
        with profiling.annotate("serve/forward", self.device), \
                torch.inference_mode():
            if self.task.startswith("fuse"):
                tf, af = self.model.pretrained_feature(
                    self._pad_batch(audio_feats, bucket),
                    self._pad_batch(text_feats, bucket))
                out = self.model(torch.cat([tf, af], dim=-1))
            elif self.task.startswith("audio"):
                out = self.model(self._pad_batch(audio_feats, bucket))
            else:
                out = self.model(self._pad_batch(text_feats, bucket))
        with profiling.annotate("serve/readback", self.device):
            return out[:n].cpu().numpy()

    def predict_batch(self, waveforms_per_speaker=None, sample_rates=None,
                      texts_per_speaker=None, ordinal_bases=None
                      ) -> List[dict]:
        """Raw inputs -> one result dict per speaker: waveforms for the
        audio and fusion tasks, transcripts for the text and fusion
        tasks.  The call is the profiling region ``serve/call``, the root
        of its ``serve/*`` regions."""
        af = tf = None
        with profiling.annotate("serve/call", self.device):
            if not self.task.startswith("text"):
                keys = self._audio_keys(waveforms_per_speaker, sample_rates,
                                        ordinal_bases)
                af = self._stack_rows(self._audio_feature_rows(
                    waveforms_per_speaker, sample_rates, ordinal_bases,
                    keys))
            if not self.task.startswith("audio"):
                tf = self._stack_rows(
                    self._text_feature_rows(texts_per_speaker),
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

    def warmup(self, batch_sizes: Sequence[int] = (1, 2, 4, 8),
               utt_seconds: Sequence[float] = (3.0, 6.0, 12.0),
               sr: int = 16000) -> None:
        """Run the standard serving shapes once with synthetic traffic
        (first-use costs: kernel build, cuFFT plans, allocator growth).
        ``utt_seconds``: the three answers' lengths; the default puts them
        one each into the 65536-, 131072- and 262144-sample buckets, so
        batches of 1, 2, 4 and 8 speakers warm each bucket's 1-, 2-, 4-
        and 8-row tiles.  A bucket of 9 or more answers (its 16-row tile
        and up) stays cold until a batch first reaches it.  The
        transcripts differ per speaker and batch size, so the feature
        cache does not skip the larger embedding batches."""
        rng = np.random.default_rng(0)
        for n in batch_sizes:
            kw = {}
            if not self.task.startswith("text"):
                kw["waveforms_per_speaker"] = [
                    [np.round(rng.standard_normal(int(sr * x))
                              * 2000).astype(np.int16) for x in utt_seconds]
                    for _ in range(n)]
                kw["sample_rates"] = [[sr] * 3] * n
            if not self.task.startswith("audio"):
                kw["texts_per_speaker"] = [
                    [f"warm {n} {i} 你 好", f"warm {n} {i} 还 可以",
                     f"warm {n} {i} 有点 累"] for i in range(n)]
            self.predict_batch(**kw)


class DaicPredictor:
    """Serves a DAIC checkpoint (:mod:`..train.daic`) end to end: a raw
    interview session (transcript CSV + whole-session wav, segmented by the
    bundled question bank as extraction segments it,
    ``DAICFeatureExtarction/feature_extraction.py:31-64``) or its
    pre-segmented response signals -> PHQ8 binary / score.

    Response counts are ragged: a batch pads its responses to a power of
    two with a validity mask, and its participants to a power of two with
    all-ones masks (no 0/0 in the padded rows' mean pooling).  Features
    stay on the device from extraction to the forward, and every response's
    features are memoised in the LRU (:class:`_FeatureCache`), keyed by
    its ordinal, sample rate, waveform (and transcript)."""

    TASKS = ("daic_clf", "daic_reg")

    def __init__(self, model, task: str, tcfg=None,
                 frontend_cfg: C.FrontendConfig = C.FrontendConfig(),
                 multimodal: bool = False, elmo_cfg=None, elmo_params=None,
                 seed: int = 0, elmo_weights: Optional[str] = "auto",
                 segmenter: str = "auto",
                 feature_cache_entries: int = 1024, device=None):
        """``model`` (:class:`..models.audio_net.AudioNet`) is moved to
        ``device`` (default: the first card) in eval mode.
        ``multimodal=True`` serves ``train-daic --multimodal``
        checkpoints: each response's text embedding (the embedder resolved
        as ``extract-daic --multimodal`` resolves it) follows its audio
        features, so the model's ``embedding_size`` must be audio + text
        width (:meth:`from_checkpoint` reads it from the sidecar)."""
        from icassp2022_depression_tpu_torch.train import daic as daic_train

        if task not in self.TASKS:
            raise ValueError(f"task must be one of {self.TASKS}, got "
                             f"{task!r}")
        self.task = task
        self.tcfg = tcfg if tcfg is not None else (
            daic_train.DAIC_CLF if task == "daic_clf"
            else daic_train.DAIC_REG)
        self.frontend_cfg = frontend_cfg
        self.device = resolve_device(device)
        # per RESPONSE: repeat participants hit it fully, sessions that
        # share responses partly
        self.feature_cache = _FeatureCache(feature_cache_entries)
        self.multimodal = multimodal
        self.segmenter = segmenter
        self._text_embed = None
        self._text_dim = 0
        #: provenance id of the text embedder (multimodal only)
        self.embedder_id: Optional[str] = None
        if multimodal:
            text_fe.get_segmenter(segmenter)   # fail fast on bad names
            self._text_embed, self._text_dim, self.embedder_id = \
                text_fe.make_embedder(params=elmo_params, cfg=elmo_cfg,
                                      seed=seed, elmo_weights=elmo_weights,
                                      with_id=True, device=self.device)
            expect = frontend_cfg.netvlad_output_dim + self._text_dim
            if self.tcfg.model.embedding_size != expect:
                raise ValueError(
                    f"multimodal DAIC model expects embedding_size "
                    f"{self.tcfg.model.embedding_size} but audio+text "
                    f"features are {expect}-d "
                    f"({frontend_cfg.netvlad_output_dim}+{self._text_dim})"
                    " - pass the elmo_cfg/elmo_weights used at extraction")
        self.model = model.to(self.device).eval()
        #: the checkpoint's JSON sidecar (set by :meth:`from_checkpoint`)
        self.meta: dict = {}

    @classmethod
    def from_checkpoint(cls, path, task: str, tcfg=None, **kw):
        """Load a ``train-daic`` checkpoint: npz of either package, or a
        reference ``.pt`` through the restricted unpickler.  The sidecar's
        ``embedding_size`` (for checkpoints without one: the first GRU
        layer's input width) resizes the model config, and a width other
        than the audio features' serves the checkpoint as multimodal
        unless ``multimodal`` is passed.  The training features' text
        provenance is adopted: ``text_segmenter`` and ``text_seed`` feed
        the embedder unless ``segmenter`` / ``seed`` are passed, and an
        embedder id other than ``text_embedder`` warns."""
        from icassp2022_depression_tpu_torch.train import daic as daic_train

        resolved = tcfg if tcfg is not None else (
            daic_train.DAIC_CLF if task == "daic_clf"
            else daic_train.DAIC_REG)
        try:
            meta = checkpoints.load_meta(path)
        except (FileNotFoundError, ValueError):
            meta = {}
        sd_pt = (porting.load_reference_pt(path)
                 if str(path).endswith(".pt") else None)
        tree = checkpoints.load(path) if sd_pt is None else None
        # the first layer's gate weight is [3H, embedding]: it gives the
        # width when the sidecar has none, and H (the JAX package's
        # functional model takes both from the loaded weights)
        w_ih = (sd_pt["lstm_net_audio.weight_ih_l0"] if sd_pt is not None
                else tree["rnn"]["0"]["fwd"]["w_ih"])
        emb = int(meta.get("embedding_size") or w_ih.shape[1])
        hidden = int(w_ih.shape[0]) // 3
        if (emb, hidden) != (resolved.model.embedding_size,
                             resolved.model.hidden_dims):
            resolved = C.replace(resolved, model=C.replace(
                resolved.model, embedding_size=emb, hidden_dims=hidden))
        audio_dim = kw.get("frontend_cfg",
                           C.FrontendConfig()).netvlad_output_dim
        if "multimodal" not in kw and emb != audio_dim:
            kw = dict(kw, multimodal=True)
            print(f"DaicPredictor: checkpoint records embedding_size "
                  f"{emb} != audio dim {audio_dim} - serving it as a "
                  "--multimodal model (audio + per-response text)",
                  file=sys.stderr)
        trained_seg = meta.get("text_segmenter")
        if trained_seg and "segmenter" not in kw:
            kw = dict(kw, segmenter=trained_seg)
            if trained_seg != "auto":
                print(f"DaicPredictor: adopting segmenter "
                      f"'{trained_seg}' recorded by the checkpoint's "
                      "training features", file=sys.stderr)
        if meta.get("text_seed") is not None and "seed" not in kw:
            kw = dict(kw, seed=int(meta["text_seed"]))
        if sd_pt is not None:
            tree = porting.tree_from_reference(sd_pt, "audio",
                                               resolved.model)
        model = checkpoints.load_model(tree, "audio", resolved.model, "cpu")
        predictor = cls(model, task, tcfg=resolved, **kw)
        predictor.meta = meta
        expected = meta.get("text_embedder")
        if (expected and predictor.embedder_id
                and expected != predictor.embedder_id):
            print(f"WARNING: checkpoint {path} was trained on text "
                  f"features from embedder '{expected}' but serving "
                  f"resolved '{predictor.embedder_id}' - predictions "
                  "will be meaningless; pass matching elmo_weights",
                  file=sys.stderr)
        return predictor

    @staticmethod
    def _flatten_signals(signals_per_participant, sample_rates,
                         start_ordinals):
        """Ragged per-participant response lists -> flat (waveforms, srs,
        ordinals, counts) for one ``extract_batch`` call."""
        if len(sample_rates) != len(signals_per_participant):
            raise ValueError(f"{len(sample_rates)} sample rates for "
                             f"{len(signals_per_participant)} participants")
        counts = [len(s) for s in signals_per_participant]
        flat = [w for sig in signals_per_participant for w in sig]
        srs = [sample_rates[i] for i, c in enumerate(counts)
               for _ in range(c)]
        if start_ordinals is None:
            ords = [k for c in counts for k in range(c)]
        else:
            ords = [start_ordinals[i] + k
                    for i, c in enumerate(counts) for k in range(c)]
        return flat, srs, ords, counts

    def response_features(self, signals_per_participant,
                          sample_rates: Sequence[int],
                          start_ordinals: Optional[Sequence[int]] = None):
        """Ragged response signals -> list of [n_i, 1, D] host feature
        blocks, through one ``extract_batch`` call.  ``start_ordinals``
        reproduces a corpus participant's training-time features
        (extraction numbers utterances cumulatively across the split);
        the default numbers each participant's responses from 0."""
        flat, srs, ords, counts = self._flatten_signals(
            signals_per_participant, sample_rates, start_ordinals)
        if flat:
            with torch.inference_mode():
                feats = audio_fe.extract_batch(
                    flat, srs, self.frontend_cfg, ordinals=ords,
                    device=self.device).cpu().numpy()
        else:
            feats = np.zeros((0, self.frontend_cfg.netvlad_output_dim),
                             np.float32)
        out, pos = [], 0
        for c in counts:
            out.append(feats[pos:pos + c][:, None, :])
            pos += c
        return out

    def _forward(self, x: torch.Tensor, mask: np.ndarray,
                 n: int) -> List[dict]:
        with torch.inference_mode():
            out = self.model(x, time_mask=torch.as_tensor(
                mask, device=self.device))
        return _format_outputs(out[:n].cpu().numpy(),
                               self.task.endswith("clf"), "phq8_score")

    @staticmethod
    def _require_responses(counts) -> None:
        if any(c == 0 for c in counts):
            raise ValueError("participant with zero segmented responses "
                             "(no transcript line matched the question "
                             "bank?) - nothing to pool over")

    def _predict_flat(self, flat: torch.Tensor, counts) -> List[dict]:
        """Flat [M, D] device features + per-participant counts -> result
        dicts; the padded batch is built on the device by one index
        gather (:func:`..frontend.daic.gather_responses`)."""
        n = len(counts)
        bucket_r = _pow2(max(counts))
        bucket_n = _pow2(n)
        # padded participants keep all-ones masks: no 0/0 in their mean
        mask = np.ones((bucket_n, bucket_r), np.float32)
        mask[:n] = np.arange(bucket_r) < np.asarray(counts)[:, None]
        return self._forward(
            daic_fe.gather_responses(flat, counts, bucket_n, bucket_r),
            mask, n)

    def predict_features(self, feature_blocks) -> List[dict]:
        """[n_i, 1, D] blocks (as the trainer consumes them) -> result
        dicts, padded as :meth:`predict_signals` pads."""
        if not feature_blocks:
            return []   # zero participants is a valid request
        counts = [f.shape[0] for f in feature_blocks]
        self._require_responses(counts)
        flat = np.concatenate([np.asarray(f, np.float32)[:, 0]
                               for f in feature_blocks])
        return self._predict_flat(torch.as_tensor(flat, device=self.device),
                                  counts)

    def predict_signals(self, signals_per_participant, sample_rates,
                        start_ordinals=None,
                        texts_per_participant=None) -> List[dict]:
        """Pre-segmented response signals (+ aligned per-response
        transcripts for multimodal models) -> result dicts.  Features stay
        on the device from extraction (and embedding) to the forward; the
        response LRU keys on ``["daic", embedder_id, ordinal, sr, wave(,
        text)]``, so with the default 0-based ordinals a repeat
        participant hits it whatever the rest of its batch."""
        if self.multimodal:
            if texts_per_participant is None:
                raise ValueError(
                    "multimodal DAIC model: per-response transcripts are "
                    "required (one texts list per participant, aligned "
                    "1:1 with its response signals)")
            if len(texts_per_participant) != len(signals_per_participant) \
                    or any(len(t) != len(s) for t, s in
                           zip(texts_per_participant,
                               signals_per_participant)):
                raise ValueError("per-participant texts must align 1:1 "
                                 "with response signals")
        flat_w, srs, ords, counts = self._flatten_signals(
            signals_per_participant, sample_rates, start_ordinals)
        if not counts:
            return []   # zero participants is a valid request
        self._require_responses(counts)
        texts_flat = ([t for ts in texts_per_participant for t in ts]
                      if self.multimodal else None)
        keys = [_FeatureCache.key(
                    ["daic", self.embedder_id or "", str(ords[i]),
                     str(srs[i]), flat_w[i]]
                    + ([texts_flat[i]] if texts_flat is not None else []))
                for i in range(len(flat_w))]
        rows: list = [None] * len(keys)
        todo = []
        for i, key in enumerate(keys):
            cached = self.feature_cache.get(key)
            if cached is not None:
                rows[i] = cached
            else:
                todo.append(i)
        if todo:
            with torch.inference_mode():
                feats = audio_fe.extract_batch(
                    [flat_w[i] for i in todo], [srs[i] for i in todo],
                    self.frontend_cfg, ordinals=[ords[i] for i in todo],
                    device=self.device)
                if self.multimodal:
                    emb = self._text_embed(
                        [text_fe.tokenize(texts_flat[i],
                                          segmenter=self.segmenter)
                         for i in todo])
                    feats = torch.cat([feats, emb], dim=-1)
            for row, i in enumerate(todo):
                # a copy, so the cache does not pin the whole batch
                rows[i] = feats[row].clone()
                self.feature_cache.put(keys[i], rows[i])
        return self._predict_flat(torch.stack(rows), counts)

    def predict_participant(self, daic_dir, number: int,
                            queries_path=None, start_ordinal: int = 0
                            ) -> dict:
        """A raw ``<daic_dir>/<number>_P`` session -> one result dict,
        through the extraction-side session pass of each modality set."""
        from pathlib import Path

        queries = daic_fe.load_queries(queries_path)
        if self.multimodal:
            from icassp2022_depression_tpu_torch.train.daic import (
                concat_multimodal,
            )

            af, tf = daic_fe.extract_participant_multimodal(
                Path(daic_dir), number, queries, None, None,
                self.frontend_cfg, start_ordinal, embed_fn=self._text_embed,
                segmenter=self.segmenter, device=self.device)
            feats = concat_multimodal([af], [tf])[0]
        else:
            feats = daic_fe.extract_participant(
                Path(daic_dir), number, queries, self.frontend_cfg,
                start_ordinal, device=self.device)
        return self.predict_features([feats])[0]
