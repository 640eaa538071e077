"""EATD text frontend: host tokenisation + sentence embedding on the device
(port of :mod:`icassp2022_depression_tpu.frontend.text`).

Per speaker, per answer: the transcript line is segmented
(:func:`tokenize`, a named segmenter: jieba where it can be imported, else
a CJK-aware fallback), embedded by the resolved sentence embedder
(:func:`make_embedder`: an explicit encoder, a converted ELMoForManyLangs
bundle, or the seeded stand-in) and averaged over its tokens -> one
1024-d vector per answer, [N, 3, 1024] for the corpus; or embedded by a
``deepseek_v3`` decoder over explicit weights (a :class:`..config.
MoeLmConfig`, one ``hidden_size`` vector per answer).

:func:`extract_eatd` writes the JAX package's four npz files and its
``extraction_meta.json`` (the embedder's provenance id, byte-identical to
the JAX package's for the same embedder); :func:`extract_eatd_device` keeps
the features on the device for the trainers (``cli train --corpus``,
``cli pipeline --corpus``).  Each runs on ``device``, by default the
first card (raising when there is none).  ``elmo_stateful`` (a bundle
only) emulates upstream's cross-batch biLM state, one embedding call per
speaker as the reference's persistent ``Embedder`` makes them.
``elmo_tp`` N runs the LSTMP biLM tensor-parallel over the first N ranks
of the default ``torch.distributed`` group (:mod:`..parallel.elmo_tp`):
every rank extracts, rank 0 writes.
"""

from __future__ import annotations

import functools
import json
import os
import sys
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

from icassp2022_depression_tpu_torch.config import MoeLmConfig
from icassp2022_depression_tpu_torch.data import eatd
from icassp2022_depression_tpu_torch.models import elmo, elmo_pretrained
from icassp2022_depression_tpu_torch.ops import prng
from icassp2022_depression_tpu_torch.parallel import distributed
from icassp2022_depression_tpu_torch.parallel import elmo_tp as tensor_parallel
from icassp2022_depression_tpu_torch.utils.device import resolve_device


def _is_cjk(ch: str) -> bool:
    return "一" <= ch <= "鿿"


def fallback_segment(text: str) -> List[str]:
    """CJK chars become single tokens, latin/digit runs stay together."""
    tokens, buf = [], ""
    for ch in text.strip():
        if _is_cjk(ch):
            if buf:
                tokens.append(buf)
                buf = ""
            tokens.append(ch)
        elif ch.isspace():
            if buf:
                tokens.append(buf)
                buf = ""
        else:
            buf += ch
    if buf:
        tokens.append(buf)
    return tokens


@functools.lru_cache(maxsize=None)
def _jieba():
    try:
        import jieba  # type: ignore
    except ImportError:
        return None
    return jieba


def _jieba_segment(text: str) -> List[str]:
    jieba = _jieba()
    if jieba is None:
        raise ImportError("segmenter 'jieba' requested but jieba is not "
                          "installed (use --segmenter fallback)")
    return list(jieba.cut(text.strip(), cut_all=False))


def _pkuseg_segment(text: str) -> List[str]:  # pragma: no cover - optional
    import pkuseg  # type: ignore

    return pkuseg.pkuseg().cut(text.strip())


def _thulac_segment(text: str) -> List[str]:  # pragma: no cover - optional
    import thulac  # type: ignore

    return [w for w, _tag in thulac.thulac(seg_only=True).cut(text.strip())]


def _hanlp_segment(text: str) -> List[str]:  # pragma: no cover - optional
    from pyhanlp import HanLP  # type: ignore

    return [term.word for term in HanLP.segment(text.strip())]


#: the reference's segmenters (``text_features_whole.py:30-32``); the
#: optional ones raise ImportError unless their package is installed
SEGMENTERS = {
    "jieba": _jieba_segment,
    "fallback": fallback_segment,
    "pkuseg": _pkuseg_segment,
    "thulac": _thulac_segment,
    "hanlp": _hanlp_segment,
}


def register_segmenter(name: str, fn) -> None:
    """Extension point (JAX ``frontend/text.py:113``): register ``fn(text)
    -> list[str]`` under ``name``, so :func:`tokenize`, the extraction
    passes and ``extract-text --segmenter`` can dispatch to it."""
    SEGMENTERS[name] = fn


def get_segmenter(name: str):
    """A segmenter by name ('auto': jieba where it can be imported, else
    the CJK fallback)."""
    if name == "auto":
        return _jieba_segment if _jieba() is not None else fallback_segment
    try:
        return SEGMENTERS[name]
    except KeyError:
        raise ValueError(
            f"unknown segmenter {name!r}; available: "
            f"{', '.join(sorted(SEGMENTERS))} (register_segmenter to add)"
        ) from None


def tokenize(text: str, segmenter: str = "auto") -> List[str]:
    """Segment one transcript line; whitespace-only tokens are dropped (the
    JAX package's documented deviation from the reference)."""
    return [t for t in get_segmenter(segmenter)(text) if t.strip()]


def embed_sentences(params, sentences: Sequence[List[str]],
                    cfg=elmo.ElmoConfig(), batch_size: int = 512,
                    encode=None) -> torch.Tensor:
    """Hashed-id encoders (the stand-in :class:`..models.elmo.ElmoConfig`
    BiLSTM or the :class:`..models.elmo.ElmoLstmpConfig` biLM): tokenised
    sentences -> [N, output_dim] on the parameters' device.  Batches pad
    rows to a multiple of 8 (length-1 rows of id 0, sliced away) and tokens
    to a multiple of 16, as in the JAX package.  ``encode`` replaces the
    encoder (:func:`..parallel.elmo_tp.make_tp_encode`)."""
    if encode is None:
        encode = (elmo.encode_lstmp if isinstance(cfg, elmo.ElmoLstmpConfig)
                  else elmo.encode)
    device = params["embed"].device
    pooled = []
    with torch.inference_mode():
        for start in range(0, len(sentences), batch_size):
            chunk = sentences[start:start + batch_size]
            max_t = -(-max(1, max(len(s) for s in chunk)) // 16) * 16
            rows = -(-len(chunk) // 8) * 8
            ids = np.zeros((rows, max_t), np.int64)
            lengths = np.ones((rows,), np.int64)
            for i, toks in enumerate(chunk):
                for j, tok in enumerate(toks):
                    ids[i, j] = elmo.token_id(tok, cfg.vocab_size)
                lengths[i] = max(1, len(toks))
            _, out = encode(params, torch.from_numpy(ids).to(device),
                            torch.from_numpy(lengths).to(device), cfg)
            pooled.append(out[:len(chunk)])
    if not pooled:
        return torch.zeros((0, cfg.output_dim), dtype=torch.float32,
                           device=device)
    return torch.cat(pooled)


def make_embedder(params=None, cfg=None, seed: int = 0,
                  elmo_weights: Optional[str] = "auto",
                  with_id: bool = False, device=None,
                  elmo_stateful: bool = False, elmo_tp: int = 0):
    """Resolve the sentence embedder once -> ``(embed_fn, output_dim)``
    (plus the provenance id with ``with_id``, recorded in extraction
    sidecars).  ``embed_fn(sentences) -> [N, output_dim]`` on ``device``.

    Resolution order, as in the JAX package: explicit ``params`` (+
    ``cfg``) win ("explicit-params"); else a converted bundle
    (``elmo_weights`` path, or ``"auto"``: ``ICASSP_ELMO_WEIGHTS``, then
    ``~/.cache/icassp2022_tpu/elmo_zhs.npz``) loaded onto ``device``
    ("elmo_bundle:<name>:<bytes>"); else the seeded stand-in drawn on ``device`` ("prng:seed=S", or "prng-lstmp:seed=S"
    for an :class:`..models.elmo.ElmoLstmpConfig`), with a stderr banner.
    Explicit ``params`` are moved to ``device``; ``device`` None is the
    first card (:func:`..utils.device.default_device`).  A
    :class:`..config.MoeLmConfig` takes explicit ``params`` only (``{"weights":
    ..., "lexicon": ...}``, :mod:`..models.moe_lm`, imported here at its
    first use): the decoder's pooled final states, ``cfg.hidden_size``
    wide, with the weights kept where they lie when already on ``device``.

    ``elmo_stateful`` (a bundle only; explicit params or no bundle raise):
    the bundle's :class:`..models.elmo_pretrained.PretrainedElmo` carries
    its biLM states across calls, and the id gets a ``:stateful`` suffix.

    ``elmo_tp`` N > 1: the LSTMP biLM runs tensor-parallel over a
    model-axis mesh of the first N ranks of the default group
    (:func:`..parallel.elmo_tp.model_mesh`, raising with fewer), each rank
    calling the embedder with the same sentences.  It applies to a bundle
    and to an explicit or seeded LSTMP encoder; the plain
    :class:`..models.elmo.ElmoConfig` BiLSTM has no such layout and
    raises.  The id is the serial encoder's: the results are the same up
    to the all-reduce's summation order.
    """
    device = resolve_device(device)

    def ret(fn, dim, ident):
        return (fn, dim, ident) if with_id else (fn, dim)

    if isinstance(cfg, MoeLmConfig):
        if params is None or elmo_stateful or (elmo_tp and elmo_tp > 1):
            raise ValueError(
                "a MoeLmConfig embedder takes explicit params (its weights "
                "and lexicon), and neither elmo_stateful nor elmo_tp")
        # imported at its first use: the ELMo paths never load it
        from icassp2022_depression_tpu_torch.models import moe_lm

        return ret(moe_lm.MoeLmEmbedder(params, cfg, device),
                   cfg.hidden_size, "explicit-params")
    if cfg is None:
        cfg = elmo.ElmoConfig()
    tp_mesh = None
    if elmo_tp and elmo_tp > 1:
        tp_mesh = tensor_parallel.model_mesh(elmo_tp)

    def embed_fn(params):
        encode = None
        if tp_mesh is not None:
            if not isinstance(cfg, elmo.ElmoLstmpConfig):
                raise ValueError(
                    "--elmo-tp shards the stacked LSTMP biLM; the plain "
                    "ElmoConfig BiLSTM has no tensor-parallel layout (use "
                    "ElmoLstmpConfig or a converted bundle)")
            encode = tensor_parallel.make_tp_encode(tp_mesh, params, cfg)
        return lambda s: embed_sentences(params, s, cfg, encode=encode)

    if params is not None:
        if elmo_stateful:
            raise ValueError("elmo_stateful requires a converted "
                             "ELMoForManyLangs bundle (explicit params "
                             "use the stateless encoder)")
        params = elmo_pretrained.tree_to(params, device)
        return ret(embed_fn(params), cfg.output_dim, "explicit-params")
    found = None
    if elmo_weights == "auto":
        found = elmo_pretrained.default_weights_path()
    elif elmo_weights:
        found = Path(elmo_weights)
    if elmo_stateful and found is None:
        raise ValueError(
            "elmo_stateful emulates the pretrained upstream ElmobiLm's "
            "cross-batch state and needs a converted bundle (python -m "
            "icassp2022_depression_tpu_torch.scripts.convert_elmo_zhs; set "
            "ICASSP_ELMO_WEIGHTS or pass --elmo-weights) - refusing to "
            "silently run the stateless PRNG encoder instead")
    if found is not None:
        pretrained = elmo_pretrained.load_npz(found, device)
        pretrained.stateful = elmo_stateful
        ident = f"elmo_bundle:{found.name}:{found.stat().st_size}"
        if elmo_stateful:
            ident += ":stateful"
        if tp_mesh is not None:
            pretrained.enable_tp(tp_mesh)
        return ret(pretrained.embed_sentences, pretrained.output_dim, ident)
    key = prng.prng_key(seed, device)
    if isinstance(cfg, elmo.ElmoLstmpConfig):
        params, kind = elmo.init_lstmp_encoder(key, cfg), "prng-lstmp"
    else:
        params, kind = elmo.init(key, cfg), "prng"
    warn_standin_encoder()
    return ret(embed_fn(params), cfg.output_dim, f"{kind}:seed={seed}")


def warn_standin_encoder() -> None:
    """Unmissable stderr notice that the seeded stand-in encoder is in use
    instead of converted pretrained ELMo weights (the reference always
    embeds with the released zhs model).  Suppressed by
    ``ICASSP_SUPPRESS_STANDIN_WARNING=1``."""
    if os.environ.get("ICASSP_SUPPRESS_STANDIN_WARNING"):
        return
    print("\n".join([
        "=" * 72,
        "WARNING: no converted ELMo bundle found - using the PRNG",
        "stand-in text encoder.  Text features will be deterministic and",
        "self-consistent but NOT comparable to the reference's published",
        "metrics (it uses the pretrained zhs ELMoForManyLangs model).",
        "Convert real weights with python -m",
        "icassp2022_depression_tpu_torch.scripts.convert_elmo_zhs and set",
        "ICASSP_ELMO_WEIGHTS (or pass --elmo-weights).",
        "=" * 72,
    ]), file=sys.stderr, flush=True)


def _corpus_sentences(root: Path, max_id: int, segmenter: str):
    """(tokenised answers in corpus order, 3 per speaker, SDS scores)."""
    sentences: List[List[str]] = []
    sds: List[float] = []
    for sp in eatd.iter_speakers(root, max_id=max_id, read_text=True):
        if sp.texts is None:
            raise ValueError(f"missing transcripts for {sp.split}/"
                             f"{sp.number}")
        sentences.extend(tokenize(t, segmenter=segmenter) for t in sp.texts)
        sds.append(sp.sds)
    return sentences, sds


def extract_eatd_device(root: Path, params=None, cfg=elmo.ElmoConfig(),
                        seed: int = 0, max_id: int = eatd.MAX_SPEAKER_ID,
                        sds_threshold: float = 53.0,
                        elmo_weights: Optional[str] = "auto",
                        segmenter: str = "auto", device=None,
                        elmo_stateful: bool = False, elmo_tp: int = 0):
    """The corpus text pass with the features left on ``device`` (``cli
    train --corpus`` / ``cli pipeline --corpus``).  Returns (features
    [N, 3, D] on ``device``, sds_targets, clf_targets, provenance dict).
    ``elmo_tp``: as :func:`make_embedder`.

    With ``elmo_stateful`` each speaker's 3 answers are one embedding call,
    the reference's granularity (one ``sents2elmo`` call per speaker on a
    persistent ``Embedder``, ``text_features_whole.py:16,40``): the carried
    states depend on the batches, so they must match call for call."""
    embed, dim, embedder_id = make_embedder(
        params, cfg, seed, elmo_weights, with_id=True, device=device,
        elmo_stateful=elmo_stateful, elmo_tp=elmo_tp)
    sentences, sds = _corpus_sentences(Path(root), max_id, segmenter)
    if elmo_stateful:
        flat = torch.cat([embed(sentences[i:i + 3])
                          for i in range(0, len(sentences), 3)]
                         or [embed([])])
    else:
        flat = embed(sentences)
    features = flat.reshape(len(sds), 3, dim)
    sds_targets, clf_targets = eatd.eatd_targets(sds, sds_threshold)
    meta = {"embedder": embedder_id, "output_dim": int(dim), "seed": seed,
            "segmenter": segmenter, "elmo_tp": elmo_tp}
    return features, sds_targets, clf_targets, meta


def extract_eatd(root: Path, params=None, cfg=elmo.ElmoConfig(),
                 out_dir: Optional[Path] = None, seed: int = 0,
                 max_id: int = eatd.MAX_SPEAKER_ID,
                 sds_threshold: float = 53.0,
                 elmo_weights: Optional[str] = "auto",
                 segmenter: str = "auto", device=None,
                 elmo_stateful: bool = False, elmo_tp: int = 0):
    """The corpus text pass -> ([N, 3, D] features, sds, clf labels) as
    numpy; with ``out_dir``, also the JAX package's
    ``whole_{samples,labels}_{reg,clf}_avg.npz`` and
    ``extraction_meta.json`` (rank 0 of a group writes them).
    ``elmo_tp``: as :func:`make_embedder`."""
    feats, sds_targets, clf_targets, meta = extract_eatd_device(
        root, params, cfg, seed, max_id, sds_threshold, elmo_weights,
        segmenter, device, elmo_stateful, elmo_tp)
    features = feats.cpu().numpy()
    if out_dir is not None and distributed.is_main():
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        np.savez(out_dir / "whole_samples_reg_avg.npz", features)
        np.savez(out_dir / "whole_labels_reg_avg.npz", sds_targets)
        np.savez(out_dir / "whole_samples_clf_avg.npz", features)
        np.savez(out_dir / "whole_labels_clf_avg.npz", clf_targets)
        (out_dir / "extraction_meta.json").write_text(json.dumps(
            {"embedder": meta["embedder"], "output_dim": meta["output_dim"],
             "seed": seed, "n_speakers": len(sds_targets),
             "segmenter": segmenter, "elmo_tp": elmo_tp}))
    return features, sds_targets, clf_targets


def load_features(features_dir: Path, track: str = "clf"):
    """(features [N, 3, D], labels [N]) from the reference-layout npz pair."""
    features_dir = Path(features_dir)
    feats = np.load(features_dir / f"whole_samples_{track}_avg.npz")["arr_0"]
    labels = np.load(features_dir / f"whole_labels_{track}_avg.npz")["arr_0"]
    return feats, labels
