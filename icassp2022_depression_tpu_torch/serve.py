"""End-to-end inference (serving) API, the stable public surface (port of
:mod:`icassp2022_depression_tpu.serve`).

The reference has no inference path at all: predictions exist only inside
its evaluation scripts.  This module is the one import users target; the
implementation is split into :mod:`.serving.predictors` (raw audio/text
-> features -> model forward on the card, the feature cache) and
:mod:`.serving.transport` (stdlib HTTP/TLS/auth front with
micro-batching and bounded admission).

Typical use::

    predictor = Predictor.from_checkpoint("fuse_0.69_1.npz", task="fuse_clf")
    result = predictor.predict_speaker(waveforms, sample_rates, texts)
    # {'label': 1, 'probs': [...], 'depressed': True}

Everything is re-exported here under its name in the submodules, which
hold the design notes.  The JAX facade's ``_model_for`` is
:func:`.serving.predictors.model_config` / ``model_kind`` here.
"""

from icassp2022_depression_tpu_torch.serving.predictors import (  # noqa: F401
    TASKS,
    DaicPredictor,
    Predictor,
    _FeatureCache,
    _format_outputs,
    _pow2,
    model_config,
    model_kind,
)
from icassp2022_depression_tpu_torch.serving.transport import (  # noqa: F401
    LatencyHistogram,
    ServerOverloaded,
    _DaicMicroBatcher,
    _MicroBatcher,
    make_http_server,
    serve_http,
)

__all__ = [
    "TASKS", "Predictor", "DaicPredictor", "ServerOverloaded",
    "LatencyHistogram", "make_http_server", "serve_http",
]
