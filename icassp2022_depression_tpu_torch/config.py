"""Configuration dataclasses (port of :mod:`icassp2022_depression_tpu.config`).

The dataclasses are framework-neutral, so the fields and the six presets
are copied verbatim from the JAX package.  The one difference is the set
of values ``RNNConfig.rnn_backend`` / ``FusionConfig.rnn_backend`` take:
``"auto"`` (the CUDA kernels for CUDA tensors, the plain torch recurrence
for CPU tensors), ``"torch"`` or ``"cuda"`` — see
:func:`.ops.rnn.resolve_backend`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class RNNConfig:
    """Shared hyper-parameters of the recurrent branch models."""

    num_classes: int = 2
    dropout: float = 0.5
    rnn_layers: int = 2
    embedding_size: int = 256
    hidden_dims: int = 256
    bidirectional: bool = False
    #: "gru" or "lstm"
    cell: str = "gru"
    #: apply LayerNorm on the input embedding before the RNN
    input_layernorm: bool = True
    #: temporal pooling over RNN outputs: "mean" | "sum" | "attention"
    pooling: str = "mean"
    #: final activation of the head: "softmax" (classification) | "relu"
    #: (regression) | "none"
    head_activation: str = "softmax"
    #: weight init: "torch" (PyTorch module defaults) or "xavier"
    init: str = "torch"
    #: dropout before the first Linear of the FC head (the audio head has it,
    #: the clf text head does not — ``text_bilstm_whole.py:60-68``)
    head_input_dropout: bool = True
    #: recurrence implementation: "auto" | "torch" | "cuda"
    rnn_backend: str = "auto"


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"  # "adamw" | "adam"
    learning_rate: float = 6e-6
    #: weight decay applied to all params except LayerNorm ('ln') params,
    #: mirroring ``get_param_group`` (``audio_gru_whole.py:247-255``)
    weight_decay: float = 1e-5
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8


@dataclass(frozen=True)
class GateConfig:
    """Metric-gated best-checkpoint selection thresholds."""

    f1_floor: float = 0.5
    train_acc_frac: float = 0.9
    mae_ceiling: float = 8.5
    train_mae_ceiling: float = 13.0
    f1_tie_update: bool = True
    #: branch trainers require ``train_acc > 0.9*n`` (strict); the clf
    #: fusion trainer uses ``>=`` (``fuse_net_whole.py:513``)
    train_acc_strict: bool = True


@dataclass(frozen=True)
class TrainerConfig:
    model: RNNConfig = field(default_factory=RNNConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    gate: GateConfig = field(default_factory=GateConfig)
    batch_size: int = 8
    epochs: int = 170
    loss: str = "ce"
    seed: int = 0
    track: str = "classification"  # "classification" | "regression"


@dataclass(frozen=True)
class FusionConfig:
    """Fusion-net specific knobs (clf: ``fuse_net_whole.py:398-411``;
    reg: ``Regression/fuse_net.py:36-49``)."""

    audio_embed_size: int = 256
    text_embed_size: int = 1024
    audio_hidden_dims: int = 256
    text_hidden_dims: int = 128
    rnn_layers: int = 2
    dropout: float = 0.3
    num_classes: int = 2
    #: clf fusion trains only fc_final.weight (``fuse_net_whole.py:590-593``);
    #: reg fusion fine-tunes everything (``Regression/fuse_net.py:578-583``)
    train_all_params: bool = False
    #: reg fusion applies sigmoid modal attention in forward
    #: (``Regression/fuse_net.py:345-351``); clf fusion does not
    modal_attention: bool = False
    #: audio branch layer-norm: clf fusion has it (``fuse_net_whole.py:360``),
    #: reg fusion does not (``Regression/fuse_net.py:338``)
    audio_layernorm: bool = True
    head_activation: str = "softmax"
    #: recurrence implementation (see RNNConfig.rnn_backend)
    rnn_backend: str = "auto"


@dataclass(frozen=True)
class FrontendConfig:
    """Audio frontend (``Classification/audio_features_whole.py:34,57-72``)."""

    sample_rate: int = 16000
    n_fft: int = 2048
    hop_length: int = 512
    n_mels: int = 80
    log_floor: float = 1e-6
    netvlad_clusters: int = 16
    netvlad_output_dim: int = 256  # cluster_size * 16
    #: silence fallback amplitude/duration for empty wavs
    #: (``audio_features_whole.py:105-110``)
    silence_amplitude: float = 1e-4
    silence_seconds: int = 5
    #: per-utterance NetVLAD weights derive from this seed and the
    #: utterance ordinal (threefry, :mod:`.ops.prng`)
    netvlad_seed: int = 0


@dataclass(frozen=True)
class FoldConfig:
    """3-fold evaluation recipes.

    Classification folds come from persisted index files
    (``audio_gru_whole.py:261-263``); regression folds slice persisted
    shuffles of depressed / non-depressed indices into 10 + 44 test speakers
    per fold (``Regression/audio_bilstm_perm.py:215-219``).
    """

    n_folds: int = 3
    reg_test_dep: int = 10
    reg_test_non: int = 44
    #: number of leading train-depressed speakers that get permutation
    #: augmentation in the regression track (``audio_bilstm_perm.py:225``)
    reg_augment_first_n: int = 14
    #: permutation ids kept for augmented *train* depressed samples
    train_perm_ids: Tuple[int, ...] = (0, 1, 2, 3, 4, 5)
    #: permutation ids kept for augmented *test* depressed samples
    #: (test-set augmentation, ``audio_gru_whole.py:290``)
    test_perm_ids: Tuple[int, ...] = (0, 1, 4, 5)
    #: SDS cutoff for the binary label (``audio_features_whole.py:113``)
    sds_threshold: float = 53.0


AUDIO_CLF = TrainerConfig(
    # Classification/audio_gru_whole.py:110-121
    model=RNNConfig(
        num_classes=2, dropout=0.5, rnn_layers=2, embedding_size=256,
        hidden_dims=256, bidirectional=False, cell="gru",
        input_layernorm=True, pooling="mean", head_activation="softmax",
        init="torch", head_input_dropout=True,
    ),
    optimizer=OptimizerConfig(name="adamw", learning_rate=6e-6),
    gate=GateConfig(f1_floor=0.5, train_acc_frac=0.9),
    batch_size=8, epochs=170, loss="ce", track="classification",
)

TEXT_CLF = TrainerConfig(
    # Classification/text_bilstm_whole.py:247-258
    model=RNNConfig(
        num_classes=2, dropout=0.5, rnn_layers=2, embedding_size=1024,
        hidden_dims=128, bidirectional=True, cell="lstm",
        input_layernorm=False, pooling="attention", head_activation="softmax",
        init="xavier", head_input_dropout=False,
    ),
    optimizer=OptimizerConfig(name="adamw", learning_rate=1e-5),
    gate=GateConfig(f1_floor=0.5, train_acc_frac=0.9),
    batch_size=4, epochs=150, loss="ce", track="classification",
)

FUSE_CLF = FusionConfig(
    # Classification/fuse_net_whole.py:398-411
    audio_embed_size=256, text_embed_size=1024, audio_hidden_dims=256,
    text_hidden_dims=128, rnn_layers=2, dropout=0.3, num_classes=2,
    train_all_params=False, modal_attention=False, audio_layernorm=True,
    head_activation="softmax",
)

FUSE_CLF_TRAINER = TrainerConfig(
    model=RNNConfig(num_classes=2, dropout=0.3),
    optimizer=OptimizerConfig(name="adam", learning_rate=8e-6, weight_decay=0.0),
    gate=GateConfig(f1_floor=0.61, train_acc_frac=0.9,
                    f1_tie_update=False, train_acc_strict=False),
    batch_size=2, epochs=100, loss="myloss_ce", track="classification",
)

AUDIO_REG = TrainerConfig(
    # Regression/audio_bilstm_perm.py:32-43
    model=RNNConfig(
        num_classes=1, dropout=0.5, rnn_layers=2, embedding_size=256,
        hidden_dims=256, bidirectional=False, cell="gru",
        input_layernorm=False, pooling="sum", head_activation="relu",
        init="torch", head_input_dropout=True,
    ),
    optimizer=OptimizerConfig(name="adam", learning_rate=1e-5, weight_decay=0.0),
    gate=GateConfig(mae_ceiling=8.5, train_mae_ceiling=13.0),
    batch_size=2, epochs=120, loss="l1", track="regression",
)

TEXT_REG = TrainerConfig(
    # Regression/text_bilstm_perm.py:24-35
    model=RNNConfig(
        num_classes=1, dropout=0.5, rnn_layers=2, embedding_size=1024,
        hidden_dims=128, bidirectional=True, cell="lstm",
        input_layernorm=False, pooling="attention", head_activation="relu",
        init="xavier", head_input_dropout=True,
    ),
    optimizer=OptimizerConfig(name="adam", learning_rate=1e-5, weight_decay=0.0),
    gate=GateConfig(mae_ceiling=8.5, train_mae_ceiling=13.0),
    batch_size=2, epochs=110, loss="smooth_l1", track="regression",
)

FUSE_REG = FusionConfig(
    # Regression/fuse_net.py:36-49
    audio_embed_size=256, text_embed_size=1024, audio_hidden_dims=256,
    text_hidden_dims=128, rnn_layers=2, dropout=0.5, num_classes=1,
    train_all_params=True, modal_attention=True, audio_layernorm=False,
    head_activation="relu",
)

FUSE_REG_TRAINER = TrainerConfig(
    model=RNNConfig(num_classes=1, dropout=0.5),
    optimizer=OptimizerConfig(name="adam", learning_rate=8e-5, weight_decay=0.0),
    gate=GateConfig(mae_ceiling=8.2, train_mae_ceiling=13.0),
    batch_size=4, epochs=150, loss="myloss_smooth_l1", track="regression",
)

PRESETS = {
    "audio_clf": AUDIO_CLF,
    "text_clf": TEXT_CLF,
    "fuse_clf": FUSE_CLF_TRAINER,
    "audio_reg": AUDIO_REG,
    "text_reg": TEXT_REG,
    "fuse_reg": FUSE_REG_TRAINER,
}

FUSION_PRESETS = {
    "fuse_clf": FUSE_CLF,
    "fuse_reg": FUSE_REG,
}


def replace(cfg, **kwargs):
    """Functional update of any frozen config dataclass."""
    return dataclasses.replace(cfg, **kwargs)
