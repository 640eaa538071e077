"""Useful operations and bytes of the models' parts, from the inputs'
unpadded sizes: the work these inputs need, not the padded shapes the
program chooses.  A multiply-add counts 2; elementwise work counts where
it is a sizeable share (the STFT's window and power), not for gates.
"""

from __future__ import annotations

import math
from typing import Iterable, Mapping, Tuple


def log_mel(samples: int, fe: Mapping) -> float:
    """Framing, window, real FFT (2.5 N log2 N), power and the mel
    filterbank of one waveform."""
    n = fe["n_fft"]
    frames = 1 + samples // fe["hop_length"]
    bins = n // 2 + 1
    return frames * (n + 2.5 * n * math.log2(n) + 3 * bins
                     + 2 * bins * fe["n_mels"])


def netvlad(samples: int, fe: Mapping) -> float:
    """Soft assignment, residual aggregation and projection."""
    frames = 1 + samples // fe["hop_length"]
    d, k = fe["n_mels"], fe["netvlad_clusters"]
    return 4 * frames * d * k + 2 * d * k * fe["netvlad_output_dim"]


def wav2vlad(samples: int, fe: Mapping) -> float:
    return log_mel(samples, fe) + netvlad(samples, fe)


def char_cnn_token(cc: Mapping) -> float:
    """One token through the char-CNN, the highways and the projection."""
    d, c = cc["char_dim"], cc["max_chars"]
    n_filters = sum(ch for _, ch in cc["filters"])
    conv = sum(2 * (c - w + 1) * ch * d * w for w, ch in cc["filters"])
    highway = cc["n_highway"] * 2 * n_filters * 2 * n_filters
    proj = 2 * (n_filters + cc.get("word_dim", 0)) * cc["output_dim"]
    return conv + highway + proj


def bilm_token(lm: Mapping, input_dim: int) -> float:
    """One token through every direction and layer of the LSTMP biLM,
    input projections included."""
    c, p = lm["cell_size"], lm["proj_size"]
    total = 0.0
    for layer in range(lm["layers"]):
        in_dim = input_dim if layer == 0 else p
        total += 2 * (2 * in_dim * 4 * c + 2 * 5 * c * p)
    return total


def lstmp_fwd(tokens: int, lm: Mapping) -> Tuple[float, float]:
    """(operations, bytes) of one launch of the LSTMP forward over
    ``tokens`` real positions: the 4CP recurrent and CP projection
    products a step; the gate inputs read and the states written once,
    the weights read once."""
    c, p = lm["cell_size"], lm["proj_size"]
    flops = 2 * tokens * 5 * c * p
    nbytes = 4 * (tokens * (4 * c + p) + 5 * c * p + 4 * c)
    return flops, nbytes


def gru(steps: int, rows: int, in_dim: int, hidden: int,
        layers: int) -> float:
    total = 0.0
    for layer in range(layers):
        d = in_dim if layer == 0 else hidden
        total += steps * rows * 2 * 3 * hidden * (d + hidden)
    return total


def gru_launch(steps: int, rows: int, hidden: int) -> Tuple[float, float]:
    """(operations, bytes) of one GRU recurrence launch (the input
    projection is a product outside it): the 3H x H product a step; the
    gate inputs read, the states written and the weights read once."""
    g = 3 * hidden
    return (2 * steps * rows * hidden * g,
            4 * (steps * rows * g + hidden * g + g + steps * rows * hidden))


def gru_bwd_launch(steps: int, rows: int, hidden: int
                   ) -> Tuple[float, float]:
    """(operations, bytes) of one GRU backward launch: the three H x 3H
    products a step (the gates recomputed, the state carried, dW)."""
    g = 3 * hidden
    return (3 * 2 * steps * rows * hidden * g,
            4 * (2 * steps * rows * g + 2 * hidden * g + 2 * g
                 + 2 * steps * rows * hidden))


def lstm(steps: int, rows: int, in_dim: int, hidden: int, layers: int,
         directions: int) -> float:
    total = 0.0
    for layer in range(layers):
        d = in_dim if layer == 0 else directions * hidden
        total += directions * steps * rows * 2 * 4 * hidden * (d + hidden)
    return total


def audio_clf(rows: int, m: Mapping) -> float:
    """The audio classifier's forward over ``rows`` speakers of 3
    answers."""
    h = m["hidden_dims"]
    return gru(3, rows, m["embedding_size"], h, m["rnn_layers"]) \
        + rows * (2 * h * h + 2 * h * m["num_classes"])


def fuse_clf(rows: int, f: Mapping) -> float:
    """The clf fusion's forward over ``rows`` speakers: both branches,
    the attention and the head."""
    ht, ha = f["text_hidden_dims"], f["audio_hidden_dims"]
    text = lstm(3, rows, f["text_embed_size"], ht, f["rnn_layers"], 2)
    attention = rows * (2 * ht * ht + 3 * 2 * 3 * ht)
    audio = gru(3, rows, f["audio_embed_size"], ha, f["rnn_layers"])
    heads = rows * (2 * ht * ht + 2 * ha * ha
                    + 2 * (ht + ha) * f["num_classes"])
    return text + attention + audio + heads


def speakers_text(token_counts: Iterable[int], cc: Mapping,
                  lm: Mapping) -> float:
    """The text frontend over sentences of ``token_counts`` real tokens
    each (``<bos>`` and ``<eos>`` included)."""
    per_token = char_cnn_token(cc) + bilm_token(lm, cc["output_dim"])
    return per_token * sum(token_counts)

