"""The operation and byte counters against hand counts at small shapes."""

import math

import pytest

from portbench.counts import flops as F
from portbench.counts.peaks import bound_s


def test_log_mel_and_netvlad():
    fe = {"n_fft": 8, "hop_length": 4, "n_mels": 2, "netvlad_clusters": 3,
          "netvlad_output_dim": 5}
    # 10 samples: 1 + 10 // 4 = 3 frames of 8 points, 5 bins
    per_frame = 8 + 2.5 * 8 * 3 + 3 * 5 + 2 * 5 * 2
    assert F.log_mel(10, fe) == 3 * per_frame
    assert F.netvlad(10, fe) == 4 * 3 * 2 * 3 + 2 * 2 * 3 * 5
    assert F.wav2vlad(10, fe) == F.log_mel(10, fe) + F.netvlad(10, fe)


def test_char_cnn_token():
    cc = {"char_dim": 2, "max_chars": 4, "filters": [[1, 3], [2, 1]],
          "n_highway": 1, "word_dim": 5, "output_dim": 6}
    conv = 2 * 4 * 3 * 2 * 1 + 2 * 3 * 1 * 2 * 2
    highway = 2 * 4 * 8
    proj = 2 * (4 + 5) * 6
    assert F.char_cnn_token(cc) == conv + highway + proj


def test_bilm_and_lstmp_launch():
    lm = {"cell_size": 3, "proj_size": 2, "layers": 2}
    layer0 = 2 * (2 * 5 * 12 + 2 * 5 * 3 * 2)
    layer1 = 2 * (2 * 2 * 12 + 2 * 5 * 3 * 2)
    assert F.bilm_token(lm, 5) == layer0 + layer1
    flops, nbytes = F.lstmp_fwd(7, lm)
    assert flops == 2 * 7 * 5 * 3 * 2
    assert nbytes == 4 * (7 * (12 + 2) + 30 + 12)


def test_recurrences_and_models():
    assert F.gru(3, 2, 4, 5, 1) == 3 * 2 * 2 * 15 * 9
    assert F.gru(3, 2, 4, 5, 2) == 3 * 2 * 2 * 15 * 9 + 3 * 2 * 2 * 15 * 10
    assert F.lstm(3, 1, 4, 2, 2, 2) == (2 * 3 * 2 * 8 * 6
                                         + 2 * 3 * 2 * 8 * 6)
    m = {"hidden_dims": 5, "embedding_size": 4, "rnn_layers": 1,
         "num_classes": 2}
    assert F.audio_clf(2, m) == F.gru(3, 2, 4, 5, 1) + 2 * (50 + 20)
    flops, nbytes = F.gru_launch(3, 2, 4)
    assert flops == 2 * 3 * 2 * 4 * 12
    assert nbytes == 4 * (3 * 2 * 12 + 48 + 12 + 3 * 2 * 4)
    assert F.gru_bwd_launch(3, 2, 4)[0] == 3 * flops


def test_bound_takes_the_larger():
    assert bound_s(67e12, 0) == pytest.approx(1.0)
    assert bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert bound_s(67e9, 3.35e12) == pytest.approx(1.0)
    assert math.isclose(bound_s(134e12, 3.35e12), 2.0)
