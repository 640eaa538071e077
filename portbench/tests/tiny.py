"""Tiny configurations and mixes of the serving cells, for CPU tests:
every width cut, every path kept."""

from __future__ import annotations

import time

from portbench.harness.cell import Cell

FRONTEND = {"sample_rate": 16000, "n_fft": 256, "hop_length": 64,
            "n_mels": 8, "log_floor": 1e-6, "netvlad_clusters": 4,
            "netvlad_output_dim": 16, "silence_amplitude": 1e-4,
            "silence_seconds": 5, "netvlad_seed": 0}


def config(task: str) -> dict:
    if task == "audio_clf":
        return {"task": task, "frontend": FRONTEND, "model": {
            "num_classes": 2, "dropout": 0.5, "rnn_layers": 2,
            "embedding_size": 16, "hidden_dims": 8, "bidirectional": False,
            "cell": "gru", "input_layernorm": True, "pooling": "mean",
            "head_activation": "softmax", "init": "torch",
            "head_input_dropout": True, "rnn_backend": "auto"}}
    return {"task": task, "frontend": FRONTEND,
            "char_cnn": {"n_chars": 46, "char_dim": 4,
                         "filters": [[1, 4], [2, 4]], "n_highway": 1,
                         "output_dim": 8, "activation": "relu",
                         "word_dim": 3, "max_chars": 6},
            "bilm": {"cell_size": 16, "proj_size": 8, "layers": 2,
                     "cell_clip": 3.0, "proj_clip": 3.0},
            "word_vocab": 30,
            "fusion": {"audio_embed_size": 16, "text_embed_size": 16,
                       "audio_hidden_dims": 8, "text_hidden_dims": 4,
                       "rnn_layers": 2, "dropout": 0.3, "num_classes": 2,
                       "train_all_params": False, "modal_attention": False,
                       "audio_layernorm": True, "head_activation": "softmax",
                       "rnn_backend": "auto"},
            "segmenter": "fallback"}


def mix(family: str) -> dict:
    return {"driver": "closed_loop", "family": family, "sample_rate": 16000,
            "answer_seconds": [0.1, 0.3], "amplitude": 3000,
            "transcript_chars": [3, 9],
            "speakers_per_call": 1 if family == "interactive" else 4,
            "pool": 8, "trace_calls": 2, "check_speakers": 16,
            "collector_paused": family == "interactive"}


def cell(task: str, family: str, limits: dict, seed: int = 2**31 + 5,
         seconds: float = 0.3, control: bool = False) -> Cell:
    return Cell(name=f"tiny.{task}.{family}", config=config(task),
                traffic=mix(family),
                workload={"chips": 1, "limits": limits}, seed=seed,
                seconds=seconds, trace=False, device="cpu",
                control=control, started=time.perf_counter())


def train_config(lr: float = 1e-2) -> dict:
    cfg = config("audio_clf")
    cfg["recipe"] = {
        "batch_size": 8, "epochs": 4, "loss": "ce",
        "track": "classification",
        "optimizer": {"name": "adamw", "learning_rate": lr,
                      "weight_decay": 1e-5, "b1": 0.9, "b2": 0.999,
                      "eps": 1e-8},
        "gate": {"f1_floor": 0.5, "train_acc_frac": 0.9}}
    return cfg


def train_cell(limits: dict, seed: int = 2**31 + 21, control: bool = False,
               lr: float = 1e-2) -> Cell:
    mix = {"driver": "tracks", "family": "train", "speakers": 24,
           "depressed": 6, "folds": 3, "warm_epochs": 2, "trace_after": 1,
           "trace_epochs": 2}
    return Cell(name="tiny.audio_clf.train", config=train_config(lr),
                traffic=mix, workload={"chips": 1, "limits": limits},
                seed=seed, seconds=0.1, trace=False, device="cpu",
                control=control, started=time.perf_counter())
