#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``icassp2022_depression_tpu_torch``)
on one NVIDIA GPU: serving of the audio, text and fusion models, the text
frontend (the ELMo char-CNN and LSTMP biLM at the zhs geometry), the
training paths of both tracks, checking and migration (``cli
extract-audio``, ``check``, ``export-pt``, reference ``.pt`` checkpoints),
DAIC-WOZ (``cli extract-daic`` / ``train-daic`` / ``check-daic`` /
``predict-daic``), the HTTP serving front, VGGish (``extract-audio
--embedder vggish``, ``train --audio-dim 128``, ``predict
--audio-embedder vggish``), cross-corpus evaluation and the stateful ELMo
mode (``extract-text --elmo-stateful``), and multi-GPU (``parallel/``:
fold-parallel and fold x data-parallel training, the explicit
data-parallel step, the clf fusion's DP x TP step, the tensor-parallel
biLM) on one card, at full width.

    python3 chip_smoke.py               # everything, ends with the ok line
    python3 chip_smoke.py --only lstmp  # the LSTMP kernels alone, no ok line
    python3 chip_smoke.py --only lstm   # the LSTM kernels alone, no ok line
    python3 chip_smoke.py --only gru    # the GRU kernels alone, no ok line
    python3 chip_smoke.py --only trainer  # fold axis, graph, resume
    python3 chip_smoke.py --only daic   # phase 9 alone, no ok line
    python3 chip_smoke.py --only serve  # phase 10 alone, no ok line
    python3 chip_smoke.py --only vggish  # phase 11 alone, no ok line
    python3 chip_smoke.py --only parallel  # phase 12 alone, no ok line
    python3 chip_smoke.py --only operations  # phase 13 alone, no ok line
    python3 chip_smoke.py --only threefry  # phase 14 alone, no ok line
    python3 chip_smoke.py --only moe_experts  # phase 15 alone, no ok line

``--only lstmp`` builds the two LSTMP sources, runs phase 2's LSTMP checks
and timings (the backward in turns with its plain loop and cuDNN), the
LSTMP profiles (one forward and one backward call at (16, 8) and (128,
24)) and the LSTMP yardsticks, prints their lines and stops: the quick
loop for work on those kernels.  ``--only lstm`` does the same for the
two LSTM sources: phase 2's LSTM checks and timings at the text model's
H = 128 and at the stand-in encoder's H = 512, the profiles of the
forward and of the backward at (256, 16, 128), and the cuDNN yardsticks.
``--only gru`` does the same for the two GRU sources: the forward's and
the backward's checks and timings, the forward's profiles at (3, 8, 256),
(3, 100, 256) and (3, 200, 256) (the kernel alone, and one round of the
timing turns), the backward's at (3, 8, 256) and (256, 16, 256), and the
cuDNN yardsticks.
``--only trainer`` builds the GRU and LSTM sources and runs the fold-axis
kernel checks and the fold-program checks of phases 2 and 5 on random
features (about a minute).  ``--only daic`` builds the GRU sources and
the LSTMP forward and runs phase 9 with a seeded bundle of its own;
``--only serve`` builds the GRU and LSTM forwards and runs phase 10 with a
seeded DAIC checkpoint.  ``--only vggish`` builds the GRU sources and the
LSTMP forward and runs phase 11 on a corpus, a seeded bundle and DAIC
features of its own.  ``--only parallel`` builds the GRU and LSTM sources
and the LSTMP forward and runs phase 12 on a corpus and a seeded bundle
of its own.  ``--only operations`` builds the eight sources and runs phase
13 on a corpus and a seeded bundle of its own.  ``--only threefry`` builds
the threefry source and runs phase 14 (about half a minute).  ``--only
moe_experts`` builds the grouped-expert and threefry sources and the GRU
and LSTM forwards, runs phase 15 (about a minute and a half) and prints
the kernels line with its one entry.

Phases (each raises on failure, so the exit code is nonzero):

1. setup: require CUDA, print the card's name and power limit, turn TF32
   off, build the eight sources of ``icassp2022_depression_tpu_torch/csrc``
   (GRU, LSTM and LSTMP, forward and backward, threefry and the grouped
   experts) with
   ``nvcc``, one compiler process per source, started together, and print
   the build time and the compiler's reports;
2. kernels: each CUDA kernel against its plain PyTorch version at the
   shapes of the paths below, a ragged shape and one the JAX package would
   stream ((256, 16, H)): outputs and dxp within 1e-5, dw and db within
   1e-5 of their largest magnitude, reruns bitwise equal, the LSTM
   backward with a nonzero cell-state cotangent; the LSTMP kernels at
   (T, B, C, P) = (32, 128, 4096, 512), (16, 8, 4096, 512),
   (48, 104, 4096, 512) and (7, 3, 384, 128) with both +-3 clips engaged
   and at (128, 24, 4096, 512) and (128, 8, 4096, 512) with the weights at
   ``init_lstmp``'s bounds (eight and one served speakers' long
   transcripts), the forward through both its routes wherever the plan
   takes the resident one (at most 32 rows; the two routes and the plain
   loop timed in turns at (16, 8), (128, 24) and (128, 8)), the backward
   (the gate recompute, then one step launch and one fixed-order
   reduction a step)
   fed the plain forward's residuals, every output within 1e-5 of its
   largest magnitude, and the backward, its plain loop and cuDNN timed in
   turns at the timed shapes;
   beside each, a reading of how far the plain float32 loop and
   the kernel are from the plain loop in float64, and the same reading at
   a recurrent gain of 3/sqrt(P), where float32 itself parts from float64
   (not checked); the GRU forward and the LSTM forward (one launch a
   step) at every GRU shape (the kernel, plain loop and cuDNN ``nn.GRU``
   in turns at the timed shapes), at every LSTM shape and at the stand-in
   text encoder's H = 512 ((T, B) = (16, 8), (128, 24), (16, 112),
   (128, 488)), and the GRU and LSTM backwards (one launch a step between
   a gate recompute and a weight product) at every GRU and LSTM shape,
   within 1e-5, reruns bitwise equal, the backward, plain loop and cuDNN
   timed in turns at each timed shape with its bound; timed with CUDA
   events, beside the nearest PyTorch call (cuDNN ``nn.GRU`` /
   ``nn.LSTM`` / ``nn.LSTM(proj_size=512)``, both directions, and
   ``nn.LSTM(512, 512)`` at every stand-in shape); the forward wrappers
   must refuse a CUDA input that requires grad; one GRU forward call at
   (3, 8, 256), (3, 100, 256) and (3, 200, 256) and one round of its
   timing turns, one
   LSTMP forward and one backward call at (16, 8) and at
   (128, 24), one LSTM forward call at the stand-in's
   (16, 8) and (128, 488), one GRU backward call at (3, 8, 256) and
   (256, 16, 256) and one LSTM backward call at (256, 16, 128), under
   ``torch.profiler``, device time split by
   kernel name and the gaps between launches; the LSTMP forward and the
   stand-in's LSTM forward beside the plain loop, cuDNN and the bound at
   each timed shape; the four kernels with a fold axis (GRU and LSTM,
   forward and backward, F = 3 folds in one launch) at the recipes'
   (F, T, B, H) = (3, 3, 8, 256), (3, 3, 2, 256), (3, 3, 4, 128) and
   (3, 3, 2, 128): against the plain loops (1e-5; dw, db of their largest
   magnitude), against F single-fold launches (bitwise) and their reruns
   (bitwise), then the fold launch, F single-fold launches, the plain
   loops and F cuDNN calls in turns beside the F folds' bound; and the
   autograd Functions ``GRUSequence`` / ``LSTMSequence`` with a fold axis
   at (3, 3, 8, 256) and (3, 3, 4, 128), one kernel launch forward and one
   backward, and at H = 254 and 126, which the kernels' 16-byte copies
   cannot take, a ``ValueError`` and no launch at all;
3. audio serving: a synthetic EATD corpus, a full-width ``audio_clf`` with
   seeded random weights saved as a JAX-layout npz, ``cli predict`` for
   one speaker and ``Predictor.predict_batch`` for 1, 3 and 8 speakers,
   the GRU forward kernel launched twice per forward; outputs equal (1e-5)
   to the plain recurrence's and, for ``cli predict``, to the CPU's;
4. a seeded converted-ELMo bundle at the zhs geometry (6784 chars, char-CNN
   to 512, biLM C = 4096, P = 512, 2 layers), drawn on the card with the
   port's threefry and written with the port's ``save_npz``;
5. text and training: a synthetic corpus of 24 + 12 speakers; counted,
   each with every kernel counter zeroed just before and read just after:
   ``cli extract-text`` with the bundle (``--segmenter fallback``; exactly
   4 LSTMP forward launches per sentence batch), whose npz features feed
   ``cli pipeline --track clf`` at the full recipes (audio_clf 170,
   text_clf 150, fuse_clf 100 epochs, 3 folds each), ``cli train --task
   audio_clf --corpus`` and ``cli pipeline --track reg --corpus`` (both
   modalities extracted on the card; folds cut to the corpus) at 20
   epochs with the gates open, so that every fold saves and every text
   and fusion sidecar is checked to name the bundle.  Per stage the
   launches must be exact (audio: 2 GRU forwards
   per step and eval, 2 GRU backwards per step; text: 4 LSTM forwards per
   step and eval, 4 LSTM backwards per step; fusion: 4 LSTM and 2 GRU
   forwards per step and per fold, and no backward kernel at all), the
   metrics finite and every gated fold's artifacts written, naming the
   bundle.  Not counted: the extracted features of 3 speakers against the
   same bundle on the CPU (1e-5 of the largest magnitude); 5-epoch
   ``audio_clf``, ``audio_reg``, ``text_clf`` and ``fuse_clf`` folds
   through the kernels against the plain recurrence on the card with the
   same dropout masks, and ``audio_clf`` and ``text_clf`` folds with
   dropout on (the same threefry masks) on the card against the CPU
   (per-step losses within 1e-5, relative to the largest loss for the L1
   loss on SDS scores; final params within 1e-5 of the largest |param|);
   every fold runs as one CUDA graph an epoch (a
   warm-up epoch per fold, counted in the launches above): 5-epoch
   ``audio_clf``, ``text_clf`` and ``fuse_clf`` folds through the graph
   against the eager route (losses and params bitwise), one replayed
   epoch under ``torch.profiler`` (its kernels by name against the launch
   counters and the captured calls; profiled again, up to three times,
   where the trace comes back short of a counted kernel), an epoch's time through the graph
   and eagerly, a 15-epoch fold with ``--chunk-epochs 7`` killed after
   its first chunk and resumed from its bundle against the single-shot
   run (bitwise), the three ``audio_clf`` folds stacked
   (``vmap_folds``) against serial (1e-5), and ``cli pipeline --track
   clf`` / ``--track reg`` again with ``--vmap-folds`` (stage times; the
   reg run's per-epoch logs against the serial run's within 1e-4);
6. checking and migration on phase 5's corpus and checkpoints: counted,
   ``cli extract-audio`` (no kernel; its clf features bitwise
   ``extract_eatd_device``'s, 3 speakers the CPU's within 1e-5, and an
   incremental rerun marks every speaker cached and writes the same npz
   files), ``cli check --corpus`` on the gated checkpoints of ``cli train
   --task audio_clf --corpus`` and of the reg pipeline (``audio_reg``,
   ``text_reg``, ``fuse_reg``), each fold's metrics its trainer's recorded
   ones (F1, precision and recall within 1e-6, MAE within 1e-5 of the
   largest target) with exact launches (2 ``gru_fwd`` a fold for audio, 4
   ``lstm_fwd`` for text, both for the fusion, 4 ``lstmp_fwd`` a batch of
   128 answers, no backward); not counted, the same checks on the CPU
   (the same metrics, predictions within 1e-5 of max(1, their largest
   magnitude)); counted, ``cli export-pt`` of fold 1's ``audio_clf`` and
   ``fuse_reg`` checkpoints, whole-module pickles of reference-layout
   modules defined in this script in torch's zipfile and legacy formats,
   and ``cli check`` and ``cli predict`` on each, equal to the npz's
   (1e-5); at EATD's size (a synthetic corpus of 83 + 79 speakers), the
   wall time of ``cli extract-audio`` and of ``cli check --task fuse_clf
   --corpus`` with the seeded bundle and seeded full-width checkpoints,
   and, not counted, the device time of each fold's forward at its test
   split's rows (``torch.profiler``);
7. text serving: full-width seeded ``fuse_clf`` and ``text_clf``
   checkpoints whose sidecars name the bundle (``ICASSP_ELMO_WEIGHTS``
   points at it): counted ``cli predict`` for one speaker (equal to the
   CPU's within 1e-5) and ``Predictor.predict_batch`` (``fuse_clf``) at 1
   and 8 speakers with transcripts of 20-120 CJK characters from a seeded
   vocabulary, exact launches per request, no LSTMP backward on any main
   path; not counted: the 8 speakers' results and text features against
   the same predictor on the CPU (1e-5); then ``text_clf`` and
   ``fuse_clf`` through the seeded stand-in encoder (``elmo_weights=None``,
   the path without a bundle) at 1 and 8 speakers, counted: 8
   ``lstm_fwd`` per request (the stand-in's 4 and the text model's 4);
   not counted: the 8 speakers' ``text_clf`` results and text features
   against the CPU (1e-5);
8. timing: warm ``predict_batch`` latency (audio at 1 and 8 speakers,
   fusion at 1 and 8, and the stand-in's ``text_clf`` and ``fuse_clf`` at
   1 and 8); the wall time of extraction and of each pipeline
   stage; an ``audio_clf`` and a ``text_clf`` train step split into
   forward, backward and optimizer; each kernel's bound (the larger of its
   float32 operations over 67 TFLOP/s and its bytes over 3.35 TB/s).

9. DAIC-WOZ: a DAIC-shaped corpus from a seed (AVEC2017's train / dev
   layout cut from 107 + 35 participants to 32 + 16, 40-120 responses of
   1-3 s each, Ellie's lines from the bundled question bank, the cuts on a
   ``reduced`` line); counted, each CLI call with exact launches: ``cli
   extract-daic`` of both splits (no kernel) and ``--multimodal`` of the
   dev split through the seeded bundle (4 ``lstmp_fwd`` a batch of 128
   responses), ``cli train-daic --track clf`` and ``--track reg`` from
   those features and ``--track clf --daic-dir`` (fused; its best equal to
   the two-step run's) at the presets' widths (D = H = 256, batch 16) and
   21 epochs with the gates open (2 ``gru_fwd`` a step and an eval, 2
   backwards a step, under ``gru_bwd_streamed`` where the JAX package
   streams the batch: ``rnn_cuda.streamed``), ``cli check-daic`` on each
   checkpoint (2 ``gru_fwd``; F1 within 1e-6, MAE within 1e-5 of the
   trainer's recorded best, through ``check_daic``), ``cli predict-daic``
   of a dev participant at its cumulative ordinal (the CPU's within 1e-5,
   and the prediction from its extract-daic features); not counted, the
   GRU forward at (R_max, 16, 256) and at one served participant, the
   backward (#3) at (R_max, 16, 256) against its plain loop (dxp 1e-5,
   dw / db 1e-5 of their largest magnitude, reruns bitwise) and timed in
   turns with the plain loop and cuDNN beside its bound, and a train
   step's time under the graph;
10. the HTTP serving front (``serving/transport.py``): ``make_http_server``
   on port 0 in a thread, on the card, for ``audio_clf``, stand-in
   ``fuse_clf`` and phase 9's ``daic_clf``, with a 5 ms batch window, max
   batch 32, max queue 64 and a bearer token; counted, 16 concurrent
   clients x 4 requests over /predict, /predict_bin and /predict_stream
   (DAIC: /predict), exact launches per device batch, every answer within
   1e-5 of a direct ``predict_batch`` / ``predict_signals`` of another
   predictor on the same speakers; a wrong token is a 401, overload a 503
   with Retry-After, and HTTPS with a self-signed certificate where
   ``openssl`` is present; the requests/s, the device batches run and
   ``/healthz``'s latency quantiles.
11. VGGish, cross-corpus evaluation and the stateful ELMo mode, on phase
   5's corpus and bundle and phase 9's DAIC features: the VGGish stand-in
   (seed 0, 72.1 M floats) drawn on the card bitwise the CPU's draw; a
   256-example chunk of real examples through the network on the card
   within 1e-5 of the CPU's with ``cudnn.allow_tf32`` at PyTorch's default
   (the module turns it off around its convolutions), its device time
   beside its bound; counted at EATD's size (83 + 79 speakers), ``cli
   extract-audio --embedder vggish`` in turns with the wav2vlad one (no
   kernel; 3 speakers the CPU's within 1e-5), ``cli train --task
   audio_clf --audio-dim 128`` at 3 epochs a fold with the gate open
   (exact ``gru_fwd`` / ``gru_bwd`` launches; ``--vmap-folds`` against it,
   not counted), ``cli predict --audio-embedder vggish`` (2 ``gru_fwd``;
   the CPU's within 1e-5); ``cli extract-text --elmo-stateful`` in turns
   with the stateless one (no kernel launch: a plain step loop; the first
   speaker the stateless features within 1e-5, later ones not; two
   carried calls on the CPU within 1e-5); ``eval.cross_corpus``
   ``evaluate_clf`` (dev split) and ``evaluate_reg`` (both splits) with
   seeded full-width EATD models, each one padded batch through 2
   ``gru_fwd`` launches (counted), against the CPU; ``gru_fwd`` at (3,
   1024, 256) against its plain loop, timed in turns with it and cuDNN.
12. multi-GPU on one card (``parallel/``; NCCL takes one rank a card, so
   several ranks share cuda:0 over Gloo), on phase 5's corpus and bundle,
   training on its leading speakers whose padded test split is even (the
   layout of 2-way data parallelism asserts it), the recipes' widths, 20
   epochs: (a) NCCL at world size 1: each collective the port uses on
   CUDA tensors, and a 5-epoch ``audio_clf`` fold with a one-rank NCCL
   data group, its all-reduces captured in the epoch's CUDA graph,
   bitwise the fold without a group (counted); (b) ``train_audio_clf`` /
   ``train_text_clf(fold_parallel=True)`` on 3 Gloo ranks on cuda:0 (one
   fold a rank), every fold's logs and step losses within 1e-5 of their
   largest magnitude of the single-process ``vmap_folds`` run's (a rank's
   one-fold products may take another cuBLAS algorithm than the 3-fold
   batched ones; whether they are bitwise is printed), the same gated
   epochs, each rank's launches exactly the stacked run's; (c) 3 folds x 2 data-parallel
   ranks, eager on Gloo: logs within 1e-5 of their largest magnitude of
   ``vmap_folds``, the same gated epochs, each rank's launches exact;
   then on the same 6 ranks the clf fusion's DP x TP step
   (``dp_tp_train_step``, mesh (data 3, model 2), the GRU and BiLSTM gate
   rows split over ``model``) at full ``FUSE_CLF`` width, batch 12 x 3,
   against the one-process step on cuda:0 (kernels #1 and #4, 2 + 4
   launches, counted): ``tf``, ``af``, the loss and ``fc_final``'s
   gradient and update within 1e-5 of their largest magnitude, the frozen
   parameters bitwise, no kernel launch on a rank;
   (d) on 2 Gloo ranks, the collectives on CUDA tensors and
   ``dp_train_step`` at the audio model's width against the one-process
   step with the same per-rank keys (loss 1e-5, params' L1 1e-4); (e) on
   the same 2 ranks ``extract_eatd(elmo_tp=2)`` with the zhs-geometry
   bundle: pooled features within 1e-5 of their largest magnitude of the
   serial path's (TPU kernel #6, counted), ``extraction_meta.json``
   naming ``elmo_tp: 2``, no LSTMP kernel on a rank; (f) ``cli train
   --fold-parallel`` on a host with fewer than 3 cards exits with the
   JAX CLI's "need >= 3 devices" message.  Each stage's wall time is
   printed as a shared-card smoke reading, not a scaling figure.
13. operations, on phase 5's corpus and bundle: (a) ``cli doctor``, its
   ``card`` and ``link`` readings printed with the card's name and power
   limit; (b) ``cli warmup --tracks clf --vmap-folds`` (24 + 12
   speakers, the bundle) with ``ICASSP_TPU_TORCH_BUILD_DIR`` an empty
   temp dir: it builds the 7 sources and reuses none, then a second run
   (``--skip-train``) builds none and reuses 7; the cold and warm
   ``kernel_builds`` seconds; each run's launches exact (counted); (c) a
   released-layout zhs model directory at the zhs geometry written from a
   seed (upstream key names and lexicons, the word branch) through the
   port's ``convert_elmo_zhs``: every bundle array bitwise the pickles'
   mapping, ``--check``'s norms on the card within 1e-5 of the CPU's
   (counted: its 4 ``lstmp_fwd``), then ``text_clf`` served from the
   bundle through ``Predictor`` (counted, against the CPU within 1e-5);
   (d) a ``profiling.trace`` of ``extract_eatd`` and of a one-fold ``cli
   train --task audio_clf --corpus`` (counted): the Chrome trace holds
   ``wav2vlad/bucket*``, ``wav2vlad/readback`` and ``audio_clf/fold1``,
   and the GRU kernels launched inside the fold's region; (e) a recorded
   region around a 4096 x 4096 matmul and ``torch.cuda.synchronize()``
   under ``torch.profiler`` holds the matmul's kernel and its own
   profiler region (offsets printed; profiled up to three times, since a
   short trace now and then comes back with no device events), and a
   region's host cost with the profiler off and on.
14. threefry, first in a whole run: the threefry kernel
   (``csrc/threefry.cu``) against the plain route (``ops/prng.py``'s
   ``*_torch``, run on the card) bitwise at the main paths' shapes
   (``fold_in`` of 8 and 96 ordinals, ``split(4)`` and ``split2`` of [3,
   2] keys, one wav2vlad bucket's NetVLAD weights at 1, 2, 4, 8 and 32
   rows (its row tiles), the
   audio train step's dropout masks at [3, 8, 256] and with ``rows``, bits
   with ``rows``, a uniform over more than ``_BITS_CHUNK`` values with a
   span that is not a power of two), each with its exact launches (one a
   draw, including the ``threefry`` counter, none on the plain route),
   then each timed with CUDA events beside the plain route and its bound
   (52 INT32-pipe instructions a cipher evaluation, from the kernel's
   SASS, over 132 x 64 x 1.98 GHz, or
   the bytes written over 3.35 TB/s), and the kernel's device time where
   a draw is large enough to show it (``torch.profiler``).
15. moe_experts, last in a whole run (its 62.5 GB drawn after every other
   phase has freed its memory): Moonlight-16B-A3B at its
   published widths (15.62 B float32 parameters, drawn on the card as the
   benchmark draws them, ``portbench/harness/lm_weights.py``) as the text
   embedder of a ``fuse_clf`` ``Predictor``, which serves a cohort call of
   32 speakers (3 answers of 2-12 s and 3 transcripts of 20-120 CJK
   characters drawn by a Zipf law each) twice: the second call's launches
   held exactly, 2 ``moe.LAUNCHES`` an expert layer (52), the GRU and LSTM
   forwards' and the draws' as every fusion ``predict_batch``; the first
   and last expert layers' routed slots of that call (from ``route`` and
   ``dispatch``: about 40,800 rows over 64 experts, H 2048, I 1408) then
   put through the kernel (``csrc/moe_experts.cu``) again, bitwise its
   output in the call, and through the plain route (``experts_torch``),
   within 1e-5 of its largest output, and each timed with CUDA events:
   the kernel's two launches, the plain route (its host read of the
   offsets included) and the cuBLAS products alone a used expert (the
   offsets read beforehand, the library yardstick), against the bound of
   ``portbench/counts/moe_lm.py``.

Phases 2-13 zero the ``threefry`` counter with the others before each
counted run and read it after, as a main path's draws: exact in each
``predict_batch`` (6 a wav2vlad bucket: a ``fold_in``, a ``split`` and four
``normal`` of NetVLAD weights, none for text) and in a replayed epoch
(the captured draws; the profiler's count of their kernels is printed
beside them), counted and not held where a run draws keys, weights and masks that no phase works
out (model set-up, training, extraction).  The kernels line's
``launches`` of ``threefry`` are the main paths' sum, as for the other
kernels: phase 14's own calls and the comparisons are not in it.

The line before the last is a JSON object describing each kernel (#3's
timed at its DAIC shape; threefry's at a one-row bucket's NetVLAD
weights; #6's forward twice, on the step route at (32, 128, 4096, 512)
and as ``lstmp_fwd_resident`` on the resident route at (128, 8, 4096,
512), one served speaker's rows); the last line is ``{"ok": true,
"device": {...}}``.  Nothing of JAX is imported.
"""

from __future__ import annotations

import contextlib
import io
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
KERNEL_TOL = 1e-5
SLICE_TOL = 1e-5
#: the GRU forward at the audio model's H = 256: serving (1, 3 and 8
#: speakers' rows; 22 and more speakers give 66 and more rows), training
#: (batches 8 and 2), an eval split, one the JAX package would stream, and
#: a ragged shape
KERNEL_SHAPES = ((3, 1, 256), (3, 4, 256), (3, 8, 256), (3, 24, 256),
                 (3, 100, 256), (3, 200, 256), (3, 2, 256), (256, 16, 256),
                 (7, 3, 200))
TIMED_SHAPES = ((3, 8, 256), (3, 24, 256), (3, 100, 256), (3, 200, 256))
#: the GRU forward calls profiled (the audio_clf training shape, and two
#: batches above 64 rows)
GRU_FWD_PROFILED = ((3, 8, 256), (3, 100, 256), (3, 200, 256))
BATCHES = (1, 3, 8)
#: the training shapes (audio_clf batch 8, audio_reg batch 2, eval of a
#: 24-row test split, a fold x DP rank's 4 rows of audio_clf's 8), a ragged
#: one, and one the JAX package would stream (its backward working set,
#: ~35 MB, exceeds `_pallas_fits`' 12 MB)
BWD_SHAPES = ((3, 8, 256), (3, 2, 256), (3, 24, 256), (3, 4, 256),
              (7, 3, 200), (256, 16, 256))
BWD_TIMED = ((3, 8, 256), (3, 2, 256), (256, 16, 256))
#: the LSTM at the text model's H = 128: the training batches (text_clf 4,
#: text_reg and fuse_clf 2), an eval split, a ragged shape, and one the JAX
#: package would stream
LSTM_SHAPES = ((3, 4, 128), (3, 2, 128), (3, 24, 128), (7, 3, 100),
               (256, 16, 128))
LSTM_TIMED = ((3, 4, 128), (3, 2, 128), (256, 16, 128))
#: the LSTMP cell (T, B, C, P, weights) at the zhs geometry.  "clips":
#: weights scaled so that both +-3 clips engage, at the extraction batch,
#: one served speaker, a ragged large batch, and a small ragged shape;
#: "init": the bounds ``init_lstmp`` draws from (the seeded bundle's), at
#: the rows and steps of eight served speakers' long transcripts (24
#: sentences of up to 122 tokens) and of one speaker's (8 rows padded)
LSTMP_SHAPES = ((32, 128, 4096, 512, "clips"), (16, 8, 4096, 512, "clips"),
                (48, 104, 4096, 512, "clips"), (7, 3, 384, 128, "clips"),
                (128, 24, 4096, 512, "init"), (128, 8, 4096, 512, "init"))
#: the timed shapes; at the three of at most 32 rows the forward's two
#: routes (resident and step) are timed in turns with the plain loop
LSTMP_TIMED = ((32, 128, 4096, 512), (16, 8, 4096, 512),
               (128, 24, 4096, 512), (128, 8, 4096, 512))
#: the served shapes whose LSTMP forward is profiled: one call's device
#: time split by kernel name, and the gaps between its launches
LSTMP_PROFILED = ((16, 8, 4096, 512), (128, 24, 4096, 512))
#: a reading, not a check: the "clips" weights with a recurrent gain of
#: 3/sqrt(P), where the float32 recurrence itself parts from float64
LSTMP_GAIN3 = (32, 128, 4096, 512, "gain3")
#: the stand-in text encoder's LSTM (H = 512), the text path of every run
#: without an ELMo bundle: one served speaker, eight served speakers' long
#: transcripts, the extraction batch of this script's corpus, and EATD's
#: 486 answers in one 512-sentence chunk
STANDIN_LSTM_SHAPES = ((16, 8, 512), (128, 24, 512), (16, 112, 512),
                       (128, 488, 512))
#: the stand-in shapes whose LSTM forward is profiled
STANDIN_PROFILED = ((16, 8, 512), (128, 488, 512))
#: the backward calls profiled: the GRU at the audio_clf training shape and
#: at one the JAX package would stream, the LSTM at the streamed shape
GRU_BWD_PROFILED = ((3, 8, 256), (256, 16, 256))
LSTM_BWD_PROFILED = ((256, 16, 128),)
#: the data sheet's peaks of one H100 SXM at 700 W (fp32 without tensor
#: cores, HBM3), for each kernel's bound
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
#: the INT32 pipe's instructions a second (132 SMs x 64 lanes x 1.98 GHz)
#: and a threefry2x32 evaluation's instructions on it, read off the built
#: kernel's SASS (``cuobjdump -sass``, CUDA 12.8): ``threefry_kernel``'s
#: uniform body, 4 evaluations a thread, holds 85 LOP3, 80 SHF.L.W and 42
#: IADD3 (51.75 an evaluation; the bits' body 52.5, the masks' 52.9), and
#: 69 IMAD.IADD that nvcc puts on the FMA pipe, which is not the one that
#: binds; the kernel's bound
PEAK_INT32_OPS = 132 * 64 * 1.98e9
THREEFRY_OPS = 52
TRAIN_TOL = 1e-5
COMPARE_EPOCHS = 5
#: epochs of the runs cut to keep the script short (cli train --corpus and
#: the reg pipeline); the clf pipeline runs the full recipes
REDUCED_EPOCHS = 20
#: stacked folds against serial folds: the same arithmetic, but the
#: batched products add in another order
VMAP_TOL = 1e-4


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, reps: int, torch) -> float:
    """Median device time of ``fn()`` in ms over ``reps`` single calls."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def cudnn_gru_fwd(torch, t: int, b: int, h: int):
    """A call of cuDNN's ``nn.GRU(h, h)`` forward at (T, B, H), input
    projection included (a yardstick used nowhere in the port)."""
    mod = torch.nn.GRU(h, h).cuda()
    x = torch.randn((t, b, h), device="cuda")

    def fn():
        with torch.no_grad():
            mod(x)
    return fn


def kernel_phase(torch, rnn_cuda, card: str):
    """The GRU forward kernel against its plain version at every
    ``KERNEL_SHAPES`` entry (within KERNEL_TOL, a rerun bitwise equal);
    then, at each ``TIMED_SHAPES`` entry, the calls of
    :func:`_gru_turn_fns` timed in turns.  Returns the worst error and the
    (kernel, plain) ms at the timed shapes."""
    worst = 0.0
    gen = torch.Generator().manual_seed(0)
    inputs = {}
    for t, b, h in KERNEL_SHAPES:
        bound = h ** -0.5
        xp = torch.randn((t, b, 3 * h), generator=gen).cuda()
        w = ((torch.rand((h, 3 * h), generator=gen) * 2 - 1) * bound).cuda()
        bias = ((torch.rand((1, 3 * h), generator=gen) * 2 - 1)
                * bound).cuda()
        ref = rnn_cuda.gru_sequence_torch(xp, w, bias)
        ys = rnn_cuda.gru_sequence(xp, w, bias)
        again = rnn_cuda.gru_sequence(xp, w, bias)
        torch.cuda.synchronize()
        if ys.shape != (t, b, h) or not torch.isfinite(ys).all():
            fail(f"gru_fwd output at {(t, b, h)} is malformed")
        err = (ys - ref).abs().max().item()
        same = torch.equal(ys, again)
        if not (err <= KERNEL_TOL and same):
            fail(f"GRU kernel disagrees with its plain version at "
                 f"{(t, b, h)}: {err}, rerun bitwise equal {same}")
        print(f"kernel gru_fwd T={t} B={b} H={h}: max|cuda - plain| "
              f"{err:.3e} (rerun bitwise equal {same}) (tol {KERNEL_TOL}; "
              f"the plan {rnn_cuda.gru_fwd_plan(b, h)})")
        worst = max(worst, err)
        inputs[(t, b, h)] = (xp, w, bias)
    timings = {}
    for shape in TIMED_SHAPES:
        ms = turns_ms(torch, _gru_turn_fns(torch, rnn_cuda, inputs[shape],
                                           shape), 50)
        b_ms, by = rnn_bounds("gru", *shape)["fwd"]
        timings[shape] = (ms["kernel"], ms["plain"])
        print(f"timing gru_fwd T={shape[0]} B={shape[1]} H={shape[2]}: "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
              + f"; bound {b_ms:.6f} ms ({by}), {b_ms / ms['kernel']:.4f} "
              f"of it; cuDNN {ms['cudnn'] / ms['kernel']:.2f}x the kernel's "
              f"time (median of 50 in turns, CUDA events) [{card}]")
    return worst, timings


def _gru_turn_fns(torch, rnn_cuda, args, shape) -> dict:
    """{name: call} of the GRU forward's timing turns at ``shape``: the
    kernel, the plain loop and cuDNN's ``nn.GRU``."""
    return {"kernel": lambda: rnn_cuda.gru_sequence(*args),
            "plain": lambda: rnn_cuda.gru_sequence_torch(*args),
            "cudnn": cudnn_gru_fwd(torch, *shape)}


def gru_profile_phase(torch, rnn_cuda, card: str) -> dict:
    """At each ``GRU_FWD_PROFILED`` shape, one ``gru_sequence`` call and
    one round of :func:`kernel_phase`'s timing turns, split by
    :func:`profile_split`: the kernel's device time, and whether its time
    in the turns is the device's or the host's."""
    gen = torch.Generator().manual_seed(13)
    out = {}
    for t, b, h in GRU_FWD_PROFILED:
        xp = torch.randn((t, b, 3 * h), generator=gen).cuda()
        w = ((torch.rand((h, 3 * h), generator=gen) * 2 - 1)
             * h ** -0.5).cuda()
        bias = torch.zeros((1, 3 * h)).cuda()
        fns = _gru_turn_fns(torch, rnn_cuda, (xp, w, bias), (t, b, h))
        out[("kernel", t, b, h)] = profile_split(
            torch, fns["kernel"], f"gru_fwd T={t} B={b} H={h}", t, card)
        out[("turns", t, b, h)] = profile_split(
            torch, lambda: [fn() for fn in fns.values()],
            f"gru_fwd turns ({', '.join(fns)}) T={t} B={b} H={h}", t, card)
    return out


def check_results(results, n: int, what: str) -> None:
    if len(results) != n:
        fail(f"{what}: {len(results)} results for {n} speakers")
    for r in results:
        probs = r["probs"]
        if len(probs) != 2 or not all(map(_finite, probs)):
            fail(f"{what}: malformed probabilities {probs}")
        if abs(sum(probs) - 1.0) > SLICE_TOL:
            fail(f"{what}: probabilities sum to {sum(probs)}")
        if r["label"] != max(range(2), key=probs.__getitem__):
            fail(f"{what}: label {r['label']} is not argmax of {probs}")


def _finite(x: float) -> bool:
    return x == x and abs(x) != float("inf")


def compare(a, b, what: str) -> float:
    worst = 0.0
    for ra, rb in zip(a, b):
        if ra["label"] != rb["label"]:
            fail(f"{what}: labels differ {ra} vs {rb}")
        worst = max(worst, max(abs(x - y)
                               for x, y in zip(ra["probs"], rb["probs"])))
    if not worst <= SLICE_TOL:
        fail(f"{what}: probabilities differ by {worst}")
    return worst


def slice_phase(torch, card: str):
    from icassp2022_depression_tpu_torch.ops import prng
    from icassp2022_depression_tpu_torch import cli
    from icassp2022_depression_tpu_torch import config as C
    from icassp2022_depression_tpu_torch.data import eatd
    from icassp2022_depression_tpu_torch.models import porting
    from icassp2022_depression_tpu_torch.models.audio_net import AudioNet
    from icassp2022_depression_tpu_torch.ops import rnn_cuda
    from icassp2022_depression_tpu_torch.serving.predictors import Predictor
    from icassp2022_depression_tpu_torch.train import checkpoints

    cfg = C.AUDIO_CLF.model
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        root = Path(tmp) / "corpus"
        t0 = time.perf_counter()
        eatd.make_synthetic_corpus(root, n_data=8, n_validation=4,
                                   seconds=(2.0, 12.0), seed=0)
        model = AudioNet(cfg, prng.prng_key(0))
        ckpt = checkpoints.save(
            Path(tmp) / "audio_clf",
            porting.audio_net_tree_from_state_dict(model.state_dict(), cfg),
            {"task": "audio_clf", "note": "random weights, seed 0"})
        speakers = list(eatd.iter_speakers(root, read_text=False))
        positions = [eatd.corpus_position(root, s.split, s.number)
                     for s in speakers]
        print(f"slice setup: {len(speakers)} speakers, answers "
              f"{min(min(s.durations) for s in speakers):.1f}-"
              f"{max(max(s.durations) for s in speakers):.1f} s, "
              f"{time.perf_counter() - t0:.2f} s")

        # -- the main path, counted ------------------------------------
        _set_counts(rnn_cuda, ZERO)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["predict", "--task", "audio_clf", "--ckpt",
                           str(ckpt), "--root", str(root), "--speaker",
                           "Data/1", "--device", "cuda"])
        if rc != 0:
            fail(f"cli predict returned {rc}")
        cli_out = json.loads(buf.getvalue().strip().splitlines()[-1])
        print(f"cli predict Data/1: {json.dumps(cli_out)} "
              f"(kernel launches {rnn_cuda.LAUNCHES})")
        if rnn_cuda.LAUNCHES != 2:
            fail(f"cli predict launched the GRU kernel {rnn_cuda.LAUNCHES} "
                 "times, expected 2 (one per layer)")
        check_results([cli_out], 1, "cli predict")

        predictor = Predictor.from_checkpoint(ckpt, "audio_clf",
                                              device="cuda")
        requests = {}
        outputs = {}
        for n in BATCHES:
            sel = list(range(n))
            req = ([speakers[i].waveforms for i in sel],
                   [speakers[i].sample_rates for i in sel],
                   [3 * positions[i] for i in sel])
            before = rnn_cuda.LAUNCHES
            outputs[n] = predictor.predict_batch(req[0], req[1],
                                                 ordinal_bases=req[2])
            grew = rnn_cuda.LAUNCHES - before
            print(f"predict_batch {n} speakers: kernel launches +{grew}")
            if grew != 2:
                fail(f"predict_batch({n}) launched the kernel {grew} "
                     "times, expected 2")
            check_results(outputs[n], n, f"predict_batch({n})")
            requests[n] = req
        launches = _counts(rnn_cuda)

        # -- comparison runs (not counted) -----------------------------
        plain = Predictor.from_checkpoint(
            ckpt, "audio_clf", device="cuda",
            model_cfg=C.replace(cfg, rnn_backend="torch"))
        worst = 0.0
        for n in BATCHES:
            ref = plain.predict_batch(requests[n][0], requests[n][1],
                                      ordinal_bases=requests[n][2])
            worst = max(worst, compare(outputs[n], ref,
                                       f"predict_batch({n}) vs plain GRU"))
        print(f"predict_batch vs plain-GRU forward: max|dprob| = "
              f"{worst:.3e} (tol {SLICE_TOL})")
        cpu = Predictor.from_checkpoint(ckpt, "audio_clf", device="cpu")
        ref_cpu = cpu.predict_speaker(speakers[0].waveforms,
                                      speakers[0].sample_rates,
                                      ordinal_base=3 * positions[0])
        d_cpu = compare([cli_out], [ref_cpu], "cli predict vs CPU run")
        print(f"cli predict vs the same predictor on the CPU: max|dprob| = "
              f"{d_cpu:.3e} (tol {SLICE_TOL})")
        if rnn_cuda.LAUNCHES != launches["gru_fwd"]:
            fail("a comparison run launched the CUDA kernel")

        # -- warm serving latency ----------------------------------------
        uncached = Predictor.from_checkpoint(ckpt, "audio_clf",
                                             device="cuda",
                                             feature_cache_entries=0)
        latency = {}
        for n in (1, 8):
            req = requests[n]
            for _ in range(3):
                uncached.predict_batch(req[0], req[1], ordinal_bases=req[2])
            times = []
            for _ in range(10):
                t0 = time.perf_counter()
                uncached.predict_batch(req[0], req[1], ordinal_bases=req[2])
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            latency[n] = statistics.median(times)
            audio_s = sum(sum(s.durations) for s in speakers[:n])
            print(f"timing predict_batch {n} speakers ({audio_s:.1f} s of "
                  f"audio, features not cached): median "
                  f"{latency[n]:.2f} ms of 10 (host clock) [{card}]")
    return launches, latency


def bwd_kernel_phase(torch, rnn_cuda, card: str):
    """The GRU backward kernel against its plain version at every
    ``BWD_SHAPES`` entry; then, at each ``BWD_TIMED`` shape, the kernel,
    the plain loop and cuDNN timed in turns.  Returns the worst |d dxp|
    and the (kernel, plain) ms at the timed shapes."""
    worst = 0.0
    gen = torch.Generator().manual_seed(1)
    inputs = {}
    for t, b, h in BWD_SHAPES:
        args = _bwd_inputs(torch, rnn_cuda, gen, "gru", t, b, h)
        ref = rnn_cuda.gru_sequence_bwd_torch(*args)
        err, rel, same = bwd_check(torch, rnn_cuda, "gru", args, ref,
                                   (t, b, h))
        print(f"kernel gru_bwd T={t} B={b} H={h}: max|d dxp| {err:.3e}, "
              f"dw/db rel {rel:.3e}, rerun bitwise equal {same} (tol "
              f"{KERNEL_TOL}; dw, db of max|ref|)")
        worst = max(worst, err)
        inputs[(t, b, h)] = args
    xp, w, bias = inputs[BWD_SHAPES[-1]][:3]
    try:
        rnn_cuda.gru_sequence(xp.clone().requires_grad_(), w, bias)
    except ValueError:
        pass
    else:
        fail("gru_sequence returned a detached result for an input that "
             "requires grad")
    timings = {shape: bwd_turns(torch, rnn_cuda, "gru", inputs[shape], shape,
                                card) for shape in BWD_TIMED}
    return worst, timings


def bwd_check(torch, rnn_cuda, cell: str, args, ref, shape) -> tuple:
    """The GRU or LSTM backward kernel against the plain ``ref``: (max|d
    dxp|, max of dw, db's error relative to their largest magnitude, rerun
    bitwise equal), failing past KERNEL_TOL or on a rerun that differs."""
    t, b, h = shape
    g = (3 if cell == "gru" else 4) * h
    bwd = _bwd_fns(rnn_cuda, cell)[1]
    got, again = bwd(*args), bwd(*args)
    torch.cuda.synchronize()
    for x, want in zip(got, ((t, b, g), (h, g), (1, g))):
        if tuple(x.shape) != want or not torch.isfinite(x).all():
            fail(f"{cell}_bwd output at {shape} is malformed")
    err = (got[0] - ref[0]).abs().max().item()
    rel = max(((x - r).abs().max() / r.abs().max()).item()
              for x, r in zip(got[1:], ref[1:]))
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    if not (err <= KERNEL_TOL and rel <= KERNEL_TOL and same):
        fail(f"{cell} backward kernel disagrees with its plain version at "
             f"{shape}: dxp {err}, dw/db {rel}, rerun bitwise equal {same}")
    return err, rel, same


def _bwd_fns(rnn_cuda, cell: str) -> tuple:
    """(plan, kernel wrapper, plain backward) of the GRU or LSTM."""
    if cell == "gru":
        return (rnn_cuda.gru_bwd_plan, rnn_cuda.gru_sequence_bwd,
                rnn_cuda.gru_sequence_bwd_torch)
    return (rnn_cuda.lstm_bwd_plan, rnn_cuda.lstm_sequence_bwd,
            rnn_cuda.lstm_sequence_bwd_torch)


def cudnn_bwd(torch, cell: str, t: int, b: int, h: int):
    """A call of cuDNN's backward at (T, B, H): ``torch.autograd.grad``
    through ``nn.GRU(h, h)`` / ``nn.LSTM(h, h)`` with respect to the input
    and the weights (a yardstick used nowhere in the port)."""
    mod = (torch.nn.GRU(h, h) if cell == "gru" else torch.nn.LSTM(h, h))
    mod = mod.cuda()
    x = torch.randn((t, b, h), device="cuda", requires_grad=True)
    y, _ = mod(x)
    dy = torch.randn_like(y)
    wrt = [x, *mod.parameters()]
    return lambda: torch.autograd.grad(y, wrt, dy, retain_graph=True)


def bwd_turns(torch, rnn_cuda, cell: str, args, shape, card: str) -> tuple:
    """The backward kernel, the plain loop and cuDNN at ``shape``, timed
    in turns; prints them with the bound and returns (kernel ms, plain
    ms)."""
    t, b, h = shape
    _, bwd, plain = _bwd_fns(rnn_cuda, cell)
    fns = {"kernel": lambda: bwd(*args), "plain": lambda: plain(*args),
           "cudnn": cudnn_bwd(torch, cell, t, b, h)}
    reps = 50 if t * b <= 512 else 20
    ms = turns_ms(torch, fns, reps)
    b_ms, by = rnn_bounds(cell, t, b, h)["bwd"]
    print(f"timing {cell}_bwd T={t} B={b} H={h}: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in ms.items())
          + f"; bound {b_ms:.6f} ms ({by}), {b_ms / ms['kernel']:.4f} of it; "
          f"cuDNN {ms['cudnn'] / ms['kernel']:.2f}x the kernel's time "
          f"(median of {reps} in turns, CUDA events) [{card}]")
    return ms["kernel"], ms["plain"]


def lstm_fwd_check(torch, rnn_cuda, args, ref, shape) -> tuple:
    """The LSTM forward kernel against the plain ``ref``: (max|d (ys,
    cs)|, rerun bitwise equal), failing past KERNEL_TOL or on a rerun that
    differs."""
    got = rnn_cuda.lstm_sequence(*args)
    again = rnn_cuda.lstm_sequence(*args)
    torch.cuda.synchronize()
    for g in got:
        if tuple(g.shape) != shape or not torch.isfinite(g).all():
            fail(f"LSTM kernel output at {shape} is malformed")
    err = max((g - r).abs().max().item() for g, r in zip(got, ref))
    same = all(torch.equal(a, c) for a, c in zip(got, again))
    if not (err <= KERNEL_TOL and same):
        fail(f"LSTM kernel disagrees with its plain version at {shape}: "
             f"{err}, rerun bitwise equal {same}")
    return err, same


def turns_ms(torch, fns: dict, reps: int) -> dict:
    """Median ms of each ``fns`` entry over ``reps`` single calls, the
    entries' calls taken in turns (one warm call each first), so that a
    slow spell of the host falls on all of them alike."""
    times = {name: [] for name in fns}
    for fn in fns.values():
        fn()
    for _ in range(reps):
        for name, fn in fns.items():
            times[name].append(event_ms(fn, 1, torch))
    return {name: statistics.median(v) for name, v in times.items()}


def lstm_kernel_phase(torch, rnn_cuda, card: str):
    """Both LSTM kernels against their plain versions, the backward with a
    nonzero cell-state cotangent (at the timed shapes the forward and its
    plain loop timed, and the backward, its plain loop and cuDNN in turns);
    returns the worst errors and the (kernel, plain) ms of each at the
    timed shapes."""
    worst = {"fwd": 0.0, "bwd": 0.0}
    gen = torch.Generator().manual_seed(2)
    inputs = {}
    for t, b, h in LSTM_SHAPES:
        bound = h ** -0.5
        xp = torch.randn((t, b, 4 * h), generator=gen).cuda()
        w = ((torch.rand((h, 4 * h), generator=gen) * 2 - 1) * bound).cuda()
        bias = ((torch.rand((1, 4 * h), generator=gen) * 2 - 1)
                * bound).cuda()
        dys = torch.randn((t, b, h), generator=gen).cuda()
        dcs = torch.randn((t, b, h), generator=gen).cuda()
        ref_ys, ref_cs = rnn_cuda.lstm_sequence_torch(xp, w, bias)
        args = (xp, w, bias, ref_ys, ref_cs, dys, dcs)
        fwd, same_f = lstm_fwd_check(torch, rnn_cuda, args[:3],
                                     (ref_ys, ref_cs), (t, b, h))
        bwd, rel, same_b = bwd_check(torch, rnn_cuda, "lstm", args,
                                     rnn_cuda.lstm_sequence_bwd_torch(*args),
                                     (t, b, h))
        print(f"kernel lstm_fwd/lstm_bwd T={t} B={b} H={h}: max|d ys|, "
              f"|d cs| = {fwd:.3e}, rerun bitwise equal {same_f}; backward "
              f"max|d dxp| {bwd:.3e}, dw/db rel {rel:.3e}, rerun bitwise "
              f"equal {same_b} (tol {KERNEL_TOL}; dw, db of max|ref|), dcs "
              f"nonzero")
        worst["fwd"] = max(worst["fwd"], fwd)
        worst["bwd"] = max(worst["bwd"], bwd)
        inputs[(t, b, h)] = args
    try:
        rnn_cuda.lstm_sequence(xp.clone().requires_grad_(), w, bias)
    except ValueError:
        pass
    else:
        fail("lstm_sequence returned a detached result for an input that "
             "requires grad")
    timings = {}
    for shape in LSTM_TIMED:
        args = inputs[shape]
        for _ in range(5):
            rnn_cuda.lstm_sequence(*args[:3])
            rnn_cuda.lstm_sequence_torch(*args[:3])
        fwd = (event_ms(lambda: rnn_cuda.lstm_sequence(*args[:3]), 50, torch),
               event_ms(lambda: rnn_cuda.lstm_sequence_torch(*args[:3]), 50,
                        torch))
        print(f"timing lstm_fwd T={shape[0]} B={shape[1]} H={shape[2]}: "
              f"cuda kernel {fwd[0]:.4f} ms, plain torch {fwd[1]:.4f} ms "
              f"(median of 50, CUDA events) [{card}]")
        timings[shape] = {"fwd": fwd, "bwd": bwd_turns(
            torch, rnn_cuda, "lstm", args, shape, card)}
    return worst, timings


def _lstmp_inputs(torch, gen, t, b, c, p, weights):
    """(xp4, w_h_t3, b3, w_p_t) for one LSTMP check.  "clips" and "gain3":
    xp4 normal with std 2, the input and forget gates opened by a bias of
    +2 so the cell grows, and a large W_p (6/sqrt(C)): both clips engage;
    the recurrent gain is 0.5/sqrt(P) ("clips") or 3/sqrt(P) ("gain3").
    "init": W_h, W_p uniform within 1/sqrt(P), 1/sqrt(C) and b = 0, as
    ``init_lstmp`` draws them, and xp4 standard normal."""
    gain = {"clips": 0.5, "gain3": 3.0, "init": 1.0}[weights]
    xp4 = torch.randn((t, b, 4, c), generator=gen)
    w_h = (torch.rand((p, 4, c), generator=gen) * 2 - 1) * gain / p ** 0.5
    if weights == "init":
        b3 = torch.zeros((1, 4, c))
        w_p = (torch.rand((c, p), generator=gen) * 2 - 1) / c ** 0.5
    else:
        xp4 = xp4 * 2
        b3 = torch.rand((1, 4, c), generator=gen) - 0.5
        b3[:, :2] += 2.0
        w_p = (torch.rand((c, p), generator=gen) * 2 - 1) * 6 / c ** 0.5
    return tuple(a.cuda() for a in (xp4, w_h, b3, w_p))


def cudnn_lstmp_bwd(torch, t: int, b: int, c: int, p: int):
    """A call of cuDNN's ``nn.LSTM(p, c, proj_size=p)`` backward at (T, B):
    ``torch.autograd.grad`` to the input and all weights (no clips; a
    yardstick used nowhere in the port)."""
    mod = torch.nn.LSTM(p, c, proj_size=p).cuda()
    x = torch.randn((t, b, p), device="cuda", requires_grad=True)
    y, _ = mod(x)
    dy = torch.randn_like(y)
    wrt = [x, *mod.parameters()]
    return lambda: torch.autograd.grad(y, wrt, dy, retain_graph=True)


def _rel(got, ref) -> float:
    """max over the outputs of max|got - ref| / max|ref|."""
    return max(((g - r).abs().max() / r.abs().max()).item()
               for g, r in zip(got, ref))


def _f64_reading(torch, rnn_cuda, fwd_in, got, ref) -> tuple:
    """(plain float32, kernel) distances from the plain recurrence run in
    float64 on the same inputs, relative to its largest magnitudes."""
    exact = rnn_cuda.lstmp_sequence_torch(*(a.double() for a in fwd_in))
    exact = tuple(e.float() for e in exact)
    return _rel(ref, exact), _rel(got, exact)


def lstmp_kernel_phase(torch, rnn_cuda, card: str):
    """Both LSTMP kernels against their plain versions at the zhs geometry
    (``LSTMP_SHAPES``); the backward against the plain backward fed the
    same forward residuals (a value within rounding of a clip may fall on
    either side in the two forwards).  Outputs within KERNEL_TOL of their
    largest magnitude, reruns bitwise equal; at the "clips" shapes both
    clips must engage.  Where the forward's plan takes the resident route
    (at most 32 rows), the step route is held the same way beside it, and
    at the timed shapes the two routes and the plain loop are timed in
    turns.  Beside each check, a reading: how far the plain float32 loop
    and the kernel are from the plain loop in float64, and the same at
    ``LSTMP_GAIN3``.  Returns the worst absolute errors, the (kernel,
    plain) ms at the timed shapes (and the routes' ms where both run) and
    the float64 readings."""
    worst = {"fwd": 0.0, "bwd": 0.0}
    worst_abs = {"fwd": 0.0, "bwd": 0.0}
    gen = torch.Generator().manual_seed(4)
    timings, readings = {}, {}
    for t, b, c, p, weights in LSTMP_SHAPES:
        shape = (t, b, c, p)
        fwd_in = _lstmp_inputs(torch, gen, t, b, c, p, weights)
        xp4, w_h, b3, w_p = fwd_in
        dys = torch.randn((t, b, p), generator=gen).cuda()
        dcpre = torch.randn((t, b, c), generator=gen).cuda()
        got = rnn_cuda.lstmp_sequence(*fwd_in)
        again = rnn_cuda.lstmp_sequence(*fwd_in)
        ref = rnn_cuda.lstmp_sequence_torch(*fwd_in)
        bwd_in = fwd_in + ref[:3] + (dys, dcpre)
        bref = rnn_cuda.lstmp_sequence_bwd_torch(*bwd_in)
        bgot = rnn_cuda.lstmp_sequence_bwd(*bwd_in)
        bagain = rnn_cuda.lstmp_sequence_bwd(*bwd_in)
        torch.cuda.synchronize()
        for g, want in zip(got + bgot, ((t, b, p), (t, b, p), (t, b, c),
                                        (t, b, c), (t, b, 4, c), (t, b, p))):
            if tuple(g.shape) != want or not torch.isfinite(g).all():
                fail(f"LSTMP kernel output at {shape} is malformed")
        clipped = (ref[2].abs().max().item() > 3.0,
                   ref[1].abs().max().item() > 3.0)
        if weights == "clips" and not all(clipped):
            fail(f"LSTMP clips not engaged at {shape}: {clipped}")
        fwd, bwd = _rel(got, ref), _rel(bgot, bref)
        same = all(torch.equal(a, c_) for a, c_ in
                   zip(got + bgot, again + bagain))
        readings[shape] = _f64_reading(torch, rnn_cuda, fwd_in, got, ref)
        route = rnn_cuda.lstmp_fwd_plan(
            b, c, p, sms=torch.cuda.get_device_properties(0)
            .multi_processor_count)["route"]
        print(f"kernel lstmp_fwd ({route} route)/lstmp_bwd T={t} B={b} "
              f"C={c} P={p} ({weights} weights): "
              f"max|d (ys, hpre, cpre, hf)| = "
              f"{fwd:.3e}, max|d (dgates, dhpre)| = {bwd:.3e} (tol "
              f"{KERNEL_TOL} of max|ref|), cell / projection clip engaged "
              f"{clipped}, dcpre nonzero, rerun bitwise equal: {same}; "
              f"reading: plain float32 / kernel vs plain float64 "
              f"{readings[shape][0]:.3e} / {readings[shape][1]:.3e}")
        if not (fwd <= KERNEL_TOL and bwd <= KERNEL_TOL and same):
            fail(f"LSTMP kernels disagree with their plain versions at "
                 f"{shape}: fwd {fwd}, bwd {bwd}, rerun {same}")
        step_plan = rnn_cuda.lstmp_fwd_plan(b, c, p, sms=0)
        if route == "resident":
            sgot = rnn_cuda.lstmp_sequence(*fwd_in, plan=step_plan)
            sagain = rnn_cuda.lstmp_sequence(*fwd_in, plan=step_plan)
            sfwd = _rel(sgot, ref)
            ssame = all(torch.equal(a, c_) for a, c_ in zip(sgot, sagain))
            print(f"kernel lstmp_fwd (step route) T={t} B={b} C={c} P={p} "
                  f"({weights} weights): max|d (ys, hpre, cpre, hf)| = "
                  f"{sfwd:.3e} (tol {KERNEL_TOL} of max|ref|), rerun bitwise "
                  f"equal: {ssame}")
            if not (sfwd <= KERNEL_TOL and ssame):
                fail(f"the LSTMP forward's step route disagrees with the "
                     f"plain loop at {shape}: {sfwd}, rerun {ssame}")
            fwd = max(fwd, sfwd)
        worst["fwd"] = max(worst["fwd"], fwd)
        worst["bwd"] = max(worst["bwd"], bwd)
        for k, gs, rs in (("fwd", got, ref), ("bwd", bgot, bref)):
            worst_abs[k] = max([worst_abs[k]] + [(g - r).abs().max().item()
                                                 for g, r in zip(gs, rs)])
        if shape in LSTMP_TIMED:
            rnn_cuda.lstmp_sequence(*fwd_in)
            rnn_cuda.lstmp_sequence_torch(*fwd_in)
            timings[shape] = {"fwd": (
                event_ms(lambda: rnn_cuda.lstmp_sequence(*fwd_in), 5, torch),
                event_ms(lambda: rnn_cuda.lstmp_sequence_torch(*fwd_in), 5,
                         torch))}
            ms, pms = timings[shape]["fwd"]
            print(f"timing lstmp_fwd T={t} B={b} C={c} P={p}: cuda kernel "
                  f"({route} route) {ms:.4f} ms, plain torch {pms:.4f} ms "
                  f"(median of 5, CUDA events) [{card}]")
            if route == "resident":
                timings[shape]["routes"] = turns_ms(torch, {
                    "resident": lambda: rnn_cuda.lstmp_sequence(*fwd_in),
                    "step": lambda: rnn_cuda.lstmp_sequence(
                        *fwd_in, plan=step_plan),
                    "plain": lambda: rnn_cuda.lstmp_sequence_torch(*fwd_in)},
                    5)
                print(f"timing lstmp_fwd routes T={t} B={b} C={c} P={p}: "
                      + ", ".join(f"{k} {v:.4f} ms" for k, v in
                                  timings[shape]["routes"].items())
                      + f" (median of 5 in turns, CUDA events) [{card}]")
            turns = turns_ms(torch, {
                "kernel": lambda: rnn_cuda.lstmp_sequence_bwd(*bwd_in),
                "plain": lambda: rnn_cuda.lstmp_sequence_bwd_torch(*bwd_in),
                "cudnn": cudnn_lstmp_bwd(torch, t, b, c, p)}, 5)
            timings[shape]["bwd"] = (turns["kernel"], turns["plain"])
            timings[shape]["bwd_turns"] = turns
            print(f"timing lstmp_bwd T={t} B={b} C={c} P={p}: " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in turns.items())
                  + f" (median of 5 in turns, CUDA events; cuDNN "
                  f"nn.LSTM({p}, {c}, proj_size={p}) backward, no clips) "
                  f"[{card}]")
    try:
        rnn_cuda.lstmp_sequence(xp4.clone().requires_grad_(), w_h, b3, w_p)
    except ValueError:
        pass
    else:
        fail("lstmp_sequence returned a detached result for an input that "
             "requires grad")
    *shape, weights = LSTMP_GAIN3
    fwd_in = _lstmp_inputs(torch, gen, *shape, weights)
    got = rnn_cuda.lstmp_sequence(*fwd_in)
    ref = rnn_cuda.lstmp_sequence_torch(*fwd_in)
    r32, rk = _f64_reading(torch, rnn_cuda, fwd_in, got, ref)
    readings[tuple(shape) + (weights,)] = (r32, rk)
    print(f"reading lstmp_fwd T={shape[0]} B={shape[1]} C={shape[2]} "
          f"P={shape[3]} (gain3 weights, not checked): kernel vs plain "
          f"float32 {_rel(got, ref):.3e}; plain float32 / kernel vs plain "
          f"float64 {r32:.3e} / {rk:.3e} (of max|ref|)")
    print(f"lstmp kernels: worst max|d| relative {worst}, absolute "
          f"{worst_abs}")
    return worst_abs, timings, readings


def _kernel_short_name(name: str) -> str:
    """``void (anonymous namespace)::kernel<T>(args)`` -> ``kernel``."""
    name = name.replace("(anonymous namespace)::", "")
    name = name.split("(")[0].split("<")[0].split("::")[-1].strip()
    return name.split(" ")[-1]


def profile_split(torch, fn, label: str, steps: int, card: str):
    """``fn()`` once under ``torch.profiler`` after a warm call: the device
    time of each kernel name (launches that overlap, as programmatic
    dependent launches do, count in full for each), and the gaps, the span
    from the first kernel's start to the last one's end less the time some
    kernel ran.  Returns {"span_us", "busy_us", "gap_us", "kernels": {name:
    (us, count)}}, or None when the profiler saw no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):      # a short call's trace now and then comes empty
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        if kernels:
            break
    else:
        print(f"profile {label}: the profiler recorded no device events in "
              f"3 tries, split not measured [{card}]")
        return None
    start = min(e.time_range.start for e in kernels)
    end = max(e.time_range.end for e in kernels)
    by_name: dict = {}
    for e in kernels:
        name = _kernel_short_name(e.name)
        us, n = by_name.get(name, (0.0, 0))
        by_name[name] = (us + e.time_range.elapsed_us(), n + 1)
    busy, reach = 0.0, start    # the union of the kernels' intervals
    for e in sorted(kernels, key=lambda e: e.time_range.start):
        busy += max(0.0, e.time_range.end - max(reach, e.time_range.start))
        reach = max(reach, e.time_range.end)
    split = {"span_us": end - start, "busy_us": busy,
             "gap_us": end - start - busy, "kernels": by_name}
    print(f"profile {label}: span {split['span_us']:.1f} us "
          f"({split['span_us'] / steps:.2f} us a step), some kernel "
          f"running {busy:.1f} us, gaps {split['gap_us']:.1f} us "
          f"({split['gap_us'] / max(split['span_us'], 1e-9):.3f} of the "
          f"span); " + ", ".join(
              f"{k} {us:.1f} us in {n} launches ({us / n:.2f} us each)"
              for k, (us, n) in sorted(by_name.items(),
                                       key=lambda kv: -kv[1][0]))
          + f" (torch.profiler) [{card}]")
    return split


def lstmp_profile_phase(torch, rnn_cuda, card: str) -> dict:
    """One ``lstmp_sequence`` call and one ``lstmp_sequence_bwd`` call (the
    plan's route, fed the forward's residuals) at each ``LSTMP_PROFILED``
    shape (``init_lstmp``-scale weights) split by :func:`profile_split`."""
    gen = torch.Generator().manual_seed(8)
    out = {}
    for shape in LSTMP_PROFILED:
        fwd_in = _lstmp_inputs(torch, gen, *shape, "init")
        t, b, c, p = shape
        out[("fwd",) + shape] = profile_split(
            torch, lambda: rnn_cuda.lstmp_sequence(*fwd_in),
            f"lstmp_fwd T={t} B={b} C={c} P={p}", t, card)
        bwd_in = (fwd_in + rnn_cuda.lstmp_sequence(*fwd_in)[:3]
                  + (torch.randn((t, b, p), generator=gen).cuda(),
                     torch.randn((t, b, c), generator=gen).cuda()))
        out[("bwd",) + shape] = profile_split(
            torch, lambda: rnn_cuda.lstmp_sequence_bwd(*bwd_in),
            f"lstmp_bwd T={t} B={b} C={c} P={p}", t, card)
    return out


def _standin_inputs(torch, gen, t, b, h):
    """(xp, w_hh_t, b_hh) at the stand-in's scale: xp standard normal, the
    weights uniform within 1/sqrt(H), as ``elmo.init`` draws them."""
    xp = torch.randn((t, b, 4 * h), generator=gen)
    w = (torch.rand((h, 4 * h), generator=gen) * 2 - 1) * h ** -0.5
    bias = (torch.rand((1, 4 * h), generator=gen) * 2 - 1) * h ** -0.5
    return tuple(a.cuda() for a in (xp, w, bias))


def lstm_profile_phase(torch, rnn_cuda, card: str) -> dict:
    """One ``lstm_sequence`` call at each ``STANDIN_PROFILED`` shape split
    by :func:`profile_split`."""
    gen = torch.Generator().manual_seed(9)
    out = {}
    for t, b, h in STANDIN_PROFILED:
        args = _standin_inputs(torch, gen, t, b, h)
        out[(t, b, h)] = profile_split(
            torch, lambda: rnn_cuda.lstm_sequence(*args),
            f"lstm_fwd T={t} B={b} H={h} (the stand-in encoder)", t, card)
    return out


def _bwd_inputs(torch, rnn_cuda, gen, cell: str, t: int, b: int,
                h: int) -> tuple:
    """The backward's arguments at (T, B, H): xp standard normal, the
    weights uniform within 1/sqrt(H), the plain forward's states, and
    standard normal cotangents (``dcs`` too for the LSTM)."""
    g = (3 if cell == "gru" else 4) * h
    xp = torch.randn((t, b, g), generator=gen).cuda()
    w = ((torch.rand((h, g), generator=gen) * 2 - 1) * h ** -0.5).cuda()
    bias = ((torch.rand((1, g), generator=gen) * 2 - 1) * h ** -0.5).cuda()
    dys = torch.randn((t, b, h), generator=gen).cuda()
    if cell == "gru":
        return xp, w, bias, rnn_cuda.gru_sequence_torch(xp, w, bias), dys
    dcs = torch.randn((t, b, h), generator=gen).cuda()
    ys, cs = rnn_cuda.lstm_sequence_torch(xp, w, bias)
    return xp, w, bias, ys, cs, dys, dcs


def bwd_profile_phase(torch, rnn_cuda, card: str, cells=("gru", "lstm")):
    """One backward call at each ``GRU_BWD_PROFILED`` /
    ``LSTM_BWD_PROFILED`` shape split by :func:`profile_split`."""
    gen = torch.Generator().manual_seed(10)
    out = {}
    for cell in cells:
        fn = _bwd_fns(rnn_cuda, cell)[1]
        for t, b, h in (GRU_BWD_PROFILED if cell == "gru"
                        else LSTM_BWD_PROFILED):
            args = _bwd_inputs(torch, rnn_cuda, gen, cell, t, b, h)
            out[(cell, t, b, h)] = profile_split(
                torch, lambda: fn(*args), f"{cell}_bwd T={t} B={b} H={h}",
                t, card)
    return out


def standin_lstm_phase(torch, rnn_cuda, card: str) -> tuple:
    """The LSTM forward kernel at the stand-in text encoder's H = 512
    (``STANDIN_LSTM_SHAPES``) against its plain version: within
    KERNEL_TOL, a rerun bitwise equal.  Then the kernel, the plain loop and
    cuDNN's ``nn.LSTM(512, 512)`` (a yardstick used nowhere, input
    projection included) timed in turns.  Returns the (kernel, plain) ms
    per shape, cuDNN's ms and the worst error."""
    gen = torch.Generator().manual_seed(5)
    timings, cudnn, worst = {}, {}, 0.0
    for t, b, h in STANDIN_LSTM_SHAPES:
        shape = (t, b, h)
        args = _standin_inputs(torch, gen, t, b, h)
        ref = rnn_cuda.lstm_sequence_torch(*args)
        err, same = lstm_fwd_check(torch, rnn_cuda, args, ref, shape)
        worst = max(worst, err)
        lstm = torch.nn.LSTM(h, h).cuda()
        x = torch.randn((t, b, h), generator=gen).cuda()

        def library():
            with torch.no_grad():
                lstm(x)

        reps = 20 if t * b <= 4096 else 5
        ms = turns_ms(torch, {
            "kernel": lambda: rnn_cuda.lstm_sequence(*args),
            "plain": lambda: rnn_cuda.lstm_sequence_torch(*args),
            "cudnn": library}, reps)
        timings[shape] = (ms["kernel"], ms["plain"])
        cudnn[shape] = ms["cudnn"]
        print(f"kernel lstm_fwd T={t} B={b} H={h} (the stand-in encoder): "
              f"max|d (ys, cs)| {err:.3e} (rerun bitwise equal {same}) "
              f"(tol {KERNEL_TOL}); the plan {rnn_cuda.lstm_fwd_plan(b, h)}; "
              f"kernel {ms['kernel']:.4f} ms, plain torch "
              f"{ms['plain']:.4f} ms, cuDNN {ms['cudnn']:.4f} ms (median of "
              f"{reps} in turns, CUDA events) [{card}]")
    return timings, cudnn, worst


def standin_summary(card: str, standin_times: dict, cudnn: dict) -> None:
    """The LSTM forward at each stand-in shape beside the plain loop,
    cuDNN's ``nn.LSTM(512, 512)`` and its bound."""
    for shape in STANDIN_LSTM_SHAPES:
        ms, plain = standin_times[shape]
        b_ms, by = rnn_bounds("lstm", *shape)["fwd"]
        print(f"lstm_fwd at the stand-in's (T, B, H) = {shape}: kernel "
              f"{ms:.4f} ms, plain loop {plain:.4f} ms, cuDNN "
              f"{cudnn[shape]:.4f} ms, bound {b_ms:.6f} ms ({by}); "
              f"{plain / ms:.2f}x the plain loop's speed, "
              f"{cudnn[shape] / ms:.2f}x cuDNN's, {b_ms / ms:.4f} of the "
              f"bound [{card}]")


def library_phase(torch, card: str, only=("",)) -> dict:
    """The nearest PyTorch call to each kernel, timed as a yardstick and
    used nowhere in the port: cuDNN's ``nn.GRU`` / ``nn.LSTM`` (they also
    do the input projection the kernels take ready-made) and
    ``nn.LSTM(proj_size=...)`` for the LSTMP cell (no +-3 clips).  The
    backwards are ``torch.autograd.grad`` of the forward's output with
    respect to the input and the weights.  ``only``: the names that start
    with it (a prefix, or a tuple of prefixes)."""
    (t1, b1, c1, p1), (t2, b2, c2, p2), (t3, b3, c3, p3), (t4, b4, c4, p4) = (
        LSTMP_TIMED)
    shapes = {"gru_fwd": ("gru",) + BWD_TIMED[0] + (None,),
              "gru_bwd": ("gru",) + BWD_TIMED[0] + (None,),
              "gru_bwd_streamed": ("gru",) + BWD_TIMED[-1] + (None,),
              "lstm_fwd": ("lstm",) + LSTM_TIMED[0] + (None,),
              "lstm_bwd": ("lstm",) + LSTM_TIMED[0] + (None,),
              "lstm_bwd_streamed": ("lstm",) + LSTM_TIMED[-1] + (None,),
              "lstmp_fwd": ("lstm", t1, b1, c1, p1),
              "lstmp_bwd": ("lstm", t1, b1, c1, p1),
              "lstmp_fwd_b8": ("lstm", t2, b2, c2, p2),
              "lstmp_bwd_b8": ("lstm", t2, b2, c2, p2),
              "lstmp_fwd_t128": ("lstm", t3, b3, c3, p3),
              "lstmp_bwd_t128": ("lstm", t3, b3, c3, p3),
              "lstmp_fwd_b8_t128": ("lstm", t4, b4, c4, p4)}
    out = {}
    for name, (cell, t, b, h, proj) in shapes.items():
        if not name.startswith(only):
            continue
        d = proj or h
        kw = {"proj_size": proj} if proj else {}
        mod = (torch.nn.GRU(d, h) if cell == "gru"
               else torch.nn.LSTM(d, h, **kw)).cuda()
        x = torch.randn((t, b, d), device="cuda", requires_grad=True)
        if "bwd" in name:
            y, _ = mod(x)
            dy = torch.randn_like(y)
            wrt = [x, *mod.parameters()]

            def fn():
                torch.autograd.grad(y, wrt, dy, retain_graph=True)
        else:
            def fn():
                with torch.no_grad():
                    mod(x)
        fn()
        out[name] = event_ms(fn, 10, torch)
        print(f"timing library {name}: torch.nn.{cell.upper()}"
              f"({d}, {h}{f', proj_size={proj}' if proj else ''}) "
              f"{'backward' if 'bwd' in name else 'forward'} at T={t} B={b}: "
              f"{out[name]:.4f} ms (median of 10, CUDA events; cuDNN, "
              f"input projection included"
              f"{', no clips' if proj else ''}) [{card}]")
    return out


def lstmp_summary(card: str, lstmp_times: dict, library: dict) -> None:
    """The LSTMP forward at each timed shape beside the plain loop, cuDNN's
    ``nn.LSTM(proj_size=P)`` (no clips) and its bound."""
    lib = dict(zip(LSTMP_TIMED, ("lstmp_fwd", "lstmp_fwd_b8",
                                 "lstmp_fwd_t128", "lstmp_fwd_b8_t128")))
    for shape in LSTMP_TIMED:
        ms, plain = lstmp_times[shape]["fwd"]
        b_ms, by = lstmp_bounds(*shape)["fwd"]
        cudnn = library[lib[shape]]
        print(f"lstmp_fwd at (T, B, C, P) = {shape}: kernel {ms:.4f} ms, "
              f"plain loop {plain:.4f} ms, cuDNN {cudnn:.4f} ms, bound "
              f"{b_ms:.4f} ms ({by}); {plain / ms:.2f}x the plain loop's "
              f"speed, {cudnn / ms:.2f}x cuDNN's, {b_ms / ms:.4f} of the "
              f"bound [{card}]")
        routes = lstmp_times[shape].get("routes")
        if routes:
            t = shape[0]
            print(f"lstmp_fwd routes at (T, B, C, P) = {shape} (in turns): "
                  f"resident {routes['resident']:.4f} ms "
                  f"({1e3 * routes['resident'] / t:.2f} us a step, "
                  f"{b_ms / routes['resident']:.4f} of the bound), step "
                  f"{routes['step']:.4f} ms ({1e3 * routes['step'] / t:.2f} "
                  f"us a step, {b_ms / routes['step']:.4f} of the bound), "
                  f"plain loop {routes['plain']:.4f} ms; the resident route "
                  f"{routes['step'] / routes['resident']:.2f}x the step "
                  f"route's speed [{card}]")
        turns = lstmp_times[shape]["bwd_turns"]
        ms = turns["kernel"]
        b_ms, by = lstmp_bounds(*shape)["bwd"]
        t, _, c, p = shape
        stream_ms = t * 5 * c * p * 4 / PEAK_HBM_BYTES * 1e3
        print(f"lstmp_bwd at (T, B, C, P) = {shape}: kernel {ms:.4f} ms, "
              f"plain {turns['plain']:.4f} ms, cuDNN {turns['cudnn']:.4f} ms"
              f" (in turns); bound {b_ms:.4f} ms ({by}, the weights "
              f"counted once), {b_ms / ms:.4f} of it; the step walk's "
              f"weight stream (5CP floats a step from HBM) {stream_ms:.4f} "
              f"ms; {turns['plain'] / ms:.2f}x the plain loop's speed, "
              f"{turns['cudnn'] / ms:.2f}x cuDNN's [{card}]")


def bound(flops: float, nbytes: float):
    """(least ms, "operations" or "bytes"): the larger of the operations
    over the fp32 peak and the bytes over the memory rate."""
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def rnn_bounds(cell: str, t: int, b: int, h: int) -> dict:
    """The GRU's or LSTM's forward and backward bounds at (T, B, H): the
    recurrent products' flops (the backward recomputes the gates, carries
    the state and reduces dW), each input read once and each output
    written once, in float32."""
    g = (3 if cell == "gru" else 4) * h
    states = 1 if cell == "gru" else 2          # ys (+ cs)
    return {
        "fwd": bound(2 * t * b * h * g,
                     4 * (t * b * g + h * g + g + states * t * b * h)),
        "bwd": bound(3 * 2 * t * b * h * g,
                     4 * (2 * t * b * g + 2 * h * g + 2 * g
                          + 2 * states * t * b * h))}


def lstmp_bounds(t: int, b: int, c: int, p: int) -> dict:
    """The LSTMP kernels' bounds at (T, B, C, P): forward 2 T B (4CP + CP)
    flops over xp4, the weights, ys, hpre, cpre and hf; backward (the
    kernel's part) 2 T B (9 C P) flops over xp4, the weights, ys, hpre,
    dys, dhpre, cpre, dcpre and dgates."""
    weights = 4 * c * p + 4 * c + c * p
    return {
        "fwd": bound(2 * t * b * 5 * c * p,
                     4 * (t * b * 4 * c + weights + 2 * t * b * p
                          + 2 * t * b * c)),
        "bwd": bound(2 * t * b * 9 * c * p,
                     4 * (2 * t * b * 4 * c + weights + 4 * t * b * p
                          + 2 * t * b * c))}


def print_bounds(card: str, timings: dict) -> None:
    """A bound line for every timed shape: ``timings`` maps (name, shape)
    to the kernel's ms."""
    for (name, shape), ms in timings.items():
        cell, direction = name.split("_")
        b_ms, by = (lstmp_bounds(*shape) if cell == "lstmp"
                    else rnn_bounds(cell, *shape))[direction]
        print(f"bound {name} at {shape}: {b_ms:.6f} ms ({by}) against "
              f"{ms:.4f} ms measured, {b_ms / ms:.4f} of the bound "
              f"[{card}]")


def kernel_bounds() -> dict:
    """Each kernel's bound at the shape its JSON entry is timed at."""
    gru, lstm = (rnn_bounds("gru", *TIMED_SHAPES[0]),
                 rnn_bounds("lstm", *LSTM_TIMED[0]))
    lstmp = lstmp_bounds(*LSTMP_TIMED[0])
    return {"gru_fwd": gru["fwd"], "gru_bwd": rnn_bounds(
                "gru", *BWD_TIMED[0])["bwd"],
            "gru_bwd_streamed": rnn_bounds("gru", *BWD_TIMED[-1])["bwd"],
            "lstm_bwd_streamed": rnn_bounds("lstm", *LSTM_TIMED[-1])["bwd"],
            "lstm_fwd": lstm["fwd"], "lstm_bwd": lstm["bwd"],
            "lstmp_fwd": lstmp["fwd"], "lstmp_bwd": lstmp["bwd"]}


#: the wrappers' launch counters (``rnn_cuda.launch_counts()``): one a
#: recurrence source, the backwards' calls at the shapes the JAX package
#: streams (TPU kernels #3 and #5), and the threefry draws'
COUNTERS = ("gru_fwd", "gru_bwd", "lstm_fwd", "lstm_bwd", "lstmp_fwd",
            "lstmp_fwd_resident", "lstmp_bwd", "gru_bwd_streamed",
            "lstm_bwd_streamed", "threefry")


def _counts(rnn_cuda) -> dict:
    return rnn_cuda.launch_counts()


def _set_counts(rnn_cuda, counts: dict) -> None:
    now = rnn_cuda.launch_counts()
    rnn_cuda.add_launches({k: v - now[k] for k, v in counts.items()})


#: every counter at 0: where a counted run starts, and a phase's sum
ZERO = dict.fromkeys(COUNTERS, 0)


class _Unheld:
    """A run's expected threefry launches where its draws are counted but
    not held: model set-up, training and extraction draw a number of keys,
    weights and masks that no phase works out.  Sums and multiples of it
    stay unheld."""

    def __add__(self, other):
        return self

    __radd__ = __mul__ = __rmul__ = __add__

    def __repr__(self) -> str:
        return "counted"


UNHELD = _Unheld()
#: a run's expected launches, its draws counted but not held; a run whose
#: draws are known (``predict_batch``, a replayed epoch, phase 14) gives
#: ``threefry`` their number.  Which of a run's ``lstmp_fwd`` calls take
#: the resident route follows from its batches' row counts, which only
#: the serving phase and the LSTMP phase hold; elsewhere it is counted
DRAWN = dict(ZERO, threefry=UNHELD, lstmp_fwd_resident=UNHELD)


def _held(got: dict, want: dict) -> bool:
    """Whether a run's launches are ``want``: every counter exactly, but
    an unheld one."""
    return got.keys() == want.keys() and all(
        v is UNHELD or got[k] == v for k, v in want.items())


def wav2vlad_draws(waveforms, sample_rates) -> int:
    """The threefry launches of ``extract_batch`` over speakers' answers
    (None: no audio): 6 a bucket (its NetVLAD weights: a ``fold_in``, a
    ``split`` and four ``normal``), a bucket a padded length and sample
    rate."""
    from icassp2022_depression_tpu_torch.config import FrontendConfig
    from icassp2022_depression_tpu_torch.frontend import audio as afe

    if waveforms is None:
        return 0
    tail = FrontendConfig().n_fft // 2
    return 6 * len({(afe._bucket_length(len(w) + tail), sr)
                    for ws, srs in zip(waveforms, sample_rates)
                    for w, sr in zip(ws, srs)})


def warmed(epochs: list) -> tuple:
    """(optimizer steps, evals) of a trainer's epoch records, with the
    warm-up epoch that each fold's CUDA graph capture runs before it (its
    launches are real; the capture itself launches nothing, and each replay
    counts the captured calls)."""
    first = {}
    for r in epochs:
        first.setdefault(r["fold"], r["steps"])
    return (int(sum(r["steps"] for r in epochs) + sum(first.values())),
            len(epochs) + len(first))


def expected_launches(task: str, steps: int, evals: int, folds: int) -> dict:
    """Two GRU layers (audio), two layers x two directions of LSTM (text):
    one forward per layer and direction per step and per eval, one backward
    per step (steps and evals with each fold's warm-up epoch, ``warmed``).
    The fusion trains only its head: its frozen branches run forward once
    per step and once per fold (the test split's features), and no
    backward kernel launches."""
    if task.startswith("audio"):
        return dict(DRAWN, gru_fwd=2 * (steps + evals), gru_bwd=2 * steps)
    if task.startswith("text"):
        return dict(DRAWN, lstm_fwd=4 * (steps + evals), lstm_bwd=4 * steps)
    return dict(DRAWN, gru_fwd=2 * (steps + folds),
                lstm_fwd=4 * (steps + folds))


def _check_launches(task: str, got: dict, steps: int, evals: int,
                    folds: int) -> None:
    want = expected_launches(task, steps, evals, folds)
    print(f"{task}: {steps} optimizer steps, {evals} evals, {folds} folds; "
          f"kernel launches {got}")
    if not _held(got, want):
        fail(f"{task} launched {got}, expected {want}")


def write_audio_npz(root: Path, feats, sds, clf) -> None:
    """``Features/AudioWhole`` in the JAX package's npz layout, from the
    port's own extraction."""
    import numpy as np

    audio = root / "Features" / "AudioWhole"
    audio.mkdir(parents=True)
    xa = feats.cpu().numpy()[:, :, None, :]
    for track, y in (("clf", clf), ("reg", sds)):
        np.savez(audio / f"whole_samples_{track}_256.npz", xa)
        np.savez(audio / f"whole_labels_{track}_256.npz", y)


def seeded_bundle(torch, path: Path, corpus_chars: str, seed: int = 11):
    """A converted-ELMo bundle at the zhs geometry (6784 chars, char-CNN
    filters (1,32)...(7,1024), 2 highways, 512 out; biLM C = 4096,
    P = 512, 2 layers, +-3 clips) with weights drawn from ``seed`` by the
    port's threefry on the card, written by the port's ``save_npz``.  The
    char lexicon is the specials, ``corpus_chars`` and then CJK code points
    from U+4E00 up to the vocabulary size.  Returns (path, the lexicon's
    characters)."""
    from icassp2022_depression_tpu_torch.models import char_cnn, elmo
    from icassp2022_depression_tpu_torch.models import elmo_pretrained as ep
    from icassp2022_depression_tpu_torch.ops import prng

    ccfg = char_cnn.CharCnnConfig()
    lcfg = elmo.ElmoLstmpConfig(vocab_size=1)
    chars = list(dict.fromkeys(corpus_chars))
    code = 0x4E00
    while len(chars) < ccfg.n_chars - 6:
        if chr(code) not in chars:
            chars.append(chr(code))
        code += 1
    lexicon = {tok: i for i, tok in enumerate(
        [ep.PAD, ep.OOV, ep.BOS, ep.EOS, ep.BOW, ep.EOW] + chars)}
    enc = elmo.init_lstmp_encoder(prng.prng_key(seed + 1, "cuda"), lcfg)
    pe = ep.PretrainedElmo(ccfg, lcfg,
                           char_cnn.init(prng.prng_key(seed, "cuda"), ccfg),
                           {"layers": enc["layers"]}, lexicon, None)
    ep.save_npz(path, pe)
    return path, chars


def bundle_id(path: Path) -> str:
    return f"elmo_bundle:{path.name}:{path.stat().st_size}"


PIPELINE_TASKS = {"clf": ("audio_clf", "text_clf", "fuse_clf"),
                  "reg": ("audio_reg", "text_reg", "fuse_reg")}


def pipeline_run(torch, root: Path, track: str, card: str, embedder: str,
                 fold_cfg=None, extra_argv=(), outside=None,
                 all_gated: bool = False) -> dict:
    """``cli pipeline --track <track> [extra_argv]`` on ``root``, counted:
    every kernel counter is zeroed just before and read just after, and
    each stage's launches and wall time are recorded by wrapping its
    trainer (``fold_cfg``, when given, is passed to the reg trainers).
    Checks the launches of each stage and, outside the trainers,
    ``outside`` (the text extraction of a ``--corpus`` run), the metrics,
    the summary line, every gated fold's artifacts and that the text and
    fusion sidecars name ``embedder`` (with ``all_gated``, every fold must
    have gated); returns the launches and the stage wall times."""
    from icassp2022_depression_tpu_torch import cli
    from icassp2022_depression_tpu_torch.ops import rnn_cuda
    from icassp2022_depression_tpu_torch.train import checkpoints, trainers

    tasks = PIPELINE_TASKS[track]
    stages: dict = {}
    originals = {t: getattr(trainers, f"train_{t}") for t in tasks}

    def staged(task, fn):
        def run(*args, **kwargs):
            if fold_cfg is not None:
                kwargs["fold_cfg"] = fold_cfg
            before = _counts(rnn_cuda)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            after = _counts(rnn_cuda)
            stages[task] = (time.perf_counter() - t0,
                            {k: after[k] - before[k] for k in after})
            return out
        return run

    for t, fn in originals.items():
        setattr(trainers, f"train_{t}", staged(t, fn))
    buf = io.StringIO()
    try:
        _set_counts(rnn_cuda, ZERO)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["pipeline", "--track", track, "--root",
                           str(root), "--device", "cuda", *extra_argv])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        total = _counts(rnn_cuda)
    finally:
        for t, fn in originals.items():
            setattr(trainers, f"train_{t}", fn)
    if rc != 0:
        fail(f"cli pipeline --track {track} returned {rc}")
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    print(f"cli pipeline --track {track}: {json.dumps(summary)}")
    metric = "f1" if track == "clf" else "mae"
    records = [json.loads(line) for line in
               (root / "Model" / f"pipeline_{track}_metrics.jsonl")
               .read_text().splitlines()]
    model = root / "Model"
    for task in tasks:
        epochs = [r for r in records
                  if r["event"] == "epoch" and r["trainer"] == task]
        bests = [r for r in records
                 if r["event"] == "fold_best" and r["trainer"] == task]
        for r in epochs:
            bad = [k for k, v in r.items()
                   if isinstance(v, float) and not _finite(v)]
            if bad:
                fail(f"{task}: non-finite metrics logged: {r}")
        if len(bests) != 3 or summary[f"{task.split('_')[0]}_{metric}"] \
                != [round(b[metric], 4) for b in bests]:
            fail(f"{task}: {len(bests)} fold results, summary {summary}")
        _check_launches(task, stages[task][1], *warmed(epochs), len(bests))
        gated = [r for r in bests if r["epoch"] >= 0]
        if all_gated and len(gated) != len(bests):
            fail(f"{task}: {len(gated)} of {len(bests)} folds gated with "
                 "the gates open")
        for r in gated:
            for f in _artifacts(checkpoints, model, task, r):
                if not f.is_file():
                    fail(f"gated {task} fold {r['fold']} wrote no {f}")
            if not task.startswith("audio"):
                meta = checkpoints.load_meta(
                    next(iter(_artifacts(checkpoints, model, task, r))))
                if meta.get("text_embedder") != embedder:
                    fail(f"{task} sidecar names another embedder: {meta}")
        named = ("" if task.startswith("audio") or not gated
                 else f", their sidecars name {embedder}")
        print(f"  {task}: {len(gated)} of 3 folds gated, their artifacts "
              f"written{named}; wall {stages[task][0]:.2f} s [{card}]")
    outside = dict(DRAWN, **(outside or {}))
    if not _held(total, {k: outside[k] + sum(st[1][k]
                                             for st in stages.values())
                         for k in total}):
        fail(f"launches outside the trainers: {total}, stages {stages}, "
             f"expected {outside} outside")
    print(f"cli pipeline --track {track}: wall {wall:.2f} s, launches "
          f"{total} [{card}]")
    return {"launches": total, "wall_s": wall,
            "stage_s": {t: st[0] for t, st in stages.items()}}


def vmap_pipeline_run(torch, root: Path, track: str, card: str,
                      fold_cfg=None, extra_argv=(), compare: bool = True):
    """``cli pipeline --track <track> --vmap-folds`` beside the serial run
    of ``pipeline_run`` on ``root`` (into ``root/ModelVmap``), not counted:
    the branches (and the reg fusion) as stacked folds, the clf fusion
    serial.  With ``compare``, every trainer's per-epoch loss and metric
    against the serial run's, within VMAP_TOL of their largest magnitude
    (the stacked folds' products add in another order).  Returns the stage
    wall times."""
    import numpy as np

    from icassp2022_depression_tpu_torch import cli
    from icassp2022_depression_tpu_torch.ops import rnn_cuda
    from icassp2022_depression_tpu_torch.train import trainers

    counted = _counts(rnn_cuda)
    tasks = PIPELINE_TASKS[track]
    stages = {}
    originals = {t: getattr(trainers, f"train_{t}") for t in tasks}

    def staged(task, fn):
        def run(*args, **kwargs):
            if fold_cfg is not None:
                kwargs["fold_cfg"] = fold_cfg
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            stages[task] = time.perf_counter() - t0
            return out
        return run

    for t, fn in originals.items():
        setattr(trainers, f"train_{t}", staged(t, fn))
    model = root / "ModelVmap"
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["pipeline", "--track", track, "--root", str(root),
                           "--device", "cuda", "--model-dir", str(model),
                           "--vmap-folds", *extra_argv])
    finally:
        for t, fn in originals.items():
            setattr(trainers, f"train_{t}", fn)
    _set_counts(rnn_cuda, counted)
    if rc != 0:
        fail(f"cli pipeline --track {track} --vmap-folds returned {rc}")

    def epochs(path):
        return [json.loads(line) for line in path.read_text().splitlines()
                if json.loads(line)["event"] == "epoch"]

    got = epochs(model / f"pipeline_{track}_metrics.jsonl")
    want = epochs(root / "Model" / f"pipeline_{track}_metrics.jsonl")
    keys = ("loss", "f1") if track == "clf" else ("loss", "mae")
    worst = 0.0
    if len(got) != len(want) or not all(
            _finite(r[k]) for r in got for k in keys):
        fail(f"--vmap-folds {track}: {len(got)} epochs logged against "
             f"{len(want)}, or non-finite metrics")
    if compare:
        for k in keys:
            a = np.array([r[k] for r in got])
            b = np.array([r[k] for r in want])
            worst = max(worst, float(np.abs(a - b).max()
                                     / max(1e-12, np.abs(b).max())))
        if worst > VMAP_TOL:
            fail(f"--vmap-folds {track} differs from the serial run: "
                 f"{worst}")
    print(f"cli pipeline --track {track} --vmap-folds: {len(got)} epochs "
          + (f"logged, max|d {'/'.join(keys)}| {worst:.3e} of the largest "
             f"against the serial run (tol {VMAP_TOL})" if compare else
             "logged, finite")
          + "; stage wall " + ", ".join(f"{t} {v:.2f} s"
                                        for t, v in stages.items())
          + f" [{card}]")
    return stages


def _artifacts(checkpoints, model: Path, task: str, r: dict) -> list:
    """The files the JAX package's trainers write for a gated fold, the
    npz first."""
    branch, track = task.split("_")
    sub = {"audio": "Audio", "text": "Text", "fuse": "Fuse"}[branch]
    if track == "clf":
        f1, fold = r["f1"], r["fold"]
        name = (checkpoints.audio_clf_name(256, 256, f1, fold)
                if branch == "audio" else
                checkpoints.text_clf_name(128, f1, fold)
                if branch == "text" else checkpoints.fuse_clf_name(f1, fold))
        d = model / "ClassificationWhole" / sub
        return [d / f"{name}.npz", d / f"{name}.json",
                d / "train_idxs_{:.2f}_{}.npy".format(f1, fold)]
    mae = r["mae"]
    name = (checkpoints.audio_reg_name(256, 256, mae) if branch == "audio"
            else checkpoints.text_reg_name(128, mae) if branch == "text"
            else checkpoints.fuse_reg_name(mae))
    d = model / "Regression" / f"{sub}{r['fold']}"
    return [d / f"{name}.npz", d / f"{name}.json"]


def _fold_run(torch, tcfg, data, device, graph=None):
    """One branch fold through the trainers' own pieces (fold 1's init and
    dropout key of seed 0; on the card the CUDA graph route, or the eager
    one with ``graph=False``); returns the per-step losses and the final
    params."""
    from icassp2022_depression_tpu_torch.train import loop, optim, trainers

    model = trainers.init_model(tcfg, 0, 1, device)
    opt = optim.build(tcfg.optimizer, model)
    _, _, step_losses = loop.run_fold(
        model, opt, *loop.model_fns(model, trainers._branch_fns(tcfg)), data,
        tcfg.track, tcfg.gate, tcfg.epochs,
        trainers.dropout_key(0, 1, device), graph)
    return step_losses, {k: v.cpu() for k, v in model.state_dict().items()}


def _fusion_fold_run(torch, fcfg, tcfg, data, branch, device, graph=None):
    """One fusion fold as ``trainers._run_fusion_folds`` runs it (branch
    init, the test split's features once, only fc_final trains)."""
    from icassp2022_depression_tpu_torch.models.fusion import FusionNet
    from icassp2022_depression_tpu_torch.ops import prng
    from icassp2022_depression_tpu_torch.train import loop, optim, trainers

    model = FusionNet(fcfg, prng.prng_key(0)).to(device)
    model.init_from_branches(*branch, tcfg.track)
    opt = optim.build(tcfg.optimizer, model)
    data = trainers._head_test_split(model, data)
    _, _, step_losses = loop.run_fold(
        model, opt, *trainers._fusion_fns(model, tcfg), data, tcfg.track,
        tcfg.gate, tcfg.epochs, trainers.dropout_key(0, 1, device), graph)
    return step_losses, {k: v.cpu() for k, v in model.state_dict().items()}


def _syncs_in(torch, fn) -> int:
    """Synchronising CUDA calls made by ``fn()``, as torch's sync debug
    mode reports them."""
    import warnings

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchronizing" in str(w.message) for w in caught)


def _compare_runs(a, b, what: str, loss_scale: float = 1.0) -> tuple:
    (la, pa), (lb, pb) = a, b
    d_loss = float(abs(la - lb).max())
    scale = max(float(v.abs().max()) for v in pb.values())
    d_param = max(float((pa[k] - pb[k]).abs().max()) for k in pb)
    print(f"{what}: {la.size} steps, max|d step loss| = {d_loss:.3e} (tol "
          f"{TRAIN_TOL * loss_scale:.3e}), max|d param| = {d_param:.3e} (tol "
          f"{TRAIN_TOL} x max|param| = {TRAIN_TOL * scale:.3e})")
    if not (d_loss <= TRAIN_TOL * loss_scale
            and d_param <= TRAIN_TOL * scale):
        fail(f"{what} differ: loss {d_loss}, params {d_param}")
    return d_loss, d_param


def _plain(tcfg, C):
    return C.replace(tcfg, model=C.replace(tcfg.model, rnn_backend="torch"))


def _no_kernel(rnn_cuda, fn):
    """``fn()``, failing if it launched any recurrence kernel (its
    dropout masks are threefry draws, as on every route)."""
    before = _counts(rnn_cuda)
    out = fn()
    after = _counts(rnn_cuda)
    if any(after[k] != before[k] for k in after if k != "threefry"):
        fail("the plain recurrence launched a kernel")
    return out


def step_split(torch, tcfg, data, card: str, what: str,
               steps: int = 60) -> dict:
    """Median ms of a train step's forward (+ loss), backward and optimizer
    step, CUDA events between the phases, after 10 warm steps."""
    from icassp2022_depression_tpu_torch.train import optim, trainers

    model = trainers.init_model(tcfg, 0, 1, "cuda").train()
    opt = optim.build(tcfg.optimizer, model)
    loss_fn = trainers._branch_fns(tcfg)
    key = trainers.dropout_key(0, 1, "cuda")
    n_steps = -(-data.n_train // data.train_y.shape[1])
    marks = []
    for i in range(steps + 10):
        j = i % n_steps
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model(data.train_x[0][j], key), data.train_y[j],
                       data.train_mask[j])
        ev[1].record()
        loss.backward()
        ev[2].record()
        opt.step()
        ev[3].record()
        if i >= 10:
            marks.append(ev)
    torch.cuda.synchronize()
    split = {name: statistics.median(m[k].elapsed_time(m[k + 1])
                                     for m in marks)
             for k, name in enumerate(("forward", "backward", "optimizer"))}
    split["step"] = statistics.median(m[0].elapsed_time(m[3])
                                      for m in marks)
    print(f"timing {what} train step (batch {data.train_y.shape[1]}): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items())
          + f" (median of {steps}, CUDA events between phases) [{card}]")
    return split


def extract_text_run(torch, card: str, corpus: Path, out: Path,
                     bundle: Path) -> dict:
    """``cli extract-text`` of ``corpus`` with the seeded bundle on the
    card, counted: exactly 2 layers x 2 directions of ``lstmp_fwd`` per
    sentence batch of 128 and nothing else.  Checks the npz files and the
    provenance sidecar, then holds the card's pooled features of the first
    speakers against the same bundle on the CPU (not counted).  Returns
    the launches, the wall time and the card-vs-CPU difference."""
    import numpy as np

    from icassp2022_depression_tpu_torch import cli
    from icassp2022_depression_tpu_torch.data import eatd
    from icassp2022_depression_tpu_torch.frontend import text as tfe
    from icassp2022_depression_tpu_torch.models import elmo_pretrained as ep
    from icassp2022_depression_tpu_torch.ops import rnn_cuda

    texts = [sp.texts for sp in eatd.iter_speakers(corpus, read_text=True)]
    n_batches = -(-3 * len(texts) // 128)
    buf = io.StringIO()
    _set_counts(rnn_cuda, ZERO)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["extract-text", "--root", str(corpus), "--out",
                       str(out), "--elmo-weights", str(bundle),
                       "--segmenter", "fallback", "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = _counts(rnn_cuda)
    if rc != 0:
        fail(f"cli extract-text returned {rc}")
    want = dict(DRAWN, lstmp_fwd=4 * n_batches)
    print(f"cli extract-text: {buf.getvalue().strip()}; {3 * len(texts)} "
          f"answers in {n_batches} batch(es), kernel launches {got}; wall "
          f"{wall:.2f} s [{card}]")
    if not _held(got, want):
        fail(f"cli extract-text launched {got}, expected {want}")
    feats = np.load(out / "whole_samples_clf_avg.npz")["arr_0"]
    if feats.shape != (len(texts), 3, 1024) or not np.isfinite(feats).all():
        fail(f"extract-text features malformed: {feats.shape}")
    labels = np.load(out / "whole_labels_clf_avg.npz")["arr_0"]
    means = [feats[labels == k].reshape(-1, feats.shape[-1]).mean(0)
             for k in (0, 1)]
    print(f"extract-text class separation: |mean(depressed) - "
          f"mean(not)| / |mean(not)| = "
          f"{np.linalg.norm(means[1] - means[0]) / np.linalg.norm(means[0]):.4e}"
          f", max per-dimension gap {np.abs(means[1] - means[0]).max():.4e}")
    meta = json.loads((out / "extraction_meta.json").read_text())
    if meta["embedder"] != bundle_id(bundle) or \
            meta["segmenter"] != "fallback":
        fail(f"extraction_meta.json: {meta}")
    pe_cpu = ep.load_npz(bundle, "cpu")
    n = 3
    cpu = pe_cpu.embed_sentences([tfe.tokenize(t, "fallback")
                                  for ts in texts[:n] for t in ts]).numpy()
    card_rows = feats[:n].reshape(3 * n, -1)
    err = float(np.abs(card_rows - cpu).max() / np.abs(cpu).max())
    print(f"extract-text pooled features of {n} speakers, card vs CPU: "
          f"max|d| = {err:.3e} of max|CPU| (tol {SLICE_TOL})")
    if not err <= SLICE_TOL:
        fail(f"extract-text on the card differs from the CPU: {err}")
    return {"launches": got, "wall_s": wall, "cpu_err": err}


def train_phase(torch, card: str, corpus: Path, bundle: Path):
    """The training paths, counted (``cli extract-text`` with the seeded
    bundle, the clf pipeline at the full recipes on its features, ``cli
    train --corpus`` and ``cli pipeline --track reg --corpus`` at reduced
    epochs), then the comparisons and timings.  Returns the counted
    launches."""
    from icassp2022_depression_tpu_torch import cli
    from icassp2022_depression_tpu_torch import config as C
    from icassp2022_depression_tpu_torch.data import folds
    from icassp2022_depression_tpu_torch.frontend import audio as afe
    from icassp2022_depression_tpu_torch.ops import rnn_cuda
    from icassp2022_depression_tpu_torch.train import trainers

    launches = dict(ZERO)
    embedder = bundle_id(bundle)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        t0 = time.perf_counter()
        feats, sds, clf = afe.extract_eatd_device(corpus, device="cuda")
        torch.cuda.synchronize()
        extract_s = time.perf_counter() - t0
        root = Path(tmp) / "npz"
        write_audio_npz(root, feats, sds, clf)
        print(f"extract_eatd_device: {feats.shape[0]} speakers "
              f"({int(clf.sum())} depressed), {extract_s:.2f} s; audio npz "
              f"written [{card}]")

        # -- main path: cli extract-text, then the clf pipeline on its
        # features at the full recipes ---------------------------------
        text = extract_text_run(torch, card, corpus,
                                root / "Features" / "TextWhole", bundle)
        for k, v in text["launches"].items():
            launches[k] += v
        clf_run = pipeline_run(torch, root, "clf", card, embedder)
        for k, v in clf_run["launches"].items():
            launches[k] += v
        # the same pipeline with --vmap-folds: its stage times (170 /
        # 150 epochs part float32 trajectories too far to compare)
        clf_run["vmap_stage_s"] = vmap_pipeline_run(torch, root, "clf",
                                                    card, compare=False)

        # -- cli train --task audio_clf --corpus, reduced epochs, gates
        # open: every fold saves, for phase 6's cli check ------------------
        full = {n: getattr(C, n) for n in
                ("AUDIO_CLF", "AUDIO_REG", "TEXT_REG", "FUSE_REG_TRAINER")}
        try:
            C.AUDIO_CLF = C.replace(
                full["AUDIO_CLF"], epochs=REDUCED_EPOCHS + 1,
                gate=C.replace(full["AUDIO_CLF"].gate, f1_floor=-1.0,
                               train_acc_frac=0.0, train_acc_strict=False))
            _set_counts(rnn_cuda, ZERO)
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["train", "--task", "audio_clf", "--root",
                               str(corpus), "--corpus", str(corpus),
                               "--device", "cuda"])
            torch.cuda.synchronize()
            corpus_wall = time.perf_counter() - t0
            got = _counts(rnn_cuda)
            if rc != 0:
                fail(f"cli train returned {rc}")
            records = [json.loads(line) for line in
                       (corpus / "Model" / "audio_clf_metrics.jsonl")
                       .read_text().splitlines()]
            epochs = [r for r in records if r["event"] == "epoch"]
            if len(epochs) != 3 * REDUCED_EPOCHS or not all(
                    _finite(r["loss"]) for r in epochs):
                fail(f"cli train audio_clf logged {len(epochs)} epochs")
            _check_launches("audio_clf (cli train --corpus)", got,
                            *warmed(epochs), 3)
            gated = [r for r in records
                     if r["event"] == "fold_best" and r["epoch"] >= 0]
            if len(gated) != 3:
                fail(f"cli train audio_clf --corpus: {len(gated)} of 3 "
                     "folds gated with the gates open")
            for k, v in got.items():
                launches[k] += v
            print(f"cli train audio_clf --corpus, 3 folds x "
                  f"{REDUCED_EPOCHS} epochs: wall {corpus_wall:.2f} s "
                  f"(extraction + folds) [{card}]")

            # -- cli pipeline --track reg, reduced epochs, gates open:
            # every fold saves, so the sidecars of the text and fusion
            # checkpoints trained on the --corpus extraction are checked
            for n in ("AUDIO_REG", "TEXT_REG", "FUSE_REG_TRAINER"):
                setattr(C, n, C.replace(
                    full[n], epochs=REDUCED_EPOCHS + 1,
                    gate=C.replace(full[n].gate, mae_ceiling=1e9,
                                   train_mae_ceiling=1e9)))
            cut = C.FoldConfig.sds_threshold
            n_dep, n_non = int((sds >= cut).sum()), int((sds < cut).sum())
            fold_cfg = C.FoldConfig(reg_test_dep=n_dep // 3,
                                    reg_test_non=n_non // 3)
            # beside the corpus, so that phase 6 checks its checkpoints
            reg_run = pipeline_run(
                torch, corpus.parent / "reg", "reg", card, embedder, fold_cfg,
                ["--corpus", str(corpus), "--elmo-weights", str(bundle),
                 "--segmenter", "fallback"],
                {"lstmp_fwd": text["launches"]["lstmp_fwd"]},
                all_gated=True)
            for k, v in reg_run["launches"].items():
                launches[k] += v
            reg_run.update(root=corpus.parent / "reg", fold_cfg=fold_cfg)
            reg_run["vmap_stage_s"] = vmap_pipeline_run(
                torch, corpus.parent / "reg", "reg", card, fold_cfg,
                ["--corpus", str(corpus), "--elmo-weights", str(bundle),
                 "--segmenter", "fallback"])
        finally:
            for n, v in full.items():
                setattr(C, n, v)

        # -- comparisons, not counted --------------------------------------
        counted = _counts(rnn_cuda)
        train_idx = folds.generate_clf_folds(clf, 3, seed=0)
        data = trainers._clf_fold_datas([feats], clf, train_idx, 8)[0]
        base = C.replace(C.AUDIO_CLF, epochs=COMPARE_EPOCHS + 1)
        # the fold loop never waits for the card: a fold's host syncs (set
        # up and the one readback) do not grow with its epochs
        runs, syncs = {}, {}
        for n in (1, COMPARE_EPOCHS):
            cfg = C.replace(base, epochs=n + 1)
            syncs[n] = _syncs_in(torch, lambda: runs.__setitem__(
                n, _fold_run(torch, cfg, data, "cuda")))
        print(f"host syncs of an audio_clf fold: {syncs[1]} at 1 epoch, "
              f"{syncs[COMPARE_EPOCHS]} at {COMPARE_EPOCHS} epochs "
              "(torch.cuda sync debug mode)")
        if syncs[1] != syncs[COMPARE_EPOCHS]:
            fail("the fold loop synchronises with the card inside its "
                 "epochs")
        cmp = {}
        cmp["audio_clf"] = _compare_runs(
            runs[COMPARE_EPOCHS], _no_kernel(rnn_cuda, lambda: _fold_run(
                torch, _plain(base, C), data, "cuda")),
            f"{COMPARE_EPOCHS}-epoch audio_clf fold, dropout 0.5, kernels vs "
            "plain recurrence on the card")
        cpu_data = trainers._clf_fold_datas([feats.cpu()], clf, train_idx,
                                            8)[0]
        cmp["audio_clf_cpu"] = _compare_runs(
            runs[COMPARE_EPOCHS], _fold_run(torch, base, cpu_data, "cpu"),
            f"{COMPARE_EPOCHS}-epoch audio_clf fold, dropout 0.5 (the same "
            "threefry masks), card vs CPU")
        dep, non = folds.generate_reg_shuffles(sds, seed=0)
        reg_data = trainers._reg_fold_datas(
            [feats], sds, dep, non, C.AUDIO_REG.batch_size, fold_cfg)[0]
        reg_base = C.replace(C.AUDIO_REG, epochs=COMPARE_EPOCHS + 1)
        reg_plain_run = _no_kernel(rnn_cuda, lambda: _fold_run(
            torch, _plain(reg_base, C), reg_data, "cuda"))
        cmp["audio_reg"] = _compare_runs(
            _fold_run(torch, reg_base, reg_data, "cuda"), reg_plain_run,
            f"{COMPARE_EPOCHS}-epoch audio_reg fold, dropout 0.5, kernels vs "
            "plain recurrence on the card",
            loss_scale=max(1.0, float(abs(reg_plain_run[0]).max())))
        # the text branch: batch 4, BiLSTM x 2 layers, attention, xavier
        import numpy as np

        xt = torch.as_tensor(np.load(root / "Features" / "TextWhole" /
                                     "whole_samples_clf_avg.npz")["arr_0"],
                             device="cuda")
        text_data = trainers._clf_fold_datas([xt], clf, train_idx, 4)[0]
        text_base = C.replace(C.TEXT_CLF, epochs=COMPARE_EPOCHS + 1)
        cmp["text_clf"] = _compare_runs(
            _fold_run(torch, text_base, text_data, "cuda"),
            _no_kernel(rnn_cuda, lambda: _fold_run(
                torch, _plain(text_base, C), text_data, "cuda")),
            f"{COMPARE_EPOCHS}-epoch text_clf fold, dropout 0.5, kernels vs "
            "plain recurrence on the card")
        cmp["text_clf_cpu"] = _compare_runs(
            _fold_run(torch, text_base, text_data, "cuda"),
            _fold_run(torch, text_base, trainers._clf_fold_datas(
                [xt.cpu()], clf, train_idx, 4)[0], "cpu"),
            f"{COMPARE_EPOCHS}-epoch text_clf fold, dropout 0.5 (the same "
            "threefry masks), card vs CPU")
        # the fusion: frozen branches (random, seeded), only fc_final trains
        fuse_data = trainers._clf_fold_datas([feats, xt], clf, train_idx,
                                             2)[0]
        branch = (trainers.init_model(C.TEXT_CLF, 0, 1, "cuda").state_dict(),
                  trainers.init_model(C.AUDIO_CLF, 0, 1,
                                      "cuda").state_dict())
        fuse_t = C.replace(C.FUSE_CLF_TRAINER, epochs=COMPARE_EPOCHS + 1)
        cmp["fuse_clf"] = _compare_runs(
            _fusion_fold_run(torch, C.FUSE_CLF, fuse_t, fuse_data, branch,
                             "cuda"),
            _no_kernel(rnn_cuda, lambda: _fusion_fold_run(
                torch, C.replace(C.FUSE_CLF, rnn_backend="torch"), fuse_t,
                fuse_data, branch, "cuda")),
            f"{COMPARE_EPOCHS}-epoch fuse_clf fold, dropout 0.3, kernels vs "
            "plain recurrence on the card")
        split = {"audio_clf": step_split(torch, C.AUDIO_CLF, data, card,
                                         "audio_clf"),
                 "text_clf": step_split(torch, C.TEXT_CLF, text_data, card,
                                        "text_clf")}
        _set_counts(rnn_cuda, counted)
        split["graph"] = trainer_phase(torch, rnn_cuda, card, feats, clf, xt)
    return launches, {"clf": clf_run, "reg": reg_run, "extract_s": extract_s,
                      "text": text, "corpus_wall_s": corpus_wall,
                      "split": split, "cmp": cmp}


def _transcripts(rng, chars, n: int) -> list:
    """n speakers' 3 answers of 20-120 CJK characters each."""
    return [["".join(rng.choice(chars, int(rng.integers(20, 121))))
             for _ in range(3)] for _ in range(n)]


def text_serving_phase(torch, card: str, bundle: Path, chars) -> tuple:
    """Serving ``fuse_clf`` and ``text_clf`` through the text frontend on
    the card, with full-width seeded checkpoints whose sidecars name the
    bundle (found through ``ICASSP_ELMO_WEIGHTS``, as a user sets it).
    Counted: ``cli predict`` of one speaker per task, then
    ``Predictor.predict_batch`` (``fuse_clf``) at 1 and 8 speakers with
    seeded transcripts, each with exact launches (4 ``lstmp_fwd`` per
    sentence batch, the fusion's 4 LSTM and 2 GRU forwards, no backward;
    ``predict_batch``'s threefry draws, 6 a wav2vlad bucket).
    Not counted: the same ``cli predict`` and the 8 speakers'
    ``predict_batch`` and text features on the CPU, which must agree, and
    the warm latencies.  Returns the launches and the latencies."""
    import os

    import numpy as np

    from icassp2022_depression_tpu_torch.ops import prng
    from icassp2022_depression_tpu_torch import cli
    from icassp2022_depression_tpu_torch import config as C
    from icassp2022_depression_tpu_torch.data import eatd
    from icassp2022_depression_tpu_torch.models import porting
    from icassp2022_depression_tpu_torch.models.fusion import FusionNet
    from icassp2022_depression_tpu_torch.models.text_net import TextNet
    from icassp2022_depression_tpu_torch.ops import rnn_cuda
    from icassp2022_depression_tpu_torch.serving.predictors import Predictor
    from icassp2022_depression_tpu_torch.train import checkpoints

    launches = dict(ZERO)
    per_request = {"fuse_clf": dict(DRAWN, lstmp_fwd=4, lstmp_fwd_resident=4,
                                    lstm_fwd=4, gru_fwd=2),
                   "text_clf": dict(DRAWN, lstmp_fwd=4, lstmp_fwd_resident=4,
                                    lstm_fwd=4)}
    before_env = os.environ.get("ICASSP_ELMO_WEIGHTS")
    os.environ["ICASSP_ELMO_WEIGHTS"] = str(bundle)
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_text_") as tmp:
            root = Path(tmp) / "corpus"
            eatd.make_synthetic_corpus(root, n_data=6, n_validation=2,
                                       seconds=(2.0, 12.0), seed=4)
            meta = {"text_embedder": bundle_id(bundle),
                    "text_segmenter": "fallback", "note": "seeded weights"}
            ckpts = {
                "fuse_clf": checkpoints.save(
                    Path(tmp) / "fuse_clf", porting.fusion_tree_from_state_dict(
                        FusionNet(C.FUSE_CLF, prng.prng_key(6)).state_dict(),
                        C.FUSE_CLF),
                    dict(meta, task="fuse_clf")),
                "text_clf": checkpoints.save(
                    Path(tmp) / "text_clf", porting.text_net_tree_from_state_dict(
                        TextNet(C.TEXT_CLF.model, prng.prng_key(7)).state_dict(),
                        C.TEXT_CLF.model), dict(meta, task="text_clf"))}
            sp = eatd.load_speaker(root, "Data", 1)
            for task, ckpt in ckpts.items():
                buf = io.StringIO()
                _set_counts(rnn_cuda, ZERO)
                with contextlib.redirect_stdout(buf), \
                        contextlib.redirect_stderr(io.StringIO()):
                    rc = cli.main(["predict", "--task", task, "--ckpt",
                                   str(ckpt), "--root", str(root),
                                   "--speaker", "Data/1", "--device",
                                   "cuda"])
                torch.cuda.synchronize()
                got = _counts(rnn_cuda)
                if rc != 0:
                    fail(f"cli predict --task {task} returned {rc}")
                out = json.loads(buf.getvalue().strip().splitlines()[-1])
                print(f"cli predict --task {task} Data/1: {json.dumps(out)} "
                      f"(kernel launches {got})")
                if not _held(got, per_request[task]):
                    fail(f"cli predict --task {task} launched {got}, "
                         f"expected {per_request[task]}")
                check_results([out], 1, f"cli predict {task}")
                for k, v in got.items():
                    launches[k] += v
                with contextlib.redirect_stderr(io.StringIO()):
                    cpu = Predictor.from_checkpoint(ckpt, task, device="cpu")
                kw = {"texts": sp.texts}
                if task == "fuse_clf":
                    kw.update(waveforms=sp.waveforms,
                              sample_rates=sp.sample_rates,
                              ordinal_base=3 * eatd.corpus_position(
                                  root, "Data", 1))
                d = compare([out], [cpu.predict_speaker(**kw)],
                            f"cli predict {task} vs CPU")
                print(f"cli predict --task {task} vs the same predictor on "
                      f"the CPU: max|dprob| = {d:.3e} (tol {SLICE_TOL})")

            # -- Predictor.predict_batch, fuse_clf, 1 and 8 speakers --------
            speakers = list(eatd.iter_speakers(root, read_text=False))
            rng = np.random.default_rng(7)
            with contextlib.redirect_stderr(io.StringIO()):
                predictor = Predictor.from_checkpoint(
                    ckpts["fuse_clf"], "fuse_clf", device="cuda",
                    feature_cache_entries=0)
            latency, served = {}, {}
            for n in (1, 8):
                req = ([s.waveforms for s in speakers[:n]],
                       [s.sample_rates for s in speakers[:n]],
                       _transcripts(rng, chars, n))
                _set_counts(rnn_cuda, ZERO)
                res = predictor.predict_batch(*req)
                torch.cuda.synchronize()
                got = _counts(rnn_cuda)
                want = dict(per_request["fuse_clf"],
                            threefry=wav2vlad_draws(*req[:2]))
                print(f"predict_batch fuse_clf {n} speakers: kernel launches "
                      f"{got}")
                if not _held(got, want):
                    fail(f"predict_batch({n}) fuse_clf launched {got}, "
                         f"expected {want}")
                check_results(res, n, f"predict_batch fuse_clf ({n})")
                served[n] = (req, res)
                for k, v in got.items():
                    launches[k] += v
                counted = _counts(rnn_cuda)
                times = []
                for _ in range(6):
                    t0 = time.perf_counter()
                    predictor.predict_batch(*req)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                latency[n] = statistics.median(times[1:])
                _set_counts(rnn_cuda, counted)
                n_chars = sum(len(t) for ts in req[2] for t in ts)
                print(f"timing predict_batch fuse_clf {n} speakers "
                      f"({n_chars} transcript characters, features not "
                      f"cached): median {latency[n]:.2f} ms of 5 warm "
                      f"(host clock) [{card}]")

            # -- the 8 speakers' long transcripts (T up to 128) on the
            # CPU, not counted: results and text features equal ----------
            counted = _counts(rnn_cuda)
            req, res = served[8]
            with contextlib.redirect_stderr(io.StringIO()):
                cpu = Predictor.from_checkpoint(
                    ckpts["fuse_clf"], "fuse_clf", device="cpu",
                    feature_cache_entries=0)
            d = compare(res, cpu.predict_batch(*req),
                        "predict_batch fuse_clf (8) vs CPU")
            want = cpu.text_features(req[2])
            err = float(np.abs(predictor.text_features(req[2]) - want).max()
                        / np.abs(want).max())
            _set_counts(rnn_cuda, counted)
            print(f"predict_batch fuse_clf 8 speakers vs the same predictor "
                  f"on the CPU: max|dprob| = {d:.3e} (tol {SLICE_TOL}); "
                  f"text features max|d| = {err:.3e} of max|CPU| (tol "
                  f"{SLICE_TOL})")
            if not err <= SLICE_TOL:
                fail(f"served text features on the card differ from the "
                     f"CPU's: {err}")
    finally:
        if before_env is None:
            os.environ.pop("ICASSP_ELMO_WEIGHTS", None)
        else:
            os.environ["ICASSP_ELMO_WEIGHTS"] = before_env
    return launches, latency


def standin_serving_phase(torch, card: str) -> tuple:
    """Serving ``text_clf`` and ``fuse_clf`` through the seeded stand-in
    text encoder (``elmo_weights=None``: the path of every machine without
    an ELMo bundle), full-width seeded checkpoints.  Counted:
    ``Predictor.predict_batch`` at 1 and 8 speakers with seeded
    transcripts, each with exact launches (the stand-in's 2 layers x 2
    directions of ``lstm_fwd`` and the text model's 4, the fusion's 2 GRU
    forwards, no backward, the fusion's threefry draws 6 a wav2vlad
    bucket and the text model's none).  Not counted: the warm latencies,
    and the 8
    speakers' ``text_clf`` results and text features against the same
    predictor on the CPU.  Returns the launches and the latencies."""
    import numpy as np

    from icassp2022_depression_tpu_torch.ops import prng
    from icassp2022_depression_tpu_torch import config as C
    from icassp2022_depression_tpu_torch.data import eatd
    from icassp2022_depression_tpu_torch.models import porting
    from icassp2022_depression_tpu_torch.models.fusion import FusionNet
    from icassp2022_depression_tpu_torch.models.text_net import TextNet
    from icassp2022_depression_tpu_torch.ops import rnn_cuda
    from icassp2022_depression_tpu_torch.serving.predictors import Predictor
    from icassp2022_depression_tpu_torch.train import checkpoints

    launches = dict(ZERO)
    per_request = {"fuse_clf": dict(ZERO, lstm_fwd=8, gru_fwd=2),
                   "text_clf": dict(ZERO, lstm_fwd=8)}
    latency = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_standin_") as tmp:
        root = Path(tmp) / "corpus"
        eatd.make_synthetic_corpus(root, n_data=8, n_validation=2,
                                   seconds=(2.0, 12.0), seed=4)
        speakers = list(eatd.iter_speakers(root, read_text=True))
        chars = sorted({ch for sp in speakers for t in sp.texts for ch in t
                        if not ch.isspace()})
        meta = {"text_embedder": "prng:seed=0", "text_segmenter": "fallback",
                "note": "seeded weights"}
        trees = {"fuse_clf": porting.fusion_tree_from_state_dict(
                     FusionNet(C.FUSE_CLF, prng.prng_key(6)).state_dict(),
                     C.FUSE_CLF),
                 "text_clf": porting.text_net_tree_from_state_dict(
                     TextNet(C.TEXT_CLF.model, prng.prng_key(7)).state_dict(),
                     C.TEXT_CLF.model)}
        rng = np.random.default_rng(8)
        texts = _transcripts(rng, chars, 8)
        for task, tree in trees.items():
            ckpt = checkpoints.save(Path(tmp) / task, tree,
                                    dict(meta, task=task))
            with contextlib.redirect_stderr(io.StringIO()):
                predictor = Predictor.from_checkpoint(
                    ckpt, task, device="cuda", feature_cache_entries=0,
                    elmo_weights=None)
            if predictor.embedder_id != "prng:seed=0":
                fail(f"{task} served with {predictor.embedder_id}, not the "
                     f"stand-in")
            for n in (1, 8):
                req = (None, None, texts[:n])
                if task == "fuse_clf":
                    req = ([sp.waveforms for sp in speakers[:n]],
                           [sp.sample_rates for sp in speakers[:n]],
                           texts[:n])
                _set_counts(rnn_cuda, ZERO)
                res = predictor.predict_batch(*req)
                torch.cuda.synchronize()
                got = _counts(rnn_cuda)
                want = dict(per_request[task],
                            threefry=wav2vlad_draws(*req[:2]))
                print(f"predict_batch {task} {n} speakers (stand-in "
                      f"encoder): kernel launches {got}")
                if not _held(got, want):
                    fail(f"predict_batch({n}) {task} with the stand-in "
                         f"launched {got}, expected {want}")
                check_results(res, n, f"predict_batch {task} stand-in ({n})")
                for k, v in got.items():
                    launches[k] += v
                counted = _counts(rnn_cuda)
                times = []
                for _ in range(6):
                    t0 = time.perf_counter()
                    predictor.predict_batch(*req)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                latency[(task, n)] = statistics.median(times[1:])
                _set_counts(rnn_cuda, counted)
                n_chars = sum(len(t) for ts in texts[:n] for t in ts)
                print(f"timing predict_batch {task} {n} speakers (stand-in "
                      f"encoder, {n_chars} transcript characters, features "
                      f"not cached): median {latency[(task, n)]:.2f} ms of 5 "
                      f"warm (host clock) [{card}]")
            if task == "text_clf":
                counted = _counts(rnn_cuda)
                with contextlib.redirect_stderr(io.StringIO()):
                    cpu = Predictor.from_checkpoint(
                        ckpt, task, device="cpu", feature_cache_entries=0,
                        elmo_weights=None)
                d = compare(res, cpu.predict_batch(*req),
                            "predict_batch text_clf stand-in (8) vs CPU")
                want = cpu.text_features(texts)
                err = float(np.abs(predictor.text_features(texts) - want)
                            .max() / np.abs(want).max())
                _set_counts(rnn_cuda, counted)
                print(f"predict_batch text_clf 8 speakers (stand-in encoder) "
                      f"vs the same predictor on the CPU: max|dprob| = "
                      f"{d:.3e} (tol {SLICE_TOL}); text features max|d| = "
                      f"{err:.3e} of max|CPU| (tol {SLICE_TOL})")
                if not err <= SLICE_TOL:
                    fail(f"stand-in text features on the card differ from "
                         f"the CPU's: {err}")
    return launches, latency


class RefAudioBiLSTM(torch.nn.Module):
    """The reference's audio classifier as it pickles
    (``Classification/audio_gru_whole.py:24-108`` names, full width).  It
    is defined only here, so ``torch.save`` of it pickles a class that no
    other code defines, as a reference user's checkpoint does."""

    def __init__(self, d: int = 256, h: int = 256):
        super().__init__()
        nn = torch.nn
        self.attention_layer = nn.Sequential(nn.Linear(h, h),
                                             nn.ReLU(inplace=True))
        self.lstm_net_audio = nn.GRU(d, h, num_layers=2, batch_first=True)
        self.ln = nn.LayerNorm(d)
        self.fc_audio = nn.Sequential(
            nn.Dropout(0.5), nn.Linear(h, h), nn.ReLU(), nn.Dropout(0.5),
            nn.Linear(h, 2), nn.Softmax(dim=1))


class RefFusionReg(torch.nn.Module):
    """The reference's regression fusion as it pickles
    (``Regression/fuse_net.py:325-351`` names: no ``ln``, one output)."""

    def __init__(self, ae: int = 256, te: int = 1024, ah: int = 256,
                 th: int = 128):
        super().__init__()
        nn = torch.nn
        self.attention_layer = nn.Sequential(nn.Linear(th, th),
                                             nn.ReLU(inplace=True))
        self.lstm_net = nn.LSTM(te, th, num_layers=2, bidirectional=True)
        self.fc_out = nn.Sequential(nn.Dropout(0.5), nn.Linear(th, th),
                                    nn.ReLU(), nn.Dropout(0.5))
        self.lstm_net_audio = nn.GRU(ae, ah, num_layers=2, batch_first=True)
        self.fc_audio = nn.Sequential(nn.Dropout(0.5), nn.Linear(ah, ah),
                                      nn.ReLU(), nn.Dropout(0.5))
        self.modal_attn = nn.Linear(th + ah, th + ah, bias=False)
        self.fc_final = nn.Sequential(nn.Linear(th + ah, 1, bias=False),
                                      nn.ReLU())


#: kernel launches of one check fold's forward, by branch
CHECK_FOLD = {"audio": dict(DRAWN, gru_fwd=2),
              "text": dict(DRAWN, lstm_fwd=4),
              "fuse": dict(DRAWN, lstm_fwd=4, gru_fwd=2)}


def check_launches(task: str, n_answers: int = 0) -> dict:
    """A three-fold ``cli check``'s launches: each fold's forward, plus,
    for the text and fusion tasks with ``--corpus``, the text extraction
    of ``n_answers`` answers (4 ``lstmp_fwd`` a batch of 128)."""
    branch = task.split("_")[0]
    want = {k: 3 * v for k, v in CHECK_FOLD[branch].items()}
    if branch != "audio" and n_answers:
        want["lstmp_fwd"] = 4 * -(-n_answers // 128)
    return want


def _fold_ckpt(directory: Path, pattern: str) -> Path:
    found = sorted(directory.glob(pattern))
    if len(found) != 1:
        fail(f"expected one checkpoint {directory}/{pattern}, found {found}")
    return found[0]


def _nan_as_zero(x: float) -> float:
    """The trainers' gate counts a 0/0 precision (no positive prediction)
    as 0 on the device, the host's metrics as nan."""
    return 0.0 if x != x else x


def _rows_diff(rows, base) -> float:
    """The largest difference between two ``cli check`` outputs' numbers
    (each fold's line and the mean's)."""
    def numbers(row):
        return [_nan_as_zero(float(v)) for v in row.get("mean", row).values()]
    return max(abs(a - b) for ra, rb in zip(rows, base)
               for a, b in zip(numbers(ra), numbers(rb)))


def _output(pred: dict) -> list:
    return pred["probs"] if "probs" in pred else [pred["sds_score"]]


@contextlib.contextmanager
def _reg_fold_cfg(checking, fold_cfg):
    """The regression checks on ``fold_cfg`` (the reg pipeline's folds,
    cut to the corpus), as :func:`pipeline_run` hands it to the
    trainers."""
    names = ("check_audio_reg", "check_text_reg", "check_fuse_reg")
    originals = {n: getattr(checking, n) for n in names}

    def with_cfg(fn):
        def run(*args, **kwargs):
            return fn(*args, **dict(kwargs, fold_cfg=fold_cfg))
        return run

    for n, fn in originals.items():
        setattr(checking, n, with_cfg(fn))
    try:
        yield
    finally:
        for n, fn in originals.items():
            setattr(checking, n, fn)


class _Counted:
    """``cli.main`` calls with every kernel counter zeroed just before and
    read just after; each call's launches must be exactly the expected
    ones, and they add up in ``launches``."""

    def __init__(self, torch, rnn_cuda):
        self.torch, self.rnn_cuda = torch, rnn_cuda
        self.launches = dict(ZERO)

    def __call__(self, argv, want: dict, what: str):
        """Returns the call's stdout lines and wall time."""
        from icassp2022_depression_tpu_torch import cli

        argv = [str(a) for a in argv]
        if argv[0] != "export-pt":      # the one that runs no model
            argv += ["--device", "cuda"]
        buf = io.StringIO()
        _set_counts(self.rnn_cuda, ZERO)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        self.torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = _counts(self.rnn_cuda)
        if rc != 0:
            fail(f"{what} returned {rc}")
        if not _held(got, want):
            fail(f"{what} launched {got}, expected {want}")
        for k, v in got.items():
            self.launches[k] += v
        return buf.getvalue().strip().splitlines(), wall


def check_phase(torch, card: str, corpus: Path, bundle: Path,
                train: dict) -> dict:
    """Phase 6, checking and migration on the card: ``cli extract-audio``;
    ``cli check --corpus`` on phase 5's checkpoints against the metrics
    their trainers recorded, and the same checks on the CPU; the ``.pt``
    round trip; the wall times at EATD's size.  Every CLI call is counted
    with exact launches.  Returns the launches and the timings."""
    import os

    from icassp2022_depression_tpu_torch.eval import checking
    from icassp2022_depression_tpu_torch.ops import rnn_cuda

    counted = _Counted(torch, rnn_cuda)
    before_env = os.environ.get("ICASSP_ELMO_WEIGHTS")
    # cli predict of a fusion .pt finds the bundle as a user's does
    os.environ["ICASSP_ELMO_WEIGHTS"] = str(bundle)
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_check_") as tmp, \
                _reg_fold_cfg(checking, train["reg"]["fold_cfg"]):
            work = Path(tmp)
            xa, sds, clf = extract_audio_checks(counted, card, corpus, work)
            ckpts = check_corpus_checks(counted, card, corpus, bundle, train,
                                        work, sds)
            check_card_vs_cpu(torch, rnn_cuda, corpus, bundle, work, ckpts,
                              xa, sds, clf)
            pt_round_trip(torch, counted, corpus, work, ckpts)
            timing = eatd_size_timing(torch, rnn_cuda, counted, card, bundle,
                                      work)
    finally:
        if before_env is None:
            os.environ.pop("ICASSP_ELMO_WEIGHTS", None)
        else:
            os.environ["ICASSP_ELMO_WEIGHTS"] = before_env
    return dict(timing, launches=counted.launches)


def extract_audio_checks(counted, card: str, corpus: Path, work: Path):
    """``cli extract-audio`` (no kernel of the port): its clf features are
    ``extract_eatd_device``'s bitwise, 3 speakers the CPU's within
    SLICE_TOL; an incremental rerun, twice, marks every speaker 'ok' then
    'cached' and writes the CLI's npz files byte for byte.  Returns the
    host features and the targets."""
    import numpy as np

    from icassp2022_depression_tpu_torch.data import eatd
    from icassp2022_depression_tpu_torch.frontend import audio as afe

    audio_dir = work / "features" / "Features" / "AudioWhole"
    lines, wall = counted(["extract-audio", "--root", corpus, "--out",
                           audio_dir], DRAWN, "cli extract-audio")
    print(f"cli extract-audio: {lines[-1]}; wall {wall:.2f} s [{card}]")
    xa = np.load(audio_dir / "whole_samples_clf_256.npz")["arr_0"][:, :, 0]
    fused, sds, clf = afe.extract_eatd_device(corpus, device="cuda")
    if not np.array_equal(xa, fused.cpu().numpy()):
        fail("extract-audio's clf features differ from extract_eatd_device's")
    speakers = eatd.load_speakers(corpus)[:3]
    cpu = afe.extract_batch([w for sp in speakers for w in sp.waveforms],
                            [r for sp in speakers for r in sp.sample_rates],
                            ordinals=range(9), device="cpu").numpy()
    err = float(np.abs(xa[:3].reshape(9, -1) - cpu).max())
    print(f"extract-audio: clf features bitwise equal to "
          f"extract_eatd_device's; 3 speakers card vs CPU max|d| = "
          f"{err:.3e} (tol {SLICE_TOL})")
    if not err <= SLICE_TOL:
        fail(f"extract-audio on the card differs from the CPU: {err}")
    npz = [f"whole_{k}_{t}_256.npz" for k in ("samples", "labels")
           for t in ("reg", "clf")]
    inc = work / "incremental"
    for want in ("ok", "cached"):
        _, _, _, manifest = afe.extract_eatd(corpus, out_dir=inc,
                                             incremental=True, device="cuda")
        status = {m["status"] for m in manifest}
        same = all((inc / f).read_bytes() == (audio_dir / f).read_bytes()
                   for f in npz)
        if status != {want} or not same:
            fail(f"incremental extract_eatd: statuses {status} (want "
                 f"{want}), npz files equal to the CLI's: {same}")
    m_cli = json.loads((audio_dir / "manifest.json").read_text())
    m_inc = json.loads((inc / "manifest.json").read_text())
    if (m_inc["min_len_s"], m_inc["max_len_s"]) != \
            (m_cli["min_len_s"], m_cli["max_len_s"]):
        fail(f"incremental manifest durations {m_inc} vs {m_cli}")
    print(f"extract_eatd incremental=True twice: {len(manifest)} speakers "
          f"'ok' then 'cached', npz files byte-identical to the CLI's, "
          f"answer lengths {m_cli['min_len_s']:.2f}-"
          f"{m_cli['max_len_s']:.2f} s kept")
    return xa, sds, clf


def check_corpus_checks(counted, card: str, corpus: Path, bundle: Path,
                        train: dict, work: Path, sds) -> dict:
    """``cli check --corpus`` on the gated checkpoints of phase 5's ``cli
    train --task audio_clf --corpus`` and ``cli pipeline --track reg
    --corpus`` (the gates open, so each fold saved one): each fold's
    metrics must be the ones its trainer recorded in the sidecar (F1,
    precision and recall within 1e-6; MAE within SLICE_TOL of the largest
    target).  Returns the checkpoints by task."""
    import numpy as np

    from icassp2022_depression_tpu_torch.train import checkpoints

    ckpts = {"audio_clf": [_fold_ckpt(
        corpus / "Model" / "ClassificationWhole" / "Audio",
        f"BiLSTM_gru_vlad256_256_*_{f}.npz") for f in (1, 2, 3)]}
    reg_dir = train["reg"]["root"] / "Model" / "Regression"
    for task, sub in (("audio_reg", "Audio"), ("text_reg", "Text"),
                      ("fuse_reg", "Fuse")):
        ckpts[task] = [_fold_ckpt(reg_dir / f"{sub}{f}", "*.npz")
                       for f in (1, 2, 3)]
    scale = float(np.abs(sds).max())
    for task, paths in ckpts.items():
        lines, wall = counted(
            ["check", "--task", task, "--root", work, "--ckpts", *paths,
             "--corpus", corpus, "--elmo-weights", bundle, "--segmenter",
             "fallback"], check_launches(task, 3 * len(sds)),
            f"cli check --task {task} --corpus")
        rows = [json.loads(line) for line in lines]
        print(f"cli check --task {task} --corpus: {json.dumps(rows)}; wall "
              f"{wall:.2f} s [{card}]")
        worst = 0.0
        for row, path in zip(rows[:-1], paths):
            meta = checkpoints.load_meta(path)
            if task.endswith("clf"):
                d = max(abs(_nan_as_zero(row[k]) - meta[k])
                        for k in ("f1", "precision", "recall"))
                tol = 1e-6
            else:
                d, tol = abs(row["mae"] - meta["mae"]), SLICE_TOL * scale
            worst = max(worst, d)
            if not d <= tol:
                fail(f"check {task} fold {row['fold']}: {row} against the "
                     f"trainer's {meta} (tol {tol})")
        print(f"  {task}: every fold's metrics are its trainer's, max|d| = "
              f"{worst:.3e}")
    return ckpts


def check_card_vs_cpu(torch, rnn_cuda, corpus: Path, bundle: Path,
                      work: Path, ckpts: dict, xa, sds, clf) -> None:
    """Not counted: each task's check on the card and on the CPU on the
    same host features: the same metrics (clf exactly, MAE within
    SLICE_TOL of the largest target), predictions within SLICE_TOL of
    max(1, their largest magnitude).  Writes the text features for the
    ``.pt`` round trip."""
    import numpy as np

    from icassp2022_depression_tpu_torch.data import folds
    from icassp2022_depression_tpu_torch.eval import checking
    from icassp2022_depression_tpu_torch.frontend import text as tfe

    before = _counts(rnn_cuda)
    xt, _, _ = tfe.extract_eatd(
        corpus, out_dir=work / "features" / "Features" / "TextWhole",
        elmo_weights=str(bundle), segmenter="fallback", device="cuda")
    tf_idx = folds.generate_clf_folds(clf, 3, seed=0)
    dep, non = folds.generate_reg_shuffles(sds, seed=0)
    runs = {
        "audio_clf": lambda dev: checking.check_audio_clf(
            xa, clf, tf_idx, ckpts["audio_clf"], device=dev),
        "audio_reg": lambda dev: checking.check_audio_reg(
            xa, sds, dep, non, ckpts["audio_reg"], device=dev),
        "text_reg": lambda dev: checking.check_text_reg(
            xt, sds, dep, non, ckpts["text_reg"], device=dev),
        "fuse_reg": lambda dev: checking.check_fuse_reg(
            xa, xt, sds, dep, non, ckpts["fuse_reg"], device=dev)}
    scale = float(np.abs(sds).max())
    for task, run in runs.items():
        clf_task = task.endswith("clf")
        keys = (("precision", "recall", "f1", "accuracy") if clf_task
                else ("mae", "rmse"))
        d_pred = d_metric = 0.0
        for a, b in zip(run("cuda")[0], run("cpu")[0]):
            ref = max(1.0, float(np.abs(b["predictions"]).max()))
            d = float(np.abs(a["predictions"] - b["predictions"]).max()) / ref
            dm = max(abs(_nan_as_zero(a[k]) - _nan_as_zero(b[k]))
                     for k in keys)
            d_pred, d_metric = max(d_pred, d), max(d_metric, dm)
            if not (d <= SLICE_TOL
                    and dm <= (0.0 if clf_task else SLICE_TOL * scale)):
                fail(f"check {task} fold {a['fold']}, card vs CPU: "
                     f"predictions {d} of max(1, max|CPU|), metrics "
                     f"{[a[k] for k in keys]} vs {[b[k] for k in keys]}")
        print(f"check {task}, card vs CPU: predictions max|d| = "
              f"{d_pred:.3e} of max(1, max|CPU|) (tol {SLICE_TOL}), metrics "
              f"max|d| = {d_metric:.3e}")
    _set_counts(rnn_cuda, before)


def pt_round_trip(torch, counted, corpus: Path, work: Path,
                  ckpts: dict) -> None:
    """Counted: ``cli export-pt`` of fold 1's ``audio_clf`` and
    ``fuse_reg`` checkpoints, then whole-module pickles of the
    reference-layout modules above loaded with the export, in torch's
    zipfile and legacy formats; ``cli check`` (fold 1 from each file, on
    the npz features) and ``cli predict`` (one speaker) must give the
    npz's metrics and outputs within SLICE_TOL."""
    pt = work / "pt"
    pt.mkdir()
    refs = {"audio_clf": RefAudioBiLSTM(), "fuse_reg": RefFusionReg()}
    predict_launches = {"audio_clf": CHECK_FOLD["audio"],
                        "fuse_reg": dict(CHECK_FOLD["fuse"], lstmp_fwd=4)}
    for task, ref in refs.items():
        exported = pt / f"{task}_export.pt"
        lines, _ = counted(["export-pt", "--task", task, "--ckpt",
                            ckpts[task][0], "--out", exported], DRAWN,
                           f"cli export-pt --task {task}")
        print(f"cli export-pt --task {task}: {lines[-1]}")
        ref.load_state_dict(torch.load(exported, weights_only=True),
                            strict=True)
        torch.save(ref, pt / f"{task}_module.pt")
        torch.save(ref, pt / f"{task}_module_legacy.pt",
                   _use_new_zipfile_serialization=False)
        base = None
        for first in (ckpts[task][0], exported, pt / f"{task}_module.pt",
                      pt / f"{task}_module_legacy.pt"):
            lines, _ = counted(
                ["check", "--task", task, "--root", work / "features",
                 "--ckpts", first, *ckpts[task][1:]], check_launches(task),
                f"cli check with {first.name}")
            rows = [json.loads(line) for line in lines]
            out, _ = counted(
                ["predict", "--task", task, "--ckpt", first, "--root",
                 corpus, "--speaker", "Data/1", "--segmenter", "fallback"],
                predict_launches[task], f"cli predict {first.name}")
            pred = _output(json.loads(out[-1]))
            if base is None:
                base = (rows, pred)
                continue
            d_rows = _rows_diff(rows, base[0])
            d_pred = max(abs(a - b) for a, b in zip(pred, base[1]))
            print(f"{first.name}: cli check and cli predict against the "
                  f"npz's: metrics max|d| = {d_rows:.3e}, outputs max|d| = "
                  f"{d_pred:.3e} (tol {SLICE_TOL})")
            if not (d_rows <= SLICE_TOL and d_pred <= SLICE_TOL):
                fail(f"{first.name} differs from the npz checkpoint: {rows} "
                     f"{pred} vs {base}")


def eatd_size_timing(torch, rnn_cuda, counted, card: str, bundle: Path,
                     work: Path) -> dict:
    """At EATD's size (a synthetic corpus of 83 + 79 speakers, the JAX
    ``warmup`` defaults): the wall time of ``cli extract-audio`` and of
    ``cli check --task fuse_clf --corpus`` with the seeded bundle and
    seeded full-width checkpoints, both counted; then, not counted, the
    device time of each fold's forward at its test split's rows
    (``torch.profiler``): the three clf folds and one reg fold."""
    import numpy as np

    from icassp2022_depression_tpu_torch.ops import prng
    from icassp2022_depression_tpu_torch import config as C
    from icassp2022_depression_tpu_torch.data import augment, eatd, folds
    from icassp2022_depression_tpu_torch.eval import checking
    from icassp2022_depression_tpu_torch.frontend import text as tfe
    from icassp2022_depression_tpu_torch.models import porting
    from icassp2022_depression_tpu_torch.models.fusion import FusionNet
    from icassp2022_depression_tpu_torch.train import checkpoints

    big = work / "eatd_size"
    t0 = time.perf_counter()
    eatd.make_synthetic_corpus(big, n_data=83, n_validation=79,
                               seconds=(2.0, 12.0), seed=5)
    make_s = time.perf_counter() - t0
    _, extract_s = counted(["extract-audio", "--root", big], DRAWN,
                           "cli extract-audio (83 + 79)")
    audio = big / "Features" / "AudioWhole"
    m = json.loads((audio / "manifest.json").read_text())
    print(f"timing cli extract-audio, 83 + 79 speakers (486 answers of "
          f"{m['min_len_s']:.2f}-{m['max_len_s']:.2f} s; corpus written in "
          f"{make_s:.2f} s): {extract_s:.2f} s wall [{card}]")
    fuse_ckpts = [checkpoints.save(
        work / f"fuse_clf_{f}", porting.fusion_tree_from_state_dict(
            FusionNet(C.FUSE_CLF, prng.prng_key(20 + f))
            .state_dict(), C.FUSE_CLF)) for f in (1, 2, 3)]
    lines, check_s = counted(
        ["check", "--task", "fuse_clf", "--root", big, "--ckpts",
         *fuse_ckpts, "--corpus", big, "--elmo-weights", bundle,
         "--segmenter", "fallback"], check_launches("fuse_clf", 486),
        "cli check --task fuse_clf --corpus (83 + 79)")
    print(f"timing cli check --task fuse_clf --corpus, 83 + 79 speakers "
          f"(both modalities extracted, seeded full-width checkpoints): "
          f"{check_s:.2f} s wall; {lines[-1]} [{card}]")

    before = _counts(rnn_cuda)
    xa = np.load(audio / "whole_samples_clf_256.npz")["arr_0"][:, :, 0]
    clf = np.load(audio / "whole_labels_clf_256.npz")["arr_0"]
    sds = np.load(audio / "whole_labels_reg_256.npz")["arr_0"]
    xt, _, _ = tfe.extract_eatd(big, elmo_weights=str(bundle),
                                segmenter="fallback", device="cuda")
    dep, non = np.where(clf == 1)[0], np.where(clf == 0)[0]
    forwards = []
    for fold, tr in enumerate(folds.generate_clf_folds(clf, 3, seed=0)):
        _, (xs, y) = augment.augment_classification_fold([xa, xt], clf, tr,
                                                         dep, non)
        forwards.append((f"fuse_clf fold {fold + 1}", xs, len(y),
                         checkpoints.load_model(fuse_ckpts[fold], "fusion",
                                                C.FUSE_CLF, "cuda")))
    rdep, rnon = folds.generate_reg_shuffles(sds, seed=0)
    _, _, te_d, te_n = folds.reg_fold_split(rdep, rnon, 0)
    te = np.concatenate([te_d, te_n])
    forwards.append(("fuse_reg fold 1", [xa[te], xt[te]], len(te),
                     checkpoints.load_model(
                         FusionNet(C.FUSE_REG, prng.prng_key(30)),
                         "fusion", C.FUSE_REG, "cuda")))
    device_us = {}
    for label, xs, rows, model in forwards:
        split = profile_split(
            torch, lambda: checking.fold_forward(model, xs),
            f"check {label} forward ({rows} rows)", 3, card)
        device_us[label] = (rows, None if split is None
                            else split["busy_us"])
    _set_counts(rnn_cuda, before)
    print("timing check fold forwards at EATD's test-split rows, device "
          "time (torch.profiler): " + ", ".join(
              f"{k} ({r} rows) "
              + ("not measured" if us is None else f"{us:.1f} us")
              for k, (r, us) in device_us.items()) + f" [{card}]")
    return {"extract_s": extract_s, "check_s": check_s,
            "device_us": device_us}


# -- the fold axis, the fold's CUDA graph, resume --------------------------

#: the four fold-axis kernels' shapes (F, T, B, H): the recipes' audio GRU
#: (batch 8) and text BiLSTM direction (batch 4), and the reg tracks' batch
#: 2; then the one fold of a fold-parallel rank (phase 12 (b)) and its
#: half batch on a fold x DP rank (c)
FOLD_SHAPES = (("gru", (3, 3, 8, 256)), ("gru", (3, 3, 2, 256)),
               ("lstm", (3, 3, 4, 128)), ("lstm", (3, 3, 2, 128)),
               ("gru", (1, 3, 8, 256)), ("gru", (1, 3, 4, 256)),
               ("lstm", (1, 3, 4, 128)), ("lstm", (1, 3, 2, 128)))
#: the fold-axis checks through the autograd Functions (``GRUSequence`` /
#: ``LSTMSequence``): the recipes' shapes, where they launch the kernels,
#: and an H that is no multiple of 4, where they raise and launch nothing
FOLD_SEQUENCE_SHAPES = (("gru", (3, 3, 8, 256)), ("gru", (3, 3, 4, 254)),
                        ("lstm", (3, 3, 4, 128)), ("lstm", (3, 3, 4, 126)))
RESUME_EPOCHS = 15
RESUME_CHUNK = 7


def _fold_fns(rnn_cuda, cell: str) -> tuple:
    """(kernel forward, plain forward, kernel backward, plain backward)
    of the GRU or LSTM; the forwards' results as tuples."""
    if cell == "gru":
        return ((lambda *a, **kw: (rnn_cuda.gru_sequence(*a, **kw),)),
                (lambda *a: (rnn_cuda.gru_sequence_torch(*a),)),
                rnn_cuda.gru_sequence_bwd, rnn_cuda.gru_sequence_bwd_torch)
    return (rnn_cuda.lstm_sequence, rnn_cuda.lstm_sequence_torch,
            rnn_cuda.lstm_sequence_bwd, rnn_cuda.lstm_sequence_bwd_torch)


def _cudnn_fwd(torch, cell: str, t: int, b: int, h: int):
    mod = (torch.nn.GRU(h, h) if cell == "gru" else torch.nn.LSTM(h, h))
    mod = mod.cuda()
    x = torch.randn((t, b, h), device="cuda")

    def fn():
        with torch.no_grad():
            mod(x)
    return fn


def _check_fold(torch, rnn_cuda, gen, cell: str, shape: tuple) -> tuple:
    """One launch over F folds of the ``cell`` forward and backward through
    their plans, held against the plain versions (1e-5; dw, db of their
    largest magnitude), against F single-fold launches of those plans
    (bitwise) and against itself (rerun bitwise); fails on a difference.
    Returns ``(fwd, plain_fwd, bwd, plain_bwd, (xp, w, bias), bargs,
    err_f, err_dxp)``, the kernel functions bound to the plans."""
    f, t, b, h = shape
    g = (3 if cell == "gru" else 4) * h
    kfwd, plain_fwd, kbwd, plain_bwd = _fold_fns(rnn_cuda, cell)
    fwd_plan = getattr(rnn_cuda, f"{cell}_fwd_plan")(b, h)
    bwd_plan = getattr(rnn_cuda, f"{cell}_bwd_plan")(b, h, steps=t)

    def fwd(*a):
        return kfwd(*a, plan=fwd_plan)

    def bwd(*a):
        return kbwd(*a, plan=bwd_plan)

    def rnd(*shape, scale=1.0):
        return ((torch.rand(shape, generator=gen) * 2 - 1) * scale).cuda()

    xp = torch.randn((f, t, b, g), generator=gen).cuda()
    w, bias = rnd(f, h, g, scale=h ** -0.5), rnd(f, 1, g, scale=h ** -0.5)
    couts = tuple(torch.randn((f, t, b, h), generator=gen).cuda()
                  for _ in range(1 if cell == "gru" else 2))
    got, again = fwd(xp, w, bias), fwd(xp, w, bias)
    ref = plain_fwd(xp, w, bias)
    singles = [fwd(xp[i], w[i], bias[i]) for i in range(f)]
    bargs = (xp, w, bias, *ref, *couts)
    gotb, againb = bwd(*bargs), bwd(*bargs)
    refb = plain_bwd(*bargs)
    singlesb = [bwd(*(a[i] for a in bargs)) for i in range(f)]
    torch.cuda.synchronize()
    err_f = max((x - r).abs().max().item() for x, r in zip(got, ref))
    err_dxp = (gotb[0] - refb[0]).abs().max().item()
    rel = max(((x[i] - r[i]).abs().max() / r[i].abs().max()).item()
              for x, r in zip(gotb[1:], refb[1:]) for i in range(f))
    rerun = (all(torch.equal(x, y) for x, y in zip(got, again))
             and all(torch.equal(x, y) for x, y in zip(gotb, againb)))
    single = (all(torch.equal(x[i], s[k]) for i, s in enumerate(singles)
                  for k, x in enumerate(got))
              and all(torch.equal(x[i], s[k]) for i, s in enumerate(singlesb)
                      for k, x in enumerate(gotb)))
    print(f"kernel {cell}_fwd/{cell}_bwd with a fold axis (F, T, B, H) = "
          f"{shape}: "
          f"forward max|d| {err_f:.3e}, dxp {err_dxp:.3e}, dw/db rel "
          f"{rel:.3e} (tol {KERNEL_TOL}) against the plain loops; bitwise F "
          f"single-fold launches {single}; reruns bitwise equal {rerun}")
    if not (err_f <= KERNEL_TOL and err_dxp <= KERNEL_TOL
            and rel <= KERNEL_TOL and rerun and single):
        fail(f"the fold-axis {cell} kernels disagree at {shape}")
    return (fwd, plain_fwd, bwd, plain_bwd, (xp, w, bias), bargs, err_f,
            err_dxp)


def _check_fold_function(torch, rnn_cuda, gen, cell: str,
                         shape: tuple) -> None:
    """The autograd Function of ``cell`` (``GRUSequence`` /
    ``LSTMSequence``) forward and backward over F folds, held against the
    plain versions (1e-5; dw, db of their largest magnitude), launching one
    forward and one backward kernel; at an H the kernels cannot take (not
    a multiple of 4) it must raise ``ValueError`` and launch nothing;
    fails otherwise."""
    f, t, b, h = shape
    g = (3 if cell == "gru" else 4) * h
    fn = rnn_cuda.GRUSequence if cell == "gru" else rnn_cuda.LSTMSequence
    _, plain_fwd, _, plain_bwd = _fold_fns(rnn_cuda, cell)

    def rnd(*shape, scale=1.0):
        return ((torch.rand(shape, generator=gen) * 2 - 1) * scale).cuda()

    xp = torch.randn((f, t, b, g), generator=gen).cuda()
    w, bias = rnd(f, h, g, scale=h ** -0.5), rnd(f, 1, g, scale=h ** -0.5)
    couts = tuple(torch.randn((f, t, b, h), generator=gen).cuda()
                  for _ in range(1 if cell == "gru" else 2))
    ins = tuple(a.clone().requires_grad_() for a in (xp, w, bias))
    before = rnn_cuda.launch_counts()
    if h % 4:
        try:
            fn.apply(*ins)
        except ValueError as e:
            torch.cuda.synchronize()
            print(f"{fn.__name__} with a fold axis (F, T, B, H) = {shape}: "
                  f"raises ({e})")
            if rnn_cuda.launch_counts() == before:
                return
        fail(f"the {cell} Function at {shape} did not raise before "
             f"launching")
    got = fn.apply(*ins)
    got = got if isinstance(got, tuple) else (got,)
    grads = torch.autograd.grad(got, ins, couts)
    torch.cuda.synchronize()
    after = rnn_cuda.launch_counts()
    launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    ref = plain_fwd(xp, w, bias)
    refb = plain_bwd(xp, w, bias, *ref, *couts)
    err_f = max((x - r).abs().max().item() for x, r in zip(got, ref))
    err_dxp = (grads[0] - refb[0]).abs().max().item()
    rel = max(((x[i] - r[i].reshape(x[i].shape)).abs().max()
               / r[i].abs().max()).item()
              for x, r in zip(grads[1:], refb[1:]) for i in range(f))
    want = {f"{cell}_fwd": 1,
            (f"{cell}_bwd_streamed" if rnn_cuda.streamed(
                t, b, h, g // h) else f"{cell}_bwd"): 1}
    print(f"{fn.__name__} with a fold axis (F, T, B, H) = {shape}: "
          f"forward max|d| {err_f:.3e}, dxp {err_dxp:.3e}, dw/db rel "
          f"{rel:.3e} (tol {KERNEL_TOL}) against the plain loops; launches "
          f"{launched} (expected {want})")
    if not (err_f <= KERNEL_TOL and err_dxp <= KERNEL_TOL
            and rel <= KERNEL_TOL and launched == want):
        fail(f"the {cell} Function disagrees at {shape}: launches "
             f"{launched}, expected {want}")


def fold_kernel_phase(torch, rnn_cuda, card: str) -> dict:
    """The four fold-axis kernels (#1 ``gru_fwd``, #2 ``gru_bwd``, #4
    ``lstm_fwd``, #8 ``lstm_bwd``): at ``FOLD_SHAPES`` through their
    default plans, each checked by :func:`_check_fold`, then the fold
    launch, the F single-fold launches, the plain loops and F cuDNN calls
    timed in turns beside the bound of the F folds' work; then the autograd
    Functions at ``FOLD_SEQUENCE_SHAPES`` (:func:`_check_fold_function`).
    Returns {(name, shape): (ms, plain_ms, bound_ms, bound_by, cudnn_ms,
    max_err)}."""
    gen = torch.Generator().manual_seed(21)
    out = {}
    for cell, (f, t, b, h) in FOLD_SHAPES:
        fwd, plain_fwd, bwd, plain_bwd, (xp, w, bias), bargs, err_f, \
            err_dxp = _check_fold(torch, rnn_cuda, gen, cell, (f, t, b, h))
        cud_f = [_cudnn_fwd(torch, cell, t, b, h) for _ in range(f)]
        cud_b = [cudnn_bwd(torch, cell, t, b, h) for _ in range(f)]
        turns = {
            "fwd": {"fold": lambda: fwd(xp, w, bias),
                    "single x F": lambda: [fwd(xp[i], w[i], bias[i])
                                           for i in range(f)],
                    "plain": lambda: plain_fwd(xp, w, bias),
                    "cudnn x F": lambda: [c() for c in cud_f]},
            "bwd": {"fold": lambda: bwd(*bargs),
                    "single x F": lambda: [bwd(*(a[i] for a in bargs))
                                           for i in range(f)],
                    "plain": lambda: plain_bwd(*bargs),
                    "cudnn x F": lambda: [c() for c in cud_b]}}
        for d, fns in turns.items():
            ms = turns_ms(torch, fns, 50)
            b_ms, by = rnn_bounds(cell, t, b, h)[d]
            b_ms *= f              # F folds' operations and bytes
            print(f"timing {cell}_{d} fold axis (F, T, B, H) = "
                  f"{(f, t, b, h)}: " + ", ".join(
                      f"{k} {v:.4f} ms" for k, v in ms.items())
                  + f"; bound {b_ms:.6f} ms ({by}), {b_ms / ms['fold']:.4f} "
                  f"of it (median of 50 in turns, CUDA events) [{card}]")
            out[(f"{cell}_{d}", (f, t, b, h))] = (
                ms["fold"], ms["plain"], b_ms, by, ms["cudnn x F"],
                err_f if d == "fwd" else err_dxp)
    for cell, shape in FOLD_SEQUENCE_SHAPES:
        _check_fold_function(torch, rnn_cuda, gen, cell, shape)
    return out


def _same_runs(a, b) -> bool:
    (la, pa), (lb, pb) = a, b
    import numpy as np

    return (np.array_equal(la, lb)
            and all(torch.equal(pa[k], pb[k]) for k in pb))


def _kernel_calls(prof_events, steps: int) -> dict:
    """Kernel wrapper calls read off a profiler trace by kernel name: a
    forward call launches its step kernel T times, a backward call its
    gate recompute once."""
    names = [e.name for e in prof_events]
    return {"gru_fwd": sum("gru_fwd_step_kernel" in n for n in names)
            // steps,
            "gru_bwd": sum("gates_kernel<false>" in n for n in names),
            "lstm_fwd": sum("lstm_fwd_step_kernel" in n for n in names)
            // steps,
            "lstm_bwd": sum("gates_kernel<true>" in n for n in names)}


def _busy_split(prof) -> tuple:
    """A trace's kernels: their device time (us) by kind -- the recurrence
    kernels, the GEMMs and every other kernel (elementwise, reductions,
    the threefry draws) -- and the union of their intervals (us)."""
    from torch.autograd import DeviceType

    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    out = {"recurrence": 0.0, "gemm": 0.0, "other": 0.0}
    for e in kernels:
        n = e.name
        kind = ("recurrence" if any(k in n for k in (
                    "gru_", "lstm_", "gates_kernel", "dw_"))
                else "gemm" if any(k in n.lower() for k in (
                    "gemm", "cutlass", "xmma")) else "other")
        out[kind] += e.time_range.elapsed_us()
    busy, reach = 0.0, None
    for e in sorted(kernels, key=lambda e: e.time_range.start):
        start = e.time_range.start if reach is None else max(
            reach, e.time_range.start)
        busy += max(0.0, e.time_range.end - start)
        reach = max(reach or e.time_range.end, e.time_range.end)
    return out, busy


def trainer_phase(torch, rnn_cuda, card: str, feats, clf, xt) -> dict:
    """The fold program on the card, not counted: 5-epoch ``audio_clf``,
    ``text_clf`` and ``fuse_clf`` folds through the CUDA graph against the
    eager route (bitwise: losses and params); one replayed epoch under
    ``torch.profiler``, its kernels by name against the launch counters
    (up to three epochs, the counters held on each);
    ``--chunk-epochs 7`` with a resume bundle, killed after its first
    chunk and resumed, against the single-shot run (bitwise); the three
    ``audio_clf`` folds stacked (``vmap_folds``) against the serial folds
    (per-step losses within 1e-5 of the largest); and an epoch's time
    through the graph and eagerly, serial and stacked
    (:func:`stacked_step_timing`).  Returns the timings."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from icassp2022_depression_tpu_torch import config as C
    from icassp2022_depression_tpu_torch.data import folds
    from icassp2022_depression_tpu_torch.train import loop, optim, trainers

    counted = _counts(rnn_cuda)
    train_idx = folds.generate_clf_folds(clf, 3, seed=0)
    data = trainers._clf_fold_datas([feats], clf, train_idx, 8)[0]
    text_data = trainers._clf_fold_datas([xt], clf, train_idx, 4)[0]
    fuse_data = trainers._clf_fold_datas([feats, xt], clf, train_idx, 2)[0]
    base = C.replace(C.AUDIO_CLF, epochs=COMPARE_EPOCHS + 1)
    text_base = C.replace(C.TEXT_CLF, epochs=COMPARE_EPOCHS + 1)
    fuse_t = C.replace(C.FUSE_CLF_TRAINER, epochs=COMPARE_EPOCHS + 1)
    branch = (trainers.init_model(C.TEXT_CLF, 0, 1, "cuda").state_dict(),
              trainers.init_model(C.AUDIO_CLF, 0, 1, "cuda").state_dict())
    runs = {"audio_clf": lambda g: _fold_run(torch, base, data, "cuda", g),
            "text_clf": lambda g: _fold_run(torch, text_base, text_data,
                                            "cuda", g),
            "fuse_clf": lambda g: _fusion_fold_run(
                torch, C.FUSE_CLF, fuse_t, fuse_data, branch, "cuda", g)}
    for name, run in runs.items():
        graph, eager = run(True), run(False)
        same = _same_runs(graph, eager)
        print(f"{COMPARE_EPOCHS}-epoch {name} fold, dropout on: CUDA graph "
              f"against the eager route, {graph[0].size} step losses and "
              f"every param bitwise equal: {same}")
        if not same:
            fail(f"the {name} fold's CUDA graph differs from its eager run")

    # one replayed epoch under the profiler: the captured calls, by name
    timings = {}
    for name, tcfg, d in (("audio_clf", C.AUDIO_CLF, data),
                          ("text_clf", C.TEXT_CLF, text_data)):
        per_epoch = {}
        for graph in (True, False):
            model = trainers.init_model(tcfg, 0, 1, "cuda")
            opt = optim.build(tcfg.optimizer, model)
            fr = loop.FoldRun(model, opt, *loop.model_fns(
                model, trainers._branch_fns(tcfg)), d, tcfg.track, tcfg.gate,
                12, trainers.dropout_key(0, 1, "cuda"), graph)
            fr.run(2)                     # capture (graph), warm
            torch.cuda.synchronize()
            if graph:
                # the counters held on every try; the trace's kernel calls
                # on one of up to three (late in a whole run a trace has
                # come back a kernel short of the replay, PERF.md section 7)
                for attempt in range(3):
                    before = _counts(rnn_cuda)
                    ev = [torch.cuda.Event(enable_timing=True)
                          for _ in range(2)]
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        ev[0].record()
                        fr.run(1)
                        ev[1].record()
                        torch.cuda.synchronize()
                    moved = {k: _counts(rnn_cuda)[k] - before[k]
                             for k in before}
                    seen = _kernel_calls(prof.events(), 3)
                    want = {k: fr.captured.get(k, 0) for k in seen}
                    if {k: moved[k] for k in seen} != want:
                        fail(f"{name}: replay counters {moved}, captured "
                             f"{fr.captured}")
                    if seen == want:
                        break
                    print(f"{name}: try {attempt + 1}: the trace of a "
                          f"replayed epoch holds {seen} of the captured "
                          f"{want} kernel calls; profiling again")
                # a reading, not held: late in a whole run the trace has
                # shown 2-3 threefry kernels fewer than the capture counted,
                # where a fresh process's trace of the same fold shows all
                traced = sum("threefry_kernel" in e.name
                             for e in prof.events())
                kinds, busy = _busy_split(prof)
                span = ev[0].elapsed_time(ev[1]) * 1e3
                print(f"{name}: one replayed epoch launched {seen} kernel "
                      f"calls by the profiler's kernel names; captured "
                      f"{fr.captured}; counters moved {moved}; threefry "
                      f"kernels in the trace {traced}")
                print(f"{name}: a replayed epoch, some kernel running "
                      f"{busy:.1f} us of a {span:.1f} us span (CUDA "
                      f"events; idle {1 - busy / span:.3f}); kernel time "
                      + ", ".join(f"{k} {v:.1f} us"
                                  for k, v in kinds.items())
                      + f" (torch.profiler) [{card}]")
                if seen != want or {k: moved[k] for k in seen} != want:
                    fail(f"{name}: replay launches {seen}, counters "
                         f"{moved}, captured {fr.captured}")
            ev0, ev1 = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
            ev0.record()
            fr.run(8)
            ev1.record()
            torch.cuda.synchronize()
            per_epoch["graph" if graph else "eager"] = \
                ev0.elapsed_time(ev1) / 8
        steps = fr.n_steps
        timings[name] = {k: v / steps for k, v in per_epoch.items()}
        print(f"timing {name} epoch ({steps} steps + eval): CUDA graph "
              f"{per_epoch['graph']:.3f} ms, eager {per_epoch['eager']:.3f} "
              f"ms; a step {timings[name]['graph']:.3f} against "
              f"{timings[name]['eager']:.3f} ms, "
              f"{per_epoch['eager'] / per_epoch['graph']:.2f}x (mean of 8 "
              f"epochs, CUDA events) [{card}]")

    # chunked with a resume bundle, killed after the first chunk
    cfg = C.replace(C.AUDIO_CLF, epochs=RESUME_EPOCHS + 1)
    one = train_idx[:1]
    single = trainers.train_audio_clf(feats, clf, one, tcfg=cfg,
                                      device="cuda")[0]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_resume_") as tmp:
        run, chunks = loop.FoldRun.run, []

        def killed(self, n):
            if chunks:
                raise KeyboardInterrupt
            chunks.append(n)
            run(self, n)

        loop.FoldRun.run = killed
        try:
            with contextlib.redirect_stderr(io.StringIO()):
                trainers.train_audio_clf(feats, clf, one, tcfg=cfg,
                                         device="cuda",
                                         chunk_epochs=RESUME_CHUNK,
                                         resume_dir=tmp)
        except KeyboardInterrupt:
            pass
        finally:
            loop.FoldRun.run = run
        with np.load(Path(tmp) / "audio_clf_fold1.npz") as z:
            done = int(z["epoch_done"])
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            resumed = trainers.train_audio_clf(
                feats, clf, one, tcfg=cfg, device="cuda",
                chunk_epochs=RESUME_CHUNK, resume_dir=tmp)[0]
    same = (np.array_equal(single["step_losses"], resumed["step_losses"])
            and all(np.array_equal(single["logs"][k], resumed["logs"][k])
                    for k in single["logs"])
            and all(torch.equal(v, resumed["best"]["params"][k])
                    for k, v in single["best"]["params"].items())
            and single["best"]["epoch"] == resumed["best"]["epoch"])
    print(f"audio_clf fold, {RESUME_EPOCHS} epochs, --chunk-epochs "
          f"{RESUME_CHUNK} killed after its first chunk (bundle at epoch "
          f"{done}) and resumed ({err.getvalue().count('committed')} more "
          f"chunks committed): bitwise the single-shot run {same}")
    if done != RESUME_CHUNK or not same:
        fail("the resumed run differs from the single-shot run")

    # the folds stacked against the serial folds
    serial = trainers.train_audio_clf(feats, clf, train_idx, tcfg=base,
                                      device="cuda")
    stacked = trainers.train_audio_clf(feats, clf, train_idx, tcfg=base,
                                       device="cuda", vmap_folds=True)
    worst = 0.0
    for s, v in zip(serial, stacked):
        scale = float(np.abs(s["step_losses"]).max())
        d = float(np.abs(s["step_losses"] - v["step_losses"]).max())
        worst = max(worst, d / scale)
    print(f"{COMPARE_EPOCHS}-epoch audio_clf, 3 folds stacked (vmap_folds) "
          f"against serial on the card: max|d step loss| {worst:.3e} of the "
          f"largest (tol {TRAIN_TOL}); gated epochs "
          f"{[r['best']['epoch'] for r in stacked]} against "
          f"{[r['best']['epoch'] for r in serial]}")
    if worst > TRAIN_TOL:
        fail("the stacked folds differ from the serial folds")
    timings["vmap_folds"] = stacked_step_timing(
        torch, card, {"audio_clf": (C.AUDIO_CLF, trainers._clf_fold_datas(
            [feats], clf, train_idx, 8)),
                      "text_clf": (C.TEXT_CLF, trainers._clf_fold_datas(
                          [xt], clf, train_idx, 4))})
    _set_counts(rnn_cuda, counted)
    return timings


def stacked_step_timing(torch, card: str, runs: dict) -> dict:
    """A ``--vmap-folds`` step: for each ``{name: (tcfg, fold datas)}``,
    the three folds stacked as ``trainers._vmapped_results`` stacks them,
    timed through the epoch's CUDA graph and eagerly (after two warm
    epochs, the mean of 8 epochs over CUDA events, per step).  Returns
    {name: {"graph": ms, "eager": ms}}."""
    from icassp2022_depression_tpu_torch.models import folds as mfolds
    from icassp2022_depression_tpu_torch.train import loop, optim, trainers

    out = {}
    for name, (tcfg, fold_datas) in runs.items():
        per_step = {}
        for graph in (True, False):
            n = len(fold_datas)
            stacked = mfolds.stack([trainers.init_model(tcfg, 0, f, "cuda")
                                    for f in range(1, n + 1)])
            keys = torch.stack([trainers.dropout_key(0, f, "cuda")
                                for f in range(1, n + 1)])
            fr = loop.FoldRun(
                stacked, optim.build_stacked(tcfg.optimizer, stacked),
                *loop.model_fns(stacked, trainers._branch_fns(tcfg)),
                loop.stack_fold_data(fold_datas), tcfg.track, tcfg.gate, 12,
                keys, graph)
            fr.run(2)
            torch.cuda.synchronize()
            ev0, ev1 = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
            ev0.record()
            fr.run(8)
            ev1.record()
            torch.cuda.synchronize()
            per_step["graph" if graph else "eager"] = \
                ev0.elapsed_time(ev1) / 8 / fr.n_steps
        out[name] = per_step
        print(f"timing {name} --vmap-folds step ({n} folds stacked, "
              f"{fr.n_steps} steps + eval an epoch): CUDA graph "
              f"{per_step['graph']:.4f} ms, eager {per_step['eager']:.4f} ms "
              f"(mean of 8 epochs, CUDA events) [{card}]")
    return out


# -- phase 9: DAIC-WOZ ------------------------------------------------------

#: the DAIC corpus of this script, AVEC2017's layout cut to size: 107 + 35
#: train / dev participants -> 32 + 16, each with 40-120 responses of 1-3 s
#: (the first train participant 120, so that the batch's response count
#: exceeds 83 and the JAX package streams the backward)
DAIC_TRAIN, DAIC_DEV = 32, 16
DAIC_RESPONSES = (40, 120)
DAIC_SECONDS = (1.0, 3.0)
#: the presets' 101 epochs cut to keep the script short, gates open
DAIC_EPOCHS = 21
DAIC_WORDS = ("i", "feel", "okay", "tired", "sleep", "work", "family",
              "good", "bad", "really", "not", "much", "today", "friends",
              "worried", "happy", "guess", "yeah")


def make_daic_corpus(root: Path, seed: int = 0) -> dict:
    """DAIC-shaped sessions from ``seed``: ``<id>_P/<id>_AUDIO.wav`` (16
    kHz int16; depressed participants speak lower and softer, as in
    ``eatd.make_synthetic_corpus``) and ``<id>_TRANSCRIPT.csv``, whose
    Ellie lines are questions of the bundled bank (a response closes at the
    next one, a ``scrubbed_entry`` now and then is skipped), plus the
    train and dev split CSVs.  Returns the split ids and the response
    counts."""
    import numpy as np

    from icassp2022_depression_tpu_torch.data import eatd
    from icassp2022_depression_tpu_torch.frontend import daic as daic_fe

    rng = np.random.default_rng(seed)
    bank = daic_fe.load_queries()
    sr = 16000
    splits = {"train": list(range(300, 300 + DAIC_TRAIN)),
              "dev": list(range(400, 400 + DAIC_DEV))}
    counts = {}
    for split, ids in splits.items():
        rows_csv = ["Participant_ID,PHQ8_Binary,PHQ8_Score"]
        for i, pid in enumerate(ids):
            dep = i % 3 == 0
            n = (DAIC_RESPONSES[1] if (split, i) == ("train", 0)
                 else int(rng.integers(DAIC_RESPONSES[0],
                                       DAIC_RESPONSES[1] + 1)))
            rows, parts, t = [], [], 0.0
            for _ in range(n):
                rows.append(f"{t:.3f}\t{t + 0.3:.3f}\tEllie\t"
                            f"{bank[int(rng.integers(len(bank)))]}")
                t += 0.3
                if rng.random() < 0.05:
                    rows.append(f"{t:.3f}\t{t + 0.2:.3f}\tParticipant\t"
                                "scrubbed_entry")
                    t += 0.2
                dur = float(rng.uniform(*DAIC_SECONDS))
                words = " ".join(rng.choice(DAIC_WORDS,
                                            int(rng.integers(3, 13))))
                rows.append(f"{t:.3f}\t{t + dur:.3f}\tParticipant\t{words}")
                t += dur
            rows.append(f"{t:.3f}\t{t + 0.3:.3f}\tEllie\ti think i have "
                        "asked everything i need to")
            t += 0.5
            m = int(t * sr)
            f0 = (90 if dep else 180) + rng.uniform(-10, 10)
            amp = (1200 if dep else 6000) * rng.uniform(0.8, 1.2)
            wav = (amp * np.sin(2 * np.pi * f0 * np.arange(m) / sr)
                   + rng.normal(0, 300, m))
            d = root / f"{pid}_P"
            eatd.write_wav(d / f"{pid}_AUDIO.wav", wav, sr)
            (d / f"{pid}_TRANSCRIPT.csv").write_text(
                "\n".join(["start_time\tstop_time\tspeaker\tvalue"] + rows)
                + "\n")
            score = int(rng.integers(10, 25) if dep else rng.integers(0, 10))
            rows_csv.append(f"{pid},{int(dep)},{score}")
            counts[pid] = n
        (root / f"{split}_split.csv").write_text("\n".join(rows_csv) + "\n")
    return {"splits": splits, "counts": counts}


def _daic_presets(tdaic, C):
    """The two DAIC presets at DAIC_EPOCHS epochs with the gates open, set
    in place for the CLI (which reads them at call time); returns the
    originals."""
    originals = (tdaic.DAIC_CLF, tdaic.DAIC_REG)
    tdaic.DAIC_CLF = C.replace(
        tdaic.DAIC_CLF, epochs=DAIC_EPOCHS,
        gate=C.GateConfig(f1_floor=-1.0, train_acc_frac=0.0))
    tdaic.DAIC_REG = C.replace(tdaic.DAIC_REG, epochs=DAIC_EPOCHS)
    return originals


def daic_train_launches(rnn_cuda, n_train: int, max_r: int,
                        batch: int) -> dict:
    """One ``train-daic`` fold's exact launches: ``ceil(n / batch)`` steps
    an epoch over DAIC_EPOCHS - 1 epochs and the graph's warm-up epoch, 2
    GRU forwards a step and an eval, 2 backwards a step, counted under
    ``gru_bwd_streamed`` where the JAX package streams (R, batch, 256)
    (``rnn_cuda.streamed``), else under ``gru_bwd``."""
    epochs = DAIC_EPOCHS - 1 + 1
    steps = -(-n_train // batch) * epochs
    bwd = ("gru_bwd_streamed" if rnn_cuda.streamed(max_r, batch, 256, 3)
           else "gru_bwd")
    return dict(DRAWN, gru_fwd=2 * (steps + epochs), **{bwd: 2 * steps})


def daic_kernel_checks(torch, rnn_cuda, card: str, max_r: int,
                       serve_r: int) -> dict:
    """The GRU kernels at the DAIC shapes, not counted: the forward (#1)
    at the train batch and eval split (max_r, 16, 256) and at one served
    participant (serve_r, 1, 256); the backward (#3 where the JAX package
    streams it, else #2) at (max_r, 16, 256) against its plain loop (dxp
    1e-5, dw / db 1e-5 of their largest magnitude, reruns bitwise), then
    the kernel, the plain loop and cuDNN ``nn.GRU`` timed in turns with its
    bound.  Returns the worst errors and the timings."""
    gen = torch.Generator().manual_seed(12)
    worst_fwd = 0.0
    for t, b in ((max_r, 16), (serve_r, 1)):
        args = _bwd_inputs(torch, rnn_cuda, gen, "gru", t, b, 256)[:3]
        ref = rnn_cuda.gru_sequence_torch(*args)
        ys, again = rnn_cuda.gru_sequence(*args), rnn_cuda.gru_sequence(*args)
        torch.cuda.synchronize()
        err = (ys - ref).abs().max().item()
        if not (err <= KERNEL_TOL and torch.equal(ys, again)):
            fail(f"gru_fwd at the DAIC shape {(t, b, 256)}: {err}, rerun "
                 f"bitwise equal {torch.equal(ys, again)}")
        worst_fwd = max(worst_fwd, err)
        print(f"kernel gru_fwd at the DAIC shape T={t} B={b} H=256: "
              f"max|cuda - plain| {err:.3e}, rerun bitwise equal (tol "
              f"{KERNEL_TOL})")
    shape = (max_r, 16, 256)
    name = ("gru_bwd_streamed" if rnn_cuda.streamed(*shape, 3)
            else "gru_bwd")
    args = _bwd_inputs(torch, rnn_cuda, gen, "gru", *shape)
    ref = rnn_cuda.gru_sequence_bwd_torch(*args)
    err, rel, same = bwd_check(torch, rnn_cuda, "gru", args, ref, shape)
    print(f"kernel {name} (TPU kernel #{3 if name.endswith('ed') else 2}) "
          f"at the DAIC shape T={max_r} B=16 H=256: max|d dxp| {err:.3e}, "
          f"dw/db rel {rel:.3e}, rerun bitwise equal {same} (tol "
          f"{KERNEL_TOL}; dw, db of max|ref|)")
    ms = turns_ms(torch, {
        "kernel": lambda: rnn_cuda.gru_sequence_bwd(*args),
        "plain": lambda: rnn_cuda.gru_sequence_bwd_torch(*args),
        "cudnn": cudnn_bwd(torch, "gru", *shape)}, 20)
    b_ms, by = rnn_bounds("gru", *shape)["bwd"]
    print(f"timing {name} at the DAIC shape T={max_r} B=16 H=256: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
          + f"; the plan {rnn_cuda.gru_bwd_plan(16, 256, steps=max_r)}; "
          f"bound {b_ms:.6f} ms ({by}), {b_ms / ms['kernel']:.4f} of it; "
          f"cuDNN {ms['cudnn'] / ms['kernel']:.2f}x the kernel's time "
          f"(median of 20 in turns, CUDA events) [{card}]")
    return {"name": name, "shape": shape, "fwd_err": worst_fwd,
            "bwd_err": err, "ms": ms["kernel"], "plain_ms": ms["plain"],
            "cudnn_ms": ms["cudnn"], "bound": (b_ms, by)}


def daic_graph_check(torch, feats_dir: Path, card: str) -> float:
    """A DAIC clf fold through the CUDA graph against the same fold run
    eagerly (``graph=False``), not counted: the saved train and dev
    features, the trainer's init and dropout keys of seed 0, 6 epochs
    each; the per-step losses, the log rows and the gated params bitwise
    equal (a replay that read a stale response mask would part them).
    Times the last 5 epochs of each on the host clock around a
    synchronize; returns a step's time under the graph."""
    import numpy as np

    from icassp2022_depression_tpu_torch.frontend import daic as daic_fe
    from icassp2022_depression_tpu_torch.models.audio_net import AudioNet
    from icassp2022_depression_tpu_torch.ops import prng
    from icassp2022_depression_tpu_torch.train import daic as tdaic
    from icassp2022_depression_tpu_torch.train import loop, optim

    xtr, ytr = daic_fe.load_features(feats_dir, "train", "clf")
    xte, yte = daic_fe.load_features(feats_dir, "dev", "clf")
    max_r = max(f.shape[0] for f in xtr + xte)
    tcfg = tdaic.DAIC_CLF
    data = loop.make_fold_data(
        [*daic_fe.pad_responses(xtr, max_r)], ytr.astype("int64"),
        [*daic_fe.pad_responses(xte, max_r)], yte.astype("int64"),
        tcfg.batch_size, device="cuda")
    out, step = {}, {}
    for graph in (True, False):
        model = AudioNet(tcfg.model, prng.prng_key(0)).cuda()
        run = loop.FoldRun(model, optim.build(tcfg.optimizer, model),
                           *tdaic._fns(model, tcfg), data, tcfg.track,
                           tcfg.gate, 6,
                           prng.fold_in(prng.prng_key(0), 1).cuda(), graph)
        run.run(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run.run(5)
        torch.cuda.synchronize()
        step[graph] = (time.perf_counter() - t0) * 1e3 / (5 * run.n_steps)
        out[graph] = run.results()
    (gb, gl, gs), (eb, el, es) = out[True], out[False]
    same = (np.array_equal(gs, es)
            and all(np.array_equal(gl[k], el[k]) for k in el)
            and all(torch.equal(gb["params"][k], eb["params"][k])
                    for k in eb["params"])
            and {k: v for k, v in gb.items() if k != "params"}
            == {k: v for k, v in eb.items() if k != "params"})
    if not same:
        fail(f"DAIC clf fold: the CUDA graph's run differs from the eager "
             f"run's (step losses {gs.ravel()[:6]} against {es.ravel()[:6]}"
             f", logs {gl} against {el})")
    print(f"DAIC clf fold through the CUDA graph against graph=False: "
          f"{gs.size} step losses, {len(el) - 1} log columns over 6 "
          "epochs and the gated params bitwise equal")
    print(f"timing a DAIC clf train step (batch 16, T = {max_r} responses, "
          f"H = 256, eval of {len(yte)} participants once an epoch): "
          f"{step[True]:.3f} ms under the CUDA graph, {step[False]:.3f} ms "
          f"eagerly, 5 epochs of {run.n_steps} steps each (host clock) "
          f"[{card}]")
    return step[True]


def daic_phase(torch, card: str, bundle: Path, work: Path) -> dict:
    """Phase 9, DAIC-WOZ on the card.  Counted, each CLI call with every
    kernel counter zeroed before and read after: ``cli extract-daic`` of
    both splits (no kernel) and of the dev split with ``--multimodal``
    through the seeded bundle (4 ``lstmp_fwd`` a batch of 128 responses),
    ``cli train-daic --track clf`` / ``--track reg`` from the features and
    ``--track clf --daic-dir`` (fused) at the presets' widths and
    DAIC_EPOCHS (exact launches, ``daic_train_launches``; the fused
    checkpoint bitwise the two-step one), ``cli check-daic`` on each
    checkpoint (2 ``gru_fwd``; the metrics those the trainer recorded) and
    ``cli predict-daic``.  Not counted: the check through ``check_daic``
    (F1 within 1e-6, MAE within 1e-5), the same prediction on the CPU
    (1e-5) and from the training features, the kernels at the DAIC shapes,
    and a clf fold through the graph against the same fold run eagerly
    (``daic_graph_check``).  Returns the launches, the stage times, the
    kernel readings and the clf checkpoint."""
    import numpy as np

    from icassp2022_depression_tpu_torch import cli
    from icassp2022_depression_tpu_torch import config as C
    from icassp2022_depression_tpu_torch.frontend import daic as daic_fe
    from icassp2022_depression_tpu_torch.ops import rnn_cuda
    from icassp2022_depression_tpu_torch.serving.predictors import (
        DaicPredictor,
    )
    from icassp2022_depression_tpu_torch.train import checkpoints
    from icassp2022_depression_tpu_torch.train import daic as tdaic

    counted = _Counted(torch, rnn_cuda)
    stage_s = {}
    root = work / "daic"
    t0 = time.perf_counter()
    corpus = make_daic_corpus(root)
    counts = corpus["counts"]
    train_ids, dev_ids = corpus["splits"]["train"], corpus["splits"]["dev"]
    n_resp = sum(counts.values())
    print(f"reduced: DAIC corpus of AVEC2017's train / dev layout, 107 + 35 "
          f"participants cut to {DAIC_TRAIN} + {DAIC_DEV}, {n_resp} "
          f"responses of {DAIC_SECONDS[0]:g}-{DAIC_SECONDS[1]:g} s "
          f"({DAIC_RESPONSES[0]}-{DAIC_RESPONSES[1]} a participant), "
          f"written in {time.perf_counter() - t0:.2f} s; train-daic epochs "
          f"101 cut to {DAIC_EPOCHS} with the clf gate open; --multimodal "
          "extraction of the dev split only")
    feats = work / "Features"
    data = ["--daic-dir", root]
    csv = {s: root / f"{s}_split.csv" for s in ("train", "dev")}
    for split in ("train", "dev"):
        _, stage_s[f"extract-daic {split}"] = counted(
            ["extract-daic", *data, "--split-csv", csv[split], "--out",
             feats, "--split-name", split], DRAWN,
            f"cli extract-daic {split}")
    xtr, ytr = daic_fe.load_features(feats, "train", "clf")
    xte, yte = daic_fe.load_features(feats, "dev", "clf")
    if [f.shape[0] for f in xtr + xte] != [counts[p] for p in
                                           train_ids + dev_ids]:
        fail("extract-daic: responses per participant differ from the "
             "corpus's")
    if not all(np.isfinite(f).all() and f.shape[1:] == (1, 256)
               for f in xtr + xte):
        fail("extract-daic: malformed features")
    max_r = max(counts.values())
    n_dev = sum(counts[p] for p in dev_ids)
    mm = work / "FeaturesMM"
    _, stage_s["extract-daic dev --multimodal"] = counted(
        ["extract-daic", *data, "--split-csv", csv["dev"], "--out", mm,
         "--split-name", "dev", "--multimodal", "--elmo-weights", bundle,
         "--segmenter", "fallback"],
        dict(DRAWN, lstmp_fwd=4 * -(-n_dev // 128)),
        "cli extract-daic --multimodal")
    meta = json.loads((mm / "extraction_meta.json").read_text())
    _, tt, _ = daic_fe.load_features(mm, "dev", "clf", True)
    if (meta["embedder"] != bundle_id(bundle)
            or any(t.shape[1] != meta["text_dim"] or not np.isfinite(t).all()
                   for t in tt)):
        fail(f"extract-daic --multimodal: sidecar {meta}, text features "
             f"{[t.shape for t in tt[:3]]}")
    if [len(t) for t in tt] != [counts[p] for p in dev_ids]:
        fail("extract-daic --multimodal: text responses differ from audio")
    print(f"cli extract-daic: {n_resp} responses, R_max {max_r}; the dev "
          f"split's {n_dev} transcripts through the bundle "
          f"({meta['embedder']})")

    originals = _daic_presets(tdaic, C)
    want_train = daic_train_launches(rnn_cuda, DAIC_TRAIN, max_r,
                                     tdaic.DAIC_CLF.batch_size)
    results, ckpts = {}, {}
    try:
        for name, argv in (
                ("clf", ["--track", "clf", "--features", feats,
                         "--eval-split", "dev"]),
                ("reg", ["--track", "reg", "--features", feats,
                         "--eval-split", "dev"]),
                ("clf fused", ["--track", "clf", *data, "--train-csv",
                               csv["train"], "--eval-csv", csv["dev"]])):
            model_dir = work / f"Model {name}"
            lines, stage_s[f"train-daic {name}"] = counted(
                ["train-daic", *argv, "--model-dir", model_dir], want_train,
                f"cli train-daic {name}")
            results[name] = json.loads(lines[-1])
            track = name.split()[0]
            found = sorted(model_dir.glob(f"daic_{track}_*.npz"))
            if len(found) != 1:
                fail(f"train-daic {name} wrote {found}")
            ckpts[name] = found[0].with_suffix("")
            print(f"cli train-daic {name}: best {json.dumps(results[name])}"
                  f", launches {want_train}, wall "
                  f"{stage_s[f'train-daic {name}']:.2f} s [{card}]")
        fused, two_step = (np.load(f"{ckpts[n]}.npz")
                           for n in ("clf fused", "clf"))
        if (results["clf fused"] != results["clf"]
                or set(fused.files) != set(two_step.files)
                or not all(np.array_equal(fused[k], two_step[k])
                           for k in two_step.files)):
            fail(f"fused train-daic {results['clf fused']} differs from "
                 f"the two-step run {results['clf']} (or its checkpoint's "
                 "arrays do)")
        print(f"cli train-daic clf fused against the two-step run: best "
              f"and the checkpoint's {len(two_step.files)} arrays bitwise "
              "equal")
        for name in ("clf", "reg", "clf fused"):
            track = name.split()[0]
            metric = "f1" if track == "clf" else "mae"
            src = (["--daic-dir", root, "--eval-csv", csv["dev"]]
                   if name == "clf fused"
                   else ["--features", feats, "--eval-split", "dev"])
            lines, wall = counted(["check-daic", "--track", track, *src,
                                   "--ckpt", ckpts[name]],
                                  dict(DRAWN, gru_fwd=2),
                                  f"cli check-daic {name}")
            printed = json.loads(lines[-1])
            recorded = checkpoints.load_meta(ckpts[name])
            xs, ys = daic_fe.load_features(feats, "dev", track)
            exact = tdaic.check_daic(
                xs, ys, ckpts[name], getattr(tdaic, f"DAIC_{track.upper()}"),
                device="cuda")
            # every metric the trainer recorded; the host's metrics give
            # 0/0 as nan where the trainer's device metrics give 0 (as in
            # the JAX package)
            keys = [k for k in exact if k in recorded and k != "epoch"]
            tol = 1e-6 if track == "clf" else 1e-5
            d = max(abs(_nan_as_zero(exact[k]) - recorded[k]) for k in keys)
            shown = max(abs(_nan_as_zero(printed[k]) - recorded[k])
                        for k in keys)
            if not (metric in keys and d <= tol and shown <= 5e-5 + tol):
                fail(f"check-daic {name}: {exact} (printed {printed}) "
                     f"against the trainer's {recorded}")
            print(f"cli check-daic {name}: {metric} {printed[metric]}, "
                  f"max |check_daic - trainer's best| over {keys} "
                  f"{d:.3e} (tol {tol}), wall {wall:.2f} s [{card}]")
    finally:
        tdaic.DAIC_CLF, tdaic.DAIC_REG = originals

    # predict-daic: a dev participant at its cumulative ordinal
    idx = min(3, len(dev_ids) - 1)
    pid = dev_ids[idx]
    start = sum(counts[p] for p in dev_ids[:idx])
    argv = ["predict-daic", "--task", "daic_clf", *data, "--ckpt",
            ckpts["clf"], "--participant", pid, "--start-ordinal", start]
    lines, wall = counted(argv, dict(DRAWN, gru_fwd=2), "cli predict-daic")
    on_card = json.loads(lines[-1])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([str(a) for a in argv] + ["--device", "cpu"])
    if rc != 0:
        fail(f"cli predict-daic --device cpu returned {rc}")
    on_cpu = json.loads(buf.getvalue().strip().splitlines()[-1])
    d_cpu = compare([on_card], [on_cpu], "predict-daic card vs CPU")
    # the participant's training-time features give the same prediction
    served = DaicPredictor.from_checkpoint(ckpts["clf"], "daic_clf",
                                           device="cuda")
    d_feat = compare([on_card], served.predict_features([xte[idx]]),
                     "predict-daic vs its extract-daic features")
    check_results([on_card], 1, "cli predict-daic")
    print(f"cli predict-daic {pid} (start ordinal {start}): "
          f"{json.dumps(on_card)}; card vs CPU max|dprob| {d_cpu:.3e}, vs "
          f"its extract-daic features {d_feat:.3e} (tol {SLICE_TOL}); wall "
          f"{wall:.2f} s [{card}]")
    kernels = daic_kernel_checks(torch, rnn_cuda, card, max_r,
                                 1 << (max(counts[p] for p in dev_ids) - 1)
                                 .bit_length())
    step = daic_graph_check(torch, feats, card)
    for stage, wall in stage_s.items():
        print(f"timing DAIC stage cli {stage}: {wall:.2f} s wall [{card}]")
    return {"launches": counted.launches, "stage_s": stage_s,
            "kernels": kernels, "step_ms": step, "clf_ckpt": ckpts["clf"],
            "root": root, "dev_ids": dev_ids, "features": feats}


def seeded_daic(work: Path) -> dict:
    """``--only serve``'s stand-in for phase 9: the DAIC corpus and a
    seeded full-width ``daic_clf`` checkpoint."""
    from icassp2022_depression_tpu_torch.models import porting
    from icassp2022_depression_tpu_torch.models.audio_net import AudioNet
    from icassp2022_depression_tpu_torch.ops import prng
    from icassp2022_depression_tpu_torch.train import checkpoints
    from icassp2022_depression_tpu_torch.train import daic as tdaic

    root = work / "daic"
    corpus = make_daic_corpus(root)
    cfg = tdaic.DAIC_CLF.model
    ckpt = checkpoints.save(
        work / "daic_clf_seeded", porting.audio_net_tree_from_state_dict(
            AudioNet(cfg, prng.prng_key(5)).state_dict(), cfg),
        {"embedding_size": cfg.embedding_size})
    return {"clf_ckpt": ckpt, "root": root,
            "dev_ids": corpus["splits"]["dev"]}


# -- phase 10: the HTTP serving front ---------------------------------------

SERVE_CLIENTS, SERVE_REQUESTS = 16, 4
SERVE_KW = dict(batch_window_ms=5.0, max_batch=32, max_queue=64)
SERVE_TOKEN = "chip-smoke-token"


def _http(port: int, method: str, path: str, body=None, headers=None,
          context=None) -> tuple:
    import http.client

    conn = (http.client.HTTPSConnection("127.0.0.1", port, timeout=300,
                                        context=context) if context
            else http.client.HTTPConnection("127.0.0.1", port, timeout=300))
    try:
        conn.request(method, path, body, headers or {})
        r = conn.getresponse()
        return r.status, r.read(), dict(r.getheaders())
    finally:
        conn.close()


@contextlib.contextmanager
def _http_server(transport, predictor, **kw):
    """``make_http_server`` on an ephemeral port, served from a thread
    that is joined on the way out."""
    import threading

    server = transport.make_http_server(predictor, port=0, **kw)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        yield server.server_address[1]
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=60)
        if t.is_alive():
            fail("the HTTP server thread did not stop")


def _b64(w) -> str:
    import base64

    import numpy as np

    return base64.b64encode(np.asarray(w, np.int16).tobytes()).decode()


def _eatd_bodies(speakers, texts: bool) -> list:
    """Per speaker: its /predict JSON entry and its /predict_bin part."""
    import numpy as np

    out = []
    for sp in speakers:
        entry = {"wav_b64": [_b64(w) for w in sp.waveforms],
                 "sr": list(sp.sample_rates)}
        if texts:
            entry["texts"] = list(sp.texts)
        header = dict(entry, n_samples=[len(w) for w in sp.waveforms])
        del header["wav_b64"]
        pcm = b"".join(np.asarray(w, np.int16).tobytes()
                       for w in sp.waveforms)
        out.append((entry, header, pcm))
    return out


def _bin(parts) -> bytes:
    header = json.dumps({"speakers": [h for _, h, _ in parts]}).encode()
    return (len(header).to_bytes(4, "little") + header
            + b"".join(p for _, _, p in parts))


def _close_results(got, want, what: str) -> float:
    """Served against direct results (probabilities, or scores), within
    SLICE_TOL of max(1, |score|)."""
    if len(got) != len(want):
        fail(f"{what}: {len(got)} results for {len(want)}")
    worst = 0.0
    for g, w in zip(got, want):
        if set(g) != set(w) or g.get("label") != w.get("label"):
            fail(f"{what}: {g} against {w}")
        for k in ("probs", "phq8_score", "sds_score"):
            if k in w:
                a = w[k] if isinstance(w[k], list) else [w[k]]
                b = g[k] if isinstance(g[k], list) else [g[k]]
                d = max(abs(x - y) / max(1.0, abs(y)) for x, y in zip(b, a))
                if not d <= SLICE_TOL:
                    fail(f"{what}: {k} differs by {d}")
                worst = max(worst, d)
    return worst


def _burst(port: int, requests: list, headers: dict) -> tuple:
    """SERVE_CLIENTS client threads, each sending its SERVE_REQUESTS
    requests ``(path, body)`` in turn; returns ({(client, k): (status,
    payload)}, wall seconds)."""
    import threading

    out = {}

    def client(c):
        for k in range(SERVE_REQUESTS):
            path, body = requests[c * SERVE_REQUESTS + k]
            status, data, _ = _http(port, "POST", path, body, headers)
            out[(c, k)] = (status, data)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(SERVE_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads) or len(out) != len(requests):
        fail(f"serve burst: {len(out)} of {len(requests)} answered")
    return out, wall


def _parse_served(path: str, status: int, data: bytes, what: str) -> list:
    if status != 200:
        fail(f"{what} {path}: status {status}: {data[:300]!r}")
    if path == "/predict_stream":
        lines = [json.loads(ln) for ln in data.splitlines() if ln]
        if any("result" not in ln for ln in lines):
            fail(f"{what} /predict_stream: {lines}")
        return [ln["result"] for ln in
                sorted(lines, key=lambda ln: ln["index"])]
    return json.loads(data)["results"]


class _CountedCalls:
    """Counts a predictor's calls of ``method`` (each one device batch)."""

    def __init__(self, predictor, method: str):
        self.n = 0
        inner = getattr(predictor, method)

        def call(*args, **kwargs):
            self.n += 1
            return inner(*args, **kwargs)
        setattr(predictor, method, call)


def _serve_one(torch, rnn_cuda, transport, card: str, task: str, predictor,
               requests, per_call: dict, method: str) -> dict:
    """One task behind ``make_http_server`` (SERVE_KW, the bearer token):
    the burst of SERVE_CLIENTS x SERVE_REQUESTS requests, sent once to a
    warm-up server and then to a fresh one with the feature cache emptied,
    counted (every counter zeroed before, read after: exactly
    ``per_call`` a device batch), each answer against its reference
    (``requests``' third field, a direct call of another predictor); a
    wrong token is a 401; healthz's histograms and cache counters.  The
    readings are a smoke run's (64 requests over a few speakers), not a
    throughput.  Returns them."""
    calls = _CountedCalls(predictor, method)
    auth = {"Authorization": f"Bearer {SERVE_TOKEN}"}
    bodies = [(path, body) for path, body, _ in requests]
    with _http_server(transport, predictor, auth_token=SERVE_TOKEN,
                      **SERVE_KW) as port:
        _burst(port, bodies, auth)      # first calls' allocations
    cache = predictor.feature_cache
    predictor.feature_cache = type(cache)(cache.max_entries)
    with _http_server(transport, predictor, auth_token=SERVE_TOKEN,
                      **SERVE_KW) as port:
        status, _, hdrs = _http(port, "POST", "/predict", bodies[0][1],
                                {"Authorization": "Bearer wrong"})
        if status != 401 or hdrs.get("WWW-Authenticate") != "Bearer":
            fail(f"serve {task}: a wrong token got {status}")
        _set_counts(rnn_cuda, ZERO)
        calls.n = 0
        out, wall = _burst(port, bodies, auth)
        torch.cuda.synchronize()
        got = _counts(rnn_cuda)
        health = json.loads(_http(port, "GET", "/healthz")[1])
    want = {k: v * calls.n for k, v in per_call.items()}
    if not _held(got, dict(DRAWN, **want)):
        fail(f"serve {task}: {calls.n} device batches launched {got}, "
             f"expected {want}")
    worst = 0.0
    for i, (path, _, ref) in enumerate(requests):
        status, data = out[divmod(i, SERVE_REQUESTS)]
        worst = max(worst, _close_results(
            _parse_served(path, status, data, f"serve {task}"), ref,
            f"serve {task} {path} vs direct"))
    b = health["batcher"]
    if b["requests_served"] != len(requests) or b["pending"] != 0:
        fail(f"serve {task}: healthz {b}")
    lat = health["latency"]
    print(f"serve {task} (smoke reading after a warm-up burst): "
          f"{len(requests)} requests from {SERVE_CLIENTS} clients in "
          f"{wall:.3f} s, {b['batches_run']} device batches ({calls.n} "
          f"predictor calls, launches {got}), feature cache "
          f"{health['cache']['hits']} hits / {health['cache']['misses']} "
          f"misses; served vs direct max diff {worst:.3e} (tol "
          f"{SLICE_TOL}); request latency p50 / p90 / p99 "
          f"{lat['request']['p50_ms']} / {lat['request']['p90_ms']} / "
          f"{lat['request']['p99_ms']} ms, device batch "
          f"{lat['device_batch']['p50_ms']} / {lat['device_batch']['p90_ms']}"
          f" / {lat['device_batch']['p99_ms']} ms (healthz histograms; "
          f"window {SERVE_KW['batch_window_ms']} ms, max batch "
          f"{SERVE_KW['max_batch']}) [{card}]")
    return {"launches": got, "wall": wall, "batches": b["batches_run"],
            "latency": lat, "cache": health["cache"], "worst": worst}


def _overload_and_tls(transport, card: str, predictor, entry,
                      ref) -> None:
    """Overload on a server with one pending speaker allowed: 503 with
    Retry-After, the admitted answers right; then HTTPS with a
    self-signed certificate where ``openssl`` is present."""
    import shutil
    import ssl
    import threading

    body = json.dumps({"speakers": [entry]})
    out = {}
    with _http_server(transport, predictor, batch_window_ms=300.0,
                      max_batch=1, max_queue=1) as port:
        def one(i):
            out[i] = _http(port, "POST", "/predict", body)

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    statuses = sorted(s for s, _, _ in out.values())
    if 503 not in statuses or 200 not in statuses:
        fail(f"overload: statuses {statuses}")
    for status, data, hdrs in out.values():
        if status == 503 and hdrs.get("Retry-After") != "1":
            fail(f"a 503 without Retry-After: {hdrs}")
        if status == 200:
            _close_results(json.loads(data)["results"], ref,
                           "overload: an admitted request")
    print(f"serve overload (max_queue 1, max_batch 1, 6 concurrent): "
          f"statuses {statuses}, 503s carry Retry-After: 1")
    if shutil.which("openssl") is None:
        print("serve TLS: skipped (no openssl on this machine to mint a "
              "certificate)")
        return
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tls_") as tmp:
        cert, key = Path(tmp) / "crt.pem", Path(tmp) / "key.pem"
        subprocess.run(["openssl", "req", "-x509", "-newkey", "rsa:2048",
                        "-nodes", "-keyout", str(key), "-out", str(cert),
                        "-days", "1", "-subj", "/CN=127.0.0.1"],
                       capture_output=True, check=True, timeout=120)
        ctx = ssl.create_default_context(cafile=str(cert))
        ctx.check_hostname = False
        with _http_server(transport, predictor, tls_cert=str(cert),
                          tls_key=str(key)) as port:
            status, data, _ = _http(port, "POST", "/predict", body,
                                    context=ctx)
    if status != 200:
        fail(f"serve TLS: status {status}")
    d = _close_results(json.loads(data)["results"], ref, "serve TLS")
    print(f"serve TLS (self-signed, single-threaded): served vs direct "
          f"{d:.3e} [{card}]")


def serve_phase(torch, card: str, daic: dict) -> dict:
    """Phase 10, the HTTP front on the card (``make_http_server`` on port
    0 in a thread): ``audio_clf`` (seeded, full width), stand-in
    ``fuse_clf`` (seeded, ``elmo_weights=None``, feature cache off so each
    device batch embeds) and ``daic_clf`` (phase 9's checkpoint), each
    with SERVE_KW and a bearer token; counted bursts of SERVE_CLIENTS x
    SERVE_REQUESTS requests over /predict, /predict_bin and
    /predict_stream (DAIC: /predict), every answer within SLICE_TOL of a
    direct ``predict_batch`` / ``predict_signals`` of another predictor on
    the same speakers; then overload (503 + Retry-After), a wrong token
    (401) and TLS.  Returns the launches and the readings."""
    import numpy as np

    from icassp2022_depression_tpu_torch import config as C
    from icassp2022_depression_tpu_torch.data import eatd
    from icassp2022_depression_tpu_torch.frontend import daic as daic_fe
    from icassp2022_depression_tpu_torch.models import porting
    from icassp2022_depression_tpu_torch.models.audio_net import AudioNet
    from icassp2022_depression_tpu_torch.models.fusion import FusionNet
    from icassp2022_depression_tpu_torch.ops import prng, rnn_cuda
    from icassp2022_depression_tpu_torch.serving import transport
    from icassp2022_depression_tpu_torch.serving.predictors import (
        DaicPredictor,
        Predictor,
    )
    from icassp2022_depression_tpu_torch.train import checkpoints

    launches = dict(ZERO)
    readings = {}
    n_req = SERVE_CLIENTS * SERVE_REQUESTS
    paths = ("/predict", "/predict_bin", "/predict_stream", "/predict")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as tmp:
        root = Path(tmp) / "corpus"
        eatd.make_synthetic_corpus(root, n_data=12, n_validation=4,
                                   seconds=(2.0, 6.0), seed=9)
        speakers = list(eatd.iter_speakers(root, read_text=True))
        trees = {
            "audio_clf": ("audio", C.AUDIO_CLF.model,
                          AudioNet(C.AUDIO_CLF.model, prng.prng_key(21))),
            "fuse_clf": ("fusion", C.FUSE_CLF,
                         FusionNet(C.FUSE_CLF, prng.prng_key(22)))}
        for task, (kind, cfg, model) in trees.items():
            ckpt = checkpoints.save(
                Path(tmp) / task,
                {"audio": porting.audio_net_tree_from_state_dict,
                 "fusion": porting.fusion_tree_from_state_dict}[kind](
                     model.state_dict(), cfg),
                {"task": task, "text_embedder": "prng:seed=0",
                 "text_segmenter": "fallback"})
            kw = dict(device="cuda")
            if task == "fuse_clf":
                kw.update(elmo_weights=None, feature_cache_entries=0)
            predictor = Predictor.from_checkpoint(ckpt, task, **kw)
            direct = Predictor.from_checkpoint(ckpt, task, **kw)
            parts = _eatd_bodies(speakers, texts=task == "fuse_clf")
            requests = []
            for i in range(n_req):
                j = i % len(speakers)
                path = paths[i % len(paths)]
                entry, header, pcm = parts[j]
                body = (_bin([parts[j]]) if path == "/predict_bin"
                        else json.dumps({"speakers": [entry]}))
                ref = direct.predict_batch(
                    [speakers[j].waveforms], [speakers[j].sample_rates],
                    [speakers[j].texts] if task == "fuse_clf" else None)
                requests.append((path, body, ref))
            per_call = (dict(gru_fwd=2) if task == "audio_clf"
                        else dict(gru_fwd=2, lstm_fwd=8))
            readings[task] = _serve_one(torch, rnn_cuda, transport, card,
                                        task, predictor, requests, per_call,
                                        "predict_batch")
            if task == "audio_clf":
                _overload_and_tls(transport, card, predictor, parts[0][0],
                                  requests[0][2])
        # DAIC: dev participants' first 8-31 responses as int16 PCM
        predictor = DaicPredictor.from_checkpoint(daic["clf_ckpt"],
                                                  "daic_clf", device="cuda")
        direct = DaicPredictor.from_checkpoint(daic["clf_ckpt"], "daic_clf",
                                               device="cuda")
        queries = daic_fe.load_queries()
        rng = np.random.default_rng(10)
        requests = []
        sessions = {}
        for pid in daic["dev_ids"]:
            sig, sr = daic_fe.participant_signals(daic["root"], pid, queries)
            sessions[pid] = (sig, sr)
        for i in range(n_req):
            pid = daic["dev_ids"][i % len(daic["dev_ids"])]
            sig, sr = sessions[pid]
            k = int(rng.integers(8, 32))
            resp = [np.asarray(w, np.int16) for w in sig[:k]]
            body = json.dumps({"participants": [{
                "responses_b64": [_b64(w) for w in resp], "sr": sr}]})
            ref = direct.predict_signals([resp], [sr])
            requests.append(("/predict", body, ref))
        readings["daic_clf"] = _serve_one(
            torch, rnn_cuda, transport, card, "daic_clf", predictor,
            requests, dict(gru_fwd=2), "predict_signals")
    for r in readings.values():
        for k, v in r["launches"].items():
            launches[k] += v
    return {"launches": launches, "readings": readings}


# -- phase 11: VGGish, cross-corpus evaluation, the stateful ELMo mode -----

#: EATD's size, the corpus of phase 6's timings (same seed and lengths)
VGGISH_SPEAKERS = (83, 79)
#: the --audio-dim 128 recipe's epochs (3 trained epochs a fold)
VGGISH_EPOCHS = 4
#: cross-corpus batches: next_pow2 of the dev split's windows, and the
#: batch of AVEC2017's 35 dev participants (timed alone)
CROSS_TIMED = (3, 1024, 256)


def vggish_bounds(n: int):
    """The VGGish network's bound on ``n`` examples: its convolutions' and
    FCs' float32 flops, the examples, weights and embeddings read or
    written once."""
    from icassp2022_depression_tpu_torch.models import vggish

    flops, h, w, params = 0, vggish.EXAMPLE_FRAMES, vggish.NUM_MEL_BINS, 0
    for i, (cin, cout) in enumerate(vggish._CONV_CHANNELS):
        flops += 2 * n * h * w * cin * cout * 9
        params += 9 * cin * cout + cout
        if i in vggish._POOL_AFTER:
            h, w = h // 2, w // 2
    for din, dout in vggish._FC_DIMS:
        flops += 2 * n * din * dout
        params += din * dout + dout
    return bound(flops, 4 * (n * vggish.EXAMPLE_FRAMES * vggish.NUM_MEL_BINS
                             + params + n * vggish.EMBEDDING_SIZE)), flops


def vggish_network_checks(torch, card: str, corpus: Path):
    """Not counted: the seeded stand-in drawn on the card against the CPU
    draw (bitwise); one chunk of real examples through the network on the
    card against the CPU within SLICE_TOL of the largest output, with
    ``torch.backends.cudnn.allow_tf32`` at PyTorch's default (True) around
    the call (the module turns it off around its convolutions; the same
    chunk with that guard lifted shows what TF32 would cost); the chunk's
    device time beside its bound.  Returns the CPU draw."""
    import numpy as np

    from icassp2022_depression_tpu_torch.data import eatd
    from icassp2022_depression_tpu_torch.frontend import audio as afe
    from icassp2022_depression_tpu_torch.models import vggish
    from icassp2022_depression_tpu_torch.ops import prng

    t0 = time.perf_counter()
    on_card = vggish.init(prng.prng_key(0, "cuda"))
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = vggish.init(prng.prng_key(0, "cpu"))
    cpu_s = time.perf_counter() - t0
    same = all(torch.equal(a[k].cpu(), b[k]) for g in ("convs", "fcs")
               for a, b in zip(on_card[g], on_cpu[g]) for k in ("w", "b"))
    n = sum(d[k].numel() for g in ("convs", "fcs") for d in on_cpu[g]
            for k in d)
    print(f"vggish stand-in (seed 0, {n} floats): drawn on the card in "
          f"{card_s:.2f} s, on the CPU in {cpu_s:.2f} s; bitwise equal "
          f"{same} [{card}]")
    if not same:
        fail("the VGGish stand-in drawn on the card differs from the CPU's")
    examples = np.concatenate([
        vggish.waveform_to_examples(w, sr)
        for sp in eatd.load_speakers(corpus)[:6]
        for w, sr in zip(sp.waveforms, sp.sample_rates)])[:afe.VGGISH_CHUNK]
    chunk = np.zeros((afe.VGGISH_CHUNK,) + examples.shape[1:], np.float32)
    chunk[:len(examples)] = examples
    model = vggish.from_params(on_card, "cuda")
    x = torch.from_numpy(chunk).cuda()
    with torch.inference_mode():
        want = vggish.from_params(on_cpu, "cpu")(torch.from_numpy(chunk))
        default = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True    # PyTorch's default
        try:
            got = model(x).cpu()
            guard = vggish.no_tf32_convs
            vggish.no_tf32_convs = contextlib.nullcontext
            try:
                tf32 = model(x).cpu()
            finally:
                vggish.no_tf32_convs = guard
        finally:
            torch.backends.cudnn.allow_tf32 = default
        scale = float(want.abs().max())
        err = float((got - want).abs().max()) / scale
        tf32_err = float((tf32 - want).abs().max()) / scale
        ms = event_ms(lambda: model(x), 20, torch)
    (b_ms, by), flops = vggish_bounds(afe.VGGISH_CHUNK)
    print(f"vggish network on {afe.VGGISH_CHUNK} examples ({len(examples)} "
          f"real), card vs CPU with cudnn.allow_tf32 at its default True: "
          f"max|d| {err:.3e} of the largest (tol {SLICE_TOL}); the same "
          f"call with the module's TF32 guard lifted {tf32_err:.3e}")
    if not err <= SLICE_TOL:
        fail(f"VGGish on the card differs from the CPU: {err}")
    print(f"timing vggish chunk of {afe.VGGISH_CHUNK} examples: {ms:.4f} ms "
          f"device time (median of 20, CUDA events; {flops / 1e9:.1f} "
          f"GFLOP); bound {b_ms:.4f} ms ({by}), {b_ms / ms:.4f} of it "
          f"[{card}]")
    return on_cpu, {"chunk_ms": ms, "chunk_bound_ms": b_ms,
                    "chunk_err": err, "tf32_err": tf32_err}


def vggish_cli_checks(torch, counted, card: str, work: Path, on_cpu):
    """Counted at EATD's size (a synthetic corpus of 83 + 79 speakers):
    ``cli extract-audio --embedder vggish`` (no kernel of the port) beside
    the wav2vlad ``cli extract-audio`` of the same corpus; its features
    finite, 3 speakers' the CPU's within SLICE_TOL of the largest; ``cli
    train --task audio_clf --audio-dim 128`` on them at VGGISH_EPOCHS with
    the gate open (exact launches; each fold through its CUDA graph), the
    same with ``--vmap-folds`` (not counted) against it within VMAP_TOL;
    ``cli predict --audio-embedder vggish`` of fold 1's checkpoint (2
    ``gru_fwd``) against the CPU's ``Predictor`` within SLICE_TOL."""
    import numpy as np

    from icassp2022_depression_tpu_torch import cli
    from icassp2022_depression_tpu_torch import config as C
    from icassp2022_depression_tpu_torch.data import eatd
    from icassp2022_depression_tpu_torch.frontend import audio as afe
    from icassp2022_depression_tpu_torch.models import vggish
    from icassp2022_depression_tpu_torch.serving.predictors import Predictor

    if vggish.default_weights_path() is not None:
        fail(f"a VGGish bundle ({vggish.default_weights_path()}) would "
             "replace the seeded stand-in this phase checks")
    big = work / "vggish_eatd"
    t0 = time.perf_counter()
    eatd.make_synthetic_corpus(big, n_data=VGGISH_SPEAKERS[0],
                               n_validation=VGGISH_SPEAKERS[1],
                               seconds=(2.0, 12.0), seed=5)
    make_s = time.perf_counter() - t0
    n_spk = sum(VGGISH_SPEAKERS)
    audio = big / "Features" / "AudioWhole"
    walls = {}
    for name, extra in (("netvlad", []), ("vggish", ["--embedder", "vggish"]),
                        ("netvlad again", []),
                        ("vggish again", ["--embedder", "vggish"])):
        lines, walls[name] = counted(
            ["extract-audio", "--root", big, *extra], DRAWN,
            f"cli extract-audio {name} ({n_spk} speakers)")
    print(f"timing cli extract-audio at {n_spk} speakers ({3 * n_spk} "
          f"answers of 2-12 s; corpus written in {make_s:.2f} s), in turns: "
          f"wav2vlad "
          f"{walls['netvlad']:.2f}, {walls['netvlad again']:.2f} s; "
          f"--embedder vggish {walls['vggish']:.2f}, "
          f"{walls['vggish again']:.2f} s wall [{card}]")
    xa = np.load(audio / "whole_samples_clf_128.npz")["arr_0"]
    manifest = json.loads((audio / "manifest.json").read_text())
    if (xa.shape != (n_spk, 3, 1, 128) or not np.isfinite(xa).all()
            or manifest.get("embedder") != "vggish"):
        fail(f"extract-audio --embedder vggish: {xa.shape}, {manifest}")
    speakers = eatd.load_speakers(big)[:3]
    cpu = afe.vggish_embed_waveforms(
        vggish.from_params(on_cpu, "cpu"),
        [w for sp in speakers for w in sp.waveforms],
        [r for sp in speakers for r in sp.sample_rates])
    err = float(np.abs(xa[:3].reshape(9, -1) - cpu).max()
                / np.abs(cpu).max())
    print(f"extract-audio --embedder vggish: {xa.shape}, 3 speakers card vs "
          f"CPU max|d| {err:.3e} of the largest (tol {SLICE_TOL})")
    if not err <= SLICE_TOL:
        fail(f"VGGish features on the card differ from the CPU: {err}")

    full = C.AUDIO_CLF
    try:
        C.AUDIO_CLF = C.replace(full, epochs=VGGISH_EPOCHS, gate=C.replace(
            full.gate, f1_floor=-1.0, train_acc_frac=0.0,
            train_acc_strict=False))
        model = work / "vggish_model"
        argv = ["train", "--task", "audio_clf", "--root", big,
                "--audio-dim", "128", "--model-dir", model]
        # the expected launches come from the run's own epoch records
        rnn_cuda = counted.rnn_cuda
        _set_counts(rnn_cuda, ZERO)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main([str(a) for a in argv] + ["--device", "cuda"])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        got = _counts(rnn_cuda)
        if rc != 0:
            fail(f"cli train --audio-dim 128 returned {rc}")
        records = [json.loads(ln) for ln in
                   (model / "audio_clf_metrics.jsonl").read_text()
                   .splitlines()]
        epochs = [r for r in records if r["event"] == "epoch"]
        if len(epochs) != 3 * (VGGISH_EPOCHS - 1) or not all(
                _finite(r["loss"]) for r in epochs):
            fail(f"cli train --audio-dim 128 logged {len(epochs)} epochs")
        _check_launches("audio_clf --audio-dim 128", got, *warmed(epochs), 3)
        for k, v in got.items():
            counted.launches[k] += v
        vmap_model = work / "vggish_model_vmap"
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main([str(a) for a in argv[:-1]]
                          + [str(vmap_model), "--vmap-folds", "--device",
                             "cuda"])
        _set_counts(rnn_cuda, dict(ZERO))
        if rc != 0:
            fail(f"cli train --audio-dim 128 --vmap-folds returned {rc}")
        stacked = [json.loads(ln) for ln in
                   (vmap_model / "audio_clf_metrics.jsonl").read_text()
                   .splitlines() if json.loads(ln)["event"] == "epoch"]
        worst = max(abs(a[k] - b[k]) / max(1e-12, abs(b[k]))
                    for a, b in zip(stacked, epochs) for k in ("loss",))
        print(f"cli train --task audio_clf --audio-dim 128 ({n_spk} "
              f"speakers, 3 folds x {VGGISH_EPOCHS - 1} epochs, gate open): "
              f"launches {got}; wall {train_s:.2f} s; --vmap-folds epoch "
              f"losses within {worst:.3e} of the serial run's (tol "
              f"{VMAP_TOL}) [{card}]")
        if len(stacked) != len(epochs) or not worst <= VMAP_TOL:
            fail(f"--audio-dim 128 --vmap-folds differs: {worst}")
    finally:
        C.AUDIO_CLF = full
    ckpt = _fold_ckpt(model / "ClassificationWhole" / "Audio", "*_1.npz")
    sp = speakers[1]
    lines, wall = counted(
        ["predict", "--task", "audio_clf", "--ckpt", ckpt, "--root", big,
         "--speaker", f"{sp.split}/{sp.number}", "--audio-embedder",
         "vggish"], dict(DRAWN, gru_fwd=2), "cli predict --audio-embedder "
        "vggish")
    on_card = json.loads(lines[-1])
    cfg128 = C.replace(C.AUDIO_CLF.model, embedding_size=128)
    on_host = Predictor.from_checkpoint(
        ckpt, "audio_clf", model_cfg=cfg128, audio_embedder="vggish",
        vggish_params=on_cpu, device="cpu").predict_speaker(
            sp.waveforms, sp.sample_rates)
    d = compare([on_card], [on_host], "predict --audio-embedder vggish "
                "card vs CPU")
    check_results([on_card], 1, "cli predict --audio-embedder vggish")
    print(f"cli predict --audio-embedder vggish {on_card['speaker']}: "
          f"{on_card['probs']}; card vs CPU max|dprob| {d:.3e} (tol "
          f"{SLICE_TOL}); wall {wall:.2f} s [{card}]")
    return {"extract_s": walls, "train_s": train_s, "feature_err": err}


def cross_corpus_checks(torch, rnn_cuda, card: str, daic_features: Path):
    """EATD audio models (seeded, full width; the regressor's last bias
    shifted to SDS scale) on phase 9's DAIC features:
    ``evaluate_clf`` on the dev split and ``evaluate_reg`` on both splits,
    each one batch of next_pow2(windows) rows through 2 ``gru_fwd``
    launches (counted, exact), against the CPU (predictions equal, window
    outputs within SLICE_TOL); then, not counted, ``gru_fwd`` at
    CROSS_TIMED against its plain loop (KERNEL_TOL) and timed in turns
    with it and cuDNN beside its bound.  Returns the launches and
    readings."""
    import numpy as np

    from icassp2022_depression_tpu_torch import config as C
    from icassp2022_depression_tpu_torch.eval import cross_corpus as cc
    from icassp2022_depression_tpu_torch.frontend import daic as daic_fe
    from icassp2022_depression_tpu_torch.models.audio_net import AudioNet
    from icassp2022_depression_tpu_torch.ops import prng
    from icassp2022_depression_tpu_torch.utils import shapes

    launches = dict(ZERO)
    readings = {}
    xs, ys = daic_fe.load_features(daic_features, "dev", "clf")
    xr = []
    yr = []
    for split in ("train", "dev"):
        a, b = daic_fe.load_features(daic_features, split, "reg")
        xr += list(a)
        yr += list(b)
    for name, fn, cfg, feats, labels in (
            ("evaluate_clf", cc.evaluate_clf, C.AUDIO_CLF.model, xs, ys),
            ("evaluate_reg", cc.evaluate_reg, C.AUDIO_REG.model, xr, yr)):
        model = AudioNet(cfg, prng.prng_key(41))
        if name == "evaluate_reg":
            # SDS-scale scores out of the ReLU head, as a trained
            # regressor gives, not the seeded head's zeros
            with torch.no_grad():
                [m for m in model.modules()
                 if isinstance(m, torch.nn.Linear)][-1].bias += 40.0
        windows = sum(-(-len(f) // 3) for f in feats)
        _set_counts(rnn_cuda, ZERO)
        t0 = time.perf_counter()
        on_card = fn(model, feats, labels, cfg, device="cuda")
        wall = time.perf_counter() - t0
        got = _counts(rnn_cuda)
        if not _held(got, dict(DRAWN, gru_fwd=2)):
            fail(f"{name} launched {got}, expected 2 gru_fwd")
        for k, v in got.items():
            launches[k] += v
        on_cpu = fn(model, feats, labels, cfg, device="cpu")
        _, out_card = cc._all_window_outputs(model.cuda(), feats)
        _, out_cpu = cc._all_window_outputs(model.cpu(), feats)
        _set_counts(rnn_cuda, ZERO)
        err = float(np.abs(out_card - out_cpu).max())
        if not np.ptp(out_cpu) > 0:
            fail(f"{name}: every window gives {out_cpu.ravel()[0]}")
        same = (on_card.get("predictions") == on_cpu.get("predictions")
                and all(abs(on_card[k] - on_cpu[k]) <= 1e-5 * max(
                    1.0, abs(on_cpu[k])) for k in on_cpu
                        if isinstance(on_cpu[k], float)))
        shown = {k: v for k, v in on_card.items()
                 if k not in ("predictions", "confusion_matrix")}
        print(f"cross-corpus {name}: {len(feats)} DAIC participants, "
              f"{windows} windows in one batch of "
              f"{shapes.next_pow2(windows)} rows; {json.dumps(shown)}; "
              f"launches {got}; card vs CPU: window outputs max|d| "
              f"{err:.3e} (tol {SLICE_TOL}), metrics and predictions equal "
              f"{same}; wall {wall * 1e3:.1f} ms [{card}]")
        if not (err <= SLICE_TOL and same):
            fail(f"{name} on the card differs from the CPU")
        readings[name] = {"windows": windows, "ms": wall * 1e3}

    t, b, h = CROSS_TIMED
    gen = torch.Generator().manual_seed(17)
    args = (torch.randn((t, b, 3 * h), generator=gen).cuda(),
            ((torch.rand((h, 3 * h), generator=gen) * 2 - 1)
             * h ** -0.5).cuda(),
            ((torch.rand((1, 3 * h), generator=gen) * 2 - 1)
             * h ** -0.5).cuda())
    before = _counts(rnn_cuda)
    ys_k = rnn_cuda.gru_sequence(*args)
    err = float((ys_k - rnn_cuda.gru_sequence_torch(*args)).abs().max())
    same = torch.equal(ys_k, rnn_cuda.gru_sequence(*args))
    if not (err <= KERNEL_TOL and same):
        fail(f"gru_fwd at {CROSS_TIMED} disagrees with its plain loop: "
             f"{err}, rerun bitwise {same}")
    fns = _gru_turn_fns(torch, rnn_cuda, args, CROSS_TIMED)
    ms = turns_ms(torch, fns, 50)
    _set_counts(rnn_cuda, before)
    plan = rnn_cuda.gru_fwd_plan(b, h)
    b_ms, by = rnn_bounds("gru", t, b, h)["fwd"]
    print(f"timing gru_fwd at the cross-corpus batch {CROSS_TIMED} (plan "
          f"{plan}): max|cuda - plain| {err:.3e} (tol {KERNEL_TOL}), rerun "
          f"bitwise {same}; " + ", ".join(f"{k} {v:.4f} ms"
                                          for k, v in ms.items())
          + f"; bound {b_ms:.6f} ms ({by}), {b_ms / ms['kernel']:.4f} "
          f"of it (median of 50 in turns, CUDA events) [{card}]")
    readings["gru_fwd"] = dict(ms, err=err, bound_ms=b_ms)
    return launches, readings


def stateful_text_checks(torch, counted, card: str, corpus: Path,
                         bundle: Path, work: Path):
    """``cli extract-text --elmo-stateful`` with the seeded zhs bundle,
    counted: one embedding call a speaker, the biLM state carried across
    them through the plain step loop (no kernel launch at all); beside the
    stateless ``cli extract-text`` of the same corpus (counted too).  The
    first speaker's features (zero initial state) equal the stateless
    ones within SLICE_TOL of the largest, and later ones differ; the CPU,
    with the same bundle carrying its state over two calls, gives the
    first two speakers within SLICE_TOL of the largest."""
    import numpy as np

    from icassp2022_depression_tpu_torch.data import eatd
    from icassp2022_depression_tpu_torch.frontend import text as tfe
    from icassp2022_depression_tpu_torch.models import elmo_pretrained as ep

    texts = [sp.texts for sp in eatd.iter_speakers(corpus, read_text=True)]
    n_batches = -(-3 * len(texts) // 128)
    outs, walls = {}, {}
    for name, flag, want in (
            ("stateless", [], dict(DRAWN, lstmp_fwd=4 * n_batches)),
            ("stateful", ["--elmo-stateful"], DRAWN),
            ("stateless again", [], dict(DRAWN, lstmp_fwd=4 * n_batches)),
            ("stateful again", ["--elmo-stateful"], DRAWN)):
        outs[name] = work / f"text {name}"
        _, walls[name] = counted(
            ["extract-text", "--root", corpus, "--out", outs[name],
             "--elmo-weights", bundle, "--segmenter", "fallback", *flag],
            want, f"cli extract-text {name}")
    feats = {k: np.load(outs[k] / "whole_samples_clf_avg.npz")["arr_0"]
             for k in ("stateless", "stateful", "stateful again")}
    meta = json.loads((outs["stateful"] / "extraction_meta.json")
                      .read_text())
    if meta["embedder"] != bundle_id(bundle) + ":stateful":
        fail(f"extract-text --elmo-stateful: {meta}")
    scale = float(np.abs(feats["stateless"]).max())
    first = float(np.abs(feats["stateful"][0]
                         - feats["stateless"][0]).max()) / scale
    later = float(np.abs(feats["stateful"][1:]
                         - feats["stateless"][1:]).max()) / scale
    rerun = np.array_equal(feats["stateful"], feats["stateful again"])
    pe = ep.load_npz(bundle, "cpu")
    pe.stateful = True
    cpu = np.stack([pe.embed_sentences(
        [tfe.tokenize(t, "fallback") for t in ts]).numpy()
        for ts in texts[:2]])
    err = float(np.abs(feats["stateful"][:2] - cpu).max()
                / np.abs(cpu).max())
    print(f"cli extract-text --elmo-stateful ({len(texts)} speakers, one "
          f"call each, state carried): no kernel launch; the first speaker "
          f"within {first:.3e} of the stateless features, later speakers "
          f"up to {later:.3e} apart (of the largest); a rerun bitwise "
          f"{rerun}; 2 speakers (2 calls) card vs CPU max|d| {err:.3e} of "
          f"the largest (tol {SLICE_TOL})")
    if not (first <= SLICE_TOL and later > 10 * SLICE_TOL and rerun
            and err <= SLICE_TOL):
        fail("the stateful extraction disagrees")
    print(f"timing cli extract-text at {len(texts)} speakers, in turns: "
          f"stateless {walls['stateless']:.2f}, "
          f"{walls['stateless again']:.2f} s; --elmo-stateful "
          f"{walls['stateful']:.2f}, {walls['stateful again']:.2f} s wall "
          f"[{card}]")
    return walls


def vggish_phase(torch, card: str, corpus: Path, bundle: Path, work: Path,
                 daic_features: Path) -> dict:
    """Phase 11: VGGish (``vggish_network_checks``, ``vggish_cli_checks``),
    cross-corpus evaluation (``cross_corpus_checks``) and the stateful
    ELMo mode (``stateful_text_checks``) on the card.  Returns the counted
    launches and the timings."""
    from icassp2022_depression_tpu_torch.ops import rnn_cuda

    t0 = time.perf_counter()
    counted = _Counted(torch, rnn_cuda)
    on_cpu, net = vggish_network_checks(torch, card, corpus)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_vggish_") as tmp:
        cli = vggish_cli_checks(torch, counted, card, Path(tmp), on_cpu)
        text = stateful_text_checks(torch, counted, card, corpus, bundle,
                                    Path(tmp))
    cross_launches, cross = cross_corpus_checks(torch, rnn_cuda, card,
                                                daic_features)
    for k, v in cross_launches.items():
        counted.launches[k] += v
    print(f"timing phase 11: {time.perf_counter() - t0:.1f} s [{card}]")
    return {"launches": counted.launches, "net": net, "cli": cli,
            "text_s": text, "cross": cross}


# -- phase 12: multi-GPU (parallel/) ------------------------------------------

PARALLEL_EPOCHS = 20
#: a shared-card run is a smoke reading of the code path, not a scaling one
SHARED = "shared-card smoke reading, not scaling"


def _parallel_speakers(clf, dp: int) -> int:
    """The most leading speakers of phase 5's corpus whose 3 folds (seed
    0) give a padded test split that ``dp``-way data parallelism can take:
    the JAX package's layout asserts that ``dp`` divides it."""
    import numpy as np

    from icassp2022_depression_tpu_torch.data import augment, folds

    for n in range(len(clf), 11, -1):
        y = clf[:n]
        dep, non = np.where(y == 1)[0], np.where(y == 0)[0]
        tests = [len(augment.plan_classification_fold(y, t, dep, non)[1]
                     .targets) for t in folds.generate_clf_folds(y, 3)]
        if max(tests) % dp == 0:
            return n
    fail("no leading speakers give an even test split")


def _same_results(torch, a, b) -> bool:
    """Two trainers' per-fold results bitwise equal: gated metrics, every
    per-epoch log, every step loss and every gated parameter."""
    import numpy as np

    for ra, rb in zip(a, b):
        if {k: v for k, v in ra["best"].items() if k != "params"} != \
                {k: v for k, v in rb["best"].items() if k != "params"}:
            return False
        if any(not np.array_equal(ra["logs"][k], rb["logs"][k])
               for k in rb["logs"]):
            return False
        if not np.array_equal(ra["step_losses"], rb["step_losses"]):
            return False
        if any(not torch.equal(v.cpu(), rb["best"]["params"][k].cpu())
               for k, v in ra["best"]["params"].items()):
            return False
    return len(a) == len(b)


def _logs_gap(a, b) -> tuple:
    """(max |d log| over every per-epoch log relative to its largest
    magnitude, whether every fold's gated epoch is the same)."""
    import numpy as np

    gap = 0.0
    for ra, rb in zip(a, b):
        for k, v in rb["logs"].items():
            scale = max(float(np.abs(v).max()), 1e-30)
            gap = max(gap, float(np.abs(ra["logs"][k] - v).max()) / scale)
    return gap, all(ra["best"]["epoch"] == rb["best"]["epoch"]
                    for ra, rb in zip(a, b))


def _steps_gap(a, b) -> float:
    """Max |d step loss| over every fold relative to its largest
    magnitude."""
    import numpy as np

    return max(float(np.abs(ra["step_losses"] - rb["step_losses"]).max())
               / max(float(np.abs(rb["step_losses"]).max()), 1e-30)
               for ra, rb in zip(a, b))


def _rank_launches(what: str, got: list, want: dict) -> dict:
    """Each rank's kernel launches must be ``want``; returns their sum."""
    total = dict(ZERO)
    for r, counts in enumerate(got):
        counts = {k: counts[k] for k in ZERO}
        if not _held(counts, want):
            fail(f"{what}: rank {r} launched {counts}, expected {want}")
        for k, v in counts.items():
            total[k] += v
    print(f"{what}: every one of {len(got)} ranks launched exactly {want}")
    return total


def nccl_world_one(torch, rnn_cuda, card: str, data, work: Path) -> dict:
    """(a) NCCL at world size 1 on cuda:0: each collective the port uses
    on CUDA tensors, and a DP ``FoldRun`` of ``audio_clf`` with a one-rank
    NCCL data group (its collectives captured in the epoch's CUDA graph)
    against the same fold without a group (bitwise).  Returns the DP
    run's launches (a main path: counted)."""
    import numpy as np
    import torch.distributed as dist

    from icassp2022_depression_tpu_torch import config as C
    from icassp2022_depression_tpu_torch.parallel import distributed, dryrun
    from icassp2022_depression_tpu_torch.train import loop, optim, trainers

    tcfg = C.replace(C.AUDIO_CLF, epochs=COMPARE_EPOCHS + 1)
    dist.init_process_group("nccl", init_method=f"file://{work}/nccl_one",
                            world_size=1, rank=0,
                            timeout=distributed.COLLECTIVE_TIMEOUT)
    try:
        c = dryrun.collectives()
        base = torch.arange(8, dtype=torch.float32, device="cuda")
        ok = (torch.equal(c["all_reduce"], base)
              and torch.equal(c["broadcast"], base)
              and torch.equal(c["all_gather"], base[None])
              and c["all_gather_object"] == [{"rank": 0}]
              and c["broadcast_object_list"] == {"from": 0}
              and c["device"].startswith("cuda"))
        print(f"(a) NCCL world size 1 on {c['device']}: all_reduce, "
              f"broadcast, all_gather, all_gather_object, "
              f"broadcast_object_list right: {ok}")
        if not ok:
            fail(f"NCCL collectives wrong: {c}")

        def fold(group):
            model = trainers.init_model(tcfg, 0, 1, "cuda")
            opt = optim.build(tcfg.optimizer, model)
            run = loop.FoldRun(model, opt, *loop.model_fns(
                model, trainers._branch_fns(tcfg)), data, tcfg.track,
                tcfg.gate, COMPARE_EPOCHS, trainers.dropout_key(0, 1, "cuda"),
                data_group=group)
            t0 = time.perf_counter()
            run.run(COMPARE_EPOCHS)
            _, _, steps = run.results()
            return (run.graph, steps, time.perf_counter() - t0,
                    {k: v.cpu() for k, v in model.state_dict().items()},
                    run.n_steps)

        _set_counts(rnn_cuda, ZERO)
        captured, dp_steps, dp_s, dp_params, n_steps = fold(dist.group.WORLD)
        launches = _counts(rnn_cuda)
        _, steps, plain_s, params, _ = fold(None)
    finally:
        dist.destroy_process_group()
    same = (np.array_equal(dp_steps, steps)
            and all(torch.equal(dp_params[k], v) for k, v in params.items()))
    print(f"(a) {COMPARE_EPOCHS}-epoch audio_clf fold with a one-rank NCCL "
          f"data group: epochs captured in a CUDA graph {captured}; step "
          f"losses and params bitwise the fold without a group: {same}; "
          f"{dp_s:.2f} s against {plain_s:.2f} s wall [{card}]")
    if not (captured and same):
        fail("the NCCL data-parallel fold differs from the plain fold, or "
             "was not captured")
    _check_launches("audio_clf (DP, NCCL world 1)", launches,
                    (COMPARE_EPOCHS + 1) * n_steps, COMPARE_EPOCHS + 1, 1)
    return launches


#: the clf fusion's DP x TP step of (c): ``dryrun_multichip``'s mesh for 6
#: devices (model 2), its batch (2 * devices), the recipe's 3 answers
DP_TP_MESH = (3, 2)
DP_TP_BATCH, DP_TP_STEPS = 12, 3


def dp_tp_call(torch) -> tuple:
    """(fn, args, kwargs) of ``dryrun.dp_tp_fusion_step`` at the full
    ``FUSE_CLF`` width (audio 256 -> GRU 256 x 2, text 1024 -> BiLSTM 128
    x 2): a seeded ``FusionNet``'s state dict (threefry, the JAX package's
    init) and a seeded batch, dropout 0.3 in train mode."""
    import numpy as np

    from icassp2022_depression_tpu_torch import config as C
    from icassp2022_depression_tpu_torch.models.fusion import FusionNet
    from icassp2022_depression_tpu_torch.ops import prng
    from icassp2022_depression_tpu_torch.parallel import dryrun

    fcfg = C.FUSE_CLF
    sd = FusionNet(fcfg, prng.prng_key(0)).state_dict()
    gen = np.random.default_rng(6)
    shape = (DP_TP_BATCH, DP_TP_STEPS)
    xa = gen.standard_normal(shape + (fcfg.audio_embed_size,)).astype(
        np.float32)
    xt = gen.standard_normal(shape + (fcfg.text_embed_size,)).astype(
        np.float32)
    y = gen.integers(0, 2, DP_TP_BATCH)
    mask = np.ones(DP_TP_BATCH, np.float32)
    return (dryrun.dp_tp_fusion_step,
            (fcfg, C.FUSE_CLF_TRAINER, sd, xa, xt, y, mask),
            dict(key_seed=1, model_parallel=DP_TP_MESH[1]))


def dp_tp_checks(torch, rnn_cuda, card: str, call: tuple,
                 got: list) -> dict:
    """(c)'s DP x TP step: the 6 ranks' results (``got``, in rank order)
    against ``dryrun.dp_tp_fusion_step_reference`` on cuda:0 (the serial
    ``pretrained_feature``: TPU kernels #1 and #4, counted exactly).
    ``tf`` / ``af`` (the data ranks' rows), the loss and ``fc_final``'s
    gradient and update within 1e-5 of their largest magnitude; every
    rank of a model group the same, bitwise; the frozen parameters bitwise
    their initial values.  Returns the reference's launches."""
    from icassp2022_depression_tpu_torch.parallel import dryrun

    _, args, kwargs = call
    fcfg = args[0]
    data, model = DP_TP_MESH
    _set_counts(rnn_cuda, ZERO)
    ref = dryrun.dp_tp_fusion_step_reference(
        *args, key_seed=kwargs["key_seed"], device="cuda")
    launches = _counts(rnn_cuda)
    want = dict(DRAWN, gru_fwd=fcfg.rnn_layers, lstm_fwd=2 * fcfg.rnn_layers)
    if not _held(launches, want):
        fail(f"the one-process DP x TP reference launched {launches}, "
             f"expected {want}")
    print(f"(c) the one-process reference step launched exactly {want}")
    for r, v in enumerate(got):
        peer = got[r - r % model]
        if not all(torch.equal(v[k], peer[k])
                   for k in ("tf", "af", "grad", "fc_final")) or \
                v["loss"] != peer["loss"]:
            fail(f"DP x TP rank {r} differs from rank {r - r % model} of "
                 "its model group")

    def gap(a, b) -> float:
        b = b.cpu()
        return float((a.cpu() - b).abs().max()) / max(
            float(b.abs().max()), 1e-30)

    gaps = {k: gap(torch.cat([got[d * model][k] for d in range(data)]),
                   ref[k]) for k in ("tf", "af")}
    for k in ("grad", "fc_final"):
        gaps[k] = max(gap(v[k], ref[k]) for v in got)
    gaps["loss"] = max(abs(v["loss"] - ref["loss"]) for v in got) / max(
        abs(ref["loss"]), 1e-30)
    frozen = (ref["frozen_same"] and all(
        v["frozen_same"] and v["frozen_l1"] == ref["frozen_l1"]
        for v in got))
    print(f"(c) clf fusion DP x TP step at full FUSE_CLF width, mesh "
          f"(data {data}, model {model}) on 6 Gloo ranks of cuda:0, batch "
          f"{DP_TP_BATCH} x {DP_TP_STEPS}, dropout {fcfg.dropout}: within "
          + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())
          + f" of their largest magnitude of the one-process reference "
          f"(kernels #1, #4; tol {SLICE_TOL}); loss {got[0]['loss']:.7f} "
          f"(reference {ref['loss']:.7f}); frozen parameters bitwise: "
          f"{frozen}")
    steps = [v["step_s"] for v in got]
    print(f"timing phase 12 (c) DP x TP step: {min(steps):.3f}-"
          f"{max(steps):.3f} s a rank (6 ranks sharing the card over Gloo), "
          f"reference {ref['step_s']:.3f} s wall [{card}; {SHARED}]")
    if not (max(gaps.values()) <= SLICE_TOL and frozen):
        fail(f"the DP x TP step differs from the one-process step: {gaps}, "
             f"frozen parameters bitwise {frozen}")
    return launches


def parallel_phase(torch, card: str, corpus: Path, bundle: Path,
                   work: Path) -> dict:
    """Phase 12: the multi-GPU paths on one card (NCCL takes one rank a
    card, so several ranks share cuda:0 over Gloo).  Returns the counted
    launches (summed over the ranks) and the wall times."""
    global np
    import numpy as np

    from icassp2022_depression_tpu_torch import cli
    from icassp2022_depression_tpu_torch import config as C
    from icassp2022_depression_tpu_torch.data import folds
    from icassp2022_depression_tpu_torch.frontend import audio as afe
    from icassp2022_depression_tpu_torch.frontend import text as tfe
    from icassp2022_depression_tpu_torch.ops import rnn_cuda
    from icassp2022_depression_tpu_torch.parallel import distributed, dryrun
    from icassp2022_depression_tpu_torch.train import trainers

    t_phase = time.perf_counter()
    launches, walls = dict(ZERO), {}

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    feats, _, clf_all = afe.extract_eatd_device(corpus, device="cuda")
    # (e)'s serial reference, counted: the serial biLM runs TPU kernel #6
    _set_counts(rnn_cuda, ZERO)
    t0 = time.perf_counter()
    xt, _, _ = tfe.extract_eatd(corpus, out_dir=work / "serial",
                                elmo_weights=str(bundle),
                                segmenter="fallback", device="cuda")
    walls["serial extract_eatd"] = time.perf_counter() - t0
    serial_counts = _counts(rnn_cuda)
    if serial_counts["lstmp_fwd"] <= 0:
        fail(f"the serial biLM launched no lstmp_fwd: {serial_counts}")
    add(serial_counts)
    n = _parallel_speakers(clf_all, 2)
    feats, clf, xt_all = feats[:n], clf_all[:n], xt
    xt = xt_all[:n]
    tf_idx = folds.generate_clf_folds(clf, 3, seed=0)
    print(f"phase 12 trains on the first {n} of {len(clf_all)} speakers "
          "(the most whose padded test split is even)")
    audio = C.replace(C.AUDIO_CLF, epochs=PARALLEL_EPOCHS + 1)
    text = C.replace(C.TEXT_CLF, epochs=PARALLEL_EPOCHS + 1)

    # (a) NCCL at world size 1
    add(nccl_world_one(torch, rnn_cuda, card, trainers._clf_fold_datas(
        [feats], clf, tf_idx, audio.batch_size)[0], work))

    # the single-process stacked folds the ranks are held against
    t0 = time.perf_counter()
    _set_counts(rnn_cuda, ZERO)
    vmapped = [trainers.train_audio_clf(feats, clf, tf_idx, tcfg=audio,
                                        vmap_folds=True)]
    vm_audio = _counts(rnn_cuda)
    _set_counts(rnn_cuda, ZERO)
    vmapped.append(trainers.train_text_clf(
        torch.as_tensor(xt, device="cuda"), clf, tf_idx, tcfg=text,
        vmap_folds=True))
    vm_text = _counts(rnn_cuda)
    walls["vmap_folds audio_clf + text_clf"] = time.perf_counter() - t0
    feats_np = feats.cpu().numpy()

    def calls(**mode):
        return [(trainers.train_audio_clf, (feats_np, clf, tf_idx),
                 dict(tcfg=audio, **mode)),
                (trainers.train_text_clf, (xt, clf, tf_idx),
                 dict(tcfg=text, **mode))]

    # (b) fold-parallel: 3 Gloo ranks on cuda:0, one fold a rank
    t0 = time.perf_counter()
    ranks = distributed.launch(dryrun.several, 3, ["cuda:0"] * 3, "gloo",
                               args=(calls(fold_parallel=True),),
                               with_launches=True, timeout=900)
    walls["fold-parallel, 3 ranks"] = time.perf_counter() - t0
    for r, (value, _) in enumerate(ranks):
        for name, got, want in (("audio_clf", value[0], vmapped[0]),
                                ("text_clf", value[1], vmapped[1])):
            same = _same_results(torch, got, want)
            gap, same_best = _logs_gap(got, want)
            steps = _steps_gap(got, want)
            print(f"(b) {PARALLEL_EPOCHS}-epoch {name}, rank {r} of 3: "
                  f"per-epoch logs within {gap:.3e} and step losses within "
                  f"{steps:.3e} of their largest magnitude of --vmap-folds "
                  f"(tol {TRAIN_TOL}), the same gated epochs: {same_best}; "
                  f"every log, step loss, gated metric and param bitwise: "
                  f"{same} (a reading: a rank's one-fold products may take "
                  "another cuBLAS algorithm than the 3-fold batched ones)")
            if not (gap <= TRAIN_TOL and steps <= TRAIN_TOL and same_best):
                fail(f"fold-parallel {name} differs from --vmap-folds")
    add(_rank_launches("(b) fold-parallel audio_clf + text_clf",
                       [c for _, c in ranks],
                       dict({k: vm_audio[k] + vm_text[k] for k in ZERO},
                            threefry=UNHELD)))

    # (c) fold x data parallelism: 6 Gloo ranks, eager; then, on the same
    # ranks, the clf fusion's DP x TP step
    fusion = dp_tp_call(torch)
    t0 = time.perf_counter()
    ranks = distributed.launch(dryrun.several, 6, ["cuda:0"] * 6, "gloo",
                               args=(calls(fold_parallel=True,
                                           data_parallel=2) + [fusion],),
                               with_launches=True, timeout=900)
    walls["fold x DP + DP x TP step, 6 ranks"] = time.perf_counter() - t0
    for name, i in (("audio_clf", 0), ("text_clf", 1)):
        gap, same_best = _logs_gap(ranks[0][0][i], vmapped[i])
        print(f"(c) {PARALLEL_EPOCHS}-epoch {name}, 3 folds x 2 DP ranks "
              f"(eager on Gloo): per-epoch logs within {gap:.3e} of their "
              f"largest magnitude of --vmap-folds (tol {TRAIN_TOL}), the "
              f"same gated epochs: {same_best}")
        if not (gap <= TRAIN_TOL and same_best):
            fail(f"fold x DP {name} differs from --vmap-folds")
    # a rank makes the stacked run's calls, on its rows, eagerly: without
    # the graph's warm-up epoch; its DP x TP step launches no kernel (the
    # gate-row recurrences are sliced matmuls)
    e = PARALLEL_EPOCHS
    add(_rank_launches("(c) fold x DP audio_clf + text_clf and the DP x TP "
                       "step (0 of its own)", [c for _, c in ranks],
                       dict({k: (vm_audio[k] + vm_text[k]) * e // (e + 1)
                             for k in ZERO}, threefry=UNHELD)))
    add(dp_tp_checks(torch, rnn_cuda, card, fusion,
                     [value[2] for value, _ in ranks]))

    # (d) dp_train_step and (e) the TP biLM: 2 Gloo ranks on cuda:0
    tcfg = C.AUDIO_CLF
    gen = np.random.default_rng(0)
    x = gen.standard_normal((8, 3, 256)).astype(np.float32)
    y = gen.integers(0, 2, 8)
    mask = np.ones(8, np.float32)
    tp_out = work / "tp"
    t0 = time.perf_counter()
    ranks = distributed.launch(dryrun.several, 2, ["cuda:0"] * 2, "gloo",
                               args=([(dryrun.collectives, (), {}),
                                      (dryrun.dp_step, (tcfg, x, y, mask),
                                       {}),
                                      (tfe.extract_eatd, (corpus,),
                                       dict(out_dir=tp_out,
                                            elmo_weights=str(bundle),
                                            segmenter="fallback",
                                            elmo_tp=2))],),
                               with_launches=True, timeout=900)
    walls["dp_train_step + TP extract_eatd, 2 ranks"] = \
        time.perf_counter() - t0
    ref = dryrun.dp_step_reference(tcfg, x, y, mask, 2, device="cuda")
    base = torch.arange(8, dtype=torch.float32)
    for r, (value, _) in enumerate(ranks):
        c, step, (tp, _, _) = value
        ok = (torch.equal(c["all_reduce"], 2 * base + 1)
              and torch.equal(c["broadcast"], base)
              and torch.equal(c["all_gather"], torch.stack([base, base + 1]))
              and c["all_gather_object"] == [{"rank": 0}, {"rank": 1}]
              and c["device"] == "cuda:0")
        d_loss = abs(step["loss"] - ref["loss"])
        d_l1 = abs(step["param_l1"] - ref["param_l1"])
        tp_gap = float(np.abs(tp - xt_all).max()) / float(
            np.abs(xt_all).max())
        print(f"(d) rank {r}: Gloo collectives on CUDA tensors right: {ok}; "
              f"dp_train_step loss {step['loss']:.7f} (one process "
              f"{ref['loss']:.7f}, |d| {d_loss:.3e}, tol 1e-5), param L1 "
              f"|d| {d_l1:.3e} (tol 1e-4)")
        print(f"(e) rank {r}: extract_eatd(elmo_tp=2) at the zhs geometry, "
              f"{tp.shape[0]} speakers: pooled features within {tp_gap:.3e} "
              f"of their largest magnitude of the serial lstmp_fwd path "
              f"(tol {SLICE_TOL})")
        if not (ok and d_loss <= 1e-5 and d_l1 <= 1e-4
                and tp_gap <= SLICE_TOL):
            fail(f"rank {r}: collectives, dp_train_step or the TP biLM "
                 "disagree")
    meta = json.loads((tp_out / "extraction_meta.json").read_text())
    if meta["elmo_tp"] != 2 or meta["embedder"] != bundle_id(bundle):
        fail(f"the TP extraction's sidecar: {meta}")
    print(f"(e) extraction_meta.json names elmo_tp {meta['elmo_tp']} and "
          f"{meta['embedder']}")
    # per rank: the DP step's GRU forward and backward (2 layers), and no
    # LSTMP kernel: the TP biLM is a step loop of sharded matmuls
    add(_rank_launches("(d) + (e)", [c for _, c in ranks],
                       dict(DRAWN, gru_fwd=2, gru_bwd=2)))

    # (f) the CLI never puts two ranks on one card
    have = torch.cuda.device_count()
    if have < 3:
        try:
            cli.main(["train", "--task", "audio_clf", "--root", str(work),
                      "--fold-parallel"])
            fail("cli train --fold-parallel ran on a host with < 3 cards")
        except SystemExit as e:
            msg = str(e)
        print(f"(f) cli train --fold-parallel on {have} card(s): exits with "
              f"{msg!r}")
        if "need >= 3 devices" not in msg:
            fail(f"the one-card refusal said {msg!r}")
    else:
        print(f"(f) skipped: this host has {have} cards")
    for what, wall in walls.items():
        print(f"timing phase 12 {what}: {wall:.2f} s wall [{card}; {SHARED}]")
    print(f"timing phase 12: {time.perf_counter() - t_phase:.1f} s [{card}]")
    return {"launches": launches, "walls": walls}


#: epochs of phase 13 (d)'s traced fold
OPS_EPOCHS = 4
READBACK = "wav2vlad/readback"
#: char-CNN of the released zhs model (cnn_50_100_512_4096_sample.json)
ZHS_WORD_DIM = 100


def _cli_json(cli, argv: list) -> tuple:
    """``cli.main(argv)`` in this process -> (exit code, its JSON lines,
    its standard output)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = cli.main(argv)
    out = buf.getvalue()
    return rc, [json.loads(line) for line in out.splitlines()
                if line.startswith("{")], out


def stacked_launches(task: str, results: list) -> dict:
    """The launches of a ``vmap_folds`` branch trainer from its results:
    one stacked call an optimizer step of the folds' longest epoch and one
    an eval, each epoch and the warm-up epoch before the capture."""
    epochs = len(results[0]["logs"]["steps"])
    steps = max(int(r["logs"]["steps"][0]) for r in results)
    return expected_launches(task, (epochs + 1) * steps, epochs + 1,
                             len(results))


def serial_launches(task: str, results: list) -> dict:
    """The launches of a serial trainer from its results (``warmed``)."""
    epochs = [{"fold": r["fold"], "steps": s} for r in results
              for s in r["logs"]["steps"]]
    steps, evals = warmed(epochs)
    return expected_launches(task, steps, evals, len(results))


def _add(total: dict, got: dict) -> None:
    for k, v in got.items():
        total[k] += v


def warmup_runs(torch, card: str, bundle: Path, work: Path) -> dict:
    """Phase 13 (b): ``cli warmup`` twice into an empty build directory,
    counted; each trainer of the train stage recorded, to check its
    launches.  Returns the launches and readings."""
    import os

    from icassp2022_depression_tpu_torch import _build, cli
    from icassp2022_depression_tpu_torch.ops import rnn_cuda
    from icassp2022_depression_tpu_torch.train import trainers

    build_dir = work / "kernel_builds"
    build_dir.mkdir()
    argv = ["warmup", "--device", "cuda", "--n-data", "24",
            "--n-validation", "12", "--tracks", "clf", "--vmap-folds",
            "--elmo-weights", str(bundle)]
    tasks = PIPELINE_TASKS["clf"]
    originals = {t: getattr(trainers, f"train_{t}") for t in tasks}
    recorded = {}

    def recording(task, fn):
        def run(*args, **kwargs):
            recorded[task] = fn(*args, **kwargs)
            return recorded[task]
        return run

    before = os.environ.get("ICASSP_TPU_TORCH_BUILD_DIR")
    os.environ["ICASSP_TPU_TORCH_BUILD_DIR"] = str(build_dir)
    launches, runs = dict(ZERO), []
    try:
        for run_argv in (argv, argv + ["--skip-train"]):
            for t, fn in originals.items():
                setattr(trainers, f"train_{t}", recording(t, fn))
            recorded.clear()
            _set_counts(rnn_cuda, ZERO)
            t0 = time.perf_counter()
            try:
                rc, lines, _ = _cli_json(cli, run_argv)
            finally:
                for t, fn in originals.items():
                    setattr(trainers, f"train_{t}", fn)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = _counts(rnn_cuda)
            if rc != 0:
                fail(f"cli warmup returned {rc}")
            stages = {ln["warmup"]: ln for ln in lines if "warmup" in ln}
            runs.append((stages, wall, dict(recorded)))
            # the text stage: 4 lstmp_fwd a batch of 128 sentences (108
            # here: one) a token bucket; the train stage extracts the
            # corpus's 108 answers once more through the bundle
            want = dict(DRAWN, lstmp_fwd=4 * len(
                stages["text_chunks"]["token_buckets"]))
            if "train_programs" in stages:
                want["lstmp_fwd"] += 4
                _add(want, stacked_launches("audio_clf",
                                            recorded["audio_clf"]))
                _add(want, stacked_launches("text_clf",
                                            recorded["text_clf"]))
                _add(want, serial_launches("fuse_clf",
                                           recorded["fuse_clf"]))
            print(f"cli warmup {' '.join(run_argv[1:])}: "
                  + "; ".join(json.dumps(ln) for ln in lines)
                  + f"; wall {wall:.2f} s; kernel launches {got} [{card}]")
            if not _held(got, want):
                fail(f"cli warmup launched {got}, expected {want}")
            _add(launches, got)
    finally:
        if before is None:
            os.environ.pop("ICASSP_TPU_TORCH_BUILD_DIR", None)
        else:
            os.environ["ICASSP_TPU_TORCH_BUILD_DIR"] = before
    (cold, cold_wall, _), (warm, warm_wall, _) = runs
    n_sources = len(_build.SOURCES)
    for stages, n_built in ((cold, n_sources), (warm, 0)):
        kb = stages["kernel_builds"]
        if (len(kb["built"]) != n_built
                or len(kb["reused"]) != n_sources - n_built
                or sorted(kb["built"] + kb["reused"])
                != sorted(_build.SOURCES) or kb["dir"] != str(build_dir)):
            fail(f"cli warmup's kernel_builds {kb}: expected {n_built} "
                 f"built and {n_sources - n_built} reused in {build_dir}")
        if stages.get("done") is None:
            fail(f"cli warmup printed no done line: {stages}")
    if "train_programs" not in cold or "jax" in sys.modules:
        fail("cli warmup ran no train stage, or imported jax")
    print(f"timing cli warmup kernel_builds: cold "
          f"{cold['kernel_builds']['seconds']} s ({n_sources} sources built "
          f"in parallel), warm "
          f"{warm['kernel_builds']['seconds']} s ({n_sources} reused); run "
          f"walls "
          f"{cold_wall:.2f} s (clf --vmap-folds, 24 + 12 speakers), "
          f"{warm_wall:.2f} s (--skip-train) [{card}]")
    return {"launches": launches, "cold_s": cold["kernel_builds"]["seconds"],
            "warm_s": warm["kernel_builds"]["seconds"],
            "stages": {k: v.get("seconds") for k, v in cold.items()}}


def released_zhs_dir(root: Path, chars: list, words: list,
                     seed: int = 21) -> tuple:
    """A model directory in the released zhs layout (``config.json``
    naming the architecture file, tab-separated ``char.dic`` /
    ``word.dic``, ``token_embedder.pkl`` / ``encoder.pkl`` state dicts
    under upstream's key names, as ``tests/test_torch_elmo.py`` writes it
    small) at the zhs geometry, weights from ``seed`` at init scale.
    Returns the two state dicts as numpy arrays."""
    import numpy as np

    from icassp2022_depression_tpu_torch.models import char_cnn, elmo
    from icassp2022_depression_tpu_torch.models import elmo_pretrained as ep

    ccfg = char_cnn.CharCnnConfig()
    lcfg = elmo.ElmoLstmpConfig()
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True)
    specials = [ep.PAD, ep.OOV, ep.BOS, ep.EOS, ep.BOW, ep.EOW]
    char_lex = {tok: i for i, tok in enumerate(specials + chars)}
    word_lex = {tok: i for i, tok in enumerate(specials[:4] + words)}
    for name, lex in (("char.dic", char_lex), ("word.dic", word_lex)):
        with open(root / name, "w", encoding="utf-8") as f:
            for tok, i in lex.items():
                f.write(f"{tok}\t{i}\n")
    arch = {"encoder": {"name": "elmo", "projection_dim": lcfg.proj_size,
                        "dim": lcfg.cell_size, "n_layers": lcfg.layers,
                        "cell_clip": 3, "proj_clip": 3},
            "token_embedder": {"name": "cnn", "activation": "relu",
                               "filters": [list(f) for f in ccfg.filters],
                               "n_highway": ccfg.n_highway,
                               "word_dim": ZHS_WORD_DIM,
                               "char_dim": ccfg.char_dim,
                               "max_characters_per_token": ccfg.max_chars}}
    (root / "cnn_50_100_512_4096_sample.json").write_text(json.dumps(arch))
    (root / "config.json").write_text(json.dumps(
        {"config_path": "/released/configs/cnn_50_100_512_4096_sample.json"}))

    def t(*shape):
        bound = 1.0 / np.sqrt(shape[-1])
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    nf = ccfg.n_filters
    te = {"char_emb_layer.embedding.weight": t(len(char_lex), ccfg.char_dim),
          "word_emb_layer.embedding.weight": t(len(word_lex), ZHS_WORD_DIM),
          "projection.weight": t(ccfg.output_dim, ZHS_WORD_DIM + nf),
          "projection.bias": t(ccfg.output_dim)}
    for i, (w, out) in enumerate(ccfg.filters):
        te[f"convolutions.{i}.weight"] = t(out, ccfg.char_dim, w)
        te[f"convolutions.{i}.bias"] = t(out)
    for i in range(ccfg.n_highway):
        te[f"highways._layers.{i}.weight"] = t(2 * nf, nf)
        te[f"highways._layers.{i}.bias"] = t(2 * nf)
    enc = {}
    c, p = lcfg.cell_size, lcfg.proj_size
    for d in ("forward", "backward"):
        for k in range(lcfg.layers):
            pre = f"{d}_layer_{k}"
            enc[f"{pre}.input_linearity.weight"] = t(4 * c, p)
            enc[f"{pre}.state_linearity.weight"] = t(4 * c, p)
            enc[f"{pre}.state_linearity.bias"] = t(4 * c)
            enc[f"{pre}.state_projection.weight"] = t(p, c)
    torch.save({k: torch.from_numpy(v) for k, v in te.items()},
               root / "token_embedder.pkl")
    torch.save({k: torch.from_numpy(v) for k, v in enc.items()},
               root / "encoder.pkl")
    return te, enc


def _bundle_mapping(te: dict, enc: dict, n_highway: int, n_convs: int,
                    layers: int) -> dict:
    """The bundle keys a converter must write from the released state
    dicts (the projection's columns from upstream's [word | char] to the
    char-CNN's [char | word])."""
    import numpy as np

    want = {"cc/char_emb": te["char_emb_layer.embedding.weight"],
            "cc/word_emb": te["word_emb_layer.embedding.weight"],
            "cc/projection/w": np.concatenate(
                [te["projection.weight"][:, ZHS_WORD_DIM:],
                 te["projection.weight"][:, :ZHS_WORD_DIM]], axis=1),
            "cc/projection/b": te["projection.bias"]}
    for i in range(n_convs):
        want[f"cc/convs/{i}/w"] = te[f"convolutions.{i}.weight"]
        want[f"cc/convs/{i}/b"] = te[f"convolutions.{i}.bias"]
    for i in range(n_highway):
        want[f"cc/highways/{i}/w"] = te[f"highways._layers.{i}.weight"]
        want[f"cc/highways/{i}/b"] = te[f"highways._layers.{i}.bias"]
    for k in range(layers):
        for d, name in (("fwd", "forward"), ("bwd", "backward")):
            pre = f"{name}_layer_{k}"
            for ours, theirs in (("w_x", "input_linearity.weight"),
                                 ("w_h", "state_linearity.weight"),
                                 ("b", "state_linearity.bias"),
                                 ("w_p", "state_projection.weight")):
                want[f"enc/layers/{k}/{d}/{ours}"] = enc[f"{pre}.{theirs}"]
    return want


def converter_checks(torch, card: str, corpus: Path, work: Path) -> dict:
    """Phase 13 (c): a released-layout zhs directory through the port's
    ``convert_elmo_zhs``, the bundle against the pickles' mapping, the
    ``--check`` norms card against CPU, and ``text_clf`` served from the
    bundle.  Returns the counted launches."""
    import numpy as np

    from icassp2022_depression_tpu_torch import config as C
    from icassp2022_depression_tpu_torch.data import eatd
    from icassp2022_depression_tpu_torch.frontend import text as tfe
    from icassp2022_depression_tpu_torch.models import char_cnn, elmo
    from icassp2022_depression_tpu_torch.models.text_net import TextNet
    from icassp2022_depression_tpu_torch.ops import prng, rnn_cuda
    from icassp2022_depression_tpu_torch.scripts import convert_elmo_zhs
    from icassp2022_depression_tpu_torch.serving.predictors import Predictor

    launches = dict(ZERO)
    speakers = eatd.load_speakers(corpus, read_text=True)
    words = list(dict.fromkeys(
        w for sp in speakers for t in sp.texts
        for w in tfe.tokenize(t, "fallback")))
    for s in convert_elmo_zhs.CHECK_SENTENCES:
        words += [w for w in s if w not in words]
    chars = list(dict.fromkeys(ch for w in words for ch in w))
    code = 0x4E00
    ccfg = char_cnn.CharCnnConfig()
    while len(chars) < ccfg.n_chars - 6:
        if chr(code) not in chars:
            chars.append(chr(code))
        code += 1
    t0 = time.perf_counter()
    model_dir = work / "zhs.model"
    te, enc = released_zhs_dir(model_dir, chars, words)
    written_s = time.perf_counter() - t0
    out = work / "elmo_zhs_converted.npz"
    norms = {}
    for device in ("cpu", "cuda"):
        _set_counts(rnn_cuda, ZERO)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = convert_elmo_zhs.main([str(model_dir), "-o", str(out),
                                        "--check", "--device", device])
        wall = time.perf_counter() - t0
        got = _counts(rnn_cuda)
        if rc != 0:
            fail(f"convert_elmo_zhs --device {device} returned {rc}")
        lines = buf.getvalue().strip().splitlines()
        norms[device] = [float(ln.split("norm")[-1]) for ln in lines
                         if " norm " in ln]
        print(f"convert_elmo_zhs --check --device {device}: "
              + " | ".join(lines) + f"; wall {wall:.2f} s; kernel launches "
              f"{got} [{card}]")
        if device == "cuda":
            # the two sentences are one batch: 4 LSTMP forwards
            if not _held(got, dict(DRAWN, lstmp_fwd=4)):
                fail(f"convert_elmo_zhs --check launched {got}")
            _add(launches, got)
    lcfg = elmo.ElmoLstmpConfig()
    want = _bundle_mapping(te, enc, ccfg.n_highway, len(ccfg.filters),
                           lcfg.layers)
    with np.load(out) as z:
        got_keys = sorted(k for k in z.files if k != "__meta__")
        same = got_keys == sorted(want) and all(
            z[k].dtype == want[k].dtype and np.array_equal(z[k], want[k])
            for k in want)
        meta = json.loads(str(z["__meta__"]))
    n_params = sum(v.size for v in want.values())
    print(f"released-layout zhs dir ({len(chars) + 6} chars, "
          f"{len(words) + 4} words, {n_params:,} params) written in "
          f"{written_s:.2f} s; the bundle's {len(want)} arrays bitwise the "
          f"pickles' mapping: {same}")
    if not same or len(meta["char_lexicon"]) != len(chars) + 6:
        fail("the converted bundle differs from the released pickles")
    d = max(abs(a - b) for a, b in zip(norms["cuda"], norms["cpu"]))
    print(f"--check norms card {norms['cuda']} against CPU {norms['cpu']}: "
          f"max|d| {d:.3e} (tol {SLICE_TOL}) [{card}]")
    if len(norms["cuda"]) != 2 or d > SLICE_TOL:
        fail(f"--check norms card vs CPU differ by {d}")

    # text_clf served from the converted bundle
    model = TextNet(C.TEXT_CLF.model, prng.prng_key(7, "cpu"))
    texts = [sp.texts for sp in speakers[:4]]
    results = {}
    for device in ("cuda", "cpu"):
        with contextlib.redirect_stderr(io.StringIO()):
            pred = Predictor(model, "text_clf", device=device,
                             elmo_weights=str(out), segmenter="fallback")
        _set_counts(rnn_cuda, ZERO)
        results[device] = pred.predict_batch(texts_per_speaker=texts)
        got = _counts(rnn_cuda)
        if device == "cuda":
            torch.cuda.synchronize()
            if not _held(got, dict(DRAWN, lstmp_fwd=4, lstm_fwd=4)):
                fail(f"text_clf from the converted bundle launched {got}")
            _add(launches, got)
    check_results(results["cuda"], len(texts), "text_clf from the bundle")
    err = compare(results["cuda"], results["cpu"],
                  "text_clf from the converted bundle, card vs CPU")
    print(f"text_clf served from the converted bundle ({len(texts)} "
          f"speakers, one request): card vs CPU {err:.3e}; kernel launches "
          f"4 lstmp_fwd, 4 lstm_fwd [{card}]")
    return {"launches": launches}


def _trace_regions(path: Path) -> tuple:
    """A Chrome trace -> ({region name: [(start, end)]} of the CPU
    annotations, [(kernel name, launch time)]): each kernel placed at the
    host time of the runtime call that launched it (by correlation id)."""
    events = json.loads(path.read_text())["traceEvents"]
    regions, launch_ts = {}, {}
    for e in events:
        cat = e.get("cat", "")
        if cat == "user_annotation":
            regions.setdefault(e["name"], []).append(
                (e["ts"], e["ts"] + e.get("dur", 0)))
        elif cat == "cuda_runtime" and "correlation" in e.get("args", {}):
            launch_ts[e["args"]["correlation"]] = e["ts"]
    kernels = [(e["name"], launch_ts.get(e["args"].get("correlation")))
               for e in events if e.get("cat") == "kernel"]
    return regions, kernels


def trace_checks(torch, card: str, corpus: Path, work: Path) -> dict:
    """Phase 13 (d): ``extract_eatd`` and a one-fold ``cli train --task
    audio_clf --corpus`` under ``profiling.trace``, counted; the trace's
    regions and the GRU kernels inside the fold's."""
    import numpy as np

    from icassp2022_depression_tpu_torch import cli
    from icassp2022_depression_tpu_torch import config as C
    from icassp2022_depression_tpu_torch.data import folds
    from icassp2022_depression_tpu_torch.frontend import audio as afe
    from icassp2022_depression_tpu_torch.ops import rnn_cuda
    from icassp2022_depression_tpu_torch.utils import profiling

    _, _, clf, _ = afe.extract_eatd(corpus, device="cuda")
    idx = work / "fold1_train_idx.npy"
    np.save(idx, folds.generate_clf_folds(clf, 3, seed=0)[0])
    model = work / "ModelTraced"
    full = C.AUDIO_CLF
    C.AUDIO_CLF = C.replace(full, epochs=OPS_EPOCHS + 1)
    _set_counts(rnn_cuda, ZERO)
    t0 = time.perf_counter()
    try:
        with profiling.trace(work / "trace") as prof:
            afe.extract_eatd(corpus, device="cuda")
            rc, _, _ = _cli_json(cli, [
                "train", "--task", "audio_clf", "--root", str(corpus),
                "--corpus", str(corpus), "--idx-files", str(idx),
                "--model-dir", str(model), "--device", "cuda"])
            torch.cuda.synchronize()
    finally:
        C.AUDIO_CLF = full
    wall = time.perf_counter() - t0
    got = _counts(rnn_cuda)
    if rc != 0:
        fail(f"traced cli train returned {rc}")
    epochs = [json.loads(line) for line in
              (model / "audio_clf_metrics.jsonl").read_text().splitlines()]
    epochs = [r for r in epochs if r["event"] == "epoch"]
    steps, evals = warmed(epochs)
    _check_launches("audio_clf (traced, one fold)", got, steps, evals, 1)
    regions, kernels = _trace_regions(prof.trace_path)
    buckets = sorted(n for n in regions if n.startswith("wav2vlad/bucket"))
    fold = regions.get("audio_clf/fold1", [])
    inside = {}
    for name, ts in kernels:
        if ts is not None and any(a <= ts <= b for a, b in fold):
            kind = ("gru_fwd" if "gru_fwd" in name else
                    "gru_bwd" if ("gates_kernel<false>" in name
                                  or "gru_bwd" in name) else "other")
            inside[kind] = inside.get(kind, 0) + 1
    print(f"profiling.trace {prof.trace_path.name} "
          f"({prof.trace_path.stat().st_size / 2**20:.1f} MiB): regions "
          f"{buckets}, wav2vlad/readback x{len(regions.get(READBACK, []))},"
          f" audio_clf/fold1 x{len(fold)}; kernels launched inside the "
          f"fold's "
          f"region by kind {inside}; wall {wall:.2f} s; kernel launches "
          f"{got} [{card}]")
    if (not buckets or READBACK not in regions or len(fold) != 1
            or "audio_clf/fold2" in regions or not inside.get("gru_fwd")
            or not inside.get("gru_bwd")):
        fail("the trace lacks a region, or the GRU kernels in the fold's")
    return {"launches": got}


def span_checks(torch, card: str) -> dict:
    """Phase 13 (e): a recorded region (``profiling.annotate``) around a
    4096 x 4096 float32 matmul and ``torch.cuda.synchronize()`` under
    ``torch.profiler`` holds the matmul kernel's interval on the card, on
    the one clock (``time.time_ns()``) the records and the trace share;
    then a region's host cost with no profiler (with and without NVTX)
    and under one, beside a bare ``record_function``."""
    from torch.autograd import DeviceType

    from icassp2022_depression_tpu_torch.utils import profiling

    a = torch.randn(4096, 4096, device="cuda")
    (a @ a).sum().item()
    torch.cuda.synchronize()
    for tries in range(1, 4):  # a short call's trace now and then is empty
        spans = []
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for i in range(3):
                with profiling.annotate(f"smoke/matmul{i}", "cuda") as span:
                    a @ a
                    torch.cuda.synchronize()
                spans.append(span)
        kernels, regions = [], {}
        for e in prof.profiler.kineto_results.events():
            iv = (e.start_ns(), e.start_ns() + e.duration_ns())
            if e.device_type() != DeviceType.CUDA:
                if e.name().startswith("smoke/matmul"):
                    regions[e.name()] = iv
            elif "/" not in e.name():       # not a region's device mirror
                kernels.append((e.name(), iv))
        if kernels:
            break
    offsets, held = [], 0
    for span in spans:
        inside = [iv for n, iv in kernels
                  if span.start_ns <= iv[0] and iv[1] <= span.end_ns]
        region = regions.get(span.name)
        if not inside or region is None or not (
                span.start_ns <= region[0] and region[1] <= span.end_ns):
            fail(f"the record {span} does not hold its kernel and its "
                 f"profiler region: kernels {kernels}, region {region}")
        held += len(inside)
        offsets.append((min(k0 for k0, _ in inside) - span.start_ns,
                        span.end_ns - max(k1 for _, k1 in inside),
                        region[0] - span.start_ns, span.end_ns - region[1]))
    if held != len(kernels):
        fail(f"kernels outside every record: {kernels}")
    print("recorded region around a 4096^2 matmul + synchronize, under "
          "torch.profiler (ns: record start -> kernel start, kernel end "
          "-> record end, record start -> profiler region start, profiler "
          f"region end -> record end; profiled {tries} time(s)): {offsets}"
          f" [{card}]")

    def per_region_us(device, n=20000) -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            with profiling.annotate("smoke/empty", device):
                pass
        return 1e6 * (time.perf_counter() - t0) / n

    def bare_us(n=20000) -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            with torch.profiler.record_function("smoke/bare"):
                pass
        return 1e6 * (time.perf_counter() - t0) / n

    per_region_us(None, 2000)
    cost = {"off": per_region_us(None), "off_nvtx": per_region_us("cuda"),
            "bare_record_function": bare_us()}
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        cost["on"] = per_region_us(None, 5000)
        cost["on_nvtx"] = per_region_us("cuda", 5000)
    profiling.clear()
    print(f"a recorded region's host cost, us: {cost} [{card}]")
    return {"offsets_ns": offsets, "cost_us": cost}


def operations_phase(torch, card: str, corpus: Path, bundle: Path,
                     work: Path) -> dict:
    """Phase 13: ``cli doctor``, ``cli warmup`` twice, the ELMo converter
    at the zhs geometry, a trace of the named regions and the span
    records on the trace's clock.  Returns the counted launches."""
    from icassp2022_depression_tpu_torch import cli

    t_phase = time.perf_counter()
    work = work / "operations"
    work.mkdir()
    rc, lines, _ = _cli_json(cli, ["doctor", "--device", "cuda"])
    if rc != 0 or not lines:
        fail(f"cli doctor returned {rc}")
    rep = lines[-1]
    link, kb = rep.get("link") or {}, rep["kernel_builds"]
    print(f"cli doctor: card {json.dumps(rep['card'])}; nvcc "
          f"{json.dumps(rep['nvcc'])}; kernel builds {kb['sources']}; link "
          f"roundtrip {link.get('roundtrip_s')} s, up {link.get('up_mb_s')} "
          f"MB/s, down {link.get('down_mb_s')} MB/s ({link.get('size_mb')} "
          f"MB x {link.get('reps')}, pageable) [{card}]")
    if (rep["backend"] != "cuda" or not rep["card"] or not rep["nvcc"]
            or not link.get("up_mb_s", 0) > 0
            or not link.get("down_mb_s", 0) > 0
            or set(kb["sources"].values()) != {"built"}):
        fail(f"cli doctor's report is incomplete: {rep}")
    launches = dict(ZERO)
    warm = warmup_runs(torch, card, bundle, work)
    _add(launches, warm["launches"])
    _add(launches, converter_checks(torch, card, corpus, work)["launches"])
    _add(launches, trace_checks(torch, card, corpus, work)["launches"])
    span_checks(torch, card)
    if "jax" in sys.modules:
        fail("jax was imported")
    print(f"timing phase 13: {time.perf_counter() - t_phase:.1f} s [{card}]")
    return {"launches": launches, "doctor": rep, "warmup": warm}


@contextlib.contextmanager
def _plain_draws(prng):
    """The public threefry draws swapped for their plain versions (on any
    device) inside: the callers (``netvlad``, ``dropout``) as they are,
    the draws through ``ops/prng.py``'s ``*_torch``."""
    names = ("fold_in", "split", "random_bits", "uniform", "normal",
             "bernoulli")
    saved = {n: getattr(prng, n) for n in names}
    for n in names:
        setattr(prng, n, getattr(prng, f"{n}_torch"))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(prng, n, fn)


def _equal_tree(torch, got, want) -> bool:
    """Every tensor of two results (a tensor, a dict or a tuple of them)
    bitwise equal, dtype and shape included."""
    if isinstance(got, dict):
        return got.keys() == want.keys() and all(
            _equal_tree(torch, got[k], want[k]) for k in got)
    if isinstance(got, (tuple, list)):
        return len(got) == len(want) and all(
            _equal_tree(torch, a, b) for a, b in zip(got, want))
    return (got.dtype == want.dtype and got.shape == want.shape
            and torch.equal(got, want))


def threefry_bound(evals: int, nbytes: int):
    """(least ms, "operations" or "bytes") of threefry draws making
    ``evals`` cipher evaluations and writing ``nbytes``."""
    t_ops = evals * THREEFRY_OPS / PEAK_INT32_OPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


#: the wav2vlad bucket row tiles phase 14 draws NetVLAD weights at
#: (``frontend/audio.py::_bucket_rows``): 1 and 2 rows an interactive
#: request's buckets, 4 and 8 small served batches' (and the warm-up's),
#: 32 the cohort's
BUCKET_TILES = (1, 2, 4, 8, 32)


def threefry_phase(torch, card: str) -> dict:
    """Phase 14: the threefry kernel (``csrc/threefry.cu``) against the
    plain route (``ops/prng.py``'s ``*_torch``) run on the card, bitwise
    (keys, bits, uniforms, normals and masks), at the main paths' shapes
    (``fold_in`` of 8 and 96 ordinals, ``split(4)`` and ``split2`` of [3,
    2] keys, one wav2vlad bucket's NetVLAD weights at each row tile of
    ``BUCKET_TILES`` through ``netvlad.batched_per_utterance_params``, the
    audio train step's dropout masks at [3, 8, 256] and, as a data-parallel rank draws
    them, with ``rows``, bits with ``rows`` and a uniform over more than
    ``_BITS_CHUNK`` values with a span that is not a power of two),
    each with its exact launches (one a draw, none on the plain route),
    then timed with CUDA events beside the plain route and the bound.
    Returns {case: (kernel ms, plain ms, bound ms, bound by)}."""
    from icassp2022_depression_tpu_torch.config import FrontendConfig
    from icassp2022_depression_tpu_torch.ops import netvlad, prng
    from icassp2022_depression_tpu_torch.ops import rnn_cuda

    t_phase = time.perf_counter()
    cfg = FrontendConfig()
    dev = "cuda"
    root = prng.fold_in(prng.prng_key(20, dev), 3)
    keys3 = prng.split(root, 3)                     # [3, 2]: three folds
    keep = 1.0 - 0.5                                # the audio dropout
    chunk = prng._BITS_CHUNK + 5

    def bucket(rows):
        ordinals = torch.arange(1000, 1000 + rows, device=dev)
        return lambda: netvlad.batched_per_utterance_params(
            cfg.netvlad_seed, ordinals, cfg.n_mels, cfg.netvlad_clusters,
            cfg.netvlad_output_dim)

    weights = cfg.n_mels * cfg.netvlad_clusters
    per_row = (2 * weights + cfg.netvlad_clusters
               + weights * cfg.netvlad_output_dim)
    # case: (call, draws, cipher evaluations, bytes written)
    cases = {
        "fold_in [8]": (lambda: prng.fold_in(
            prng.prng_key(0, dev), torch.arange(8, device=dev)), 1, 8, 128),
        "fold_in [96]": (lambda: prng.fold_in(
            prng.prng_key(0, dev), torch.arange(96, device=dev)), 1, 96,
            1536),
        "split(4) [3, 2]": (lambda: prng.split(keys3, 4), 1, 12, 192),
        "split2 [3, 2]": (lambda: prng.split2(keys3), 1, 6, 96),
        **{f"netvlad bucket, {n} row{'s' * (n > 1)}": (
            bucket(n), 6, n * (1 + 4 + per_row), n * (16 + 64 + 4 * per_row))
           for n in BUCKET_TILES},
        "dropout mask [3, 8, 256]": (
            lambda: prng.bernoulli(keys3, keep, (8, 256)), 1, 3 * 8 * 256,
            3 * 8 * 256),
        "dropout mask [3, 4, 256] rows (4, 8)": (
            lambda: prng.bernoulli(keys3, keep, (4, 256), (4, 8)), 1,
            3 * 4 * 256, 3 * 4 * 256),
        "random_bits [3, 5, 7] rows (2, 9)": (
            lambda: prng.random_bits(keys3, (5, 7), rows=(2, 9)), 1,
            3 * 35, 3 * 35 * 8),
        f"uniform [{chunk}] in [-0.3, 0.3)": (
            lambda: prng.uniform(root, (chunk,), -0.3, 0.3), 1, chunk,
            4 * chunk),
    }
    for name, (call, draws, _, _) in cases.items():
        before = rnn_cuda.launch_counts()
        got = call()
        torch.cuda.synchronize()
        moved = {k: v - before[k] for k, v in rnn_cuda.launch_counts().items()}
        with _plain_draws(prng):
            want = call()
        plain_moved = rnn_cuda.launch_counts()["threefry"] - before[
            "threefry"] - moved["threefry"]
        same = _equal_tree(torch, got, want)
        print(f"threefry {name}: kernel against the plain route on the "
              f"card bitwise: {same}; launches {moved}")
        if not same:
            fail(f"threefry {name}: the kernel differs from the plain route")
        if moved != dict(ZERO, threefry=draws):
            fail(f"threefry {name} launched {moved}, expected {draws} "
                 "threefry launch(es) and nothing else")
        if plain_moved != 0:
            fail(f"threefry {name}: the plain route launched the kernel")
    timed = {}
    for name, (call, draws, evals, nbytes) in cases.items():
        def plain(call=call):
            with _plain_draws(prng):
                return call()
        reps = 5 if "uniform" in name else 20
        call()
        plain()
        ms, plain_ms = event_ms(call, reps, torch), event_ms(plain, reps,
                                                               torch)
        bound_ms, bound_by = threefry_bound(evals, nbytes)
        timed[name] = (ms, plain_ms, bound_ms, bound_by)
        print(f"timing threefry {name}: {draws} draw(s), {ms:.4f} ms "
              f"(plain route {plain_ms:.4f} ms, {plain_ms / ms:.1f}x), bound "
              f"{bound_ms:.4f} ms by {bound_by} ({bound_ms / ms:.1%} of it) "
              f"[{card}]")
    # the kernel's device time where the draws are large enough to show
    # it behind the host's enqueue
    for name in ("netvlad bucket, 1 row", "netvlad bucket, 8 rows",
                 "netvlad bucket, 32 rows",
                 f"uniform [{chunk}] in [-0.3, 0.3)"):
        call, draws = cases[name][:2]
        split = profile_split(torch, call, f"threefry {name}", draws, card)
        us, n = (split or {"kernels": {}})["kernels"].get("threefry_kernel",
                                                          (None, 0))
        if us is None:
            continue
        bound_ms = timed[name][2]
        print(f"timing threefry {name}: the kernel's device time {us:.2f} us "
              f"in {n} launches against a bound of {bound_ms * 1e3:.2f} us "
              f"({bound_ms * 1e3 / us:.1%} of it) [{card}]")
    print(f"timing phase 14: {time.perf_counter() - t_phase:.1f} s [{card}]")
    return timed


#: phase 15's cohort call: speakers, answers a speaker, the lengths of an
#: answer (s) and of a transcript (characters), the characters drawn by a
#: Zipf law of this exponent over their ranks (``fuse_clf_moonlight``'s)
MOE_SPEAKERS, MOE_ANSWERS = 32, 3
MOE_SECONDS, MOE_CHARS, MOE_ZIPF = (2.0, 12.0), (20, 120), 1.0
MOE_LEXICON = 6778


def _moe_cohort(seed: int) -> tuple:
    """(waveforms, sample rates, transcripts) of phase 15's cohort call."""
    import numpy as np

    rng = np.random.default_rng(seed)
    chars = [chr(0x4E00 + i) for i in range(MOE_LEXICON)]
    p = np.arange(1, MOE_LEXICON + 1, dtype=np.float64) ** -MOE_ZIPF
    p /= p.sum()
    waves, rates, texts = [], [], []
    for _ in range(MOE_SPEAKERS):
        waves.append([rng.integers(-3000, 3000, int(
            rng.uniform(*MOE_SECONDS) * 16000)).astype(np.int16)
            for _ in range(MOE_ANSWERS)])
        rates.append([16000] * MOE_ANSWERS)
        texts.append(["".join(chars[i] for i in rng.choice(
            MOE_LEXICON, int(rng.integers(MOE_CHARS[0], MOE_CHARS[1] + 1)),
            p=p)) for _ in range(MOE_ANSWERS)])
    return waves, rates, texts, chars


def moe_experts_phase(torch, card: str, seed: int = 21) -> dict:
    """Phase 15: the grouped-expert kernel (``csrc/moe_experts.cu``) on the
    main path of Moonlight-16B-A3B's cohort call and at its routed slots.
    Returns {"launches": the two calls' moe_experts launches, "entry": the
    kernels line's fields (ms, plain_ms, library_ms, bound_ms, bound_by,
    max_abs_err)}; no tensor outlives it."""
    import dataclasses
    import gc

    import torch.nn.functional as F

    from icassp2022_depression_tpu_torch import config as C
    from icassp2022_depression_tpu_torch.models import moe_lm
    from icassp2022_depression_tpu_torch.models.fusion import FusionNet
    from icassp2022_depression_tpu_torch.ops import moe, prng, rnn_cuda
    from icassp2022_depression_tpu_torch.serving.predictors import Predictor
    from portbench.counts import moe_lm as lm_counts
    from portbench.harness import lm_weights

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = C.MoeLmConfig()
    expert_layers = cfg.num_hidden_layers - cfg.first_k_dense_replace
    t0 = time.perf_counter()
    weights = lm_weights.draw(moe_lm.param_shapes(cfg), seed, "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in weights.values())
    print(f"moe_experts: Moonlight-16B-A3B's {n_params:,} float32 "
          f"parameters drawn on the card in {time.perf_counter() - t0:.2f} s,"
          f" {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated "
          f"[{card}]")
    if n_params != 15_624_565_888:
        fail(f"moe_experts: {n_params} parameters, not the published "
             "widths' 15,624,565,888")
    waves, rates, texts, chars = _moe_cohort(seed)
    model = FusionNet(C.replace(C.FUSE_CLF, text_embed_size=cfg.hidden_size),
                      prng.prng_key(seed, "cuda"), device="cuda")
    predictor = Predictor(
        model, "fuse_clf", device="cuda", feature_cache_entries=0,
        elmo_params={"weights": weights,
                     "lexicon": lm_weights.lexicon(chars, seed, cfg.bos_id)},
        elmo_cfg=cfg, segmenter="fallback")
    del weights
    answers = MOE_SPEAKERS * MOE_ANSWERS
    want = dict(ZERO, gru_fwd=2, lstm_fwd=4,
                threefry=wav2vlad_draws(waves, rates))
    want_moe = 2 * expert_layers * -(-answers // moe_lm.CHUNK)
    experts, captured, layer = moe.experts, {}, [0]

    def recording(*args):
        ys = experts(*args)
        layer[0] += 1
        if layer[0] in (1, expert_layers):
            captured[layer[0]] = (args, ys)
        return ys

    launches = 0
    for call in ("first", "second"):
        _set_counts(rnn_cuda, ZERO)
        moe.LAUNCHES = 0
        if call == "second":
            moe.experts = recording
        try:
            t0 = time.perf_counter()
            res = predictor.predict_batch(waves, rates, texts)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            moe.experts = experts
        got, got_moe = _counts(rnn_cuda), moe.LAUNCHES
        launches += got_moe
        print(f"moe_experts: predict_batch fuse_clf with the LM embedder, "
              f"{MOE_SPEAKERS} speakers ({call} call) in {wall:.3f} s: "
              f"moe_experts launches {got_moe}, others {got} [{card}]")
        check_results(res, MOE_SPEAKERS, f"moe_experts cohort ({call})")
        if got_moe != want_moe or not _held(got, want):
            fail(f"moe_experts: the {call} call launched {got_moe} "
                 f"moe_experts and {got}, expected {want_moe} ({expert_layers}"
                 f" expert layers, two each) and {want}")
    del predictor, model, res

    def reading(at, args, ys) -> dict:
        xs, w_gate, w_up, w_down, slot_w, offsets = args
        rows, n_experts = xs.shape[0], w_gate.shape[0]
        at += cfg.first_k_dense_replace
        again = moe.experts(*args)
        plain = moe.experts_torch(*args)
        torch.cuda.synchronize()
        bitwise = torch.equal(again, ys)
        err = float((again - plain).abs().max() / plain.abs().max())
        del again, plain
        used = offsets.diff().count_nonzero().item()
        print(f"moe_experts layer {at}: {rows} routed slots over {used} of "
              f"{n_experts} experts (H {xs.shape[1]}, I {w_gate.shape[1]}):"
              f" rerun bitwise {bitwise}; against the plain route max|d| / "
              f"max|plain| = {err:.3e} (tol {KERNEL_TOL})")
        if not bitwise:
            fail(f"moe_experts layer {at}: a rerun differs from the main "
                 "path's output")
        if not err < KERNEL_TOL:
            fail(f"moe_experts layer {at}: {err:.3e} from the plain route")
        bounds = offsets.tolist()

        def library():
            out = torch.empty_like(xs)
            for e in range(n_experts):
                a, b = bounds[e], bounds[e + 1]
                if a < b:
                    x = xs[a:b]
                    h = F.silu(x @ w_gate[e].T) * (x @ w_up[e].T)
                    out[a:b] = (h @ w_down[e].T) * slot_w[a:b, None]
            return out

        kernel_ms = event_ms(lambda: moe.experts(*args), 10, torch)
        plain_ms = event_ms(lambda: moe.experts_torch(*args), 5, torch)
        library_ms = event_ms(library, 5, torch)
        ops, bound = lm_counts.moe_experts(rows // cfg.num_experts_per_tok,
                                           dataclasses.asdict(cfg))
        bound_by = ("operations" if bound <= ops / PEAK_FP32_FLOPS
                    * (1 + 1e-9) else "bytes")
        print(f"timing moe_experts layer {at} ({rows} slots): kernel "
              f"{kernel_ms:.3f} ms (two launches), plain route "
              f"{plain_ms:.3f} ms, cuBLAS a used expert {library_ms:.3f} "
              f"ms, bound {1e3 * bound:.3f} ms by {bound_by} "
              f"({1e3 * bound / kernel_ms:.1%} of it) [{card}]")
        return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                    bound_ms=1e3 * bound, bound_by=bound_by, max_abs_err=err)

    with torch.inference_mode():
        readings = {at: reading(at, *captured.pop(at))
                    for at in sorted(captured)}
    gc.collect()
    torch.cuda.empty_cache()
    print(f"timing phase 15: {time.perf_counter() - t_phase:.1f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB left allocated "
          f"[{card}]")
    return {"launches": launches, "entry": readings[1]}


def moe_entry(moe: dict) -> dict:
    """The kernels line's entry of the grouped-expert kernel, timed at the
    first expert layer of phase 15's cohort call; its launches are that
    phase's two main-path calls, the comparisons and timings left out."""
    return {"name": "moe_experts", "route": "cuda",
            "source": "icassp2022_depression_tpu_torch/csrc/moe_experts.cu",
            "replaces": "none: the JAX package has no experts",
            "launches": moe["launches"], **moe["entry"]}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=["gru", "lstm", "lstmp", "trainer",
                                       "daic", "serve", "vggish",
                                       "parallel", "operations",
                                       "threefry", "moe_experts"],
                    help="gru / lstm / lstmp: build the GRU / LSTM / LSTMP "
                         "kernels, run their checks, profiles and "
                         "yardsticks, and stop (no ok line); trainer: the "
                         "GRU and LSTM kernels' fold-axis checks and the "
                         "fold program's (graph, resume, stacked folds) on "
                         "random features; daic: phase 9 (with a seeded "
                         "bundle); serve: phase 10 (with a seeded DAIC "
                         "checkpoint); vggish: phase 11 (with a corpus, a "
                         "seeded bundle and DAIC features of its own); "
                         "parallel: phase 12 (with a corpus and a seeded "
                         "bundle of its own); operations: phase 13 (the "
                         "same); threefry: phase 14; moe_experts: phase "
                         "15 and its kernels entry")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    import icassp2022_depression_tpu_torch as pkg

    if Path(pkg.__file__).resolve().parent.parent != HERE:
        fail(f"imported the port from {pkg.__file__}, not from {HERE}")
    from icassp2022_depression_tpu_torch import _build
    from icassp2022_depression_tpu_torch.data import eatd
    from icassp2022_depression_tpu_torch.ops import rnn_cuda

    t_start = time.perf_counter()
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    names = {"trainer": ("gru_fwd", "gru_bwd", "lstm_fwd", "lstm_bwd"),
             "daic": ("gru_fwd", "gru_bwd", "lstmp_fwd"),
             "serve": ("gru_fwd", "lstm_fwd"),
             "vggish": ("gru_fwd", "gru_bwd", "lstmp_fwd"),
             "parallel": ("gru_fwd", "gru_bwd", "lstm_fwd", "lstm_bwd",
                          "lstmp_fwd"),
             "operations": _build.SOURCES,
             "threefry": ("threefry",),
             "moe_experts": ("moe_experts", "threefry", "gru_fwd",
                             "lstm_fwd")}.get(
        args.only, (f"{args.only}_fwd", f"{args.only}_bwd") if args.only
        else _build.SOURCES)
    _build.build_all(names)                        # one nvcc per source
    print(f"built {', '.join(_build.library_path(n).name for n in names)} "
          f"in {time.perf_counter() - t0:.2f} s")
    for name in names:
        print(_build.build_log(name).strip())

    if args.only == "threefry":
        threefry_phase(torch, card)
        print(f"timing whole script: {time.perf_counter() - t_start:.1f} s "
              f"[{card}]")
        return 0
    if args.only == "moe_experts":
        moe = moe_experts_phase(torch, card)
        print(f"timing whole script: {time.perf_counter() - t_start:.1f} s "
              f"[{card}]")
        print(json.dumps({"kernels": [moe_entry(moe)]}))
        return 0
    if args.only == "trainer":
        fold_kernel_phase(torch, rnn_cuda, card)
        gen = torch.Generator().manual_seed(3)
        clf = (torch.arange(36) % 3 == 0).long().numpy()
        feats = (torch.randn((36, 3, 256), generator=gen)
                 + 0.5 * torch.as_tensor(clf)[:, None, None]).cuda()
        xt = torch.randn((36, 3, 1024), generator=gen).cuda()
        trainer_phase(torch, rnn_cuda, card, feats, clf, xt)
        print(f"timing whole script: {time.perf_counter() - t_start:.1f} s "
              f"[{card}]")
        return 0
    if args.only == "vggish":
        from icassp2022_depression_tpu_torch import cli

        with tempfile.TemporaryDirectory(prefix="chip_smoke_vggish_") as tmp:
            work = Path(tmp)
            corpus = work / "corpus"
            eatd.make_synthetic_corpus(corpus, n_data=24, n_validation=12,
                                       seconds=(2.0, 12.0), seed=1)
            chars = "".join(ch for sp in eatd.iter_speakers(
                corpus, read_text=True) for t in sp.texts for ch in t
                if not ch.isspace())
            bundle, _ = seeded_bundle(torch, work / "elmo_zhs_seeded.npz",
                                      chars)
            daic_root = work / "daic"
            make_daic_corpus(daic_root)
            for split in ("train", "dev"):
                if cli.main(["extract-daic", "--daic-dir", str(daic_root),
                             "--split-csv",
                             str(daic_root / f"{split}_split.csv"), "--out",
                             str(work / "Features"), "--split-name", split,
                             "--device", "cuda"]) != 0:
                    fail(f"cli extract-daic {split} failed")
            vggish_phase(torch, card, corpus, bundle, work,
                         work / "Features")
        print(f"timing whole script: {time.perf_counter() - t_start:.1f} s "
              f"[{card}]")
        return 0
    if args.only == "operations":
        with tempfile.TemporaryDirectory(prefix="chip_smoke_ops_") as tmp:
            work = Path(tmp)
            corpus = work / "corpus"
            eatd.make_synthetic_corpus(corpus, n_data=24, n_validation=12,
                                       seconds=(2.0, 12.0), seed=1)
            chars = "".join(ch for sp in eatd.iter_speakers(
                corpus, read_text=True) for t in sp.texts for ch in t
                if not ch.isspace())
            bundle, _ = seeded_bundle(torch, work / "elmo_zhs_seeded.npz",
                                      chars)
            operations_phase(torch, card, corpus, bundle, work)
        print(f"timing whole script: {time.perf_counter() - t_start:.1f} s "
              f"[{card}]")
        return 0
    if args.only == "parallel":
        with tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_") as tmp:
            work = Path(tmp)
            corpus = work / "corpus"
            eatd.make_synthetic_corpus(corpus, n_data=24, n_validation=12,
                                       seconds=(2.0, 12.0), seed=1)
            chars = "".join(ch for sp in eatd.iter_speakers(
                corpus, read_text=True) for t in sp.texts for ch in t
                if not ch.isspace())
            bundle, _ = seeded_bundle(torch, work / "elmo_zhs_seeded.npz",
                                      chars)
            parallel_phase(torch, card, corpus, bundle, work)
        print(f"timing whole script: {time.perf_counter() - t_start:.1f} s "
              f"[{card}]")
        return 0
    if args.only in ("daic", "serve"):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_daic_") as tmp:
            work = Path(tmp)
            if args.only == "daic":
                bundle, _ = seeded_bundle(torch, work / "elmo_seeded.npz",
                                          "")
                daic_phase(torch, card, bundle, work)
            else:
                serve_phase(torch, card, seeded_daic(work))
        print(f"timing whole script: {time.perf_counter() - t_start:.1f} s "
              f"[{card}]")
        return 0
    if args.only == "lstmp":
        _, lstmp_times, _ = lstmp_kernel_phase(torch, rnn_cuda, card)
        lstmp_profile_phase(torch, rnn_cuda, card)
        lstmp_summary(card, lstmp_times,
                      library_phase(torch, card, only="lstmp"))
        print(f"timing whole script: {time.perf_counter() - t_start:.1f} s "
              f"[{card}]")
        return 0
    if args.only == "gru":
        kernel_phase(torch, rnn_cuda, card)
        gru_profile_phase(torch, rnn_cuda, card)
        bwd_kernel_phase(torch, rnn_cuda, card)
        bwd_profile_phase(torch, rnn_cuda, card, ("gru",))
        library_phase(torch, card, only="gru")
        print(f"timing whole script: {time.perf_counter() - t_start:.1f} s "
              f"[{card}]")
        return 0
    if args.only == "lstm":
        lstm_kernel_phase(torch, rnn_cuda, card)
        standin_times, cudnn, _ = standin_lstm_phase(torch, rnn_cuda, card)
        lstm_profile_phase(torch, rnn_cuda, card)
        bwd_profile_phase(torch, rnn_cuda, card, ("lstm",))
        library_phase(torch, card, only=("lstm_fwd", "lstm_bwd"))
        standin_summary(card, standin_times, cudnn)
        print(f"timing whole script: {time.perf_counter() - t_start:.1f} s "
              f"[{card}]")
        return 0
    threefry_times = threefry_phase(torch, card)
    err, kernel_times = kernel_phase(torch, rnn_cuda, card)
    gru_profile_phase(torch, rnn_cuda, card)
    bwd_err, bwd_times = bwd_kernel_phase(torch, rnn_cuda, card)
    lstm_err, lstm_times = lstm_kernel_phase(torch, rnn_cuda, card)
    fold_kernel_phase(torch, rnn_cuda, card)
    lstmp_err, lstmp_times, _ = lstmp_kernel_phase(torch, rnn_cuda,
                                                   card)
    lstmp_profile_phase(torch, rnn_cuda, card)
    standin_times, cudnn, standin_err = standin_lstm_phase(torch, rnn_cuda,
                                                           card)
    lstm_profile_phase(torch, rnn_cuda, card)
    bwd_profile_phase(torch, rnn_cuda, card)
    library = library_phase(torch, card)
    lstmp_summary(card, lstmp_times, library)
    standin_summary(card, standin_times, cudnn)
    slice_launches, _ = slice_phase(torch, card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_text_") as tmp:
        corpus = Path(tmp) / "corpus"
        eatd.make_synthetic_corpus(corpus, n_data=24, n_validation=12,
                                   seconds=(2.0, 12.0), seed=1)
        corpus_chars = "".join(
            ch for sp in eatd.iter_speakers(corpus, read_text=True)
            for t in sp.texts for ch in t if not ch.isspace())
        t0 = time.perf_counter()
        bundle, chars = seeded_bundle(torch, Path(tmp) / "elmo_zhs_seeded.npz",
                                      corpus_chars)
        print(f"seeded zhs-geometry ELMo bundle {bundle.name}: "
              f"{bundle.stat().st_size / 2**20:.1f} MiB, drawn on the card "
              f"and written in {time.perf_counter() - t0:.2f} s [{card}]")
        launches, train = train_phase(torch, card, corpus, bundle)
        checked = check_phase(torch, card, corpus, bundle, train)
        text_launches, text_latency = text_serving_phase(torch, card, bundle,
                                                         chars)
        daic = daic_phase(torch, card, bundle, Path(tmp))
        served = serve_phase(torch, card, daic)
        vgg = vggish_phase(torch, card, corpus, bundle, Path(tmp),
                           daic["features"])
        par = parallel_phase(torch, card, corpus, bundle, Path(tmp))
        ops = operations_phase(torch, card, corpus, bundle, Path(tmp))
    standin_launches, _ = standin_serving_phase(torch, card)
    moe = moe_experts_phase(torch, card)
    for k, v in text_launches.items():
        launches[k] += (v + slice_launches[k] + standin_launches[k]
                        + checked["launches"][k]
                        + daic["launches"][k] + served["launches"][k]
                        + vgg["launches"][k] + par["launches"][k]
                        + ops["launches"][k])
    if launches["lstmp_bwd"] != 0:
        fail(f"a main path launched the LSTMP backward: {launches}")
    if daic["launches"]["gru_bwd_streamed"] <= 0:
        fail(f"the DAIC path never reached TPU kernel #3: {daic['launches']}")
    if "jax" in sys.modules:
        fail("jax was imported")
    for track in ("clf", "reg"):
        for task, wall in train[track]["stage_s"].items():
            print(f"timing pipeline stage {task}: {wall:.2f} s wall, "
                  f"{train[track]['vmap_stage_s'][task]:.2f} s with "
                  f"--vmap-folds [{card}]")
    print(f"timing cli extract-text (108 answers, one batch of 112 rows): "
          f"{train['text']['wall_s']:.2f} s wall [{card}]")
    print(f"timing at 83 + 79 speakers: cli extract-audio "
          f"{checked['extract_s']:.2f} s, cli check --task fuse_clf --corpus "
          f"{checked['check_s']:.2f} s wall [{card}]")
    print(f"timing DAIC: a clf train step {daic['step_ms']:.3f} ms under the "
          "graph; stages " + ", ".join(
              f"{k} {v:.2f} s" for k, v in daic["stage_s"].items())
          + f" [{card}]")
    for task, r in served["readings"].items():
        print(f"timing serve {task} through the HTTP front (smoke "
              f"reading, not a throughput): {SERVE_CLIENTS * SERVE_REQUESTS}"
              f" requests in {r['wall']:.3f} s, {r['batches']} device "
              f"batches, cache {r['cache']['hits']} hits / "
              f"{r['cache']['misses']} misses, request p50 "
              f"{r['latency']['request']['p50_ms']} ms [{card}]")
    print(f"timing whole script: {time.perf_counter() - t_start:.1f} s "
          f"[{card}]")

    print_bounds(card, {
        **{("gru_fwd", k): v[0] for k, v in kernel_times.items()},
        **{("gru_bwd", k): v[0] for k, v in bwd_times.items()},
        **{(f"lstm_{d}", k): v[d][0] for k, v in lstm_times.items()
           for d in ("fwd", "bwd")},
        **{("lstm_fwd", k): v[0] for k, v in standin_times.items()},
        **{(f"lstmp_{d}", k): v[d][0] for k, v in lstmp_times.items()
           for d in ("fwd", "bwd")}})
    bounds = kernel_bounds()
    # one entry per TPU kernel: #3 and #5 are #2's and #8's sources; #3 is
    # timed at its main path's shape (the DAIC train batch, phase 9), #5 at
    # the streamed T = 256 (no main path reaches it); their launches are
    # the backward calls at the shapes the JAX package streams.  #6's
    # forward has a second entry for its resident route (its launches
    # those of the forward's that took it)
    dk = daic["kernels"]
    if dk["name"] != "gru_bwd_streamed":
        fail(f"the DAIC shape {dk['shape']} is not one the JAX package "
             "streams")
    bounds["gru_bwd_streamed"] = dk["bound"]
    bounds["threefry"] = threefry_times["netvlad bucket, 1 row"][2:]
    bounds["lstmp_fwd_resident"] = lstmp_bounds(*LSTMP_TIMED[3])["fwd"]
    library["threefry"] = None
    library["gru_bwd_streamed"] = dk["cudnn_ms"]
    timed = {
        "gru_fwd": (kernel_times[TIMED_SHAPES[0]], max(err, dk["fwd_err"]),
                    "gru_fwd"),
        "gru_bwd": (bwd_times[BWD_TIMED[0]], bwd_err, "gru_bwd"),
        "gru_bwd_streamed": ((dk["ms"], dk["plain_ms"]), dk["bwd_err"],
                             "gru_bwd_streamed"),
        "lstm_fwd": (lstm_times[LSTM_TIMED[0]]["fwd"],
                     max(lstm_err["fwd"], standin_err), "lstm_fwd"),
        "lstm_bwd_streamed": (lstm_times[LSTM_TIMED[-1]]["bwd"],
                              lstm_err["bwd"], "lstm_bwd_streamed"),
        "lstm_bwd": (lstm_times[LSTM_TIMED[0]]["bwd"], lstm_err["bwd"],
                     "lstm_bwd"),
        "lstmp_fwd": (lstmp_times[LSTMP_TIMED[0]]["fwd"], lstmp_err["fwd"],
                      "lstmp_fwd"),
        # the forward's resident route, at one served speaker's rows
        "lstmp_fwd_resident": (lstmp_times[LSTMP_TIMED[3]]["fwd"],
                               lstmp_err["fwd"], "lstmp_fwd_b8_t128"),
        "lstmp_bwd": (lstmp_times[LSTMP_TIMED[0]]["bwd"], lstmp_err["bwd"],
                      "lstmp_bwd"),
        # a one-answer bucket's NetVLAD weights, the interactive path's
        "threefry": (threefry_times["netvlad bucket, 1 row"][:2], 0.0,
                     "threefry"),
    }
    src = "icassp2022_depression_tpu_torch/csrc"
    pallas = "icassp2022_depression_tpu/ops/rnn_pallas.py"
    replaces = {"gru_fwd": f"{pallas}:149", "gru_bwd": f"{pallas}:38",
                "gru_bwd_streamed": f"{pallas}:174",
                "lstm_fwd": f"{pallas}:346",
                "lstm_bwd_streamed": f"{pallas}:377",
                "lstm_bwd": f"{pallas}:868",
                "lstmp_fwd": f"{pallas}:562", "lstmp_bwd": f"{pallas}:609",
                "lstmp_fwd_resident": f"{pallas}:562",
                "threefry": "none: XLA fused each jax.random draw"}
    entries = []
    for name, ((ms, plain_ms), max_err, lib) in timed.items():
        bound_ms, bound_by = bounds[name]
        source = name.replace("_streamed", "").replace("_resident", "")
        entries.append({
            "name": name, "route": "cuda", "source": f"{src}/{source}.cu",
            "replaces": replaces[name],
            "launches": launches[name],
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library[lib]})
    entries.append(moe_entry(moe))
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
