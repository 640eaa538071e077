"""icassp2022_depression_tpu_torch — the PyTorch + CUDA port of
:mod:`icassp2022_depression_tpu` for NVIDIA H100 cards.

The JAX package beside this one is the reference: every module here has a
counterpart there under the same name, keeps its public function names and
array layouts at the boundary, and is held against it by the
``tests/test_torch_*.py`` parity tests.  This package imports ``torch``
and never ``jax``.  Every entry point runs on the card unless its caller
asks for the CPU (:mod:`.utils.device`).

* :mod:`.config`               the dataclasses, the six presets, ``DataPaths``
* :mod:`.data.eatd`, :mod:`.data.folds`, :mod:`.data.augment`  EATD reader,
  synthetic corpus, fold recipes and answer-permutation plans (numpy)
* :mod:`.ops.prng`             bit-exact JAX threefry2x32 streams
* :mod:`.ops.mel`, :mod:`.ops.netvlad`, :mod:`.frontend.audio`  log-mel and
  MFCC, wav2vlad, the corpus passes (and the VGGish one) that feed training
* :mod:`.frontend.text`        segmenters (``register_segmenter``), the
  ELMo embedder's resolution, the corpus text passes
* :mod:`.frontend.daic`        DAIC-WOZ segmentation and feature passes
* :mod:`.ops.rnn`              multi-layer (bi)directional GRU, LSTM and
  LSTMP with a backend seam
* :mod:`.ops.rnn_cuda`         the hand-written CUDA GRU, LSTM and LSTMP
  forward and backward kernels (``csrc/{gru,lstm,lstmp}_{fwd,bwd}.cu``)
  and their autograd Functions, built with ``nvcc`` at first use (or ahead
  of time, ``cli warmup``) by :mod:`._build`
* :mod:`.ops.nn`, :mod:`.ops.attention`, :mod:`.ops.initializers`
  LayerNorm, dropout, the branch losses, additive attention, torch-default
  and xavier init
* :mod:`.models.audio_net`, :mod:`.models.text_net`, :mod:`.models.fusion`,
  :mod:`.models.losses`, :mod:`.models.folds`  the audio GRU and text
  BiLSTM branches, the fusion net and its MyLoss, stacked folds
* :mod:`.models.char_cnn`, :mod:`.models.elmo`,
  :mod:`.models.elmo_pretrained`, :mod:`.models.vggish`  the ELMo char-CNN
  and biLM (stand-in and pretrained bundle), VGGish
* :mod:`.models.porting`, :mod:`.train.checkpoints`  JAX npz checkpoints
  and the reference's ``.pt`` files
* :mod:`.eval.metrics`, :mod:`.train.optim`, :mod:`.train.loop`,
  :mod:`.train.trainers`, :mod:`.train.daic`, :mod:`.utils.logging`  the
  fold loop (one CUDA graph an epoch) with its on-device metric gate, the
  six trainers and the DAIC trainer
* :mod:`.eval.checking`, :mod:`.eval.cross_corpus`,
  :mod:`.eval.traditional`  checking checkpoints, cross-corpus scoring,
  the sklearn baselines
* :mod:`.serving.predictors`, :mod:`.serving.transport`, :mod:`.serve`
  ``Predictor``, ``DaicPredictor``, the HTTP front, the facade
* :mod:`.parallel`             fold-parallel and data-parallel training and
  the tensor-parallel biLM on ``torch.distributed``
* :mod:`.utils.profiling`      named, recorded regions and traces
* :mod:`.scripts`              the ELMo and VGGish weight converters
* :mod:`.cli`                  the command line (all 17 of the JAX CLI's
  subcommands; console script ``icassp2022-depression-tpu-torch``)
"""

__version__ = "0.1.0"
