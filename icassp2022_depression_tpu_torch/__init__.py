"""icassp2022_depression_tpu_torch — the PyTorch + CUDA port of
:mod:`icassp2022_depression_tpu` for one NVIDIA H100.

The JAX package beside this one is the reference: every module here has a
counterpart there under the same name, keeps its public function names and
array layouts at the boundary, and is held against it by the
``tests/test_torch_*.py`` parity tests.  This package imports ``torch``
and never ``jax``.

Ported so far (serving ``audio_clf`` / ``audio_reg``; training the audio
and text branches and the fusion of both tracks from npz features):

* :mod:`.data.eatd`, :mod:`.data.folds`, :mod:`.data.augment`  EATD reader,
  synthetic corpus, fold recipes and answer-permutation plans (numpy)
* :mod:`.ops.prng`             bit-exact JAX threefry2x32 streams
* :mod:`.ops.mel`, :mod:`.ops.netvlad`, :mod:`.frontend.audio`  wav2vlad,
  and the corpus pass that feeds training
* :mod:`.frontend.text`        the npz reader of the text features
* :mod:`.ops.rnn`              multi-layer (bi)directional GRU and LSTM
  with a backend seam
* :mod:`.ops.rnn_cuda`         the hand-written CUDA GRU and LSTM forward
  and backward kernels (``csrc/{gru,lstm}_{fwd,bwd}.cu``) and their
  autograd Functions, built with ``nvcc`` at first use by :mod:`._build`
* :mod:`.ops.nn`, :mod:`.ops.attention`, :mod:`.ops.initializers`
  LayerNorm, dropout, the branch losses, additive attention, torch-default
  and xavier init
* :mod:`.models.audio_net`, :mod:`.models.text_net`, :mod:`.models.fusion`,
  :mod:`.models.losses`  the audio GRU and text BiLSTM branches, the
  fusion net and its MyLoss
* :mod:`.models.porting`, :mod:`.train.checkpoints`  JAX npz checkpoints
* :mod:`.eval.metrics`, :mod:`.train.optim`, :mod:`.train.loop`,
  :mod:`.train.trainers`, :mod:`.utils.logging`  the fold loop with its
  on-device metric gate, and the six trainers
* :mod:`.serving.predictors`, :mod:`.cli`  ``Predictor``, ``cli predict``,
  ``cli train`` and ``cli pipeline``
"""

__version__ = "0.1.0"
