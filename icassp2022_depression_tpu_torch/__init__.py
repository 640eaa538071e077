"""icassp2022_depression_tpu_torch — the PyTorch + CUDA port of
:mod:`icassp2022_depression_tpu` for one NVIDIA H100.

The JAX package beside this one is the reference: every module here has a
counterpart there under the same name, keeps its public function names and
array layouts at the boundary, and is held against it by the
``tests/test_torch_*.py`` parity tests.  This package imports ``torch``
and never ``jax``.

Ported so far (serving and training ``audio_clf`` / ``audio_reg``):

* :mod:`.data.eatd`, :mod:`.data.folds`, :mod:`.data.augment`  EATD reader,
  synthetic corpus, fold recipes and answer-permutation plans (numpy)
* :mod:`.ops.prng`             bit-exact JAX threefry2x32 streams
* :mod:`.ops.mel`, :mod:`.ops.netvlad`, :mod:`.frontend.audio`  wav2vlad,
  and the corpus pass that feeds training
* :mod:`.ops.rnn`              multi-layer GRU with a backend seam
* :mod:`.ops.rnn_cuda`         the hand-written CUDA GRU forward and
  backward kernels (``csrc/gru_fwd.cu``, ``csrc/gru_bwd.cu``) and their
  autograd Function, built with ``nvcc`` at first use by :mod:`._build`
* :mod:`.ops.nn`               LayerNorm, dropout and the training losses
* :mod:`.models.audio_net`     the audio GRU classifier / regressor
* :mod:`.models.porting`, :mod:`.train.checkpoints`  JAX npz checkpoints
* :mod:`.eval.metrics`, :mod:`.train.optim`, :mod:`.train.loop`,
  :mod:`.train.trainers`, :mod:`.utils.logging`  the fold loop with its
  on-device metric gate, and the audio trainers
* :mod:`.serving.predictors`, :mod:`.cli`  ``Predictor``, ``cli predict``
  and ``cli train``
"""

__version__ = "0.1.0"
