"""icassp2022_depression_tpu_torch — the PyTorch + CUDA port of
:mod:`icassp2022_depression_tpu` for one NVIDIA H100.

The JAX package beside this one is the reference: every module here has a
counterpart there under the same name, keeps its public function names and
array layouts at the boundary, and is held against it by the
``tests/test_torch_*.py`` parity tests.  This package imports ``torch``
and never ``jax``.

Ported so far (serving ``audio_clf`` / ``audio_reg``):

* :mod:`.data.eatd`            EATD reader + synthetic corpus (numpy)
* :mod:`.ops.prng`             bit-exact JAX threefry2x32 streams
* :mod:`.ops.mel`, :mod:`.ops.netvlad`, :mod:`.frontend.audio`  wav2vlad
* :mod:`.ops.rnn`              multi-layer GRU with a backend seam
* :mod:`.ops.rnn_cuda`         the hand-written CUDA GRU forward kernel
  (``csrc/gru_fwd.cu``), built with ``nvcc`` at first use by
  :mod:`._build`
* :mod:`.models.audio_net`     the audio GRU classifier / regressor
* :mod:`.models.porting`, :mod:`.train.checkpoints`  JAX npz checkpoints
* :mod:`.serving.predictors`, :mod:`.cli`  ``Predictor`` and ``cli predict``
"""

__version__ = "0.1.0"
