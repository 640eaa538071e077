"""Multi-device execution on ``torch.distributed`` (port of
:mod:`icassp2022_depression_tpu.parallel`): process groups, the rank
launcher and the fold-parallel layout (:mod:`.distributed`), the
``(data, model)`` grid (:mod:`.mesh`), the explicit data-parallel step
(:mod:`.collectives`) and the tensor-parallel biLM (:mod:`.elmo_tp`)."""
