"""The port's one-time weight converters, run as modules:

  python -m icassp2022_depression_tpu_torch.scripts.convert_elmo_zhs MODEL_DIR
  python -m icassp2022_depression_tpu_torch.scripts.convert_vggish CKPT

(counterparts of the JAX repo's two converter scripts, with their
arguments and output files; neither imports jax)."""
