"""The JAX package's examples on the card (counterparts of
``examples/``), each run as ``python -m euler_tpu_torch.examples.<name>``:
``sage`` (supervised GraphSAGE on synthetic PPI), ``sage_reddit`` (on
synthetic Reddit), ``custom_sage_reddit`` (a user model built from the
primitive ops) and ``dist_train.sh`` (graph shards plus shared-mode
training)."""
