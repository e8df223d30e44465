"""Examples of the port (counterparts of the JAX package's
``examples/``): ``python -m pymht_tpu_torch.examples.<name>``, on the GPU
unless given ``--device cpu``."""
