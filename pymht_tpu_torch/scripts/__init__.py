"""The scripts through which users run the port: the headline benchmark,
the swarm, saturation and scaling benchmarks, the evaluation configs and
the distributed-selection A/B (counterparts of the JAX package's root
scripts and ``tools/ab_distributed_select.py``).  Each runs as
``python -m pymht_tpu_torch.scripts.<name>``, on the GPU unless given
``--device cpu``."""
