"""The port's counterparts of the JAX package's ``benchmark/`` probes.

``python -m paddle_tpu_torch.benchmark.bandwidth`` is the HBM
stream-bandwidth probe of ``benchmark/bandwidth.py``.  Nothing here is
imported by the package itself.
"""
