"""The port's counterparts of the JAX package's ``benchmark/`` probes.

``python -m paddle_tpu_torch.benchmark.bandwidth`` is the HBM
stream-bandwidth probe of ``benchmark/bandwidth.py``;
``python -m paddle_tpu_torch.benchmark.input_pipeline`` is the wide_deep
leg of ``benchmark/input_pipeline.py``;
``python -m paddle_tpu_torch.benchmark.run`` is the model-zoo runner of
``benchmark/run.py`` (``--all``: its HEADLINE configs).  Nothing here is
imported by the package itself.
"""
