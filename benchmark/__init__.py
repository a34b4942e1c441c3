"""The benchmark of the PyTorch and CUDA port (``dlrm_yx_tpu_torch``): see
``BENCHMARK.json`` and ``python3 -m benchmark.run --help``."""
