"""The benchmark of the PyTorch and CUDA port: ``python3 -m benchmark.run`` (see
:mod:`benchmark.run`)."""
