"""The benchmark of the PyTorch and CUDA port, `multioptpy_tpu_torch`, on
one NVIDIA H100: one cell (configuration x traffic mix) per command, driven
by BENCHMARK.json at the checkout's root. See README.md."""
