"""The benchmark of the PyTorch/CUDA port renderer_rs_tpu_torch (python3 -m bench_port.run)."""
