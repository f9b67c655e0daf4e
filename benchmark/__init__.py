"""The benchmark of gf3x_torch, the PyTorch and CUDA port: a data-driven
harness (`harness.py`, `run.py`), the traffic generator, the float64
reference that judges every run (`reference/`), the per-layer metrics'
readers (`metrics/`) and the cells' files. It imports nothing of the JAX
package."""
