"""The benchmark of ``gridcodegenerator_tpu_torch`` (``run.py``): the
harness, its reference, its traffic and its yardstick. It measures the
PyTorch and CUDA package alone and imports neither JAX nor the JAX
package."""
