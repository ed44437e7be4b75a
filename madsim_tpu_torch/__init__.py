"""PyTorch/CUDA port of the madsim_tpu batched simulation engine.

`madsim_tpu_torch.tpu` mirrors `madsim_tpu.tpu` module for module; the JAX
package stays the reference each part is held against. This package
imports torch and numpy only.
"""
