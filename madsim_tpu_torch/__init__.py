"""PyTorch/CUDA port of the madsim_tpu batched simulation engine.

`madsim_tpu_torch.tpu` mirrors `madsim_tpu.tpu` module for module, and
`nemesis`, `triage` and `repro` mirror their JAX-package namesakes (the
fault vocabulary and pure schedule, the ddmin shrinker, bundle replay);
the JAX package stays the reference each part is held against. This
package imports torch and numpy only.
"""
