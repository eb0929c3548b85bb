"""climategan_torch: the PyTorch / CUDA port of climategan_tpu for NVIDIA
Hopper (H100).

Flood inference (Masker + SPADE Painter) runs end to end; its two kernels
are hand-written for sm_90a: ``kernels/spade_cond.py`` (CUDA C++ in
``csrc/``) and ``kernels/masked_blend.py`` (Triton). Entry point:
``climategan_torch.inference.build_infer_fn``.
"""

__version__ = "0.1.0"
