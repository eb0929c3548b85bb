"""climategan_torch: the PyTorch / CUDA port of climategan_tpu for NVIDIA
Hopper (H100).

``infer`` with all three events (flood, wildfire, smog) runs end to end;
its five kernels are hand-written for sm_90a: ``spade_cond`` (tensor cores
in bf16), ``smog_tail``, ``fire_color_grade`` and ``fire_paste`` (CUDA C++
in ``csrc/``) and ``masked_blend`` (Triton), under ``kernels/``. So does
one default training step (``g_step`` then ``d_step``). Entry points:
``climategan_torch.inference.build_infer_fn`` and
``climategan_torch.train_step.StepBuilder``.
"""

__version__ = "0.1.0"
