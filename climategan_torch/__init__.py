"""climategan_torch: the PyTorch / CUDA port of climategan_tpu for NVIDIA
Hopper (H100).

``infer`` with all three events (flood, wildfire, smog) runs end to end;
its five kernels are hand-written for sm_90a: ``spade_cond`` (tensor cores
in bf16), ``smog_tail``, ``fire_color_grade`` and ``fire_paste`` (CUDA C++
in ``csrc/``) and ``masked_blend`` (Triton), under ``kernels/``. So do
the training step (``g_step`` then ``d_step``, with every option of the
JAX step) and the trainer with its evaluation and FID. Entry points:
``climategan_torch.inference.build_infer_fn``,
``climategan_torch.train_step.StepBuilder`` and ``python -m
climategan_torch.train``.
"""

__version__ = "0.1.0"
