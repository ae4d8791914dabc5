"""PyTorch + CUDA port of ``coma_tpu``: the ComA learning stage (filter,
downsampling, extraction on one card or several processes), inference, and
the adaptive-mask inpainting of 2D HOI generation.

The package mirrors ``coma_tpu``'s module paths (``affordance/contact.py``
here is the counterpart of ``coma_tpu/affordance/contact.py``). It imports
``torch`` and never ``jax``, and nothing of ``coma_tpu``: the framework-free
helpers it needs are kept as private copies.

Entry points with device work run on ``cuda`` unless the caller asks for
``cpu``. On a CUDA tensor the two hot updates and attention run hand-written
kernels for Hopper (``csrc/*.cu``); on a CPU tensor they run their plain
PyTorch versions.
"""
