"""PyTorch/CUDA port of the colonoscopy 3D reconstruction framework.

Runs on an NVIDIA H100 (Hopper, sm_90a) beside the JAX package, which it
never imports. This slice covers DAv2 metric-depth inference and serving:
``models.depth_anything`` (model, batched u8 inference), ``serving.engine``
(the batching server) and kernel K1, the flash-attention forward
(``ops.flash_attention``, CUDA source in ``csrc/``). Entry points run on
``"cuda"`` unless the caller passes ``device="cpu"``.
"""
