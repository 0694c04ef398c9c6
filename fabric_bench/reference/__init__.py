"""The plain reference: float32 PyTorch, no kernel, nothing of the port.

``model`` holds the dense and MoE decoders' forward pass and loss,
``train`` the data-parallel step (each worker's gradients, the G-Binary
sign-count vote or the FP32 mean, AdamW) followed for the set-up's first
steps, ``compare`` the numbers that decide ``correct``.
"""
