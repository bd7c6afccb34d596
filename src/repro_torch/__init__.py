"""PyTorch/CUDA port of the W4A4+LRC serving path (the JAX package
``repro`` is the reference it is held against).

The port imports ``torch`` and ``numpy`` only.  Entry points take
``device=`` and default to the card; see :func:`repro_torch.device.resolve_device`.
"""
