"""The plain reference that decides ``correct``: the served models in
float32 (:mod:`.model`) and the fleet's routing and caps (:mod:`.fleet`).
Plain PyTorch and NumPy; nothing of ``jax``, ``repro`` or ``repro_torch``.
"""
