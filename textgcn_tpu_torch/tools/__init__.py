"""Lab entry points of the port: the SpMM lab (``kernel_lab``) and the
row-gather lab (``gather_lab``), each on hand-written CUDA kernels, with
their layouts (``lab_layout``) and the event timer (``timing``).

Counterparts of the JAX package's ``tools/kernel_lab.py`` and
``tools/gather_lab.py``.  Nothing here runs at import time.
"""
