"""Entry points of the port beside the CLI: the SpMM lab (``kernel_lab``)
and the row-gather lab (``gather_lab``), each on hand-written CUDA
kernels, with their layouts (``lab_layout``) and the event timer
(``timing``); the synthetic data generator (``make_synthetic``), the
quality sweep over it (``conv_quality_sweep``) and the warm/cold split
report of a checkpoint (``cold_report``).

Counterparts of the JAX package's ``tools/kernel_lab.py``,
``tools/gather_lab.py``, ``tools/make_synthetic.py``,
``tools/conv_quality_sweep.py`` and ``tools/cold_report.py``.  Nothing here runs at import time.
"""
