"""The benchmark of the PyTorch and CUDA port, ``item_alignment_torch``,
on an NVIDIA H100: ``python3 -m portbench.run`` runs one cell once
(``run.py``); the cells, configurations, traffic mixes, jobs and metric
readers are files found by name (``cell.py``)."""
