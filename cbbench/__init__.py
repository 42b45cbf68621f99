"""The benchmark of ``cbinfer_tpu_torch`` on an NVIDIA H100: one cell a
run (``python3 -m cbbench.run``), its frames made from a seed on the card,
its outputs judged against a plain reference (``reference.py``)."""
