"""masabench: the benchmark of masa_tpu_torch on the card (``run.py``)."""
