"""Training data: the synthetic token pipeline (``pipeline.py``)."""
