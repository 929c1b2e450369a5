"""Optimizers: AdamW over dict trees of tensors (``adamw.py``)."""
