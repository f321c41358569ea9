"""Selector training for the PyTorch port."""
