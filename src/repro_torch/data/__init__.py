"""Synthetic data of the port (``pipeline.markov_*``)."""
