"""Synthetic data of the port (``pipeline``: the Markov language, ``SyntheticLM``)."""
