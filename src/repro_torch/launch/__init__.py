"""Entry points of the port (``serve``)."""
