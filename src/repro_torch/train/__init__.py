"""Training substrate of the port (``optimizer``, ``checkpoint``)."""
