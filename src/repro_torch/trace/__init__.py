"""Context-switching trace synthesis of the port (``synth``)."""
