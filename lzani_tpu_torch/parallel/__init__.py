"""Multi-process execution of the port (``distributed``)."""
