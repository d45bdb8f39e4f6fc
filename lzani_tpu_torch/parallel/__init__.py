"""Multi-process execution of the port (``distributed``) and one
query batch split over several devices (``mesh``)."""
