"""Host-side memory layer of the port (see `host.py`)."""
