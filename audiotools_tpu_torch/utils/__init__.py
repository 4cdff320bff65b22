"""Host utilities of the port: the user's configuration (``config``)."""
