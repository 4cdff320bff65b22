"""Host utilities of the port: the user's configuration (``config``)
and the replacement of a file's contents at once (``files``)."""
