"""Host utilities of the port: the user's configuration (``config``),
the replacement of a file's contents at once (``files``), and the
stage timers and profiler ranges (``profiling``)."""
