"""Host-side runtime of the port: the native image loader."""
