"""Host-side runtime of the port: the native image loader, export
artifacts (`export.py`) and the HTTP server (`server.py`)."""
