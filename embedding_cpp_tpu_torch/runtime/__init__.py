"""Serving runtime: batching, the Engine and the TCP server."""
