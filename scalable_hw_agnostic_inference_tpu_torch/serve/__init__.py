"""Serving runtime: ASGI router, stdlib HTTP server, app factory, units."""
