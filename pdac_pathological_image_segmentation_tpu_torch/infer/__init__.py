"""Serving of the port: artifacts and the HTTP daemon."""
