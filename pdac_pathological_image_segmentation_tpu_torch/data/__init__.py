"""Patch discovery and loading, slide reading and writing, and GeoJSON of
the port."""
