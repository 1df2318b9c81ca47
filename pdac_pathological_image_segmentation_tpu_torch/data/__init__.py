"""Patch discovery and loading of the port."""
