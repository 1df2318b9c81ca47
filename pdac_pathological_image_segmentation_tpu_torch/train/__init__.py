"""Step builders of the port."""
