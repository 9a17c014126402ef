"""Data generation for the port."""
