"""Fit loops of the port."""
