"""Kernels and plain tensor operations of the port."""
