"""Fit models of the port: initialization and full-batch Lloyd."""
